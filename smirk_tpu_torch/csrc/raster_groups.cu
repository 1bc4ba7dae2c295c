// K9 raster_fused_groups and K10 raster_fused_groups_local: the merged
// z-buffer over groups of `tps` tiles on the padded per-tile layout, plus
// the winner's three interpolated normal planes.
//
// Replaces _raster_kernel_v6 (K9) and _raster_kernel_v6tl (K10) in
// smirk_tpu/render/rasterizer.py. On the TPU those run one loop per grid
// step over a (tps, 32 faces, 1024 pixels) block: every tile of the step
// walks the same chunk index up to the step's largest chunk count, and a
// tile past its own count tests the kill records of its padded bin, which
// are never inside. Here a block owns one group of tps tiles of one image
// and runs the same schedule:
//   * each step stages the group's chunk k, tps x 32 records of 32 floats
//     (tps x 4 KB), in shared memory with float4 loads, then reads them as
//     broadcasts;
//   * the per-pixel nearest depth and winner of every tile of the group
//     live in shared memory beside them (8 KB per tile), so that they
//     persist from step to step; each (tile, pixel) is only ever touched
//     by one thread, so they need no barrier of their own;
//   * each thread tests the 32 faces in slot order for 4 pixels of a tile
//     and keeps a face only if it is inside and strictly nearer: the first-
//     minimum rule of the TPU kernels, so the result is bitwise equal to
//     K1 on the same padded windows;
//   * at tps = 16 a block holds 192 KB, past the 48 KB default, so the
//     launch opts in to the device's limit with cudaFuncSetAttribute; a
//     group larger than the limit holds runs in passes of `per_pass` tiles,
//     each pass walking the group's full chunk count.
// K10 is the same kernel with the tile-local flag: its records were rebased
// to tile-local coordinates, so every tile takes the pixel centres of the
// image's first tile, ndc(p % 128, W) and ndc(p / 128, H), and the kernel
// never needs a tile's position (the tiles arrive count-sorted).
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn and the pixel centres with __fdiv_rn, as in K1, so nothing is
// contracted into an FMA and the results are bitwise equal to the plain
// PyTorch version on the card.
//
// Bound on H100: fp32 operations, ~16 per face-pixel test over the faces
// that the function needs, K1b's padded windows, since it computes K1b's
// z-buffer. The schedule walks more: tps x the group's chunk count x 32
// faces x 1024 pixels per group, K1b's tests plus the kill-record tests of
// the shorter tiles of each group. The design keeps the records and the
// per-pixel state in shared memory; with 8 KB of state per tile a block of
// 8 tiles (96 KB) leaves room for two blocks per SM and one of 16 tiles
// for one, so latency is hidden by 16 or 8 warps per SM at most.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces per chunk
constexpr int kLanes = 32;                        // floats per record
constexpr int kQuads = 256;                       // 4-pixel items per tile
constexpr int kPixPerItem = kTilePix / kQuads;    // 4
constexpr int kChunkF4 = kChunk * kLanes / 4;     // float4 per chunk: 256
constexpr int kThreads = 512;
constexpr float kBigZ = 1e10f;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr size_t kBytesPerTile = kChunk * kLanes * 4 + kTilePix * 8;  // 12 KB

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

template <bool kLocal>
__global__ void __launch_bounds__(kThreads)
raster_groups_kernel(const int32_t* __restrict__ counts,  // (B, Tp)
                     const float* __restrict__ recs,      // (B, Tp*C, 32)
                     int32_t* __restrict__ p2f, float* __restrict__ zbuf,
                     float* __restrict__ nx, float* __restrict__ ny,
                     float* __restrict__ nz, int Tp, int C, int tps,
                     int per_pass, int H, int W, int TX) {
  extern __shared__ float4 smem[];
  float4* s_rec = smem;                                          // per_pass x 4 KB
  float* s_best = reinterpret_cast<float*>(smem + per_pass * kChunkF4);
  int* s_win = reinterpret_cast<int*>(s_best + per_pass * kTilePix);
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = g * tps;
  const int cpt = C / kChunk;
  const int32_t* cnt = counts + (size_t)b * Tp + t0;
  int nmax = 0;
  for (int j = 0; j < tps; ++j) nmax = max(nmax, cnt[j]);
  const int n_steps = (nmax + kChunk - 1) / kChunk;
  const float* img_recs = recs + (size_t)b * Tp * C * kLanes;
  const float4* img_f4 = reinterpret_cast<const float4*>(img_recs);
  const float* s = reinterpret_cast<const float*>(s_rec);

  for (int p0 = 0; p0 < tps; p0 += per_pass) {
    const int n_tiles = min(per_pass, tps - p0);
    const int n_items = n_tiles * kQuads;
    for (int i = threadIdx.x; i < n_tiles * kTilePix; i += kThreads) {
      s_best[i] = kBigZ;
      s_win[i] = -1;
    }
    __syncthreads();  // the state is read by other threads than set it
    for (int k = 0; k < n_steps; ++k) {
      __syncthreads();  // the previous step's records have been read
      for (int i = threadIdx.x; i < n_tiles * kChunkF4; i += kThreads) {
        const int t = t0 + p0 + i / kChunkF4;
        s_rec[i] = img_f4[(size_t)(t * cpt + k) * kChunkF4 + i % kChunkF4];
      }
      __syncthreads();
      for (int it = threadIdx.x; it < n_items; it += kThreads) {
        const int j = it / kQuads;
        const int q = it % kQuads;
        const int t = t0 + p0 + j;
        const int tx = kLocal ? 0 : t % TX;
        const int ty = kLocal ? 0 : t / TX;
        // pixels q + m*256: one column, rows q/128 + 2m
        const float x = ndc(q % kTileCols + tx * kTileCols, W);
        float ys[kPixPerItem], best[kPixPerItem];
        int win[kPixPerItem];
#pragma unroll
        for (int m = 0; m < kPixPerItem; ++m) {
          const int p = q + m * kQuads;
          ys[m] = ndc(p / kTileCols + ty * kTileRows, H);
          best[m] = s_best[j * kTilePix + p];
          win[m] = s_win[j * kTilePix + p];
        }
        const float* rs = s + j * kChunk * kLanes;
        const int id0 = (t * cpt + k) * kChunk;
#pragma unroll 2
        for (int f = 0; f < kChunk; ++f) {
          const float* r = rs + f * kLanes;
          const float a0 = r[0], b0 = r[1], d0 = r[2];
          const float a1 = r[3], b1 = r[4], d1 = r[5];
          const float a2 = r[6], b2 = r[7], d2 = r[8];
          const float za = r[9], zb = r[10], zc = r[11];
          const bool real = r[12] >= 0.0f;
#pragma unroll
          for (int m = 0; m < kPixPerItem; ++m) {
            const float e0 = affine(a0, b0, d0, x, ys[m]);
            const float e1 = affine(a1, b1, d1, x, ys[m]);
            const float e2 = affine(a2, b2, d2, x, ys[m]);
            const float z = affine(za, zb, zc, x, ys[m]);
            if (real && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z < best[m]) {
              best[m] = z;
              win[m] = id0 + f;
            }
          }
        }
#pragma unroll
        for (int m = 0; m < kPixPerItem; ++m) {
          const int p = q + m * kQuads;
          s_best[j * kTilePix + p] = best[m];
          s_win[j * kTilePix + p] = win[m];
        }
      }
    }
    // outputs of the pass's tiles; each thread reads only its own state
    for (int it = threadIdx.x; it < n_items; it += kThreads) {
      const int j = it / kQuads;
      const int q = it % kQuads;
      const int t = t0 + p0 + j;
      const int tx = kLocal ? 0 : t % TX;
      const int ty = kLocal ? 0 : t / TX;
      const float x = ndc(q % kTileCols + tx * kTileCols, W);
#pragma unroll
      for (int m = 0; m < kPixPerItem; ++m) {
        const int p = q + m * kQuads;
        const float bz = s_best[j * kTilePix + p];
        const size_t o = ((size_t)b * Tp + t) * kTilePix + p;
        if (bz < kBigZ) {
          const float y = ndc(p / kTileCols + ty * kTileRows, H);
          const float* r = img_recs + (size_t)s_win[j * kTilePix + p] * kLanes;
          p2f[o] = (int32_t)r[12];
          zbuf[o] = bz;
          nx[o] = affine(r[16], r[19], r[22], x, y);
          ny[o] = affine(r[17], r[20], r[23], x, y);
          nz[o] = affine(r[18], r[21], r[24], x, y);
        } else {
          p2f[o] = -1;
          zbuf[o] = kBigZ;
          nx[o] = 0.0f;
          ny[o] = 0.0f;
          nz[o] = 0.0f;
        }
      }
    }
    __syncthreads();  // the next pass re-initialises the state
  }
}

template <bool kLocal>
cudaError_t launch(const void* counts, const void* recs, void* p2f, void* zbuf,
                   void* nx, void* ny, void* nz, int B, int Tp, int C, int tps,
                   int per_pass, int H, int W, int TX, cudaStream_t stream) {
  const size_t bytes = (size_t)per_pass * kBytesPerTile;
  if (bytes > kDefaultShared) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_groups_kernel<kLocal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(Tp / tps, B);
  raster_groups_kernel<kLocal><<<grid, kThreads, bytes, stream>>>(
      (const int32_t*)counts, (const float*)recs, (int32_t*)p2f, (float*)zbuf,
      (float*)nx, (float*)ny, (float*)nz, Tp, C, tps, per_pass, H, W, TX);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int smirk_max_shared_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

int smirk_raster_fused_groups(const void* counts, const void* recs, void* p2f,
                              void* zbuf, void* nx, void* ny, void* nz, int B,
                              int Tp, int C, int tps, int per_pass, int local,
                              int H, int W, int TX, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tp == 0) return 0;
  if (tps < 1 || Tp % tps != 0 || C % kChunk != 0 || per_pass < 1)
    return (int)cudaErrorInvalidValue;
  if (per_pass > tps) per_pass = tps;
  err = local ? launch<true>(counts, recs, p2f, zbuf, nx, ny, nz, B, Tp, C, tps,
                             per_pass, H, W, TX, (cudaStream_t)stream)
              : launch<false>(counts, recs, p2f, zbuf, nx, ny, nz, B, Tp, C, tps,
                              per_pass, H, W, TX, (cudaStream_t)stream);
  return (int)err;
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
