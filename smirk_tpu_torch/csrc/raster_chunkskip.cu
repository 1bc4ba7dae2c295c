// K11 raster_chunkskip: per-tile z-buffer over a list of CH-face chunk ids
// into the image's full record table, plus the winner's three
// interpolated normal planes.
//
// Replaces _raster_kernel_v8 (via rasterize_normals_chunkskip) in
// smirk_tpu/render/rasterizer.py. There the binning selects chunks of a
// spatially ordered face list instead of faces, and each tile fetches its
// chunks from the full per-image record table held in VMEM: no record
// gather, no compact plan, no chunk compaction. Here a block owns one 8x128
// tile of one image, 256 threads x 4 pixels, as K1:
//   * the block walks clist[b, t, :counts[b, t]] in list order (near-to-far
//     chunk priority); chunk cid is the CH consecutive records at row
//     cid*CH of the image's table (B, F, 32), CH one of 4, 8, 16, 32;
//   * one step stages up to 32 faces, 32/CH consecutive list entries, in
//     shared memory (4 KB, one float4 load per thread), so an 8-face chunk
//     does not cost a barrier of its own;
//   * each thread tests the staged faces in list-then-slot order and keeps
//     a face only if it is inside, real (id lane >= 0: the off-screen
//     padding faces carry -1) and strictly nearer: the TPU kernel's rule,
//     near chunk first and first slot within a chunk;
//   * the winner's id lane (the original face id where the caller gave
//     one) and normal planes are read once, at the end.
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn and the pixel centres with __fdiv_rn, as in K1, so the results
// are bitwise equal to the plain PyTorch version on the card.
//
// Bound on H100: fp32 operations, ~16 per face-pixel test over the faces
// that the function needs, K1's windows, since it computes K1's z-buffer.
// The schedule walks more: sum(counts) x CH x 1024 pairs, every face of a
// binned chunk, even where only one member overlaps the tile. The table is
// 3408 x 128 B = 436 KB per image, 27.9 MB at batch 64, under the 50 MB
// L2: the kernel relies on that for speed (each image's table is read by
// its ~56 tiles, and after the first touch those reads hit L2), not for
// correctness.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kStage = 32;                        // faces staged per step
constexpr int kLanes = 32;                        // floats per record
constexpr int kRecF4 = kLanes / 4;                // float4 per record: 8
constexpr int kThreads = 256;                     // = kStage * kRecF4
constexpr int kPixPerThread = kTilePix / kThreads;  // 4
constexpr float kBigZ = 1e10f;

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

__global__ void __launch_bounds__(kThreads)
raster_chunkskip_kernel(const int32_t* __restrict__ counts,  // (B, Tp)
                        const int32_t* __restrict__ clist,   // (B, Tp, cap)
                        const float* __restrict__ recs,      // (B, F, 32)
                        int32_t* __restrict__ p2f, float* __restrict__ zbuf,
                        float* __restrict__ nx, float* __restrict__ ny,
                        float* __restrict__ nz, int Tp, int cap, int F, int CH,
                        int H, int W, int TX) {
  __shared__ float4 s_rec[kStage * kRecF4];  // 32 records, 4 KB
  __shared__ int s_row[kStage];              // table row of each staged face
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = counts[tile];
  const int32_t* list = clist + (size_t)tile * cap;
  const int ty = t / TX;
  const int tx = t % TX;
  const float* img_recs = recs + (size_t)b * F * kLanes;
  const float4* img_f4 = reinterpret_cast<const float4*>(img_recs);
  const int per_step = kStage / CH;  // chunks per step

  float xs[kPixPerThread], ys[kPixPerThread], best[kPixPerThread];
  int win[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    xs[k] = ndc(p % kTileCols + tx * kTileCols, W);
    ys[k] = ndc(p / kTileCols + ty * kTileRows, H);
    best[k] = kBigZ;
    win[k] = -1;
  }

  const float* s = reinterpret_cast<const float*>(s_rec);
  for (int c0 = 0; c0 < n; c0 += per_step) {
    const int n_faces = min(per_step, n - c0) * CH;
    __syncthreads();  // the previous step's records have been read
    {
      const int f = threadIdx.x / kRecF4;  // staged face of this thread's float4
      if (f < n_faces) {
        const int row = list[c0 + f / CH] * CH + f % CH;
        s_rec[threadIdx.x] = img_f4[(size_t)row * kRecF4 + threadIdx.x % kRecF4];
        if (threadIdx.x % kRecF4 == 0) s_row[f] = row;
      }
    }
    __syncthreads();
    for (int f = 0; f < n_faces; ++f) {
      const float* r = s + f * kLanes;
      const float a0 = r[0], b0 = r[1], d0 = r[2];
      const float a1 = r[3], b1 = r[4], d1 = r[5];
      const float a2 = r[6], b2 = r[7], d2 = r[8];
      const float za = r[9], zb = r[10], zc = r[11];
      const bool real = r[12] >= 0.0f;
      const int row = s_row[f];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float e0 = affine(a0, b0, d0, xs[k], ys[k]);
        const float e1 = affine(a1, b1, d1, xs[k], ys[k]);
        const float e2 = affine(a2, b2, d2, xs[k], ys[k]);
        const float z = affine(za, zb, zc, xs[k], ys[k]);
        if (real && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z < best[k]) {
          best[k] = z;
          win[k] = row;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const size_t o = (size_t)tile * kTilePix + threadIdx.x + k * kThreads;
    if (best[k] < kBigZ) {
      const float* r = img_recs + (size_t)win[k] * kLanes;
      p2f[o] = (int32_t)r[12];
      zbuf[o] = best[k];
      nx[o] = affine(r[16], r[19], r[22], xs[k], ys[k]);
      ny[o] = affine(r[17], r[20], r[23], xs[k], ys[k]);
      nz[o] = affine(r[18], r[21], r[24], xs[k], ys[k]);
    } else {
      p2f[o] = -1;
      zbuf[o] = kBigZ;
      nx[o] = 0.0f;
      ny[o] = 0.0f;
      nz[o] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

int smirk_raster_chunkskip(const void* counts, const void* clist, const void* recs,
                           void* p2f, void* zbuf, void* nx, void* ny, void* nz,
                           int B, int Tp, int cap, int F, int CH, int H, int W,
                           int TX, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tp == 0) return 0;
  if ((CH != 4 && CH != 8 && CH != 16 && CH != 32) || F % CH != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Tp, B);
  raster_chunkskip_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const int32_t*)clist, (const float*)recs,
      (int32_t*)p2f, (float*)zbuf, (float*)nx, (float*)ny, (float*)nz, Tp, cap,
      F, CH, H, W, TX);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
