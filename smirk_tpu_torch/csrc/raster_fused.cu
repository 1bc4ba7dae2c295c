// K1 raster_fused_windows: per-tile z-buffer over the first `kept` 32-face
// chunks of the tile's bin, plus the winner's three interpolated normal
// planes.
//
// Replaces _raster_kernel_v7 (compact per-image chunk list) and
// _raster_kernel_v4 (padded per-tile layout), both in
// smirk_tpu/render/rasterizer.py. On the TPU those evaluate a (32 faces x
// 1024 pixels) block per chunk with one-hot reductions over a record list
// that _compact_faces_kernel packs first, because a TPU kernel cannot
// gather. Here a block owns one 8x128 tile of one image, 256 threads x 4
// pixels, and walks chunks k = 0 .. kept - 1 of the tile's bin row; the
// compact and padded layouts differ only in kept:
//   * staging, with the packing and the record gather folded in: thread i
//     reads the id of face i / 8 of the chunk from the bins and loads the
//     16-byte quarter i % 8 of that face's 128-byte record from the
//     image's record table (28 MB at batch 64, held in L2) into shared
//     memory; an empty slot (-1) stages a record that is never inside.
//     The next chunk's record and the id after it are loaded before the
//     current chunk is tested, so their latency hides behind the tests;
//   * each thread tests the 32 faces in slot order and keeps a face only
//     if it is inside and strictly nearer (z < best): the same first-
//     minimum rule as the TPU kernels' chunk min + first slot + strict
//     chunk-to-chunk compare;
//   * the winner, k * 32 + slot in its tile's bin, is read through its id
//     at the end for its normal planes.
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn, and the pixel centres as ((2i + 1) - size) / size with
// __fdiv_rn, so nothing is contracted into an FMA and the results are
// bitwise equal to the plain PyTorch version on the card.
//
// Bound on H100: fp32 operations. Each face-pixel test is ~16 flops
// (4 affine forms) plus compares; at batch 64, 224 px, ~160 kept chunks
// per image that is ~5 GFLOP (~80 us at 67 TFLOP/s), against ~90 MB of
// records and outputs (~27 us at 3.35 TB/s). The design keeps the record
// traffic in shared memory and reuses each loaded record value for four
// pixels; reading the records through the bins costs a few percent over
// walking a packed list (48 registers against 40), far less than the
// packing and gather it replaces. It does not skip faces whose bounding
// box misses the thread's pixels (raster_planes.cu does).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces per chunk
constexpr int kLanes = 32;                        // floats per record
constexpr int kQuarters = kLanes / 4;             // float4 per record
constexpr int kThreads = 256;                     // = kChunk * kQuarters
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

// Quarter q of face id's record; an id outside [0, F) gives the kill
// record (edge constant c0 = -1 in lane 2, face id -1 in lane 12).
__device__ __forceinline__ float4 record_quarter(const float4* __restrict__ recs,
                                                 int id, int F, int q) {
  if (id >= 0 && id < F) return __ldg(recs + (size_t)id * kQuarters + q);
  return make_float4(q == 3 ? -1.0f : 0.0f, 0.0f, q == 0 ? -1.0f : 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
raster_fused_windows_kernel(const int32_t* __restrict__ kept,
                            const int32_t* __restrict__ bins,
                            const float* __restrict__ records,
                            int32_t* __restrict__ p2f,
                            float* __restrict__ zbuf,
                            float* __restrict__ nx,
                            float* __restrict__ ny,
                            float* __restrict__ nz,
                            int Tp, int C, int F, int H, int W, int TX) {
  __shared__ float4 s_chunk[kChunk * kQuarters];  // 256 float4 = 4 KB
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = min(kept[tile], C / kChunk);
  const int ty = t / TX;
  const int tx = t % TX;
  const int32_t* row = bins + (size_t)tile * C;
  const float* img = records + (size_t)b * F * kLanes;
  const float4* img4 = reinterpret_cast<const float4*>(img);

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

  const int face = threadIdx.x / kQuarters;
  const int q = threadIdx.x % kQuarters;
  float4 staged = record_quarter(img4, n > 0 ? row[face] : -1, F, q);
  int id_next = n > 1 ? row[kChunk + face] : -1;
  const float* s = reinterpret_cast<const float*>(s_chunk);
  for (int c = 0; c < n; ++c) {
    __syncthreads();  // the previous chunk has been read by every thread
    s_chunk[threadIdx.x] = staged;
    __syncthreads();
    if (c + 1 < n) {  // the next chunk's loads fly during this chunk's tests
      staged = record_quarter(img4, id_next, F, q);
      id_next = c + 2 < n ? row[(c + 2) * kChunk + face] : -1;
    }
#pragma unroll 2
    for (int f = 0; f < kChunk; ++f) {
      const float* r = s + f * kLanes;
      const float a0 = r[0], b0 = r[1], d0 = r[2];
      const float a1 = r[3], b1 = r[4], d1 = r[5];
      const float a2 = r[6], b2 = r[7], d2 = r[8];
      const float za = r[9], zb = r[10], zc = r[11];
      const bool real = r[12] >= 0.0f;
      const int id = c * kChunk + f;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float e0 = affine(a0, b0, d0, xs[k], ys[k]);
        const float e1 = affine(a1, b1, d1, xs[k], ys[k]);
        const float e2 = affine(a2, b2, d2, xs[k], ys[k]);
        const float z = affine(za, zb, zc, xs[k], ys[k]);
        if (real && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z < best[k]) {
          best[k] = z;
          win[k] = id;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const size_t o = (size_t)tile * kTilePix + threadIdx.x + k * kThreads;
    if (best[k] < kBigZ) {
      const float* r = img + (size_t)row[win[k]] * kLanes;
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

int smirk_raster_fused_windows(const void* kept, const void* bins,
                               const void* records, void* p2f, void* zbuf,
                               void* nx, void* ny, void* nz, int B, int Tp,
                               int C, int F, int H, int W, int TX, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % kChunk) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  raster_fused_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)kept, (const int32_t*)bins, (const float*)records,
      (int32_t*)p2f, (float*)zbuf, (float*)nx, (float*)ny, (float*)nz, Tp, C,
      F, H, W, TX);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
