// K1 raster_fused_windows: per-tile z-buffer over a window of 32-face
// chunks, plus the winner's three interpolated normal planes.
//
// Replaces _raster_kernel_v7 (compact per-image chunk list) and, fed the
// padded per-tile layout, _raster_kernel_v4, both in
// smirk_tpu/render/rasterizer.py. On the TPU those evaluate a (32 faces x
// 1024 pixels) block per chunk with one-hot reductions; here a block owns
// one 8x128 tile of one image, 256 threads x 4 pixels, and walks the
// tile's chunk window [starts, ends):
//   * the chunk's 32 records (32 floats each, 4 KB) are staged in shared
//     memory with one float4 load per thread, then read as broadcasts;
//   * each thread tests the 32 faces in slot order and keeps a face only
//     if it is inside and strictly nearer (z < best): the same first-
//     minimum rule as the TPU kernels' chunk min + first slot + strict
//     chunk-to-chunk compare;
//   * the winner's normal planes are evaluated once, at the end.
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn, and the pixel centres as ((2i + 1) - size) / size with
// __fdiv_rn, so nothing is contracted into an FMA and the results are
// bitwise equal to the plain PyTorch version on the card.
//
// Bound on H100: fp32 operations. Each face-pixel test is ~16 flops
// (4 affine forms) plus compares; at batch 64, 224 px, ~150 occupied
// chunks per image that is ~5 GFLOP (~75 us at 67 TFLOP/s), against
// ~120 MB of records and outputs (~36 us at 3.35 TB/s). The design keeps
// the record traffic in shared memory and reuses each loaded record value
// for four pixels; it does not yet skip faces whose bounding box misses
// the thread's pixels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces per chunk
constexpr int kLanes = 32;                        // floats per record
constexpr int kThreads = 256;
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
raster_fused_windows_kernel(const int32_t* __restrict__ starts,
                            const int32_t* __restrict__ ends,
                            const float* __restrict__ recs,
                            int32_t* __restrict__ p2f,
                            float* __restrict__ zbuf,
                            float* __restrict__ nx,
                            float* __restrict__ ny,
                            float* __restrict__ nz,
                            int Tp, int n_chunks, int H, int W, int TX) {
  __shared__ float4 s_chunk[kChunk * kLanes / 4];  // 256 float4 = 4 KB
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int c0 = starts[tile];
  const int c1 = ends[tile];
  const int ty = t / TX;
  const int tx = t % TX;
  const float* img_recs = recs + (size_t)b * n_chunks * kChunk * kLanes;

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

  const float* s = reinterpret_cast<const float*>(s_chunk);
  for (int c = c0; c < c1; ++c) {
    __syncthreads();  // the previous chunk has been read by every thread
    s_chunk[threadIdx.x] = reinterpret_cast<const float4*>(
        img_recs + (size_t)c * kChunk * kLanes)[threadIdx.x];
    __syncthreads();
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

int smirk_raster_fused_windows(const void* starts, const void* ends,
                               const void* recs, void* p2f, void* zbuf,
                               void* nx, void* ny, void* nz, int B, int Tp,
                               int n_chunks, int H, int W, int TX, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  raster_fused_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)ends, (const float*)recs,
      (int32_t*)p2f, (float*)zbuf, (float*)nx, (float*)ny, (float*)nz, Tp,
      n_chunks, H, W, TX);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
