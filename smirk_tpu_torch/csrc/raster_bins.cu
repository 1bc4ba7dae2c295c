// K8 raster_bins_coverage: per-tile z-buffer over the tile's bin, one face
// at a time, with division barycentrics.
//
// Replaces _raster_kernel (via rasterize_coverage_pallas) in
// smirk_tpu/render/rasterizer.py. On the TPU that walks exactly `count`
// faces of the tile's bin in bin order, fetching each face's vertices with
// one-hot lane reductions. Here a block owns one 8x128 tile of one image,
// 256 threads x 4 pixels, and walks the same `count` faces:
//   * 32 bin entries at a time, the first 32 threads load one face's nine
//     vertex coordinates each and stage them in shared memory with the
//     face's doubled signed area and its degenerate flag;
//   * each thread tests the staged faces in bin order with the TPU kernel's
//     arithmetic: cross-product edge terms e_i, w_i = e_i / area (IEEE,
//     __fdiv_rn), z = w0*z0 + w1*z1 + w2*z2, and keeps a face only if it is
//     inside (all w_i >= 0, area not degenerate) and strictly nearer
//     (z < best), so the first minimum in bin order wins;
//   * p2f and z go straight to the (B, Hp, Wp) image; the caller crops.
// Every operation is an __f*_rn intrinsic, so nothing is contracted into
// an FMA and the outputs are bitwise equal to the plain PyTorch version on
// the card.
//
// Bound on H100: fp32 operations. Each face-pixel test is 21 operations
// for the three edge terms, 3 divisions and 5 for the depth, ~29 in all,
// over count x 1024 face-pixel pairs per tile. The design stages each
// face once per block and reuses it for all 1024 pixels; it does not skip
// faces whose bounding box misses the thread's pixels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces staged at a time
constexpr int kFaceLanes = 12;  // x0 y0 z0 x1 y1 z1 x2 y2 z2 safe real pad
constexpr int kThreads = 256;
constexpr int kPixPerThread = kTilePix / kThreads;  // 4
constexpr float kAreaEps = 1e-10f;
constexpr float kBigZ = 1e10f;

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

// (xj - x) * (yk - y) - (yj - y) * (xk - x)
__device__ __forceinline__ float edge(float xj, float yj, float xk, float yk,
                                      float x, float y) {
  return __fsub_rn(__fmul_rn(__fsub_rn(xj, x), __fsub_rn(yk, y)),
                   __fmul_rn(__fsub_rn(yj, y), __fsub_rn(xk, x)));
}

__global__ void __launch_bounds__(kThreads)
raster_bins_kernel(const int32_t* __restrict__ counts,  // (B, Tp)
                   const int32_t* __restrict__ bins,    // (B, Tp, C)
                   const float* __restrict__ fv,        // (B, F, 9)
                   int32_t* __restrict__ p2f,           // (B, Hp, Wp)
                   float* __restrict__ zbuf,            // (B, Hp, Wp)
                   int Tp, int C, int F, int H, int W, int TX) {
  __shared__ float s_face[kChunk * kFaceLanes];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = counts[tile];
  const int ty = t / TX;
  const int tx = t % TX;
  const int* bin = bins + (size_t)tile * C;
  const float* img_fv = fv + (size_t)b * F * 9;

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

  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int m = min(kChunk, n - i0);
    __syncthreads();  // the previous faces have been read by every thread
    if (threadIdx.x < m) {
      const int fid = max(bin[i0 + threadIdx.x], 0);
      const float* v = img_fv + (size_t)fid * 9;
      float* s = s_face + threadIdx.x * kFaceLanes;
      const float x0 = v[0], y0 = v[1], x1 = v[3], y1 = v[4], x2 = v[6],
                  y2 = v[7];
#pragma unroll
      for (int j = 0; j < 9; ++j) s[j] = v[j];
      // (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
      const float denom = edge(x1, y1, x2, y2, x0, y0);
      const bool real = fabsf(denom) >= kAreaEps;
      s[9] = real ? denom : 1.0f;
      s[10] = real ? 1.0f : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < m; ++f) {
      const float* s = s_face + f * kFaceLanes;
      if (s[10] == 0.0f) continue;  // degenerate: never inside
      const float x0 = s[0], y0 = s[1], z0 = s[2];
      const float x1 = s[3], y1 = s[4], z1 = s[5];
      const float x2 = s[6], y2 = s[7], z2 = s[8];
      const float safe = s[9];
      const int id = bin[i0 + f];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float w0 = __fdiv_rn(edge(x1, y1, x2, y2, xs[k], ys[k]), safe);
        const float w1 = __fdiv_rn(edge(x2, y2, x0, y0, xs[k], ys[k]), safe);
        const float w2 = __fdiv_rn(edge(x0, y0, x1, y1, xs[k], ys[k]), safe);
        const float z = __fadd_rn(
            __fadd_rn(__fmul_rn(w0, z0), __fmul_rn(w1, z1)), __fmul_rn(w2, z2));
        if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && z < best[k]) {
          best[k] = z;
          win[k] = id;
        }
      }
    }
  }

  const int Wp = TX * kTileCols;
  const int Hp = (gridDim.x / TX) * kTileRows;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const size_t o = ((size_t)b * Hp + ty * kTileRows + p / kTileCols) * Wp +
                     tx * kTileCols + p % kTileCols;
    p2f[o] = win[k];
    zbuf[o] = best[k];
  }
}

}  // namespace

extern "C" {

// The grid covers the T = (Hp / 8) * TX real tiles of each image; bins
// and counts have Tp >= T tile rows (the rest are padding).
int smirk_raster_bins_coverage(const void* counts, const void* bins,
                               const void* fv, void* p2f, void* zbuf, int B,
                               int Tp, int T, int C, int F, int H, int W,
                               int TX, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T > Tp || T % TX) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  dim3 grid(T, B);
  raster_bins_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const int32_t*)bins, (const float*)fv,
      (int32_t*)p2f, (float*)zbuf, Tp, C, F, H, W, TX);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
