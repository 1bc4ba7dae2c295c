// K3 raster_planes_windows: the differentiable raster's forward. Per-tile
// z-buffer over a window of 32-face chunks, the winner's per-tile slot and
// its D interpolated attribute planes.
//
// Replaces _raster_kernel_v5c (compact per-image chunk list) and, fed the
// padded per-tile layout, _raster_kernel_v5, both in
// smirk_tpu/render/rasterizer.py. It is K1 (raster_fused.cu) with the
// training record layout: lanes 0-11 edge and depth planes, lane 12 the
// face id, lanes 13.. the attribute planes [PA(D) | PB(D) | PC(D)], D <= 6.
// A block owns one 8x128 tile of one image, 256 threads x 4 pixels, and
// walks the tile's chunk window [starts, ends):
//   * the chunk's 32 records (4 KB) are staged in shared memory with one
//     float4 load per thread and read as broadcasts;
//   * each thread tests the 32 faces in slot order and keeps a face only if
//     it is inside and strictly nearer: the TPU kernels' chunk minimum,
//     first slot on ties, and strict chunk-to-chunk compare;
//   * at the end the winner's slot is written per TILE, (c - start) * 32 +
//     slot, which indexes the tile's bin row for the backward's fold, and
//     its D planes are evaluated once.
// Every affine form is ((a*x) + (b*y)) + c with __fmul_rn / __fadd_rn and
// the pixel centres use __fdiv_rn, so nothing is contracted into an FMA and
// the outputs are bitwise equal to the plain PyTorch version on the card.
//
// Bound on H100: fp32 operations, ~16 per face-pixel test (4 affine forms)
// over the occupied chunk windows; at batch 32, 224 px, ~161 occupied
// chunks per image that is ~2.7 GFLOP, 0.04 ms at 67 TFLOP/s (0.08 ms at
// the rate without FMAs that bitwise equality forces), against ~72 MB of
// records and outputs (~0.021 ms at 3.35 TB/s). The design keeps record
// traffic in shared memory and reuses each loaded record value for four
// pixels; it does not skip faces whose bounding box misses the pixels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces per chunk
constexpr int kLanes = 32;                        // floats per record
constexpr int kPlane0 = 13;                       // first attribute-plane lane
constexpr int kMaxD = 6;
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
raster_planes_windows_kernel(const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ ends,
                             const float* __restrict__ recs,
                             int32_t* __restrict__ p2f,
                             float* __restrict__ zbuf,
                             int32_t* __restrict__ slot,
                             float* __restrict__ vals,  // (D, B, Tp, 1024)
                             int B, int Tp, int n_chunks, int H, int W,
                             int TX, int D) {
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

  const size_t plane = (size_t)B * Tp * kTilePix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const size_t o = (size_t)tile * kTilePix + threadIdx.x + k * kThreads;
    if (best[k] < kBigZ) {
      const float* r = img_recs + (size_t)win[k] * kLanes;
      p2f[o] = (int32_t)r[12];
      zbuf[o] = best[k];
      slot[o] = win[k] - c0 * kChunk;
      for (int d = 0; d < D; ++d) {
        vals[d * plane + o] = affine(r[kPlane0 + d], r[kPlane0 + D + d],
                                     r[kPlane0 + 2 * D + d], xs[k], ys[k]);
      }
    } else {
      p2f[o] = -1;
      zbuf[o] = kBigZ;
      slot[o] = -1;
      for (int d = 0; d < D; ++d) vals[d * plane + o] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

int smirk_raster_planes_windows(const void* starts, const void* ends,
                                const void* recs, void* p2f, void* zbuf,
                                void* slot, void* vals, int B, int Tp,
                                int n_chunks, int H, int W, int TX, int D,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  raster_planes_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)ends, (const float*)recs,
      (int32_t*)p2f, (float*)zbuf, (int32_t*)slot, (float*)vals, B, Tp,
      n_chunks, H, W, TX, D);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
