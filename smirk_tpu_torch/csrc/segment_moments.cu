// K4 segment_moments: the differentiable raster's backward reduction. For
// each (tile, slot), the sums [sum g*x | sum g*y | sum g] over the pixels
// that slot won, with x, y the pixel centres in NDC built in the kernel.
//
// Replaces _segment_moments_kernel (via segment_reduce_moments) in
// smirk_tpu/render/rasterizer.py. On the TPU that is a one-hot matmul per
// 128-slot chunk on the MXU, because the TPU has no scatter. Here a block
// owns one 8x128 tile of one image: the tile's C x 3D accumulators live in
// shared memory (13.8 KB at C=384, D=3), the threads walk the tile's 1024
// pixels and atomicAdd each pixel's 3D moments into its slot's row, then
// the block stores the rows in one coalesced pass. Slots that won nothing
// stay 0. Pixels of the padding band may hold live slots; their g is 0 and
// they are skipped. The float order of the atomics varies from run to run,
// so the result is compared with the plain version within a tolerance.
//
// Bound on H100: bytes. At batch 32, 224 px, C=384, D=3 it reads the slots
// (7.3 MB) and the tile-major cotangent (22.0 MB) and writes the per-slot
// rows (24.8 MB): ~54 MB, ~16 us at 3.35 TB/s. The design reads every
// input once, coalesced, and keeps the scatter in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 48 * 1024;

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

__global__ void __launch_bounds__(kThreads)
segment_moments_kernel(const int32_t* __restrict__ slots,
                       const float* __restrict__ g,  // (B, Tp, 1024, D)
                       float* __restrict__ out,      // (B, Tp, C, 3D)
                       int Tp, int C, int D, int H, int W, int TX) {
  extern __shared__ float acc[];  // C * 3D
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const size_t tile = (size_t)b * Tp + t;
  const int n = C * 3 * D;
  for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int ty = t / TX;
  const int tx = t % TX;
  for (int p = threadIdx.x; p < kTilePix; p += kThreads) {
    const int s = slots[tile * kTilePix + p];
    if (s < 0 || s >= C) continue;
    const float x = ndc(p % kTileCols + tx * kTileCols, W);
    const float y = ndc(p / kTileCols + ty * kTileRows, H);
    const float* gp = g + (tile * kTilePix + p) * D;
    float* row = acc + s * 3 * D;
    for (int d = 0; d < D; ++d) {
      const float gv = gp[d];
      if (gv == 0.0f) continue;
      atomicAdd(row + d, __fmul_rn(gv, x));
      atomicAdd(row + D + d, __fmul_rn(gv, y));
      atomicAdd(row + 2 * D + d, gv);
    }
  }
  __syncthreads();
  float* o = out + tile * n;
  for (int i = threadIdx.x; i < n; i += kThreads) o[i] = acc[i];
}

}  // namespace

extern "C" {

int smirk_segment_moments(const void* slots, const void* g, void* out, int B,
                          int Tp, int C, int D, int H, int W, int TX,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shared = (size_t)C * 3 * D * sizeof(float);
  if (shared > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  segment_moments_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const float*)g, (float*)out, Tp, C, D, H, W, TX);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
