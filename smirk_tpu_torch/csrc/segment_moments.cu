// K4 segment_moments: the differentiable raster's backward reduction. For
// each (tile, slot), the sums [sum g*x | sum g*y | sum g] over the pixels
// that slot won, with x, y the pixel centres in NDC built in the kernel.
//
// Replaces _segment_moments_kernel (via segment_reduce_moments) in
// smirk_tpu/render/rasterizer.py. On the TPU that is a one-hot matmul per
// 128-slot chunk on the MXU, because the TPU has no scatter. Here a block
// owns one 8x128 tile of one image and one group of the 3D output
// channels: the tile's C x (group width) accumulators live in dynamic
// shared memory (13.8 KB at C=384, D=3), the threads walk the tile's 1024
// pixels and atomicAdd each pixel's nonzero moments of the group into its
// slot's row, then the block stores the rows in one coalesced pass. Slots
// that won nothing stay 0. Pixels of the padding band may hold live slots;
// their g is 0 and they are skipped.
//
// Shared memory past the default 48 KB (C x 3D x 4 bytes, e.g. 55 KB at
// C=768, D=6) is opted into with cudaFuncSetAttribute up to the device's
// limit (227 KB on H100); past that the wrapper splits the 3D channels
// into groups over blockIdx.z. The float order of the atomics varies from
// run to run, so the result is compared with the plain version within a
// tolerance.
//
// Bound on H100: bytes. At batch 32, 224 px, C=384, D=3 it reads the slots
// (7.3 MB) and the tile-major cotangent (22.0 MB) and writes the per-slot
// rows (24.8 MB): ~54 MB, ~16 us at 3.35 TB/s. The design reads every
// input once and keeps the scatter in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kThreads = 256;
constexpr size_t kDefaultShared = 48 * 1024;

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

__global__ void __launch_bounds__(kThreads)
segment_moments_kernel(const int32_t* __restrict__ slots,
                       const float* __restrict__ g,  // (B, Tp, 1024, D)
                       float* __restrict__ out,      // (B, Tp, C, 3D)
                       int Tp, int C, int D, int group, int H, int W,
                       int TX) {
  extern __shared__ float acc[];  // C * width
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int CHN = 3 * D;
  const int ch0 = blockIdx.z * group;
  const int width = min(group, CHN - ch0);
  const size_t tile = (size_t)b * Tp + t;
  const int n = C * width;
  for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int ty = t / TX;
  const int tx = t % TX;
  const int ch1 = ch0 + width;
  for (int p = threadIdx.x; p < kTilePix; p += kThreads) {
    const int s = slots[tile * kTilePix + p];
    if (s < 0 || s >= C) continue;
    const float x = ndc(p % kTileCols + tx * kTileCols, W);
    const float y = ndc(p / kTileCols + ty * kTileRows, H);
    const float* gp = g + (tile * kTilePix + p) * D;
    float* row = acc + s * width;
    for (int d = 0; d < D; ++d) {
      const float gv = gp[d];
      if (gv == 0.0f) continue;
      // output channels d, D + d, 2D + d: [g*x | g*y | g]
      if (d >= ch0 && d < ch1) atomicAdd(row + d - ch0, __fmul_rn(gv, x));
      if (D + d >= ch0 && D + d < ch1) atomicAdd(row + D + d - ch0, __fmul_rn(gv, y));
      if (2 * D + d >= ch0 && 2 * D + d < ch1) atomicAdd(row + 2 * D + d - ch0, gv);
    }
  }
  __syncthreads();
  float* o = out + tile * C * CHN + ch0;
  if (width == CHN) {
    for (int i = threadIdx.x; i < n; i += kThreads) o[i] = acc[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int s = i / width;
      o[(size_t)s * CHN + (i - s * width)] = acc[i];
    }
  }
}

}  // namespace

extern "C" {

int smirk_max_shared_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// group: output channels per block (the wrapper's split of 3D); the grid's
// z extent is ceil(3D / group).
int smirk_segment_moments(const void* slots, const void* g, void* out, int B,
                          int Tp, int C, int D, int group, int H, int W,
                          int TX, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || group < 1 || group > 3 * D) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0 || C == 0) return 0;
  const size_t shared = (size_t)C * group * sizeof(float);
  if (shared > kDefaultShared) {
    err = cudaFuncSetAttribute(segment_moments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Tp, B, (3 * D + group - 1) / group);
  segment_moments_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const float*)g, (float*)out, Tp, C, D, group, H,
      W, TX);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
