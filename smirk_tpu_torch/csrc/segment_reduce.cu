// K7 segment_reduce_tiles: per-(tile, slot) sums of a per-pixel payload,
// the backward reduction of interpolate_attributes_fast.
//
// Replaces _segment_reduce_kernel (via segment_reduce_tiles) in
// smirk_tpu/render/rasterizer.py. On the TPU that is a one-hot matmul per
// slot chunk on the MXU, because the TPU has no scatter. Here a block owns
// one 8x128 tile of one image and one group of channels: the tile's
// C x (group width) accumulators live in dynamic shared memory; the threads
// walk the tile's 1024 x width (pixel, channel) elements with consecutive
// threads on consecutive channels of a pixel, so the payload reads
// coalesce, each thread loading 8 elements before it atomicAdds the
// nonzero ones into their slots' rows (with 74 KB per block only 3 blocks
// fit on an SM, so each warp needs several loads in flight); then the
// block stores the rows in one coalesced pass. Slots that won nothing stay
// 0. The padding pixels of the image's tile grid carry slot 0 with a zero
// payload; zero values are skipped, which changes no sum, and slots
// outside [0, C) are dropped.
//
// Shared memory: C x CHN x 4 bytes (74 KB at C=512, CHN=36) is past the
// 48 KB a block gets by default, so the launch opts in to the device's
// limit with cudaFuncSetAttribute (227 KB on H100). Where C x CHN x 4
// exceeds even that, the wrapper splits CHN into groups over blockIdx.z,
// each block reading only its channels. The float order of the atomics
// varies from run to run, so the result is compared with the plain version
// within a tolerance, not bitwise.
//
// Bound on H100: bytes. At batch 32, 224 px, C=512, CHN=36 it reads the
// tile-major payload (264 MB) and the slots (7.3 MB) and writes the
// per-slot rows (132 MB): ~0.12 ms at 3.35 TB/s. The design reads every
// input once and keeps the scatter in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTilePix = 1024;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // elements per thread per step
constexpr size_t kDefaultShared = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int32_t* __restrict__ slots,    // (B, Tp, 1024)
                      const float* __restrict__ payload,    // (B, Tp, 1024, CHN)
                      float* __restrict__ out,              // (B, Tp, C, CHN)
                      int Tp, int C, int CHN, int group) {
  extern __shared__ float acc[];  // C * width
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * group;
  const int width = min(group, CHN - ch0);
  const size_t tile = (size_t)b * Tp + t;
  const int n = C * width;
  for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int32_t* sl = slots + tile * kTilePix;
  const float* pl = payload + tile * kTilePix * CHN + ch0;
  const int total = kTilePix * width;
  for (int base = 0; base < total; base += kThreads * kUnroll) {
    // kUnroll loads in flight per thread before the atomics
    float v[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      v[u] = 0.0f;
      at[u] = -1;
      if (i < total) {
        const int p = i / width;
        const int ch = i - p * width;
        const int s = sl[p];
        v[u] = pl[(size_t)p * CHN + ch];
        if (s >= 0 && s < C) at[u] = s * width + ch;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (at[u] >= 0 && v[u] != 0.0f) atomicAdd(acc + at[u], v[u]);
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

// group: channels per block (the wrapper's split of CHN); the grid's z
// extent is ceil(CHN / group).
int smirk_segment_reduce_tiles(const void* slots, const void* payload,
                               void* out, int B, int Tp, int C, int CHN,
                               int group, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (group < 1 || group > CHN) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0 || C == 0) return 0;
  const size_t shared = (size_t)C * group * sizeof(float);
  if (shared > kDefaultShared) {
    err = cudaFuncSetAttribute(segment_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Tp, B, (CHN + group - 1) / group);
  segment_reduce_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const float*)payload, (float*)out, Tp, C, CHN,
      group);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
