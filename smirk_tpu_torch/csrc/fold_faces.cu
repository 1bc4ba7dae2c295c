// K5 fold_slots_to_faces: fold per-(tile, slot) sums into per-face totals.
//
// Replaces _fold_kernel (via _fold_matmul / fold_slots_to_faces) in
// smirk_tpu/render/rasterizer.py. On the TPU that accumulates one-hot
// matmuls over 512-face chunks into one output block per image, because
// the TPU has no scatter. Its one served launch here is the op path's
// backward, after K7 (C=512, 36 channels; the training backward folds in
// K4's epilogue instead).
//
// Design: one warp per run of 32 slot rows of one image (the grid's y is
// the image, so every index within an image is 32-bit and nothing is
// divided by the rows of an image). The warp reads the run's 32 bin ids in
// one coalesced 128-byte load and takes a ballot of those in [0, F) (the
// TPU kernel's row F takes the rest); only those rows are read: a shared
// list of them, then the lanes read the listed rows' pieces together,
// float4 pieces where the channels are a multiple of 4 and the rows
// 16-byte aligned (4-byte pieces otherwise), two in flight a lane, and add
// each nonzero piece into the zeroed face table out[image, id, :] with
// atomics whose result is unused (fire-and-forget reductions). The rows of
// slots that hold no face are never read, so whatever they hold (NaN) does
// not reach the output. A face appears at most once per tile, so a face's
// atomics come from different tiles and rarely collide. The float order of
// the atomics varies from run to run, so the result is compared with the
// plain version within a tolerance.
//
// Bound on H100: bytes, counted on the rows the contract needs. At batch
// 32, 224 px, C=512, 36 channels: the rows of slots that hold a face
// (~16 % of 132 MB, ~21 MB), the bins (3.7 MB) and the face table
// (15.7 MB): ~40 MB, ~12 us at 3.35 TB/s (reading every row: ~45 us).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 2;  // pieces a lane loads before it adds them

template <int kVec>
struct Piece;

template <>
struct Piece<1> {
  using T = float;
  static __device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
  static __device__ __forceinline__ void add(float* dst, float v) { atomicAdd(dst, v); }
};

template <>
struct Piece<4> {
  using T = float4;
  static __device__ __forceinline__ bool nonzero(float4 v) {
    return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
  }
  static __device__ __forceinline__ void add(float* dst, float4 v) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);  // sm_90: one vector reduction
  }
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
fold_faces_kernel(const float* __restrict__ per_slot,  // (B, rows, CHN)
                  const int32_t* __restrict__ bins,    // (B, rows)
                  float* __restrict__ out,             // (B, F, CHN)
                  int rows, int CHN, int F) {
  using P = Piece<kVec>;
  __shared__ int list_row[kWarps][32];
  __shared__ int list_id[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= rows) return;  // warp-uniform
  const int b = blockIdx.y;
  const int r = r0 + lane;
  const int id = r < rows ? bins[(size_t)b * rows + r] : -1;
  const bool keep = id >= 0 && id < F;
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (kept == 0) return;
  if (keep) {
    const int k = __popc(kept & ((1u << lane) - 1u));
    list_row[warp][k] = r;
    list_id[warp][k] = id;
  }
  __syncwarp();
  const int pieces = CHN / kVec;  // a row's
  const int m = __popc(kept) * pieces;
  const float* src = per_slot + (size_t)b * rows * CHN;
  float* dst = out + (size_t)b * F * CHN;
  for (int e0 = lane; e0 < m; e0 += 32 * kSteps) {
    typename P::T v[kSteps];
    int to[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int e = e0 + 32 * u;
      to[u] = -1;
      if (e < m) {
        const int k = e / pieces;
        const int at = (e - k * pieces) * kVec;
        v[u] = *reinterpret_cast<const typename P::T*>(src + list_row[warp][k] * CHN + at);
        to[u] = list_id[warp][k] * CHN + at;
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (to[u] >= 0 && P::nonzero(v[u])) P::add(dst + to[u], v[u]);
  }
}

}  // namespace

extern "C" {

// vec: 1 for float4 pieces (CHN % 4 == 0 and per_slot 16-byte aligned; the
// wrapper's choice), 0 for 4-byte pieces. rows = Tp * C, the slot rows of
// one image; rows * CHN and F * CHN below 2^31.
int smirk_fold_faces(const void* per_slot, const void* bins, void* out, int B,
                     int rows, int CHN, int F, int vec, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (vec && CHN % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || rows == 0 || CHN == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((rows + kThreads - 1) / kThreads, B);
  if (vec)
    fold_faces_kernel<4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)per_slot, (const int32_t*)bins, (float*)out, rows, CHN, F);
  else
    fold_faces_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)per_slot, (const int32_t*)bins, (float*)out, rows, CHN, F);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
