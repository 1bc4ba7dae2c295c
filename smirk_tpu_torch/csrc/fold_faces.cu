// K5 fold_slots_to_faces: fold per-(tile, slot) sums into per-face totals.
//
// Replaces _fold_kernel (via _fold_matmul / fold_slots_to_faces) in
// smirk_tpu/render/rasterizer.py. On the TPU that accumulates one-hot
// matmuls over 512-face chunks into one output block per image, because
// the TPU has no scatter. Here one thread owns one (image, tile, slot,
// channel) element and, when the slot holds a face (id >= 0, the TPU
// kernel's row F takes the rest) and the value is not 0, atomicAdds it into
// out[image, id, channel]. The wrapper zeroes `out` first. A face appears
// at most once per tile, so a face's atomics come from different tiles and
// rarely collide. The float order of the atomics varies from run to run,
// so the result is compared with the plain version within a tolerance.
//
// Bound on H100: bytes. At batch 32, 224 px, C=384, 9 channels it reads the
// per-slot rows (24.8 MB) and the bins (2.8 MB) and writes the per-face
// rows (3.9 MB): ~31 MB, ~9.4 us at 3.35 TB/s. Consecutive threads read
// consecutive elements, so the reads coalesce; the writes are atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fold_faces_kernel(const float* __restrict__ per_slot,  // (B, Tp*C, CHN)
                  const int32_t* __restrict__ bins,    // (B, Tp*C)
                  float* __restrict__ out,             // (B, F, CHN)
                  size_t n, int rows_per_image, int CHN, int F) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const size_t r = i / CHN;
    const int id = bins[r];
    if (id < 0 || id >= F) continue;
    const float v = per_slot[i];
    if (v == 0.0f) continue;
    const size_t b = r / rows_per_image;
    atomicAdd(out + (b * F + id) * CHN + (i % CHN), v);
  }
}

}  // namespace

extern "C" {

int smirk_fold_faces(const void* per_slot, const void* bins, void* out, int B,
                     int rows_per_image, int CHN, int F, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * rows_per_image * CHN;
  if (n == 0) return 0;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535u * 16u) blocks = 65535u * 16u;
  fold_faces_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)per_slot, (const int32_t*)bins, (float*)out, n,
      rows_per_image, CHN, F);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
