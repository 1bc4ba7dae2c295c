// K2 compact_faces: pack each image's occupied 32-face chunks into one list.
//
// Replaces _compact_faces_kernel in smirk_tpu/render/rasterizer.py (a
// per-image fori_loop of dynamic row copies on the TPU). Here every block
// owns one image and its threads walk the output rows in order: thread i
// writes id (i % 32) of row (i / 32), so neighbouring threads read and
// write neighbouring addresses. Rows c < total[b] copy chunk
// k = c - starts[b, tof[b, c]] of tile t = tof[b, c], i.e. bins row
// t * cpt + k; rows past total are -1.
//
// Bound on H100: bytes. At batch 64, 224 px it moves ~1-2 MB (the occupied
// rows plus the output), well under a microsecond of HBM time, so the
// launch itself dominates; nothing further is done about it here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compact_faces_kernel(const int32_t* __restrict__ tof,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ total,
                     const int32_t* __restrict__ bins,
                     int32_t* __restrict__ out,
                     int Tp, int cpt, int cmax) {
  const int b = blockIdx.x;
  const int n = total[b];
  const int32_t* img_bins = bins + (size_t)b * Tp * cpt * kChunk;
  int32_t* img_out = out + (size_t)b * cmax * kChunk;
  for (int i = threadIdx.x; i < cmax * kChunk; i += kThreads) {
    const int c = i / kChunk;
    int32_t v = -1;
    if (c < n) {
      const int t = tof[b * cmax + c];
      const int k = c - starts[b * Tp + t];
      v = img_bins[(size_t)(t * cpt + k) * kChunk + (i % kChunk)];
    }
    img_out[i] = v;
  }
}

}  // namespace

extern "C" {

int smirk_compact_faces(const void* tof, const void* starts, const void* total,
                        const void* bins, void* out, int B, int Tp, int cpt,
                        int cmax, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || cmax == 0) return 0;
  compact_faces_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tof, (const int32_t*)starts, (const int32_t*)total,
      (const int32_t*)bins, (int32_t*)out, Tp, cpt, cmax);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
