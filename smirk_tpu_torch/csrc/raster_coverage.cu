// K6 raster_coverage_windows: per-tile coverage z-buffer over the first
// `kept` 32-face chunks of the tile's bin: the nearest face, its depth and
// its per-tile bin slot.
//
// Replaces _raster_kernel_v3 (via _v3_impl, rasterize_coverage_pallas_v3
// and rasterize_coverage_pallas_v3_full) in smirk_tpu/render/rasterizer.py.
// On the TPU that evaluates a (32 faces x 1024 pixels) block per chunk of a
// tile's padded bin, over a record list gathered per bin slot, and merges
// chunk minima. Here it is K3 (raster_planes.cu) without the attribute
// planes, on 16-float coverage records (lanes 0-11 edge and depth planes,
// lane 12 the face id), and it shares K1's and K3's walk (walk_window in
// window_raster.cuh, at 16 floats a record). A block owns one 8x128 tile
// of one image and walks chunks k = 0 .. kept - 1 of the tile's bin row:
//   * staging: the chunk's 32 face ids are read from the bins and their
//     records (2 KB a chunk) loaded from the image's record table into
//     shared memory, with each face's cull box computed from its vertices
//     as rasterizer.cull_boxes computes it. A chunk is 128 float4, so the
//     block's two halves stage alternate chunks, each half's loads flying
//     two chunks ahead of the tests (window_raster.cuh says why). No
//     record list is gathered before the launch (it was 59 MB at batch 32,
//     224 px, capacity 512);
//   * the 8 warps each own a 16-column x 8-row rectangle of the tile, 4
//     pixels a thread; a ballot over the 32 staged boxes, widened by one
//     pixel, gives the faces that meet the warp's rectangle, and the warp
//     walks only those, in slot order, keeping a face only if it is inside
//     and strictly nearer: the TPU kernel's chunk minimum, first slot on
//     ties, and strict chunk-to-chunk compare;
//   * the winner's slot k * 32 + f in its tile's bin is written (it indexes
//     the bin row for the backward's segment reduction), and its face id is
//     read from the bin row there; no record is read again.
// Every affine form is ((a*x) + (b*y)) + c with __fmul_rn / __fadd_rn and
// the pixel centres use __fdiv_rn, so nothing is contracted into an FMA.
// The records' lanes 0-11 are face_records', for which cull_boxes is
// exact: a culled face fails the edge tests at every pixel of the warp, so
// the outputs are bitwise equal to the plain PyTorch version, which tests
// every face, and to K3's coverage outputs on the same bins.
//
// Bound on H100. Without the cull: fp32 operations, ~16 per face-pixel
// test over every slot of the walked chunks (~0.04 ms at batch 32, 224 px,
// capacity 512), and the unculled walk over a gathered list took ~0.18
// ms. Counting only the face-pixel pairs inside the faces' boxes, what the
// inputs need is bytes: the binned faces' records (64 B each), the walked
// bin ids and the three outputs (~0.009 ms at 3.35 TB/s). What is left is
// K3's: the latency of the staging's dependent loads over walks of ~3
// chunks.
#include "window_raster.cuh"

namespace {

using namespace smirk_raster;

constexpr int kCoverageLanes = 16;  // floats per coverage record

// 5 blocks an SM: K1's and K3's minimum (tools/torch_launch_bounds_sweep.py
// --kernel coverage)
__global__ void __launch_bounds__(kThreads, 5)
raster_coverage_windows_kernel(const int32_t* __restrict__ kept,
                               const int32_t* __restrict__ bins,
                               const float* __restrict__ records,
                               const float* __restrict__ face_verts,
                               int32_t* __restrict__ p2f,
                               float* __restrict__ zbuf,
                               int32_t* __restrict__ slot, int Tp, int C,
                               int F, int H, int W, int TX, float grid_radius) {
  __shared__ float4 s_chunk[kChunk * kCoverageLanes / 4];  // 128 float4 = 2 KB
  __shared__ float4 s_box[kChunk];                         // 512 B
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = min(kept[tile], C / kChunk);
  const int ty = t / TX;
  const int tx = t % TX;
  const int32_t* row = bins + (size_t)tile * C;
  const float* img = records + (size_t)b * F * kCoverageLanes;

  Pixels px = tile_pixels(tx, ty, W, H);
  walk_window<kCoverageLanes>(row, reinterpret_cast<const float4*>(img),
                              face_verts + (size_t)b * F * 9, n, F, (float)W,
                              grid_radius, warp_rect(tx, ty, threadIdx.x / 32),
                              s_chunk, s_box, px);

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const size_t o = (size_t)tile * kTilePix + tile_pixel(k);
    const bool covered = px.best[k] < kBigZ;
    p2f[o] = covered ? row[px.win[k]] : -1;
    zbuf[o] = covered ? px.best[k] : kBigZ;
    slot[o] = covered ? px.win[k] : -1;
  }
}

}  // namespace

extern "C" {

int smirk_raster_coverage_windows(const void* kept, const void* bins,
                                  const void* records, const void* face_verts,
                                  void* p2f, void* zbuf, void* slot, int B,
                                  int Tp, int C, int F, int H, int W, int TX,
                                  float grid_radius, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % kChunk) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  raster_coverage_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)kept, (const int32_t*)bins, (const float*)records,
      (const float*)face_verts, (int32_t*)p2f, (float*)zbuf, (int32_t*)slot, Tp,
      C, F, H, W, TX, grid_radius);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
