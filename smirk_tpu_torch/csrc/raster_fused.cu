// K1 raster_fused_windows: per-tile z-buffer over the first `kept` 32-face
// chunks of the tile's bin, plus the winner's three interpolated normal
// planes.
//
// Replaces _raster_kernel_v7 (compact per-image chunk list) and
// _raster_kernel_v4 (padded per-tile layout), both in
// smirk_tpu/render/rasterizer.py. On the TPU those evaluate a (32 faces x
// 1024 pixels) block per chunk with one-hot reductions over a record list
// that _compact_faces_kernel packs first, because a TPU kernel cannot
// gather. Here a block owns one 8x128 tile of one image and walks chunks
// k = 0 .. kept - 1 of the tile's bin row; the compact and padded layouts
// differ only in kept. It is K3 (raster_planes.cu) with the inference
// record layout (lanes 0-11 edge and depth planes, lane 12 the face id,
// lanes 16-24 the normal planes [NA | NB | NC]) and no slot output, and
// shares K3's walk (walk_window in window_raster.cuh):
//   * staging, with the packing and the record gather folded in: thread i
//     reads the id of face i / 8 of the chunk from the bins and loads the
//     16-byte quarter i % 8 of that face's 128-byte record from the
//     image's record table (28 MB at batch 64, held in L2) into shared
//     memory, one chunk ahead of the tests; lanes 0-2 of the face's 8 load
//     the x and y of its three vertices beside it, and the face's cull box
//     is computed from them as rasterizer.cull_boxes computes it, with the
//     same fp32 operations. An empty slot stages a record that is never
//     inside and an empty box;
//   * the 8 warps each own a 16-column x 8-row rectangle of the tile, 4
//     pixels a thread (one column, rows r, r + 2, 4, 6). A ballot over the
//     32 staged boxes, widened by one pixel, gives the faces that meet the
//     warp's rectangle, and the warp walks only those, in slot order,
//     keeping a face only if it is inside and strictly nearer (z < best):
//     the TPU kernels' chunk minimum, first slot on ties, and strict
//     chunk-to-chunk compare;
//   * the winner, k * 32 + slot in its tile's bin, is read through its id
//     at the end for its normal planes.
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn, and the pixel centres as ((2i + 1) - size) / size with
// __fdiv_rn, so nothing is contracted into an FMA. A culled face fails the
// edge tests at every pixel of the warp (the lanes 0-11 of K1's records
// are face_records', for which cull_boxes is exact), so the outputs are
// bitwise equal to the plain PyTorch version, which tests every face.
//
// Bound on H100. Without the cull: fp32 operations, ~16 per face-pixel
// test over every slot of the walked chunks (~0.08 ms at batch 64, 224 px,
// 67 TFLOP/s); the unculled walk took ~0.32 ms. A face of a few pixels
// covers a few of a tile's 1024 pixels, so the number of tests, not their
// cost (no FMAs, for bitwise equality), is the lever. What the inputs need
// once the cull skips the faces a warp cannot see is bytes: the outputs
// (~73 MB at batch 64) and the binned faces' records (~28 MB), ~0.03 ms at
// 3.35 TB/s. What is left is K3's: the latency of the staging's dependent
// loads over walks of ~3 chunks, and of the epilogue's record reads.
#include "window_raster.cuh"

namespace {

using namespace smirk_raster;

// 5 blocks an SM (<= 48 registers a thread, no spills) timed fastest of
// none and 4-7 (tools/torch_launch_bounds_sweep.py --kernel fused)
__global__ void __launch_bounds__(kThreads, 5)
raster_fused_windows_kernel(const int32_t* __restrict__ kept,
                            const int32_t* __restrict__ bins,
                            const float* __restrict__ records,
                            const float* __restrict__ face_verts,
                            int32_t* __restrict__ p2f,
                            float* __restrict__ zbuf,
                            float* __restrict__ nx,
                            float* __restrict__ ny,
                            float* __restrict__ nz,
                            int Tp, int C, int F, int H, int W, int TX,
                            float grid_radius) {
  __shared__ float4 s_chunk[kChunk * kQuarters];  // 256 float4 = 4 KB
  __shared__ float4 s_box[kChunk];                // 512 B
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = min(kept[tile], C / kChunk);
  const int ty = t / TX;
  const int tx = t % TX;
  const int32_t* row = bins + (size_t)tile * C;
  const float* img = records + (size_t)b * F * kLanes;

  Pixels px = tile_pixels(tx, ty, W, H);
  walk_window(row, reinterpret_cast<const float4*>(img), face_verts + (size_t)b * F * 9,
              n, F, (float)W, grid_radius, warp_rect(tx, ty, threadIdx.x / 32), s_chunk,
              s_box, px);

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const size_t o = (size_t)tile * kTilePix + tile_pixel(k);
    if (px.best[k] < kBigZ) {
      const float* r = img + (size_t)row[px.win[k]] * kLanes;
      p2f[o] = (int32_t)r[12];
      zbuf[o] = px.best[k];
      nx[o] = affine(r[16], r[19], r[22], px.x, px.ys[k]);
      ny[o] = affine(r[17], r[20], r[23], px.x, px.ys[k]);
      nz[o] = affine(r[18], r[21], r[24], px.x, px.ys[k]);
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

int smirk_raster_fused_windows(const void* kept, const void* bins,
                               const void* records, const void* face_verts,
                               void* p2f, void* zbuf, void* nx, void* ny,
                               void* nz, int B, int Tp, int C, int F, int H,
                               int W, int TX, float grid_radius, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % kChunk) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  raster_fused_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)kept, (const int32_t*)bins, (const float*)records,
      (const float*)face_verts, (int32_t*)p2f, (float*)zbuf, (float*)nx,
      (float*)ny, (float*)nz, Tp, C, F, H, W, TX, grid_radius);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
