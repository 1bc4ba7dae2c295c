// K3 raster_planes_windows: the differentiable raster's forward. Per-tile
// z-buffer over the first `kept` 32-face chunks of the tile's bin, the
// winner's per-tile slot and its D interpolated attribute planes.
//
// Replaces _raster_kernel_v5c (compact per-image chunk list) and
// _raster_kernel_v5 (padded per-tile layout), both in
// smirk_tpu/render/rasterizer.py. It is K1 (raster_fused.cu) with the
// training record layout (lanes 0-11 edge and depth planes, lane 12 the
// face id, lanes 13.. the attribute planes [PA(D) | PB(D) | PC(D)], D <= 6)
// and the slot output; the two share their walk (walk_window in
// window_raster.cuh). A block owns one 8x128 tile of one image and walks
// chunks k = 0 .. kept - 1 of the tile's bin row; the compact and padded
// layouts differ only in kept:
//   * staging: the chunk's 32 face ids are read from the bins and
//     their records (4 KB) loaded from the image's record table into
//     shared memory, one chunk ahead of the tests. Beside each record goes
//     its cull box (16 B): lanes 0-2 of the face's 8 load the x and y of
//     its three vertices with the record, and at staging the box is
//     computed from them as rasterizer.cull_boxes computes it, with the
//     same fp32 operations, so the cull costs no pass of its own before
//     the launch. An empty slot stages a record that is never inside and
//     an empty box;
//   * the 8 warps each own a 16-column x 8-row rectangle of the tile, 4
//     pixels a thread (rows r and r + 2, 4, 6). For each staged chunk a
//     warp compares the 32 faces' boxes, widened by one pixel on every
//     side, with its rectangle, one face a lane, and a ballot gives the
//     mask of the faces that meet it; the warp then walks only those. The
//     mask is the same on every lane, so the walk does not diverge;
//   * the walked faces go in slot order, and a face is kept only if it is
//     inside and strictly nearer: the TPU kernels' chunk minimum, first
//     slot on ties, and strict chunk-to-chunk compare;
//   * at the end the winner's slot in its tile's bin, k * 32 + slot, is
//     written (it indexes the bin row for the backward's fold), and its D
//     planes are evaluated once, its record read through its id.
// Every affine form is ((a*x) + (b*y)) + c with __fmul_rn / __fadd_rn and
// the pixel centres use __fdiv_rn, so nothing is contracted into an FMA.
// A culled face fails the edge tests at every pixel of the warp
// (cull_boxes keeps a box only where fp32 rounding cannot carry a pass
// one pixel past it; slivers get an unbounded box), so the outputs are
// bitwise equal to the plain PyTorch version, which tests every face.
// The box's own operations are __f*_rn too, in cull_boxes' order, so that
// it equals cull_boxes bitwise for finite vertices.
//
// Bound on H100. Without the cull: fp32 operations, ~16 per face-pixel
// test over every slot of the walked chunks (~0.04 ms at batch 32, 224 px,
// 67 TFLOP/s), and the unculled walk took ~0.19 ms. A face of a few pixels
// covers a few of a tile's 1024 pixels, so the test count, not the cost of
// a test (no FMAs, for bitwise equality), is the lever: the cull keeps
// ~14 % of the face-warp tests on the face region, and what the inputs
// then need is bound by bytes (the outputs, ~44 MB at batch 32, and the
// binned faces' records: ~0.018 ms at 3.35 TB/s). What is left
// is latency: a tile walks ~3 chunks, so the first chunk's dependent loads
// (bin ids, then records and vertices) and the epilogue's record reads are
// not hidden behind tests. With the box computed in the staging, 5
// resident blocks an SM (48 registers a thread, no spills) beat 6 (40,
// spilled) and 7 (tools/torch_launch_bounds_sweep.py).
#include "window_raster.cuh"

namespace {

using namespace smirk_raster;

constexpr int kPlane0 = 13;  // first attribute-plane lane
constexpr int kMaxD = 6;

// 5 blocks an SM (<= 48 registers a thread): a tile's walk is short, so
// resident blocks hide the staging loads' latency; 6 spill
__global__ void __launch_bounds__(kThreads, 5)
raster_planes_windows_kernel(const int32_t* __restrict__ kept,
                             const int32_t* __restrict__ bins,
                             const float* __restrict__ records,
                             const float* __restrict__ face_verts,
                             int32_t* __restrict__ p2f,
                             float* __restrict__ zbuf,
                             int32_t* __restrict__ slot,
                             float* __restrict__ vals,  // (D, B, Tp, 1024)
                             int B, int Tp, int C, int F, int H, int W,
                             int TX, int D, float grid_radius) {
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

  const size_t plane = (size_t)B * Tp * kTilePix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const size_t o = (size_t)tile * kTilePix + tile_pixel(k);
    if (px.best[k] < kBigZ) {
      const float* r = img + (size_t)row[px.win[k]] * kLanes;
      p2f[o] = (int32_t)r[12];
      zbuf[o] = px.best[k];
      slot[o] = px.win[k];
      for (int d = 0; d < D; ++d) {
        vals[d * plane + o] = affine(r[kPlane0 + d], r[kPlane0 + D + d],
                                     r[kPlane0 + 2 * D + d], px.x, px.ys[k]);
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

int smirk_raster_planes_windows(const void* kept, const void* bins,
                                const void* records, const void* face_verts,
                                void* p2f, void* zbuf, void* slot, void* vals,
                                int B, int Tp, int C, int F, int H, int W,
                                int TX, int D, float grid_radius, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || D > kMaxD || C % kChunk) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  raster_planes_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)kept, (const int32_t*)bins, (const float*)records,
      (const float*)face_verts, (int32_t*)p2f, (float*)zbuf, (int32_t*)slot,
      (float*)vals, B, Tp, C, F, H, W, TX, D, grid_radius);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
