// K9 raster_fused_groups and K10 raster_fused_groups_local: per-tile
// z-buffer over each tile's own chunks of its padded bin, plus the
// winner's three interpolated normal planes.
//
// Replace _raster_kernel_v6 (K9) and _raster_kernel_v6tl (K10) in
// smirk_tpu/render/rasterizer.py. On the TPU those run a (tps tiles, 32
// faces, 1024 pixels) block per grid step over a gathered per-tile record
// list: every tile of a group walks the same chunk index up to the group's
// largest chunk count, testing the kill records of its padded bin past its
// own count, which amortised a grid step's cost over tps tiles. On the card
// a block per tile costs nothing to schedule, so the walk to the group's
// maximum is pure waste: its chunks past a tile's own count hold only kill
// records, which are never inside, and skipping them changes no bit. Here
// a block owns one 8x128 tile of one image and runs K1's walk
// (walk_faces in window_raster.cuh) over its own ceil(count / 32) chunks of
// its bin row, clamped to C / 32: read-through staging one chunk ahead
// (each face's 128-byte record read through its bin id from the image's
// record table, its cull box computed from its vertices), 16x8 warp
// rectangles, the exact per-warp box cull and the ballot walk in slot
// order; the per-pixel state lives in registers. K9 is then K1 on the
// padded layout (K1b), bit for bit; `tps` only pads the tile axis (the
// wrapper's check), and a padding tile has count 0 and writes background.
//
// K10 takes the tiles count-sorted: row t of the bins is tile order[t] of
// the image. Its contract evaluates tile-local records (rasterizer.
// _tilelocal_adjust): every tile takes the pixel centres of the image's
// first tile and each affine constant is rebased, c' = c + ((a * dx) +
// (b * dy)), (dx, dy) = (((2 tx) 128) / W, ((2 ty) 8) / H) of tile
// order[t]. The kernel rebases each staged record in its staging (the
// TileLocal stage: shuffles within a face's 8 lanes bring each constant's
// a and b) and the winner's normal planes in the epilogue, with the same
// __f*_rn steps, so it reads the record table through the bins as K9 does
// and no tile-local copy is built. Its cull rectangles come from the
// tile's real position; the rebased forms carry one more rounding of c',
// so its boxes take the margin derived for them, 128u
// (rasterizer.cull_boxes_local).
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn and the pixel centres with __fdiv_rn, as in K1, so nothing is
// contracted into an FMA and the results are bitwise equal to the plain
// PyTorch version, which walks every tile of a group to the group's
// maximum and tests every face.
//
// Bound on H100: K1b's, the same function on the same faces: the
// face-pixel pairs inside each face's box (16 fp32 operations a pair,
// ~0.001 ms at b64, 224 px) against the binned faces' records read once
// and the outputs (~73 MB), ~0.03 ms at 3.35 TB/s. What is left is K1's
// latency over walks of ~3 chunks a tile; K10 adds the rebase's shuffles
// and 14 operations a record to its staging.
#include <type_traits>

#include "window_raster.cuh"

namespace {

using namespace smirk_raster;

// 5 blocks an SM: K1's minimum (tools/torch_launch_bounds_sweep.py
// --kernel groups / groups_local)
template <bool kLocal>
__global__ void __launch_bounds__(kThreads, 5)
raster_groups_kernel(const int32_t* __restrict__ counts,   // (B, Tp)
                     const int32_t* __restrict__ bins,     // (B, Tp, C)
                     const int32_t* __restrict__ order,    // (B, Tp), K10
                     const float* __restrict__ records,    // (B, F, 32)
                     const float* __restrict__ face_verts,  // (B, F, 3, 3)
                     int32_t* __restrict__ p2f, float* __restrict__ zbuf,
                     float* __restrict__ nx, float* __restrict__ ny,
                     float* __restrict__ nz, int Tp, int C, int F, int H, int W,
                     int TX, float grid_radius) {
  __shared__ float4 s_chunk[kChunk * kQuarters];  // 256 float4 = 4 KB
  __shared__ float4 s_box[kChunk];                // 512 B
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = min((max(counts[tile], 0) + kChunk - 1) / kChunk, C / kChunk);
  const int pos = kLocal ? order[tile] : t;  // the tile's place in the image
  const int ty = pos / TX;
  const int tx = pos % TX;
  const BinIds ids{bins + (size_t)tile * C};
  const float* img = records + (size_t)b * F * kLanes;
  using Stage = typename std::conditional<kLocal, TileLocal, AsRead>::type;
  Stage stage;
  if constexpr (kLocal) stage = TileLocal::at(tx, ty, W, H);

  Pixels px = kLocal ? tile_pixels(0, 0, W, H) : tile_pixels(tx, ty, W, H);
  walk_faces(ids, stage, reinterpret_cast<const float4*>(img),
             face_verts + (size_t)b * F * 9, n, F, (float)W, grid_radius,
             warp_rect(tx, ty, threadIdx.x / 32), s_chunk, s_box, px);

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
    store_fused(ids, stage, img, px, k, (size_t)tile * kTilePix + tile_pixel(k), p2f,
                zbuf, nx, ny, nz);
}

}  // namespace

extern "C" {

int smirk_raster_fused_groups(const void* counts, const void* bins, const void* order,
                              const void* records, const void* face_verts, void* p2f,
                              void* zbuf, void* nx, void* ny, void* nz, int B, int Tp,
                              int C, int F, int H, int W, int TX, int local,
                              float grid_radius, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % kChunk || (local && order == nullptr)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  dim3 grid(Tp, B);
  if (local)
    raster_groups_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int32_t*)bins, (const int32_t*)order,
        (const float*)records, (const float*)face_verts, (int32_t*)p2f, (float*)zbuf,
        (float*)nx, (float*)ny, (float*)nz, Tp, C, F, H, W, TX, grid_radius);
  else
    raster_groups_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int32_t*)bins, nullptr, (const float*)records,
        (const float*)face_verts, (int32_t*)p2f, (float*)zbuf, (float*)nx, (float*)ny,
        (float*)nz, Tp, C, F, H, W, TX, grid_radius);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
