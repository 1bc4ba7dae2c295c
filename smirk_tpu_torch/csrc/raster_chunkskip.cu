// K11 raster_chunkskip: per-tile z-buffer over a list of CH-face chunk ids
// into the image's full record table, plus the winner's three
// interpolated normal planes.
//
// Replaces _raster_kernel_v8 (via rasterize_normals_chunkskip) in
// smirk_tpu/render/rasterizer.py. There the binning selects chunks of a
// spatially ordered face list instead of faces, and each tile fetches its
// chunks from the full per-image record table held in VMEM: no record
// gather, no compact plan, no chunk compaction. Its price is face tests:
// every face of a binned chunk is tested against every pixel, even where
// one member alone overlaps the tile. Here a block owns one 8x128 tile of
// one image and runs K1's walk (walk_faces in window_raster.cuh) over the
// tile's list clist[b, t, :counts[b, t]] (counts clamped to [0, cap]), 32
// faces a step: the 32 / CH list entries from c * 32 / CH on, slot f face
// list[c * 32 / CH + f / CH] * CH + f % CH of the image's table (B, F, 32),
// CH one of 4, 8, 16, 32 (a template parameter). The last step of a list
// whose count x CH is no multiple of 32 is partial; its empty slots stage
// the kill record and an empty box. The walk stages each step's records
// one step ahead, computes each face's cull box from the vertices of the
// padded, Morton-ordered faces (rasterizer.cull_boxes, exact for the
// records' edge lanes), gives the off-screen padding faces (id -1 in lane
// 12, degenerate boxes that would never be culled) an empty box, and lets
// each warp test only the faces whose box meets its 16x8 rectangle, in
// list-then-slot order with a strict < as the plain version: the nearer
// chunk first, then the first slot. The winner's staged slot is turned back
// into its table row at the end, and lane 12 (the original face id) and
// the normal planes are read from it.
// Every affine form is evaluated as ((a*x) + (b*y)) + c with __fmul_rn /
// __fadd_rn and the pixel centres with __fdiv_rn, as in K1, so the results
// are bitwise equal to the plain PyTorch version, which tests every face.
//
// Bound on H100: K1's function, the same z-buffer: the face-pixel pairs
// inside each binned face's box (16 fp32 operations a pair) against the
// records of every binned chunk read once (the kernel must read them all:
// at CH = 8 about twice K1's binned faces) and the outputs, bytes-bound at
// ~0.03 ms at b64, 224 px. The table is 3408 x 128 B = 436 KB per image,
// 27.9 MB at b64, under the 50 MB L2, so a record read by several tiles
// is mostly an L2 hit. The cull brings the face-warp tests down to about
// K1's; what is left is K1's latency over walks of ~5 steps a tile.
#include "window_raster.cuh"

namespace {

using namespace smirk_raster;

// Slot f of step c: the f % CH-th face of list entry c * 32 / CH + f / CH
// (-1 past the tile's count).
template <int CH>
struct ChunkIds {
  const int32_t* list;
  int count;
  __device__ __forceinline__ int operator()(int c, int face) const {
    const int e = c * (kChunk / CH) + face / CH;
    return e < count ? list[e] * CH + face % CH : -1;
  }
};

// 5 blocks an SM: K1's minimum (tools/torch_launch_bounds_sweep.py
// --kernel chunkskip)
template <int CH>
__global__ void __launch_bounds__(kThreads, 5)
raster_chunkskip_kernel(const int32_t* __restrict__ counts,     // (B, Tp)
                        const int32_t* __restrict__ clist,      // (B, Tp, cap)
                        const float* __restrict__ records,      // (B, F, 32)
                        const float* __restrict__ face_verts,   // (B, F, 3, 3)
                        int32_t* __restrict__ p2f, float* __restrict__ zbuf,
                        float* __restrict__ nx, float* __restrict__ ny,
                        float* __restrict__ nz, int Tp, int cap, int F, int H,
                        int W, int TX, float grid_radius) {
  __shared__ float4 s_chunk[kChunk * kQuarters];  // 256 float4 = 4 KB
  __shared__ float4 s_box[kChunk];                // 512 B
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int count = min(max(counts[tile], 0), cap);
  const int n = (count * CH + kChunk - 1) / kChunk;  // steps of 32 faces
  const int ty = t / TX;
  const int tx = t % TX;
  const ChunkIds<CH> ids{clist + (size_t)tile * cap, count};
  const float* img = records + (size_t)b * F * kLanes;
  const Tagged stage{};

  Pixels px = tile_pixels(tx, ty, W, H);
  walk_faces(ids, stage, reinterpret_cast<const float4*>(img),
             face_verts + (size_t)b * F * 9, n, F, (float)W, grid_radius,
             warp_rect(tx, ty, threadIdx.x / 32), s_chunk, s_box, px);

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
    store_fused(ids, stage, img, px, k, (size_t)tile * kTilePix + tile_pixel(k), p2f,
                zbuf, nx, ny, nz);
}

template <int CH>
void launch(dim3 grid, cudaStream_t stream, const void* counts, const void* clist,
            const void* records, const void* face_verts, void* p2f, void* zbuf, void* nx,
            void* ny, void* nz, int Tp, int cap, int F, int H, int W, int TX,
            float grid_radius) {
  raster_chunkskip_kernel<CH><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)counts, (const int32_t*)clist, (const float*)records,
      (const float*)face_verts, (int32_t*)p2f, (float*)zbuf, (float*)nx, (float*)ny,
      (float*)nz, Tp, cap, F, H, W, TX, grid_radius);
}

}  // namespace

extern "C" {

int smirk_raster_chunkskip(const void* counts, const void* clist, const void* records,
                           const void* face_verts, void* p2f, void* zbuf, void* nx,
                           void* ny, void* nz, int B, int Tp, int cap, int F, int CH,
                           int H, int W, int TX, float grid_radius, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((CH != 4 && CH != 8 && CH != 16 && CH != 32) || F % CH != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0) return 0;
  const dim3 grid(Tp, B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (CH == 4)
    launch<4>(grid, s, counts, clist, records, face_verts, p2f, zbuf, nx, ny, nz, Tp, cap,
              F, H, W, TX, grid_radius);
  else if (CH == 8)
    launch<8>(grid, s, counts, clist, records, face_verts, p2f, zbuf, nx, ny, nz, Tp, cap,
              F, H, W, TX, grid_radius);
  else if (CH == 16)
    launch<16>(grid, s, counts, clist, records, face_verts, p2f, zbuf, nx, ny, nz, Tp,
               cap, F, H, W, TX, grid_radius);
  else
    launch<32>(grid, s, counts, clist, records, face_verts, p2f, zbuf, nx, ny, nz, Tp,
               cap, F, H, W, TX, grid_radius);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
