// Shared by the tile rasters K1 (raster_fused.cu), K3 (raster_planes.cu),
// K6 (raster_coverage.cu), K8 (raster_bins.cu), K9/K10 (raster_groups.cu)
// and K11 (raster_chunkskip.cu): the tile and warp geometry, the exact
// fp32 forms, the cull boxes, and the read-through window walk of K1, K3,
// K9-K11 (32-float records) and K6 (16-float records).
//
// A block owns one 8x128 tile of one image. Its 8 warps each own a
// 16-column x 8-row rectangle of the tile; lane l takes column l % 16 of
// the warp's rectangle and rows l / 16 + 2k, k < 4. A face whose cull box,
// widened by one pixel on every side, misses a warp's rectangle is skipped
// by that warp; the box functions below keep a box only where fp32
// rounding cannot carry an inside test one pixel past it, so the skip
// changes no output (rasterizer.cull_boxes, rasterizer.cull_boxes_bins).
//
// Every form is evaluated with __f*_rn intrinsics, in the plain versions'
// order, so that nothing is contracted into an FMA and the kernels stay
// bitwise equal to their plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace smirk_raster {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces per chunk
constexpr int kLanes = 32;                        // floats per record (K1, K3)
constexpr int kQuarters = kLanes / 4;             // float4 per record
constexpr int kThreads = 256;                     // = kChunk * kQuarters
constexpr int kWarpCols = 16;                     // a warp's rectangle: 16 x 8
constexpr int kPixPerThread = kTilePix / kThreads;  // 4
constexpr float kBigZ = 1e10f;
constexpr float kCullRounding = 32.0f / 16777216.0f;  // 32u, rasterizer._CULL_ROUNDING
// 128u: the margin of K10's rebased forms, rasterizer._LOCAL_CULL_ROUNDING
constexpr float kLocalCullRounding = 128.0f / 16777216.0f;

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// An empty box: meets no rectangle.
__device__ __forceinline__ float4 empty_box() {
  return make_float4(inf_f(), -inf_f(), inf_f(), -inf_f());
}

// Quarter q of face id's record of Lanes floats; an id outside [0, F)
// gives the kill record (edge constant c0 = -1 in lane 2, face id -1 in
// lane 12: the x of quarter 3 for either width).
template <int Lanes = kLanes>
__device__ __forceinline__ float4 record_quarter(const float4* __restrict__ recs,
                                                 int id, int F, int q) {
  if (id >= 0 && id < F) return __ldg(recs + (size_t)id * (Lanes / 4) + q);
  return make_float4(q == 3 ? -1.0f : 0.0f, 0.0f, q == 0 ? -1.0f : 0.0f, 0.0f);
}

// Lane q < 3 of a face: the x and y of vertex q of face id (face_verts
// (B, F, 3, 3), this image's rows at fv); other lanes and empty slots 0.
__device__ __forceinline__ float2 vertex_xy(const float* __restrict__ fv, int id,
                                            int F, int q) {
  if (q >= 3 || id < 0 || id >= F) return make_float2(0.0f, 0.0f);
  const float* v = fv + ((size_t)id * 3 + q) * 3;
  return make_float2(__ldg(v), __ldg(v + 1));
}

__device__ __forceinline__ float px_of(float x, float s) {  // (x*S + S - 1) / 2
  return __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(x, s), s), 1.0f), 0.5f);
}

// The bounding box of a face in pixel coordinates, its longer side `ext`
// and `r`, the largest |coordinate| of the grid (r0) and the vertices, as
// rasterizer.cull_boxes and cull_boxes_bins compute them.
struct FaceBox {
  float xmin, xmax, ymin, ymax, ext, r;
};

__device__ __forceinline__ FaceBox face_box(const float x[3], const float y[3],
                                            float S, float r0) {
  float px[3], py[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    px[v] = px_of(x[v], S);
    py[v] = px_of(y[v], S);
  }
  FaceBox b;
  b.xmin = fminf(fminf(px[0], px[1]), px[2]);
  b.xmax = fmaxf(fmaxf(px[0], px[1]), px[2]);
  b.ymin = fminf(fminf(py[0], py[1]), py[2]);
  b.ymax = fmaxf(fmaxf(py[0], py[1]), py[2]);
  b.ext = fmaxf(__fsub_rn(b.xmax, b.xmin), __fsub_rn(b.ymax, b.ymin));
  float r = r0;
#pragma unroll
  for (int v = 0; v < 3; ++v) r = fmaxf(r, fmaxf(fabsf(x[v]), fabsf(y[v])));
  b.r = r;
  return b;
}

// [xmin, xmax, ymin, ymax] where the face is thick enough for the margin,
// else unbounded (never culled).
__device__ __forceinline__ float4 bounded(const FaceBox& b, bool exact) {
  if (exact) return make_float4(b.xmin, b.xmax, b.ymin, b.ymax);
  return make_float4(-inf_f(), inf_f(), -inf_f(), inf_f());
}

// K1's and K3's cull box of the face whose vertex q is (x[q], y[q]), for
// edge tests in the affine form of the records: rasterizer.cull_boxes,
// operation for operation (K10's rebased forms: rounding = 128u,
// rasterizer.cull_boxes_local). r0 is the tile grid's radius, S the image
// size.
__device__ __forceinline__ float4 cull_box(const float x[3], const float y[3],
                                           float S, float r0,
                                           float rounding = kCullRounding) {
  const FaceBox b = face_box(x, y, S, r0);
  float m = 0.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {  // edge (j, k) = (e + 1, e + 2) mod 3
    const int j = (e + 1) % 3, k = (e + 2) % 3;
    const float t = __fmul_rn(__fadd_rn(fabsf(__fsub_rn(y[j], y[k])),
                                        fabsf(__fsub_rn(x[k], x[j]))), b.r);
    m = fmaxf(m, __fadd_rn(__fadd_rn(t, fabsf(__fmul_rn(x[j], y[k]))),
                           fabsf(__fmul_rn(y[j], x[k]))));
  }
  const float denom = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(y[1], y[2]), x[0]),
                __fmul_rn(__fsub_rn(x[2], x[1]), y[0])),
      __fsub_rn(__fmul_rn(x[1], y[2]), __fmul_rn(y[1], x[2])));
  const float bound = __fmul_rn(__fmul_rn(rounding, m),
                                __fadd_rn(__fmul_rn(4.0f, b.ext), 1.0f));
  return bounded(b, fabsf(denom) > bound);
}

// A warp's 16x8 rectangle in pixel coordinates (inclusive).
struct WarpRect {
  float c0, c1, r0, r1;
};

__device__ __forceinline__ WarpRect warp_rect(int tx, int ty, int warp) {
  WarpRect w;
  w.c0 = (float)(tx * kTileCols + warp * kWarpCols);
  w.c1 = w.c0 + (float)(kWarpCols - 1);
  w.r0 = (float)(ty * kTileRows);
  w.r1 = w.r0 + (float)(kTileRows - 1);
  return w;
}

// Lane l holds face l's box: the mask of the faces whose box, widened by
// one pixel, meets the warp's rectangle. The same on every lane, so a walk
// over it does not diverge.
__device__ __forceinline__ unsigned live_faces(float4 bx, const WarpRect& w) {
  return __ballot_sync(0xffffffffu, !(bx.y + 1.0f < w.c0 || bx.x - 1.0f > w.c1 ||
                                      bx.w + 1.0f < w.r0 || bx.z - 1.0f > w.r1));
}

// A thread's 4 pixels: one column x, rows ys[k]; the nearest depth so far
// and its slot k * 32 + f in the tile's bin (-1 none).
struct Pixels {
  float x;
  float ys[kPixPerThread], best[kPixPerThread];
  int win[kPixPerThread];
};

__device__ __forceinline__ Pixels tile_pixels(int tx, int ty, int W, int H) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Pixels p;
  p.x = ndc(warp * kWarpCols + lane % kWarpCols + tx * kTileCols, W);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    p.ys[k] = ndc(lane / kWarpCols + 2 * k + ty * kTileRows, H);
    p.best[k] = kBigZ;
    p.win[k] = -1;
  }
  return p;
}

// Pixel k of this thread's 4: its index in the 8x128 tile, row-major.
__device__ __forceinline__ int tile_pixel(int k) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  return (lane / kWarpCols + 2 * k) * kTileCols + warp * kWarpCols + lane % kWarpCols;
}

// Where the walk reads the face of slot f of its chunk c. K1, K3, K6, K9
// and K10: the tile's bin row, 32 face ids a chunk.
struct BinIds {
  const int32_t* row;
  __device__ __forceinline__ int operator()(int c, int face) const {
    return row[c * kChunk + face];
  }
};

// How the walk stages a face. K1, K3, K6 and K9: the record as read, the
// box of cull_box's 32u margin. kTagged (K11): a face whose record has a
// negative id lane (12) is never inside, so it gets an empty box (K11's
// off-screen padding faces, whose degenerate boxes are unbounded).
struct AsRead {
  static constexpr bool kTagged = false;
  __device__ __forceinline__ float4 record(float4 r, int /*q*/) const { return r; }
  __device__ __forceinline__ float plane(float c, float /*a*/, float /*b*/) const {
    return c;
  }
  __device__ __forceinline__ float4 box(const float x[3], const float y[3], float S,
                                        float r0) const {
    return cull_box(x, y, S, r0);
  }
};

struct Tagged : AsRead {
  static constexpr bool kTagged = true;
};

// K10: records rebased to the pixel centres of the image's first tile
// (rasterizer._tilelocal_adjust): the constant c of each of the seven
// affine forms (the 3 edges, the depth, the 3 normal planes) becomes
// c + ((a * dx) + (b * dy)), (dx, dy) the NDC offset of the tile's origin,
// every step rounded on its own. Its cull boxes take the rebase's margin,
// 128u (rasterizer.cull_boxes_local).
struct TileLocal {
  static constexpr bool kTagged = false;
  float dx, dy;

  __device__ __forceinline__ static TileLocal at(int tx, int ty, int W, int H) {
    return {__fdiv_rn(__fmul_rn(__fmul_rn(2.0f, (float)tx), (float)kTileCols), (float)W),
            __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, (float)ty), (float)kTileRows), (float)H)};
  }
  __device__ __forceinline__ float plane(float c, float a, float b) const {
    return __fadd_rn(c, __fadd_rn(__fmul_rn(a, dx), __fmul_rn(b, dy)));
  }
  // Quarter q of a 32-float record, held by lane q of the face's 8: the a
  // and b of the constants it holds lie in it and in the quarters one and
  // two lanes below (lanes 2 <- 0, 1; 5 <- 3, 4; 8 <- 6, 7; 11 <- 9, 10;
  // 22 <- 16, 19; 23 <- 17, 20; 24 <- 18, 21). Every lane of the warp
  // shuffles.
  __device__ __forceinline__ float4 record(float4 r, int q) const {
    const unsigned full = 0xffffffffu;
    const float4 p = make_float4(__shfl_up_sync(full, r.x, 1), __shfl_up_sync(full, r.y, 1),
                                 __shfl_up_sync(full, r.z, 1), __shfl_up_sync(full, r.w, 1));
    const float p2z = __shfl_up_sync(full, r.z, 2);
    if (q == 0) {
      r.z = plane(r.z, r.x, r.y);
    } else if (q == 1) {
      r.y = plane(r.y, p.w, r.x);
    } else if (q == 2) {
      r.x = plane(r.x, p.z, p.w);
      r.w = plane(r.w, r.y, r.z);
    } else if (q == 5) {
      r.z = plane(r.z, p.x, p.w);
      r.w = plane(r.w, p.y, r.x);
    } else if (q == 6) {
      r.x = plane(r.x, p2z, p.y);
    }
    return r;
  }
  __device__ __forceinline__ float4 box(const float x[3], const float y[3], float S,
                                        float r0) const {
    return cull_box(x, y, S, r0, kLocalCullRounding);
  }
};

// The window walk of one tile (K1, K3, K9-K11: Lanes = 32; K6: Lanes =
// 16): chunks c = 0 .. n - 1 of 32 faces, slot f of chunk c face
// ids(c, f) (-1 an empty slot: BinIds, the tile's bin row; K11 its
// chunk-id list), each face's record of Lanes floats read through its id
// from the image's record table (img4) and staged in shared memory ahead
// of the tests (as `stage` prepares it), lanes 0-2 of its Lanes / 4
// loading its vertices' x and y (fv) beside it, from which every lane of
// the face computes its cull box (stage.box).
// Each warp then walks the faces that meet its rectangle, in slot order,
// and keeps a face at a pixel only if it is inside (records' lanes 0-8,
// lane 12 >= 0) and strictly nearer (lanes 9-11): the first minimum in bin
// order. s_chunk holds a chunk's 32 * Lanes / 4 float4, s_box 32.
//
// A chunk is 32 x Lanes / 4 float4, so it takes kStagers = kThreads /
// (32 x Lanes / 4) groups of threads to stage: one at 32 floats (every
// thread loads a quarter of the chunk, one chunk ahead of the tests), two
// at 16 floats. Group h stages chunks c = h, h + kStagers, ..., so each
// group's loads fly for kStagers chunks before their values are stored:
// at 16 floats the first two chunks' loads leave together, and the walk
// of ~3 chunks a tile waits on one round of dependent loads (bin ids, then
// records and vertices) where staging with half the threads would wait on
// one a chunk. A group is whole warps, so its branch does not diverge;
// at 32 floats kStagers = 1 and every test below folds away.
template <int Lanes = kLanes, class Ids = BinIds, class Stage = AsRead>
__device__ __forceinline__ void walk_faces(const Ids& ids, const Stage& stage,
                                           const float4* __restrict__ img4,
                                           const float* __restrict__ fv, int n, int F,
                                           float S, float grid_radius,
                                           const WarpRect& rect, float4* s_chunk,
                                           float4* s_box, Pixels& px) {
  constexpr int kQ = Lanes / 4;                     // float4 per record
  constexpr int kChunkVec = kChunk * kQ;            // float4 per chunk
  constexpr int kStagers = kThreads / kChunkVec;    // 1 (32 floats) or 2 (16)
  static_assert(kStagers * kChunkVec == kThreads, "a chunk must tile the block");
  const int lane = threadIdx.x % 32;
  const int h = kStagers == 1 ? 0 : threadIdx.x / kChunkVec;  // staging group
  // the thread's float4 of the chunk, unsigned as threadIdx.x is (a signed
  // index costs the 32-float walk a register)
  const unsigned slot = kStagers == 1 ? threadIdx.x : threadIdx.x % kChunkVec;
  const int face = slot / kQ;
  const int q = threadIdx.x % kQ;
  const int base = lane & ~(kQ - 1);  // the face's lane q = 0
  int id = h < n ? ids(h, face) : -1;
  float4 staged = record_quarter<Lanes>(img4, id, F, q);
  float2 vxy = vertex_xy(fv, id, F, q);
  int id_next = h + kStagers < n ? ids(h + kStagers, face) : -1;
  const float* s = reinterpret_cast<const float*>(s_chunk);
  for (int c = 0; c < n; ++c) {
    const bool mine = kStagers == 1 || c % kStagers == h;  // warp-uniform
    float4 box;
    if (mine) {
      // the face's 3 vertices from its lanes 0-2; every lane computes the box
      float vx[3], vy[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        vx[v] = __shfl_sync(0xffffffffu, vxy.x, base + v);
        vy[v] = __shfl_sync(0xffffffffu, vxy.y, base + v);
      }
      bool real = id >= 0 && id < F;
      if constexpr (Stage::kTagged) {  // the id lane, x of the face's quarter 3
        real = __shfl_sync(0xffffffffu, staged.x, base + 3) >= 0.0f && real;
      }
      box = real ? stage.box(vx, vy, S, grid_radius) : empty_box();
      staged = stage.record(staged, q);
    }
    __syncthreads();  // the previous chunk has been read by every thread
    if (mine) {
      s_chunk[slot] = staged;
      if (q == 0) s_box[face] = box;
    }
    __syncthreads();
    if (mine && c + kStagers < n) {  // this group's next chunk flies meanwhile
      staged = record_quarter<Lanes>(img4, id_next, F, q);
      vxy = vertex_xy(fv, id_next, F, q);
      id = id_next;
      id_next = c + 2 * kStagers < n ? ids(c + 2 * kStagers, face) : -1;
    }
    unsigned live = live_faces(s_box[lane], rect);
    while (live) {  // the faces that meet the rectangle, in slot order
      const int f = __ffs(live) - 1;
      live &= live - 1;
      const float* r = s + f * Lanes;
      const float a0 = r[0], b0 = r[1], d0 = r[2];
      const float a1 = r[3], b1 = r[4], d1 = r[5];
      const float a2 = r[6], b2 = r[7], d2 = r[8];
      const float za = r[9], zb = r[10], zc = r[11];
      const bool real = r[12] >= 0.0f;
      const int sid = c * kChunk + f;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float e0 = affine(a0, b0, d0, px.x, px.ys[k]);
        const float e1 = affine(a1, b1, d1, px.x, px.ys[k]);
        const float e2 = affine(a2, b2, d2, px.x, px.ys[k]);
        const float z = affine(za, zb, zc, px.x, px.ys[k]);
        if (real && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z < px.best[k]) {
          px.best[k] = z;
          px.win[k] = sid;
        }
      }
    }
  }
}

// K1's, K3's and K6's walk: the faces of the tile's bin row, as read.
template <int Lanes = kLanes>
__device__ __forceinline__ void walk_window(const int32_t* __restrict__ row,
                                            const float4* __restrict__ img4,
                                            const float* __restrict__ fv, int n,
                                            int F, float S, float grid_radius,
                                            const WarpRect& rect, float4* s_chunk,
                                            float4* s_box, Pixels& px) {
  walk_faces<Lanes>(BinIds{row}, AsRead{}, img4, fv, n, F, S, grid_radius, rect, s_chunk,
                    s_box, px);
}

// The outputs of K9-K11 (K1 writes its own) at pixel k of this thread:
// the winner's id lane (12), depth and normal planes (lanes 16-24, their
// constants as `stage` stages them), its record read through
// ids(win / 32, win % 32) from the image's table img; else the background.
template <class Ids, class Stage>
__device__ __forceinline__ void store_fused(const Ids& ids, const Stage& stage,
                                            const float* __restrict__ img,
                                            const Pixels& px, int k, size_t o,
                                            int32_t* __restrict__ p2f,
                                            float* __restrict__ zbuf,
                                            float* __restrict__ nx,
                                            float* __restrict__ ny,
                                            float* __restrict__ nz) {
  if (px.best[k] < kBigZ) {
    const int w = px.win[k];
    const float* r = img + (size_t)ids(w / kChunk, w % kChunk) * kLanes;
    p2f[o] = (int32_t)r[12];
    zbuf[o] = px.best[k];
    nx[o] = affine(r[16], r[19], stage.plane(r[22], r[16], r[19]), px.x, px.ys[k]);
    ny[o] = affine(r[17], r[20], stage.plane(r[23], r[17], r[20]), px.x, px.ys[k]);
    nz[o] = affine(r[18], r[21], stage.plane(r[24], r[18], r[21]), px.x, px.ys[k]);
  } else {
    p2f[o] = -1;
    zbuf[o] = kBigZ;
    nx[o] = 0.0f;
    ny[o] = 0.0f;
    nz[o] = 0.0f;
  }
}

}  // namespace smirk_raster
