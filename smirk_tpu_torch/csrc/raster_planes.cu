// K3 raster_planes_windows: the differentiable raster's forward. Per-tile
// z-buffer over the first `kept` 32-face chunks of the tile's bin, the
// winner's per-tile slot and its D interpolated attribute planes.
//
// Replaces _raster_kernel_v5c (compact per-image chunk list) and
// _raster_kernel_v5 (padded per-tile layout), both in
// smirk_tpu/render/rasterizer.py. It is K1 (raster_fused.cu) with the
// training record layout (lanes 0-11 edge and depth planes, lane 12 the
// face id, lanes 13.. the attribute planes [PA(D) | PB(D) | PC(D)], D <= 6)
// and a cull. A block owns one 8x128 tile of one image and walks chunks
// k = 0 .. kept - 1 of the tile's bin row; the compact and padded layouts
// differ only in kept:
//   * staging as K1's: the chunk's 32 face ids are read from the bins and
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kChunk = 32;                        // faces per chunk
constexpr int kLanes = 32;                        // floats per record
constexpr int kQuarters = kLanes / 4;             // float4 per record
constexpr int kPlane0 = 13;                       // first attribute-plane lane
constexpr int kMaxD = 6;
constexpr int kThreads = 256;                     // = kChunk * kQuarters
constexpr int kWarpCols = 16;                     // a warp's rectangle: 16 x 8
constexpr int kPixPerThread = kTilePix / kThreads;  // 4
constexpr float kBigZ = 1e10f;
constexpr float kCullRounding = 32.0f / 16777216.0f;  // 32u, rasterizer._CULL_ROUNDING

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

// Quarter q of face id's record; an id outside [0, F) gives the kill
// record (edge constant c0 = -1 in lane 2, face id -1 in lane 12).
__device__ __forceinline__ float4 record_quarter(const float4* __restrict__ recs,
                                                 int id, int F, int q) {
  if (id >= 0 && id < F) return __ldg(recs + (size_t)id * kQuarters + q);
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

// The cull box [xmin, xmax, ymin, ymax] of the face whose vertex q is
// (x[q], y[q]): rasterizer.cull_boxes, operation for operation. r0 is the
// tile grid's radius, S the image size.
__device__ __forceinline__ float4 cull_box(const float x[3], const float y[3],
                                           float S, float r0) {
  float px[3], py[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    px[v] = px_of(x[v], S);
    py[v] = px_of(y[v], S);
  }
  const float xmin = fminf(fminf(px[0], px[1]), px[2]);
  const float xmax = fmaxf(fmaxf(px[0], px[1]), px[2]);
  const float ymin = fminf(fminf(py[0], py[1]), py[2]);
  const float ymax = fmaxf(fmaxf(py[0], py[1]), py[2]);
  float r = r0;
#pragma unroll
  for (int v = 0; v < 3; ++v) r = fmaxf(r, fmaxf(fabsf(x[v]), fabsf(y[v])));
  float m = 0.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {  // edge (j, k) = (e + 1, e + 2) mod 3
    const int j = (e + 1) % 3, k = (e + 2) % 3;
    const float t = __fmul_rn(__fadd_rn(fabsf(__fsub_rn(y[j], y[k])),
                                        fabsf(__fsub_rn(x[k], x[j]))), r);
    m = fmaxf(m, __fadd_rn(__fadd_rn(t, fabsf(__fmul_rn(x[j], y[k]))),
                           fabsf(__fmul_rn(y[j], x[k]))));
  }
  const float denom = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(y[1], y[2]), x[0]),
                __fmul_rn(__fsub_rn(x[2], x[1]), y[0])),
      __fsub_rn(__fmul_rn(x[1], y[2]), __fmul_rn(y[1], x[2])));
  const float ext = fmaxf(__fsub_rn(xmax, xmin), __fsub_rn(ymax, ymin));
  const float bound = __fmul_rn(__fmul_rn(kCullRounding, m),
                                __fadd_rn(__fmul_rn(4.0f, ext), 1.0f));
  const float inf = __int_as_float(0x7f800000);
  if (fabsf(denom) > bound) return make_float4(xmin, xmax, ymin, ymax);
  return make_float4(-inf, inf, -inf, inf);
}

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
  const float4* img4 = reinterpret_cast<const float4*>(img);
  const float* fv = face_verts + (size_t)b * F * 9;

  // warp w owns columns [16w, 16w + 16) of the tile, every row; lane l
  // takes column 16w + l % 16 and rows l / 16 + 2k
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = warp * kWarpCols + lane % kWarpCols;
  const float wc0 = (float)(tx * kTileCols + warp * kWarpCols);
  const float wc1 = wc0 + (float)(kWarpCols - 1);
  const float wr0 = (float)(ty * kTileRows);
  const float wr1 = wr0 + (float)(kTileRows - 1);

  const float x = ndc(col + tx * kTileCols, W);  // a thread's pixels share a column
  float ys[kPixPerThread], best[kPixPerThread];
  int win[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    ys[k] = ndc(lane / kWarpCols + 2 * k + ty * kTileRows, H);
    best[k] = kBigZ;
    win[k] = -1;
  }

  const int face = threadIdx.x / kQuarters;
  const int q = threadIdx.x % kQuarters;
  const int base = lane & ~(kQuarters - 1);  // the face's lane q = 0
  const float S = (float)W;
  int id = n > 0 ? row[face] : -1;
  float4 staged = record_quarter(img4, id, F, q);
  float2 vxy = vertex_xy(fv, id, F, q);
  int id_next = n > 1 ? row[kChunk + face] : -1;
  const float* s = reinterpret_cast<const float*>(s_chunk);
  for (int c = 0; c < n; ++c) {
    // the face's 3 vertices from its lanes 0-2; every lane computes the box
    float vx[3], vy[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      vx[v] = __shfl_sync(0xffffffffu, vxy.x, base + v);
      vy[v] = __shfl_sync(0xffffffffu, vxy.y, base + v);
    }
    const float inf = __int_as_float(0x7f800000);
    const float4 box = (id >= 0 && id < F) ? cull_box(vx, vy, S, grid_radius)
                                           : make_float4(inf, -inf, inf, -inf);
    __syncthreads();  // the previous chunk has been read by every thread
    s_chunk[threadIdx.x] = staged;
    if (q == 0) s_box[face] = box;
    __syncthreads();
    if (c + 1 < n) {  // the next chunk's loads fly during this chunk's tests
      staged = record_quarter(img4, id_next, F, q);
      vxy = vertex_xy(fv, id_next, F, q);
      id = id_next;
      id_next = c + 2 < n ? row[(c + 2) * kChunk + face] : -1;
    }
    // lane l tests face l's widened box against the warp's rectangle; the
    // ballot is the same on every lane, so the walk below is warp-uniform
    const float4 bx = s_box[lane];  // xmin, xmax, ymin, ymax
    unsigned live = __ballot_sync(0xffffffffu,
                                  !(bx.y + 1.0f < wc0 || bx.x - 1.0f > wc1 ||
                                    bx.w + 1.0f < wr0 || bx.z - 1.0f > wr1));
    while (live) {  // the faces that meet the rectangle, in slot order
      const int f = __ffs(live) - 1;
      live &= live - 1;
      const float* r = s + f * kLanes;
      const float a0 = r[0], b0 = r[1], d0 = r[2];
      const float a1 = r[3], b1 = r[4], d1 = r[5];
      const float a2 = r[6], b2 = r[7], d2 = r[8];
      const float za = r[9], zb = r[10], zc = r[11];
      const bool real = r[12] >= 0.0f;
      const int sid = c * kChunk + f;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float e0 = affine(a0, b0, d0, x, ys[k]);
        const float e1 = affine(a1, b1, d1, x, ys[k]);
        const float e2 = affine(a2, b2, d2, x, ys[k]);
        const float z = affine(za, zb, zc, x, ys[k]);
        if (real && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z < best[k]) {
          best[k] = z;
          win[k] = sid;
        }
      }
    }
  }

  const size_t plane = (size_t)B * Tp * kTilePix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = (lane / kWarpCols + 2 * k) * kTileCols + col;
    const size_t o = (size_t)tile * kTilePix + p;
    if (best[k] < kBigZ) {
      const float* r = img + (size_t)row[win[k]] * kLanes;
      p2f[o] = (int32_t)r[12];
      zbuf[o] = best[k];
      slot[o] = win[k];
      for (int d = 0; d < D; ++d) {
        vals[d * plane + o] = affine(r[kPlane0 + d], r[kPlane0 + D + d],
                                     r[kPlane0 + 2 * D + d], x, ys[k]);
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
