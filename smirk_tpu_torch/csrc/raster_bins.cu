// K8 raster_bins_coverage: per-tile z-buffer over the tile's bin, one face
// at a time, with division barycentrics.
//
// Replaces _raster_kernel (via rasterize_coverage_pallas) in
// smirk_tpu/render/rasterizer.py. On the TPU that walks exactly `count`
// faces of the tile's bin in bin order, fetching each face's vertices with
// one-hot lane reductions. Here a block owns one 8x128 tile of one image
// and walks the same `count` faces, 32 bin entries (a chunk) at a time:
//   * staging, one chunk ahead of the tests, by all 256 threads: the 8
//     threads of a chunk slot read its bin id, and lanes 0-2 of them load
//     the x, y and z of one vertex each; a shuffle hands the x and y to the
//     slot's 8 lanes, which compute the face's doubled signed area (the
//     cross product of its edges, as the plain version does), the divisor
//     `safe` and the cull box (rasterizer.cull_boxes_bins, its margin
//     derived for this arithmetic). Shared memory takes the 9 coordinates,
//     `safe`, the id and the box. A slot past the count, and a face whose
//     area is degenerate (never inside), get an empty box;
//   * the 8 warps each own a 16-column x 8-row rectangle of the tile, 4
//     pixels a thread (window_raster.cuh). A ballot over the 32 staged
//     boxes, widened by one pixel, gives the faces that meet the warp's
//     rectangle, and the warp tests only those, in bin order, with the TPU
//     kernel's arithmetic: cross-product edge terms e_i, w_i = e_i / area
//     (IEEE, __fdiv_rn), z = w0*z0 + w1*z1 + w2*z2, keeping a face only if
//     it is inside (all w_i >= 0) and strictly nearer (z < best), so the
//     first minimum in bin order wins. A pixel where some e_i has the sign
//     opposite to the area's, with |e_i| >= 2^-100 and |area| <= 2^40, is
//     rejected before the divisions: that w_i is negative, and no smaller
//     than -2^-140 in magnitude, so it cannot round to -0 (which would pass
//     w_i >= 0). Most tested pixels of a small face are outside it, so
//     most pairs need no division;
//   * p2f and z go straight to the (B, Hp, Wp) image; the caller crops.
// Every operation is an __f*_rn intrinsic, so nothing is contracted into
// an FMA. A culled face has some w_i < 0 at every pixel of the warp
// (cull_boxes_bins keeps a box only where fp32 rounding of the cross
// products cannot carry a pass one pixel past it), so the outputs are
// bitwise equal to the plain PyTorch version, which tests every face.
//
// Bound on H100. Unculled, fp32 operations: ~29 per face-pixel pair (21
// for the edge terms, 3 divisions, 5 for the depth) over count x 1024
// pairs per tile, and the unculled walk took ~0.42 ms at batch 32, 224 px.
// A face of a few pixels covers a few of a tile's 1024 pixels; counting
// only the pairs inside the faces' boxes, what the inputs need is bytes
// (the outputs and the binned faces' vertices, ~0.006 ms). The cull cuts
// the tests, the sign test most of the divisions; what is left is the
// staging's dependent loads (bin id, then vertices) over walks of a few
// chunks.
#include "window_raster.cuh"

namespace {

using namespace smirk_raster;

constexpr int kFaceLanes = 12;  // x0 y0 z0 x1 y1 z1 x2 y2 z2 safe sign, 1 unused
constexpr float kAreaEps = 1e-10f;
// |e| >= 2^-100 over |safe| <= 2^40 is at least 2^-140: a quotient of
// opposite signs rounds to a negative number, never to -0
constexpr float kSureE = 0x1p-100f;
constexpr float kSureSafe = 0x1p40f;
// 512u = 2^-15, rasterizer._BINS_CULL_ROUNDING
constexpr float kBinsCullRounding = 1.0f / 32768.0f;

// (xj - x) * (yk - y) - (yj - y) * (xk - x)
__device__ __forceinline__ float edge(float xj, float yj, float xk, float yk,
                                      float x, float y) {
  return __fsub_rn(__fmul_rn(__fsub_rn(xj, x), __fsub_rn(yk, y)),
                   __fmul_rn(__fsub_rn(yj, y), __fsub_rn(xk, x)));
}

// K8's cull box of the face with vertices (x[v], y[v]) and cross-product
// area denom: rasterizer.cull_boxes_bins, operation for operation. The box
// is kept where |denom| S^2 > 512u (ext + 1) ((ext + 2)^2 + R S).
__device__ __forceinline__ float4 bins_cull_box(const float x[3], const float y[3],
                                                float denom, float S, float r0) {
  const FaceBox b = face_box(x, y, S, r0);
  const float e2 = __fadd_rn(b.ext, 2.0f);
  const float rhs = __fmul_rn(__fmul_rn(kBinsCullRounding, __fadd_rn(b.ext, 1.0f)),
                              __fadd_rn(__fmul_rn(e2, e2), __fmul_rn(b.r, S)));
  return bounded(b, __fmul_rn(__fmul_rn(fabsf(denom), S), S) > rhs);
}

// 6 blocks an SM (<= 40 registers a thread, a few bytes spilled) timed
// fastest, 7 and 5 within 3 % (tools/torch_launch_bounds_sweep.py)
__global__ void __launch_bounds__(kThreads, 6)
raster_bins_kernel(const int32_t* __restrict__ counts,  // (B, Tp)
                   const int32_t* __restrict__ bins,    // (B, Tp, C)
                   const float* __restrict__ fv,        // (B, F, 9)
                   int32_t* __restrict__ p2f,           // (B, Hp, Wp)
                   float* __restrict__ zbuf,            // (B, Hp, Wp)
                   int Tp, int C, int F, int H, int W, int TX,
                   float grid_radius) {
  __shared__ float s_face[kChunk * kFaceLanes];  // 1.5 KB
  __shared__ float4 s_box[kChunk];               // 512 B
  __shared__ int s_id[kChunk];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = b * Tp + t;
  const int n = min(counts[tile], C);
  const int ty = t / TX;
  const int tx = t % TX;
  const int32_t* bin = bins + (size_t)tile * C;
  const float* img_fv = fv + (size_t)b * F * 9;
  const float S = (float)W;

  const int lane = threadIdx.x % 32;
  const int slot = threadIdx.x / kQuarters;  // the chunk slot this thread stages
  const int q = threadIdx.x % kQuarters;
  const int base = lane & ~(kQuarters - 1);  // the slot's lane q = 0
  const WarpRect rect = warp_rect(tx, ty, threadIdx.x / 32);
  Pixels px = tile_pixels(tx, ty, W, H);

  // the slot's id (-1 past the count) and, on lane q < 3, vertex q's x y z
  // (an id of -1 inside the count reads face 0, as the plain version does)
  int id = slot < n ? bin[slot] : -1;
  float3 v = make_float3(0.0f, 0.0f, 0.0f);
  if (q < 3 && slot < n) {
    const float* p = img_fv + (size_t)max(id, 0) * 9 + q * 3;
    v = make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
  }
  const int chunks = (n + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const bool active = c * kChunk + slot < n;
    float vx[3], vy[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vx[k] = __shfl_sync(0xffffffffu, v.x, base + k);
      vy[k] = __shfl_sync(0xffffffffu, v.y, base + k);
    }
    // (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    const float denom = edge(vx[1], vy[1], vx[2], vy[2], vx[0], vy[0]);
    const bool real = fabsf(denom) >= kAreaEps;
    const float4 box = active && real ? bins_cull_box(vx, vy, denom, S, grid_radius)
                                      : empty_box();
    __syncthreads();  // the previous chunk has been read by every thread
    float* sf = s_face + slot * kFaceLanes;
    if (q < 3) {
      sf[3 * q] = v.x;
      sf[3 * q + 1] = v.y;
      sf[3 * q + 2] = v.z;
    } else if (q == 3) {
      sf[9] = real ? denom : 1.0f;
      // the sign of safe where a sign test can reject for the division, else 0
      sf[10] = fabsf(denom) <= kSureSafe ? (denom > 0.0f ? 1.0f : -1.0f) : 0.0f;
      s_box[slot] = box;
      s_id[slot] = id;
    }
    __syncthreads();
    if (c + 1 < chunks) {  // the next chunk's loads fly during this chunk's tests
      const int i = (c + 1) * kChunk + slot;
      id = i < n ? bin[i] : -1;
      if (q < 3 && i < n) {
        const float* p = img_fv + (size_t)max(id, 0) * 9 + q * 3;
        v = make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
      }
    }
    unsigned live = live_faces(s_box[lane], rect);
    while (live) {  // the faces that meet the rectangle, in bin order
      const int f = __ffs(live) - 1;
      live &= live - 1;
      const float* s = s_face + f * kFaceLanes;
      const float x0 = s[0], y0 = s[1], z0 = s[2];
      const float x1 = s[3], y1 = s[4], z1 = s[5];
      const float x2 = s[6], y2 = s[7], z2 = s[8];
      const float safe = s[9], sgn = s[10];
      const int fid = s_id[f];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float e0 = edge(x1, y1, x2, y2, px.x, px.ys[k]);
        const float e1 = edge(x2, y2, x0, y0, px.x, px.ys[k]);
        const float e2 = edge(x0, y0, x1, y1, px.x, px.ys[k]);
        // some w_i = e_i / safe is surely negative: outside, no division
        const float t = fminf(fminf(__fmul_rn(sgn, e0), __fmul_rn(sgn, e1)),
                              __fmul_rn(sgn, e2));
        if (t <= -kSureE) continue;  // the division skip
        const float w0 = __fdiv_rn(e0, safe);
        const float w1 = __fdiv_rn(e1, safe);
        const float w2 = __fdiv_rn(e2, safe);
        const float z = __fadd_rn(
            __fadd_rn(__fmul_rn(w0, z0), __fmul_rn(w1, z1)), __fmul_rn(w2, z2));
        if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && z < px.best[k]) {
          px.best[k] = z;
          px.win[k] = fid;
        }
      }
    }
  }

  const int Wp = TX * kTileCols;
  const int Hp = (gridDim.x / TX) * kTileRows;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tile_pixel(k);
    const size_t o = ((size_t)b * Hp + ty * kTileRows + p / kTileCols) * Wp +
                     tx * kTileCols + p % kTileCols;
    p2f[o] = px.win[k];
    zbuf[o] = px.best[k];
  }
}

}  // namespace

extern "C" {

// The grid covers the T = (Hp / 8) * TX real tiles of each image; bins
// and counts have Tp >= T tile rows (the rest are padding).
int smirk_raster_bins_coverage(const void* counts, const void* bins,
                               const void* fv, void* p2f, void* zbuf, int B,
                               int Tp, int T, int C, int F, int H, int W,
                               int TX, float grid_radius, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T > Tp || T % TX) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  dim3 grid(T, B);
  raster_bins_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const int32_t*)bins, (const float*)fv,
      (int32_t*)p2f, (float*)zbuf, Tp, C, F, H, W, TX, grid_radius);
  return (int)cudaGetLastError();
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
