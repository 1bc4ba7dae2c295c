// K4 segment_moments: the differentiable raster's backward reduction. For
// each (tile, slot), the sums [sum g*x | sum g*y | sum g] over the pixels
// that slot won, with x, y the pixel centres in NDC built in the kernel.
//
// Replaces _segment_moments_kernel (via segment_reduce_moments) in
// smirk_tpu/render/rasterizer.py. On the TPU that is a one-hot matmul per
// 128-slot chunk on the MXU, because the TPU has no scatter, and a second
// kernel (_fold_kernel, K5 here) folds the per-slot table into faces. Here
// a block owns one 8x128 tile of one image and one group of the 3D output
// channels: the tile's C x (group width) accumulators live in dynamic
// shared memory (13.8 KB at C=384, D=3), beside the tile's 128 x and 8 y
// pixel centres (built once a block, with the plain version's IEEE
// operations). The threads walk the tile's 1024 pixels, four each in one
// column, their slots loaded before the walk and g read in it. A warp's
// 32 pixels of a step lie on one row; the lanes on one slot
// (__match_any_sync) sum their moments of the group with shuffles, and
// the lowest of them atomicAdds the nonzero sums into the slot's row:
// shared-memory float atomics are compare-and-swap loops on sm_90, so no
// two atomics of a warp instruction share an address. Slots that won nothing stay 0. Pixels of the padding band may
// hold live slots; their g is 0, and so are their sums. 6 blocks an SM
// (tools/torch_launch_bounds_sweep.py --kernel moments). Two epilogues, a
// template parameter:
//
// * store (segment_moments, the JAX function's contract): the block stores
//   its C rows in one coalesced pass -> (B, Tp, C, 3D);
// * fold (segment_moments_to_faces, what the training backward runs): the
//   walk also marks, one byte a slot, the slots a pixel reached; each warp
//   then reads 32 of the tile's bin ids at once (coalesced, only where
//   marked), lists the marked slots whose id lies in [0, F) and adds their
//   nonzero sums into the zeroed face table out[b, id, ch0:ch1] with
//   global atomics whose result is unused (fire-and-forget reductions).
//   A face sits in at most one slot of a tile, so these collide only
//   across the few tiles a face spans. The per-slot table is never
//   written -> (B, F, 3D).
//
// Shared memory past the default 48 KB (C x 3D x 4 bytes, e.g. 55 KB at
// C=768, D=6) is opted into with cudaFuncSetAttribute up to the device's
// limit (227 KB on H100); past that the wrapper splits the 3D channels
// into groups over blockIdx.z. The float order of the atomics varies from
// run to run, so the result is compared with the plain version within a
// tolerance.
//
// Bound on H100: bytes. At batch 32, 224 px, C=384, D=3 the store reads
// the slots (7.3 MB) and the tile-major cotangent at the live pixels and
// writes the per-slot rows (24.8 MB); the fold reads the slots, the
// cotangent at the live pixels (~5.3 MB), the bin ids of the slots a pixel
// reached (~0.5 MB; it reads no other) and writes the face table
// (3.9 MB): ~17 MB, ~5 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTilePix = kTileRows * kTileCols;  // 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kTilePix / kThreads;  // 4, one column
constexpr size_t kDefaultShared = 48 * 1024;
// static shared bytes: the tile's pixel centres; the fold epilogue's
// per-warp list of marked slots and their face ids
constexpr size_t kCentresStatic = (kTileCols + kTileRows) * sizeof(float);
constexpr size_t kFoldStatic = 2 * kWarps * 32 * sizeof(int);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSteps = 5;  // tree steps over up to 32 peers

__device__ __forceinline__ float ndc(int i, int size) {
  const float s = (float)size;
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f), s), s);
}

// bytes of the fold's per-slot marks, a whole number of words
__host__ __device__ __forceinline__ int mark_bytes(int C) { return (C + 3) / 4 * 4; }

template <bool kFold>
__global__ void __launch_bounds__(kThreads, 6)
segment_moments_kernel(const int32_t* __restrict__ slots,
                       const float* __restrict__ g,        // (B, Tp, 1024, D)
                       const int32_t* __restrict__ bins,   // (B, Tp, C), fold
                       float* __restrict__ out,  // store (B,Tp,C,3D); fold (B,F,3D)
                       int Tp, int C, int D, int group, int H, int W, int TX,
                       int F) {
  extern __shared__ float acc[];  // C * width, then the fold's marks
  __shared__ float centre[kTileCols + kTileRows];  // x of the columns, y of the rows
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int CHN = 3 * D;
  const int ch0 = blockIdx.z * group;
  const int ch1 = min(ch0 + group, CHN);
  const int width = ch1 - ch0;
  const size_t tile = (size_t)b * Tp + t;
  const int n = C * width;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  unsigned char* marked = reinterpret_cast<unsigned char*>(acc + n);

  // the thread's 4 slots (one column, rows r, r + 2, ...)
  const int32_t* sp = slots + tile * kTilePix + threadIdx.x;
  int s[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) s[k] = sp[k * kThreads];

  // the tile's pixel centres, with the plain version's IEEE operations
  const int ty = t / TX;
  const int tx = t % TX;
  if (threadIdx.x < kTileCols)
    centre[threadIdx.x] = ndc(threadIdx.x + tx * kTileCols, W);
  else if (threadIdx.x < kTileCols + kTileRows)
    centre[threadIdx.x] = ndc(threadIdx.x - kTileCols + ty * kTileRows, H);
  for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.0f;
  if (kFold)
    for (int i = threadIdx.x; i < mark_bytes(C) / 4; i += kThreads)
      reinterpret_cast<int*>(marked)[i] = 0;
  __syncthreads();

  const float x = centre[threadIdx.x % kTileCols];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    // a warp's 32 pixels of step k lie on one row of the tile
    const bool live = s[k] >= 0 && s[k] < C;
    if (__ballot_sync(kFull, live) == 0u) continue;
    const int p = threadIdx.x + k * kThreads;
    const float y = centre[kTileCols + p / kTileCols];
    float* row = acc + s[k] * width;
    if (kFold && live) marked[s[k]] = 1;  // every writer stores 1
    // lanes on one slot sum their moments first (a tree over the peers
    // in lane order, its steps taken once for all channels); the lowest
    // peer adds the sums, so a warp's atomics never share an address
    const unsigned peers = __match_any_sync(kFull, live ? s[k] : -1 - lane);
    const unsigned below = (1u << lane) - 1u;
    const bool leader = live && (peers & below) == 0u;
    int rank = __popc(peers & below);
    unsigned above = peers & ~below & ~(1u << lane);
    int src[kMaxSteps];
    int steps = 0;
#pragma unroll
    for (int i = 0; i < kMaxSteps; ++i) {
      if (!__any_sync(kFull, above != 0u)) break;
      src[i] = __ffs(above) - 1;  // -1: nothing above
      above &= ~__ballot_sync(kFull, rank & 1);
      rank >>= 1;
      steps = i + 1;
    }
    const float* gp = g + (tile * kTilePix + p) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float gv = live ? gp[d] : 0.0f;
      float m[3] = {__fmul_rn(gv, x), __fmul_rn(gv, y), gv};
#pragma unroll
      for (int i = 0; i < kMaxSteps; ++i) {
        if (i >= steps) break;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float up = __shfl_sync(kFull, m[j], src[i] < 0 ? lane : src[i]);
          if (src[i] >= 0) m[j] = __fadd_rn(m[j], up);
        }
      }
      if (!leader) continue;
      // output channels d, D + d, 2D + d: [g*x | g*y | g]
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ch = j * D + d;
        if (ch >= ch0 && ch < ch1 && m[j] != 0.0f) atomicAdd(row + ch - ch0, m[j]);
      }
    }
  }
  __syncthreads();

  if constexpr (!kFold) {
    float* o = out + tile * C * CHN + ch0;
    if (width == CHN) {
      for (int i = threadIdx.x; i < n; i += kThreads) o[i] = acc[i];
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int sl = i / width;
        o[(size_t)sl * CHN + (i - sl * width)] = acc[i];
      }
    }
  } else {
    __shared__ int list_slot[kWarps][32];
    __shared__ int list_id[kWarps][32];
    const int32_t* brow = bins + tile * C;
    float* faces = out + (size_t)b * F * CHN + ch0;
    for (int base = warp * 32; base < C; base += kThreads) {
      const int sl = base + lane;
      const int id = sl < C && marked[sl] ? brow[sl] : -1;
      const bool keep = id >= 0 && id < F;
      const unsigned kept = __ballot_sync(kFull, keep);
      if (kept == 0) continue;
      if (keep) {
        const int r = __popc(kept & ((1u << lane) - 1u));
        list_slot[warp][r] = sl;
        list_id[warp][r] = id;
      }
      __syncwarp();
      const int m = __popc(kept) * width;
      for (int e = lane; e < m; e += 32) {
        const int r = e / width;
        const int c = e - r * width;
        const float v = acc[list_slot[warp][r] * width + c];
        if (v != 0.0f) atomicAdd(faces + (size_t)list_id[warp][r] * CHN + c, v);
      }
      __syncwarp();
    }
  }
}

template <bool kFold>
int launch(const void* slots, const void* g, const void* bins, void* out, int B,
           int Tp, int C, int D, int group, int H, int W, int TX, int F,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || group < 1 || group > 3 * D) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0 || C == 0) return 0;
  const size_t shared = (size_t)C * group * sizeof(float) + (kFold ? mark_bytes(C) : 0);
  if (shared + kCentresStatic + (kFold ? kFoldStatic : 0) > kDefaultShared) {
    err = cudaFuncSetAttribute(segment_moments_kernel<kFold>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Tp, B, (3 * D + group - 1) / group);
  segment_moments_kernel<kFold><<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const float*)g, (const int32_t*)bins, (float*)out,
      Tp, C, D, group, H, W, TX, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int smirk_max_shared_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// group: output channels per block (the wrapper's split of 3D); the grid's
// z extent is ceil(3D / group).
int smirk_segment_moments(const void* slots, const void* g, void* out, int B,
                          int Tp, int C, int D, int group, int H, int W,
                          int TX, int device, void* stream) {
  return launch<false>(slots, g, nullptr, out, B, Tp, C, D, group, H, W, TX, 0,
                       device, stream);
}

// The fold epilogue: `out` (B, F, 3D) must be zeroed; bins (B, Tp, C).
int smirk_segment_moments_to_faces(const void* slots, const void* g,
                                   const void* bins, void* out, int B, int Tp,
                                   int C, int D, int group, int H, int W,
                                   int TX, int F, int device, void* stream) {
  return launch<true>(slots, g, bins, out, B, Tp, C, D, group, H, W, TX, F,
                      device, stream);
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
