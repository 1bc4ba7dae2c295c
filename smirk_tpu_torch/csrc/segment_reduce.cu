// K7 segment_reduce_tiles: per-(tile, slot) sums of a per-pixel payload,
// the backward reduction of interpolate_attributes_fast.
//
// Replaces _segment_reduce_kernel (via segment_reduce_tiles) in
// smirk_tpu/render/rasterizer.py. On the TPU that is a one-hot matmul per
// slot chunk on the MXU, because the TPU has no scatter. Here a block owns
// one range of slots (and, past 128 channels, one channel group) of one
// 8x128 tile of one image, with the range's rows of accumulators in
// dynamic shared memory; it adds each pixel's payload row whose slot falls
// in its range into that slot's row with shared-memory atomics, then
// stores the rows. Slots that won nothing stay 0; slots outside [0, C) are
// dropped. The float order of the atomics varies from run to run, so the
// result is compared with the plain version within a tolerance, not
// bitwise.
//
// Bound on H100: bytes. At batch 32, 224 px, C=512, CHN=36 the output
// alone is 132 MB (~0.04 ms at 3.35 TB/s); the contract needs the slots
// (7.3 MB) and only the payload rows whose slot is in [0, C) (the covered
// pixels and the tile grid's padding, whose rows are zero), not all 264 MB
// of payload. What the design does about each limit:
//   * the store: a block's rows are a contiguous run of the output (176
//     slots x 36 channels, 25 KB at C=512), stored in float4 pieces, so
//     every 128-byte line is written whole by one block. Splitting the
//     channels instead (3 groups of 12) had each block write 48 of every
//     144-byte row, and a launch whose pixels read no row at all (every
//     slot -1: zero fill, slot reads and store alone) took 0.138 ms for
//     132 MB (tools/torch_launch_bounds_sweep.py --kernel reduce);
//   * rows the contract never needs: the block reads the tile's 1024 slots
//     once, one 16-byte load a thread, and lists in shared memory the
//     pixels whose slot is in its range (a prefix sum over the block);
//     only their payload rows are loaded. On the op path most pixels are
//     background (slot -1), whose rows no block reads, and each row in
//     [0, C) is read by exactly one block;
//   * residency: a block's accumulators are sized for it, not for fit
//     (rasterizer._reduce_blocks): at most 32 KB, so 6-8 blocks share an
//     SM and one block's store overlaps the others' loads and atomics (one
//     block of all 512 x 36 held 74 KB, 3 an SM, its zero fill,
//     accumulation and store in series). The grid's x is the range, so a
//     tile's blocks run together and share its slots in L2;
//   * loads and atomics: width / 4 lanes take one listed pixel's row (36
//     channels: 9 lanes, 3 pixels a warp step) in 16-byte pieces; a lane's
//     piece and its share of the list are fixed once per thread, and no
//     element pays an integer division. Each group of lanes walks a
//     contiguous share of the list (pixel order), summing a row in
//     registers while its slot repeats (the neighbouring pixels of one
//     face) and adding it to the accumulators when the slot changes (an
//     atomic for every entry's row took 0.141 ms against 0.110). The
//     groups of a warp step lie a third of the list apart, on different
//     faces, so their atomics rarely hit one row at once. Two entries'
//     rows are loaded before they are summed (four spill more registers at
//     6 blocks an SM, one leaves too few loads in flight), and a zero adds
//     no atomic.
// A width that is not a multiple of 4 channels takes 4-byte pieces, one
// lane a channel (at most 32). Where the accumulators pass 48 KB the
// launch opts in to the device's limit with cudaFuncSetAttribute.
// What is left, at ~0.11 ms against the ~0.07 ms the bytes need: the
// store (0.054 ms alone, ~2.6 TB/s), then the rows' loads and the atomics;
// a block runs its zero fill, loads, atomics and store in series, and 6
// blocks an SM overlap them only in part.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTilePix = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kTilePix / kThreads;  // 4: one int4 of slots
constexpr int kSteps = 2;  // entries whose rows fly before they are summed
constexpr int kPixBits = 10;  // a list entry: local slot << 10 | pixel
constexpr size_t kDefaultShared = 48 * 1024;

template <int V>
struct Piece;  // V consecutive floats: a float4 or one float
template <>
struct Piece<4> {
  float4 v;
  __device__ __forceinline__ static Piece zero() { return {make_float4(0.f, 0.f, 0.f, 0.f)}; }
  __device__ __forceinline__ static Piece ldg(const float* p) {  // read-only global
    return {__ldg(reinterpret_cast<const float4*>(p))};
  }
  __device__ __forceinline__ static Piece lds(const float* p) {  // shared
    return {*reinterpret_cast<const float4*>(p)};
  }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = v; }
  __device__ __forceinline__ void add(const Piece& o) {
    v.x += o.v.x;
    v.y += o.v.y;
    v.z += o.v.z;
    v.w += o.v.w;
  }
  __device__ __forceinline__ void add_to(float* a) const {  // a zero adds no atomic
    if (v.x != 0.0f) atomicAdd(a, v.x);
    if (v.y != 0.0f) atomicAdd(a + 1, v.y);
    if (v.z != 0.0f) atomicAdd(a + 2, v.z);
    if (v.w != 0.0f) atomicAdd(a + 3, v.w);
  }
};
template <>
struct Piece<1> {
  float v;
  __device__ __forceinline__ static Piece zero() { return {0.0f}; }
  __device__ __forceinline__ static Piece ldg(const float* p) { return {__ldg(p)}; }
  __device__ __forceinline__ static Piece lds(const float* p) { return {*p}; }
  __device__ __forceinline__ void store(float* p) const { *p = v; }
  __device__ __forceinline__ void add(const Piece& o) { v += o.v; }
  __device__ __forceinline__ void add_to(float* a) const {
    if (v != 0.0f) atomicAdd(a, v);
  }
};

// The block's exclusive prefix of `count` over its threads in order, and
// the total. s_warp holds kWarps ints.
__device__ __forceinline__ int block_prefix(int count, int* s_warp, int& total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    if (w < warp) before += t;
    total += t;
  }
  return before + incl - count;
}

// 6 blocks an SM (<= 40 registers a thread) timed fastest of none and 4-8
// (tools/torch_launch_bounds_sweep.py --kernel reduce)
template <int V>
__global__ void __launch_bounds__(kThreads, 6)
segment_reduce_kernel(const int32_t* __restrict__ slots,    // (B, Tp, 1024)
                      const float* __restrict__ payload,    // (B, Tp, 1024, CHN)
                      float* __restrict__ out,              // (B, Tp, C, CHN)
                      int Tp, int C, int CHN, int group, int span) {
  extern __shared__ float4 smem[];  // span * group accumulators, then the list
  __shared__ int s_warp[kWarps];
  const int groups = (CHN + group - 1) / group;
  const int ch0 = (blockIdx.x % groups) * group;
  const int width = min(group, CHN - ch0);
  const int s0 = (blockIdx.x / groups) * span;  // the block's slots [s0, s0 + rows)
  const int rows = min(span, C - s0);
  const size_t tile = (size_t)blockIdx.z * Tp + blockIdx.y;
  float* acc = reinterpret_cast<float*>(smem);
  int* list = reinterpret_cast<int*>(acc + (size_t)span * group);
  const int lanes = width / V;  // lanes a pixel's row takes, <= 32
  const int pieces = rows * lanes;

  // the tile's slots, one 16-byte load a thread, while the rows are zeroed
  const int4 sv = __ldg(reinterpret_cast<const int4*>(slots + tile * kTilePix) + threadIdx.x);
  for (int i = threadIdx.x; i < pieces; i += kThreads) Piece<V>::zero().store(acc + i * V);
  const int local[kPixPerThread] = {sv.x - s0, sv.y - s0, sv.z - s0, sv.w - s0};
  int count = 0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) count += (unsigned)local[k] < (unsigned)rows;
  int n;
  int at = block_prefix(count, s_warp, n);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {  // the pixels of the range, in pixel order
    if ((unsigned)local[k] < (unsigned)rows)
      list[at++] = local[k] << kPixBits | (threadIdx.x * kPixPerThread + k);
  }
  __syncthreads();

  // lane group g = sub * kWarps + warp walks entries [g * len, g * len +
  // len) of the list in order, so the per_warp groups of a warp step are
  // kWarps * len entries apart; a row's values are summed in registers
  // while the slot repeats (neighbouring pixels of one face) and added to
  // the accumulators when it changes
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int piece = lane % lanes;
  const int sub = lane / lanes;
  const int per_warp = 32 / lanes;
  const int len = (n + per_warp * kWarps - 1) / (per_warp * kWarps);
  const int first = sub < per_warp ? (sub * kWarps + warp) * len : n;
  const int last = min(first + len, n);
  const float* pl = payload + tile * kTilePix * CHN + ch0 + piece * V;
  Piece<V> run = Piece<V>::zero();
  int run_to = -1;  // the run's place in the accumulators, -1 none
  for (int e0 = first; e0 < last; e0 += kSteps) {
    int pix[kSteps], to[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int ent = e0 + u < last ? list[e0 + u] : -1;
      pix[u] = ent & ((1 << kPixBits) - 1);
      to[u] = ent >= 0 ? ((ent >> kPixBits) * lanes + piece) * V : -1;
    }
    Piece<V> v[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      v[u] = to[u] >= 0 ? Piece<V>::ldg(pl + (size_t)pix[u] * CHN) : Piece<V>::zero();
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (to[u] < 0) continue;
      if (to[u] != run_to) {
        if (run_to >= 0) run.add_to(acc + run_to);
        run = v[u];
        run_to = to[u];
      } else {
        run.add(v[u]);
      }
    }
  }
  if (run_to >= 0) run.add_to(acc + run_to);
  __syncthreads();

  float* o = out + (tile * C + s0) * CHN + ch0;
  if (width == CHN) {  // one group: the block's rows are one contiguous run
    for (int i = threadIdx.x; i < pieces; i += kThreads) {
      Piece<V>::lds(acc + i * V).store(o + i * V);
    }
  } else {  // row s of the group at o + s * CHN; a thread keeps its piece
    const int per_pass = kThreads / lanes;
    const int r = threadIdx.x / lanes;
    const int pc = threadIdx.x - r * lanes;
    if (r < per_pass) {
      for (int s = r; s < rows; s += per_pass) {
        Piece<V>::lds(acc + (s * lanes + pc) * V).store(o + (size_t)s * CHN + pc * V);
      }
    }
  }
}

template <int V>
int launch(const void* slots, const void* payload, void* out, int B, int Tp, int C,
           int CHN, int group, int span, cudaStream_t stream) {
  const size_t shared = (size_t)span * group * sizeof(float) + kTilePix * sizeof(int);
  if (shared > kDefaultShared) {
    cudaError_t err = cudaFuncSetAttribute(segment_reduce_kernel<V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  // the slot ranges and channel groups of a tile on x, the group fastest
  dim3 grid(((C + span - 1) / span) * ((CHN + group - 1) / group), Tp, B);
  segment_reduce_kernel<V><<<grid, kThreads, shared, stream>>>(
      (const int32_t*)slots, (const float*)payload, (float*)out, Tp, C, CHN, group, span);
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

// group: channels per block, span: slots per block
// (rasterizer._reduce_blocks); the grid's x extent is ceil(C / span) x
// ceil(CHN / group). float4 pieces where CHN and group are multiples of 4
// (the payload 16-byte aligned, as the wrapper checks), else 4-byte
// pieces; a row of the group takes at most 32 lanes. The slots must be
// 16-byte aligned.
int smirk_segment_reduce_tiles(const void* slots, const void* payload,
                               void* out, int B, int Tp, int C, int CHN,
                               int group, int span, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (group < 1 || group > CHN || span < 1 || span >= (1 << (31 - kPixBits)) ||
      Tp > 65535 || B > 65535 || (uintptr_t)slots % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tp == 0 || C == 0) return 0;
  const bool vec = CHN % 4 == 0 && group % 4 == 0 && (uintptr_t)payload % 16 == 0;
  if (group > (vec ? 4 : 1) * 32) return (int)cudaErrorInvalidValue;
  return vec ? launch<4>(slots, payload, out, B, Tp, C, CHN, group, span,
                         (cudaStream_t)stream)
             : launch<1>(slots, payload, out, B, Tp, C, CHN, group, span,
                         (cudaStream_t)stream);
}

const char* smirk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
