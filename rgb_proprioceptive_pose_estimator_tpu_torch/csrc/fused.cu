// Hand-written Hopper kernels for the memory-bound Pallas kernels, the
// scale-bias-ReLU gradient and the epilogue of training BatchNorm. Built for
// sm_90a by ops/_build.py with nvcc into a shared library with a plain C
// interface; ops/fused.py binds it with ctypes.
//
// rppe_normalize_u8 replaces rgb_proprioceptive_pose_estimator_tpu/ops/
//   pallas_fused.py:pallas_normalize_u8 (body _normalize_kernel):
//   uint8 (..., C) -> f32 or bf16, y = x * scale[c] + shift[c] in f32.
// rppe_scale_bias_relu replaces rgb_proprioceptive_pose_estimator_tpu/ops/
//   pallas_fused.py:scale_bias_relu (forward, body _sbr_kernel):
//   x (M, C), channels innermost -> relu(x * scale[c] + bias[c]), x's dtype.
//
// Both are bound by device-memory bytes: every input byte is read once and
// every output byte written once, and there are two flops per element, so
// the least time on an H100 is bytes / 3.35 TB/s. The TPU kernels viewed the
// data as (rows, lcm(C, 128)) lanes to broadcast the per-channel constants.
// The first design here kept one channel per thread and moved one element
// per access (a warp load moved 32 bytes of K1's input, 64 or 128 of K2's),
// and reached 43-66% of the bound: load instructions, not bytes, set the
// pace, as they did in the reductions below. This design moves 16 bytes per
// access and keeps each thread's constants fixed, so they sit in registers
// and no index is divided inside a loop:
//   - rppe_scale_bias_relu: the reductions' mapping (block (tx, ty), grid
//     (tiles, groups), planned by ops/fused.py _sbr_forward_plan). A thread
//     owns a chunk of V neighbouring channels (V = 4 f32 as float4, 8 bf16
//     as uint4), loads their scales and biases once, and walks rows ty
//     apart in its block's group with U = 4 rows of loads in flight before
//     the stores; offsets inside a group are 32-bit.
//   - rppe_normalize_u8: a thread reads 16 input bytes as one uint4 and
//     writes 16 outputs as four float4 or two uint4 of bf16 (a warp passes
//     its 512 bytes through shared memory, so that each store instruction
//     writes 512 contiguous bytes). The loop stride, in 16-byte chunks, is
//     a multiple of 32 and of nstats / gcd(16, nstats), so a thread's phase
//     in the period of constants is fixed and its 16 scale and shift pairs
//     are gathered into registers once (planned by ops/fused.py
//     _normalize_plan).
// Where C is not a multiple of V, or a pointer is not 16-byte aligned, the
// same kernels run one element per access (K2 with V = 1; K1's one-element
// loop over the whole tensor), and K1's one-element loop also takes the
// n % 16 elements past the last whole chunk, in the same launch.
//
// Both round x*s + b twice, __fmul_rn then __fadd_rn, as the plain versions
// do (nvcc would otherwise contract it into one fused multiply-add), so each
// equals its plain version exactly and K2's ReLU decision is its backward's
// mask bit for bit. K2's ReLU writes pre unless pre <= 0, so NaN stays NaN,
// as in torch.clamp_min and jnp.maximum (fmaxf would return 0).
//
// What is left for later: fusing the epilogue into the convolution that
// writes x, which would save a whole read and write of the activation; and
// the BasicBlock's residual add + ReLU, still plain torch.
//
// Two per-channel reductions of the training path follow, both over
// x (m, c) with channels innermost:
//
// rppe_channel_stats replaces rgb_proprioceptive_pose_estimator_tpu/ops/
//   pallas_fused.py:144 channel_stats (body _channel_stats_kernel):
//   per-channel f32 (sum x, sum x^2) in one read of x.
// rppe_scale_bias_relu_backward replaces the VJP of pallas_fused.py:
//   scale_bias_relu, pallas_fused.py:243 _sbr_bwd (XLA inside the kernel's
//   custom_vjp): with
//   mask = x*scale + bias > 0, dx = g*mask*scale in x's dtype, and the f32
//   per-channel sums dscale = sum g*mask*x and dbias = sum g*mask, in one
//   read of x and g.
//
// Both are bound by device-memory bytes (a few flops per element: the
// least time on an H100 is bytes / 3.35 TB/s). The TPU kernel carried its
// sums in VMEM scratch from one sequential grid step to the next; blocks on
// the card run in parallel and in no order.
//
// The first design of these two (two stages: a partial kernel with one
// channel per thread, then fold_partials_kernel, one block per channel)
// reached 34% of the bound for channel_stats in f32, 15% in bf16 (slower
// than f32), and 41-61% for the backward, on an H100 at pr3's shapes. It
// lost time in three places, and this design answers each:
//   1. One 4- or 2-byte access per thread: a warp moved 128 or 64 bytes per
//      load, so load instructions, not bytes, set the pace. Here a thread
//      owns V neighbouring channels and moves 16 bytes per access (V = 4
//      f32 as float4, V = 8 bf16 as uint4, converted two at a time with
//      __bfloat1622float2); the backward stores dx 16 bytes at a time too.
//      At C = 64 in f32 a warp reads two whole rows, 512 contiguous bytes.
//   2. Two launches per call, the second reading its partials with a stride
//      of c between neighbouring threads. Here one launch does it all: each
//      block writes its partials, fences, and takes a ticket with an integer
//      atomicAdd; the block of a channel tile that draws the tile's last
//      ticket folds that tile's partials over the row groups, threads over
//      channels (coalesced), and resets the ticket to 0. One thread of a
//      block fences (fence.acq_rel.gpu) on each side of the ticket, not
//      every writer (a fence.sc each, as __threadfence() is).
//   3. One dependent load per loop trip, with a 64-bit multiply per element.
//      Here each thread issues U independent 16-byte loads (U = 8 rows for
//      channel_stats, 4 rows of x and of g for the backward) before it
//      accumulates, and indexes with 32-bit offsets inside its block's rows.
// Only the ticket is atomic: each partial is summed in a fixed order (rows
// in order in a thread, then an xor-shuffle pattern within the warp, then
// warps in order), and the last block folds the groups in a fixed order, so
// two launches on one card give bitwise-equal sums whichever block ends
// last. Where C is not a multiple of V, or a pointer is not 16-byte
// aligned, the same kernels run with V = 1. The mask of the backward is
// computed as round(round(x*scale) + bias), without the fused multiply-add,
// so that it is the plain version's mask (and the forward's ReLU decision)
// bit for bit, and g is multiplied by it, as _sbr_bwd does, not selected: a
// NaN or inf g at a masked element gives NaN in dx and in its channel's sums.
//
// The tickets are the caller's: ops/fused.py keeps one zeroed int32 buffer
// per device and stream. Launches on one stream run one after another, and
// each leaves its tickets at 0; two launches that ran at once on two
// streams with one buffer would mix their tickets, which is why the buffer
// is per stream.
//
// Three kernels carry the epilogue of training BatchNorm (ops/fused_bn.py,
// the bn_stats "matmul" and "pallas" routes), with the ReLU (Act) or
// without. In the JAX package this epilogue is XLA, not Pallas: they are a
// design for the card, not a port. Written in plain torch, the epilogue
// made about 15 passes over the activation, each an f32 tensor of its size
// (about 28 bytes an element forward and 74 backward); these move 4 bytes
// an element forward and 10 backward in bf16:
//   - rppe_bn_affine_act: y = act(x*scale + bias) in x's dtype, K2's forward
//     with the ReLU a template flag (the same body, so the same bits).
//   - rppe_bn_act_sums: the backward's first pass, in one read of x and g:
//     with gm = g where round(round(x*scale) + bias) > 0 (Act), else 0, or
//     gm = g (no Act), the f32 per-channel sums sum(gm) and sum(gm*x). It is
//     the K2 backward's mapping, ticket fold and fixed summation order
//     without the dx store, so the sums repeat bit for bit. A rank of a
//     data-parallel group sums them over the ranks before the second pass,
//     which is why the backward is two launches: x and g of the largest
//     site are far larger than the 50 MB L2, so one cooperative launch
//     would read them twice from device memory all the same.
//   - rppe_bn_act_dx: the second pass: dx = gm*a + x*b + c in f32, written
//     in x's dtype, with the closed form's per-channel a, b and c computed
//     in each thread's prologue from the sums, gamma, mean, inv and the
//     count n, every product, quotient and sum rounded once in the order
//     ops/fused.py's plain version computes them (no contracted FMA), so
//     that dx equals it bit for bit given the same sums. It walks rows as
//     K2's forward does, U = 4 rows of x and of g in flight; its 40
//     per-channel constants at V = 8 (a, b, c, and the mask's scale and
//     bias) leave room for one block of 512 threads per SM, not two, which
//     its plan (ops/fused.py _sbr_forward_plan at _DX_BLOCKS_PER_SM) sizes
//     the grid for.
// The mask is a select, as torch.relu's gradient (threshold_backward) is,
// not K2's multiply: a NaN or inf g where the ReLU is off gives 0 there.

#include <cstdint>
#include <cstring>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads of a rppe_normalize_u8 block, and the blocks of it an SM holds at
// once (ops/fused.py: _NORM_THREADS, _NORM_BLOCKS_PER_SM): the register cap
// of __launch_bounds__ keeps the planned grid resident in one wave.
constexpr int kNormThreads = 256;
constexpr int kNormBlocksPerSm = 3;
// Most per-channel constants rppe_normalize_u8 takes; ops/fused.py holds the
// same number as MAX_STATS.
constexpr int kMaxStats = 64;

struct NormalizeStats {
  float scale[kMaxStats];
  float shift[kMaxStats];
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// K2's forward and the two reductions walk x (m, c) by rows. A block of
// kRowThreads threads is tx x (kRowThreads / tx): threadIdx.x picks a chunk
// of V neighbouring channels, threadIdx.y a row slot. The grid is (tiles,
// groups): blockIdx.x picks a tile of tx chunks, blockIdx.y a group of
// rows_per_group neighbouring rows. The plan (V, tx, tiles, groups,
// rows_per_group) comes from ops/fused.py's _sbr_forward_plan or
// _reduction_plan.

constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
// blocks of K2's forward an SM holds at once (ops/fused.py
// _SBR_BLOCKS_PER_SM): the register cap of __launch_bounds__ keeps the
// planned grid resident in one wave
constexpr int kSbrBlocksPerSm = 2;
constexpr int kFoldUnroll = 16;  // partials a folding thread loads at once

// V channels of one row as one access: 16 bytes (float4 of f32, uint4 of
// eight bf16) for V > 1, one element for V = 1.
template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[1]) {
    f[0] = load_f32(&r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    store_f32(p, f[0]);
  }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], sizeof(h));
      const float2 v = __bfloat1622float2(h);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, sizeof(h));
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// x * s + b rounded twice, as the plain versions compute it: nvcc never
// contracts __fmul_rn and __fadd_rn into a fused multiply-add.
__device__ __forceinline__ float mul_add_rn(float x, float s, float b) {
  return __fadd_rn(__fmul_rn(x, s), b);
}

// The ReLU of torch.clamp_min(pre, 0) and jnp.maximum(pre, 0): NaN stays NaN
// (NaN <= 0 is false), +inf stays, -inf becomes 0.
__device__ __forceinline__ float relu_keep_nan(float pre) {
  return pre <= 0.0f ? 0.0f : pre;
}

// W input bytes as one shared-memory read: 4 (f32 outputs) or 8 (bf16).
template <int W>
struct Bytes;
template <>
struct Bytes<4> {
  using Raw = unsigned;
  static __device__ __forceinline__ unsigned byte(Raw v, int r) {
    return (v >> (8 * r)) & 0xffu;
  }
};
template <>
struct Bytes<8> {
  using Raw = uint2;
  static __device__ __forceinline__ unsigned byte(Raw v, int r) {
    return ((r < 4 ? v.x : v.y) >> (8 * (r % 4))) & 0xffu;
  }
};

// K1. The vector loop: thread t < vec_stride takes the 16-byte chunks t,
// t + vec_stride, ... below n_vec, U at a time, so a warp's lanes read 32
// neighbouring chunks, 512 bytes, with one uint4 load each. The warp stages
// them in shared memory and writes their outputs with Q = 4 (f32) or 2
// (bf16) stores of 16 bytes per lane, store q of lane l taking input bytes
// q * 32 W + l W .. + W of the 512: each store instruction writes 512
// contiguous bytes. (Each lane writing the outputs of its own chunk would
// put neighbouring lanes 64 or 32 bytes apart, so that every store
// instruction half-filled its 32-byte sectors.) The one-element loop: the
// thread ts-th from the grid's end, ts < scalar_stride, takes the elements
// begin + ts, begin + ts + scalar_stride, ... below n, begin = 16 n_vec, U at
// a time. The host function checks that
// vec_stride is a multiple of 32 and of nstats / gcd(16, nstats), and
// scalar_stride one of nstats, so that warps are whole and each thread's
// constants are fixed in both loops.
template <typename Out>
__global__ void __launch_bounds__(kNormThreads, kNormBlocksPerSm)
normalize_u8_kernel(const uint8_t* __restrict__ x, Out* __restrict__ y,
                    int64_t n, int64_t n_vec, int vec_stride,
                    int scalar_stride, int nstats,
                    const __grid_constant__ NormalizeStats st) {
  constexpr int U = 4;                  // accesses in flight at once
  constexpr int W = 16 / sizeof(Out);   // outputs of one 16-byte store
  constexpr int Q = 16 / W;             // stores per 16 input bytes
  using OV = Vec<Out, W>;
  using In = typename Bytes<W>::Raw;
  __shared__ float scale_s[kMaxStats], shift_s[kMaxStats];
  __shared__ uint4 stage[kNormThreads];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < nstats) {
    scale_s[threadIdx.x] = st.scale[threadIdx.x];
    shift_s[threadIdx.x] = st.shift[threadIdx.x];
  }
  __syncthreads();
  // warp-uniform: vec_stride is a multiple of 32, so a warp is all in or
  // all out
  if (t - lane < vec_stride && t - lane < n_vec) {
    // the constants of the bytes this lane stores, the same on every trip
    // (32-bit: the host function keeps 16 * threads within INT_MAX)
    float s[Q][W], b[Q][W];
    const int base = 16 * (t - lane) + lane * W;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int k = (base + q * 32 * W) % nstats;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        s[q][r] = scale_s[k];
        b[q][r] = shift_s[k];
        k = k + 1 == nstats ? 0 : k + 1;
      }
    }
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint8_t* staged = reinterpret_cast<const uint8_t*>(
        stage + (threadIdx.x - lane));
    const int64_t step = vec_stride;
    for (int64_t i = t; i - lane < n_vec; i += U * step) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * step < n_vec) raw[u] = xv[i + u * step];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t first = i - lane + u * step;   // the warp's first chunk
        if (first < n_vec) {                          // warp-uniform
          stage[threadIdx.x] = raw[u];
          __syncwarp();
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int off = q * 32 * W + lane * W;    // byte of the 512
            if (first + off / 16 < n_vec) {
              const In v = *reinterpret_cast<const In*>(staged + off);
              float f[W];
#pragma unroll
              for (int r = 0; r < W; ++r)
                f[r] = mul_add_rn(static_cast<float>(Bytes<W>::byte(v, r)),
                                  s[q][r], b[q][r]);
              OV::store(y + 16 * first + off, f);
            }
          }
          __syncwarp();                               // stage is reused
        }
      }
    }
  }
  // counted from the grid's last thread, so that the tail after the whole
  // chunks falls to threads the vector loop leaves idle where there are any
  const int ts = gridDim.x * blockDim.x - 1 - t;
  const int64_t begin = 16 * n_vec;
  if (ts < scalar_stride && begin + ts < n) {
    const int k = static_cast<int>((begin + ts) % nstats);
    const float s = scale_s[k];
    const float b = shift_s[k];
    const int64_t step = scalar_stride;
    for (int64_t e = begin + ts; e < n; e += U * step) {
      uint8_t raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u * step < n) raw[u] = x[e + u * step];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u * step < n)
          store_f32(y + e + u * step, mul_add_rn(static_cast<float>(raw[u]), s, b));
    }
  }
}

// K2's forward, and the training BatchNorm's with or without the ReLU: y =
// act(x * scale + bias). The thread's rows are row slot ty, ty + ty_count,
// ... of its block's group; offsets within the group fit in 32 bits
// (rows_per_group * c <= INT_MAX, checked by the host function).
template <typename T, int V, bool Act>
__device__ __forceinline__ void affine_act_rows(
    const T* __restrict__ x, T* __restrict__ y,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int64_t m, int c, int rows_per_group) {
  constexpr int U = 4;             // rows whose loads are in flight at once
  using VT = Vec<T, V>;
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk * V >= c) return;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * rows_per_group;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_group), m - row0));
  const int step = blockDim.y;
  float s[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = scale[chunk * V + i];
    b[i] = bias[chunk * V + i];
  }
  const int64_t at = row0 * c + chunk * V;
  const T* xb = x + at;
  T* yb = y + at;
  for (int r = threadIdx.y; r < rows; r += U * step) {
    typename VT::Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * step;
      if (rr < rows) raw[u] = VT::load(xb + rr * c);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * step;
      if (rr < rows) {
        float v[V];
        VT::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          v[i] = mul_add_rn(v[i], s[i], b[i]);
          if (Act) v[i] = relu_keep_nan(v[i]);
        }
        VT::store(yb + rr * c, v);
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads, kSbrBlocksPerSm)
scale_bias_relu_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, int64_t m, int c,
                       int rows_per_group) {
  affine_act_rows<T, V, true>(x, y, scale, bias, m, c, rows_per_group);
}

template <typename T, int V, bool Act>
__global__ void __launch_bounds__(kRowThreads, kSbrBlocksPerSm)
bn_affine_act_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, int64_t m, int c,
                     int rows_per_group) {
  affine_act_rows<T, V, Act>(x, y, scale, bias, m, c, rows_per_group);
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The end of both reductions, in every thread of the block: acc holds the
// thread's two sums for each of its V channels (acc[v] the first, acc[V + v]
// the second). The block folds them, in a fixed order, into one partial per
// channel of its tile and writes it to part (2, groups, c); the block of the
// tile that takes the last ticket folds the tile's partials over the groups,
// in a fixed order, into out0 and out1, and resets the tile's ticket to 0.
template <int V>
__device__ __forceinline__ void finish_reduction(
    float (&acc)[2 * V], int c, float* __restrict__ part,
    int* __restrict__ tickets, float* __restrict__ out0,
    float* __restrict__ out1) {
  __shared__ float red[(kRowWarps * 32 * 2 * V > kRowThreads)
                           ? kRowWarps * 32 * 2 * V : kRowThreads];
  __shared__ bool is_last;
  const int tx = threadIdx.x;
  const int t = threadIdx.y * blockDim.x + tx;
  const int lane = t % 32, warp = t / 32;
  const int groups = gridDim.y;
  const int tile_ch = blockDim.x * V;                 // channels of a tile
  const int ch0 = blockIdx.x * tile_ch;
  // 1. the row slots of a warp that share a chunk (lanes equal mod tx)
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) {
    for (int off = blockDim.x; off < 32; off <<= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (lane < static_cast<int>(blockDim.x)) {
#pragma unroll
    for (int k = 0; k < 2 * V; ++k) red[(warp * blockDim.x + tx) * 2 * V + k] = acc[k];
  }
  __syncthreads();
  // 2. across the warps in warp order: one thread per (sum, channel)
  if (t < 2 * tile_ch) {
    const int q = t / tile_ch, lc = t % tile_ch;
    const int k = q * V + lc % V;
    const int chunk = lc / V;
    float s = 0.0f;
    for (int w = 0; w < kRowWarps; ++w) s += red[(w * blockDim.x + chunk) * 2 * V + k];
    if (ch0 + lc < c)
      part[(static_cast<int64_t>(q) * groups + blockIdx.y) * c + ch0 + lc] = s;
  }
  // The block's partials, ordered before thread 0's fence by the barrier,
  // are visible to every block before the ticket is taken (release); the
  // block that takes the last ticket sees every block's partials after its
  // own fence and barrier (acquire), and reads them from L2 (__ldcg).
  __syncthreads();
  if (t == 0) {
    fence_acq_rel_gpu();
    is_last = atomicAdd(&tickets[blockIdx.x], 1) == groups - 1;
    if (is_last) {
      fence_acq_rel_gpu();
      tickets[blockIdx.x] = 0;           // ready for the next launch
    }
  }
  __syncthreads();
  if (!is_last) return;
  // 3. the last block of the tile: thread (slice, pair) sums the groups
  // slice, slice + slices, ... in order; then the slices fold in order
  const int pairs = 2 * tile_ch;                      // a power of two <= 512
  const int slices = kRowThreads / pairs;
  const int p = t % pairs, slice = t / pairs;
  const int q = p / tile_ch, ch = ch0 + p % tile_ch;
  float s = 0.0f;
  if (ch < c) {
    const float* src = part + static_cast<int64_t>(q) * groups * c + ch;
    for (int g = slice; g < groups; g += kFoldUnroll * slices) {
      float v[kFoldUnroll];
#pragma unroll
      for (int i = 0; i < kFoldUnroll; ++i) {
        const int gi = g + i * slices;
        v[i] = gi < groups ? __ldcg(src + static_cast<int64_t>(gi) * c) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kFoldUnroll; ++i) s += v[i];
    }
  }
  __syncthreads();   // red is reused
  red[t] = s;
  __syncthreads();
  if (t < pairs && ch < c) {
    float total = 0.0f;
    for (int i = 0; i < slices; ++i) total += red[i * pairs + t];
    (q == 0 ? out0 : out1)[ch] = total;
  }
}

// Rows [row0, row0 + rows) of this block's group; the thread's rows are
// row slot ty, ty + ty_count, ...; offsets within the group fit in 32 bits
// (rows_per_group * c <= INT_MAX, checked by the host function).
template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
channel_stats_kernel(const T* __restrict__ x, int64_t m, int c,
                     int rows_per_group, float* __restrict__ part,
                     int* __restrict__ tickets, float* __restrict__ sum,
                     float* __restrict__ sumsq) {
  constexpr int U = 8;             // rows whose loads are in flight at once
  using VT = Vec<T, V>;
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * rows_per_group;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_group), m - row0));
  const int step = blockDim.y;
  float acc[2 * V];
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) acc[k] = 0.0f;
  if (chunk * V < c) {
    const T* base = x + row0 * c + chunk * V;
    for (int r = threadIdx.y; r < rows; r += U * step) {
      typename VT::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * step;
        if (rr < rows) raw[u] = VT::load(base + rr * c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step < rows) {
          float v[V];
          VT::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[i] += v[i];
            acc[V + i] += v[i] * v[i];
          }
        }
      }
    }
  }
  finish_reduction<V>(acc, c, part, tickets, sum, sumsq);
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
sbr_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, int64_t m, int c,
                    int rows_per_group, T* __restrict__ dx,
                    float* __restrict__ part, int* __restrict__ tickets,
                    float* __restrict__ dscale, float* __restrict__ dbias) {
  constexpr int U = 4;             // rows whose loads are in flight at once
  using VT = Vec<T, V>;
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * rows_per_group;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_group), m - row0));
  const int step = blockDim.y;
  float acc[2 * V];
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) acc[k] = 0.0f;
  if (chunk * V < c) {
    float s[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] = scale[chunk * V + i];
      b[i] = bias[chunk * V + i];
    }
    const int64_t at = row0 * c + chunk * V;
    const T* xb = x + at;
    const T* gb = g + at;
    T* db = dx + at;
    for (int r = threadIdx.y; r < rows; r += U * step) {
      typename VT::Raw rx[U], rg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * step;
        if (rr < rows) {
          rx[u] = VT::load(xb + rr * c);
          rg[u] = VT::load(gb + rr * c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * step;
        if (rr < rows) {
          float xv[V], gv[V], d[V];
          VT::unpack(rx[u], xv);
          VT::unpack(rg[u], gv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            // two roundings, as the plain version and the forward: the mask
            // is the same bit; a multiply, not a select, as _sbr_bwd, so a
            // NaN or inf g at a masked element gives NaN
            const float pre = mul_add_rn(xv[i], s[i], b[i]);
            const float gm = gv[i] * (pre > 0.0f ? 1.0f : 0.0f);
            d[i] = gm * s[i];
            acc[i] += gm * xv[i];
            acc[V + i] += gm;
          }
          VT::store(db + rr * c, d);
        }
      }
    }
  }
  finish_reduction<V>(acc, c, part, tickets, dscale, dbias);
}

// The ReLU's gradient as torch.relu's backward takes it: g where the
// forward's pre-activation, rounded as there, is above 0, else 0 (a select:
// a NaN or inf g where the ReLU is off gives 0).
__device__ __forceinline__ float relu_grad(float x, float g, float s,
                                           float b) {
  return mul_add_rn(x, s, b) > 0.0f ? g : 0.0f;
}

// The backward's first pass: sum_g = sum(gm) and sum_gx = sum(gm * x) per
// channel, gm = relu_grad(...) with Act, else g; K2's backward without dx.
template <typename T, int V, bool Act>
__global__ void __launch_bounds__(kRowThreads)
bn_act_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, int64_t m, int c,
                   int rows_per_group, float* __restrict__ part,
                   int* __restrict__ tickets, float* __restrict__ sum_g,
                   float* __restrict__ sum_gx) {
  constexpr int U = 4;             // rows whose loads are in flight at once
  using VT = Vec<T, V>;
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * rows_per_group;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_group), m - row0));
  const int step = blockDim.y;
  float acc[2 * V];
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) acc[k] = 0.0f;
  if (chunk * V < c) {
    float s[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] = Act ? scale[chunk * V + i] : 0.0f;
      b[i] = Act ? bias[chunk * V + i] : 0.0f;
    }
    const int64_t at = row0 * c + chunk * V;
    const T* xb = x + at;
    const T* gb = g + at;
    for (int r = threadIdx.y; r < rows; r += U * step) {
      typename VT::Raw rx[U], rg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * step;
        if (rr < rows) {
          rx[u] = VT::load(xb + rr * c);
          rg[u] = VT::load(gb + rr * c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step < rows) {
          float xv[V], gv[V];
          VT::unpack(rx[u], xv);
          VT::unpack(rg[u], gv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float gm = Act ? relu_grad(xv[i], gv[i], s[i], b[i]) : gv[i];
            acc[i] += gm;
            acc[V + i] += gm * xv[i];
          }
        }
      }
    }
  }
  finish_reduction<V>(acc, c, part, tickets, sum_g, sum_gx);
}

// blocks of bn_act_dx_kernel an SM holds at once (ops/fused.py
// _DX_BLOCKS_PER_SM): its 40 per-channel constants at V = 8 and 8 loads in
// flight take more than the 64 registers two blocks of 512 would leave
constexpr int kDxBlocksPerSm = 1;

// The backward's second pass: dx = gm*a + x*b + c per element, with the
// closed form's per-channel constants (ops/fused.py bn_dx_coefficients):
//   sum_g_xhat = (sum_gx - mean * sum_g) * inv
//   a = gamma * inv
//   b = -gamma * (inv * inv) * sum_g_xhat / n
//   c = -(a * sum_g / n) - b * mean
// each operation rounded once, in this order, as the plain version's torch
// operations are. Rows as in K2's forward.
template <typename T, int V, bool Act>
__global__ void __launch_bounds__(kRowThreads, kDxBlocksPerSm)
bn_act_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ sum_g,
                 const float* __restrict__ sum_gx,
                 const float* __restrict__ gamma,
                 const float* __restrict__ mean,
                 const float* __restrict__ inv, float n, int64_t m, int c,
                 int rows_per_group, T* __restrict__ dx) {
  constexpr int U = 4;             // rows whose loads are in flight at once
  using VT = Vec<T, V>;
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk * V >= c) return;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * rows_per_group;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_group), m - row0));
  const int step = blockDim.y;
  float s[V], b[V], ka[V], kb[V], kc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = chunk * V + i;
    s[i] = Act ? scale[ch] : 0.0f;
    b[i] = Act ? bias[ch] : 0.0f;
    const float sg = sum_g[ch], mu = mean[ch], iv = inv[ch], ga = gamma[ch];
    const float sgx = __fmul_rn(__fsub_rn(sum_gx[ch], __fmul_rn(mu, sg)), iv);
    ka[i] = __fmul_rn(ga, iv);
    kb[i] = __fdiv_rn(__fmul_rn(__fmul_rn(-ga, __fmul_rn(iv, iv)), sgx), n);
    kc[i] = __fsub_rn(-__fdiv_rn(__fmul_rn(ka[i], sg), n), __fmul_rn(kb[i], mu));
  }
  const int64_t at = row0 * c + chunk * V;
  const T* xb = x + at;
  const T* gb = g + at;
  T* db = dx + at;
  for (int r = threadIdx.y; r < rows; r += U * step) {
    typename VT::Raw rx[U], rg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * step;
      if (rr < rows) {
        rx[u] = VT::load(xb + rr * c);
        rg[u] = VT::load(gb + rr * c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * step;
      if (rr < rows) {
        float xv[V], gv[V], d[V];
        VT::unpack(rx[u], xv);
        VT::unpack(rg[u], gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float gm = Act ? relu_grad(xv[i], gv[i], s[i], b[i]) : gv[i];
          d[i] = __fadd_rn(
              __fadd_rn(__fmul_rn(gm, ka[i]), __fmul_rn(xv[i], kb[i])), kc[i]);
        }
        VT::store(db + rr * c, d);
      }
    }
  }
}

// The plan a host function was given, checked: any mistake returns
// cudaErrorInvalidValue before anything is launched.
struct RowPlan {
  int vec, tx, tiles, groups, rows_per_group;
};

bool plan_ok(const RowPlan& p, int64_t m, int c, int is_bf16,
             std::initializer_list<const void*> vector_ptrs) {
  if (m < 1 || c < 1) return false;
  if (!(p.vec == 1 || p.vec == (is_bf16 ? 8 : 4))) return false;
  if (c % p.vec) return false;
  if (p.tx < 1 || p.tx > 32 || (p.tx & (p.tx - 1))) return false;
  const int64_t chunks = c / p.vec;
  if (p.tiles != (chunks + p.tx - 1) / p.tx) return false;
  if (p.groups < 1 || p.groups > 65535 || p.rows_per_group < 1) return false;
  if (static_cast<int64_t>(p.rows_per_group) * c > INT32_MAX) return false;
  if (static_cast<int64_t>(p.groups) * p.rows_per_group < m ||
      static_cast<int64_t>(p.groups - 1) * p.rows_per_group >= m)
    return false;
  if (p.vec > 1) {
    for (const void* ptr : vector_ptrs)
      if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  }
  return true;
}

// The plan of rppe_normalize_u8, checked as plan_ok checks a row plan.
bool normalize_plan_ok(const void* x, const void* y, int64_t n, int nstats,
                       int blocks, int64_t n_vec, int vec_stride,
                       int scalar_stride) {
  if (n < 1 || nstats < 1 || nstats > kMaxStats) return false;
  if (blocks < 1 || 16 * static_cast<int64_t>(blocks) * kNormThreads > INT32_MAX)
    return false;
  const int64_t threads = static_cast<int64_t>(blocks) * kNormThreads;
  if (scalar_stride < 1 || scalar_stride > threads || scalar_stride % nstats)
    return false;
  if (n_vec < 0 || 16 * n_vec > n) return false;
  if (n_vec > 0) {
    int g = 16, r = nstats;                 // gcd(16, nstats)
    while (r) { const int q = g % r; g = r; r = q; }
    if (vec_stride < 32 || vec_stride > threads || vec_stride % 32 ||
        vec_stride % (nstats / g))
      return false;
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
      return false;
  }
  return true;
}

template <typename T, int V>
void launch_sbr_forward(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                        void* y, const void* scale, const void* bias,
                        int64_t m, int c, int rows_per_group) {
  scale_bias_relu_kernel<T, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(scale), static_cast<const float*>(bias), m, c,
      rows_per_group);
}

template <typename T, int V>
void launch_channel_stats(dim3 grid, dim3 block, cudaStream_t s,
                          const void* x, int64_t m, int c, int rows_per_group,
                          void* part, void* tickets, void* sum, void* sumsq) {
  channel_stats_kernel<T, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), m, c, rows_per_group,
      static_cast<float*>(part), static_cast<int*>(tickets),
      static_cast<float*>(sum), static_cast<float*>(sumsq));
}

template <typename T, int V>
void launch_sbr_backward(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                         const void* g, const void* scale, const void* bias,
                         int64_t m, int c, int rows_per_group, void* dx,
                         void* part, void* tickets, void* dscale,
                         void* dbias) {
  sbr_backward_kernel<T, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(bias), m, c,
      rows_per_group, static_cast<T*>(dx), static_cast<float*>(part),
      static_cast<int*>(tickets), static_cast<float*>(dscale),
      static_cast<float*>(dbias));
}

template <typename T, int V>
void launch_bn_affine_act(bool act, dim3 grid, dim3 block, cudaStream_t s,
                          const void* x, void* y, const void* scale,
                          const void* bias, int64_t m, int c,
                          int rows_per_group) {
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (act)
    bn_affine_act_kernel<T, V, true><<<grid, block, 0, s>>>(
        xt, static_cast<T*>(y), sc, bi, m, c, rows_per_group);
  else
    bn_affine_act_kernel<T, V, false><<<grid, block, 0, s>>>(
        xt, static_cast<T*>(y), sc, bi, m, c, rows_per_group);
}

template <typename T, int V>
void launch_bn_act_sums(bool act, dim3 grid, dim3 block, cudaStream_t s,
                        const void* x, const void* g, const void* scale,
                        const void* bias, int64_t m, int c,
                        int rows_per_group, void* part, void* tickets,
                        void* sum_g, void* sum_gx) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  float* o0 = static_cast<float*>(sum_g);
  float* o1 = static_cast<float*>(sum_gx);
  if (act)
    bn_act_sums_kernel<T, V, true><<<grid, block, 0, s>>>(
        xt, gt, sc, bi, m, c, rows_per_group, pt, tk, o0, o1);
  else
    bn_act_sums_kernel<T, V, false><<<grid, block, 0, s>>>(
        xt, gt, sc, bi, m, c, rows_per_group, pt, tk, o0, o1);
}

// The per-channel inputs of bn_act_dx_kernel: the forward's scale and bias
// (for the mask), the two sums, gamma, the batch mean and inv, in order.
struct DxChannels {
  const void* v[7];
};

template <typename T, int V>
void launch_bn_act_dx(bool act, dim3 grid, dim3 block, cudaStream_t s,
                      const void* x, const void* g, const DxChannels& ch,
                      float n, int64_t m, int c, int rows_per_group,
                      void* dx) {
  const float* f[7];
  for (int i = 0; i < 7; ++i) f[i] = static_cast<const float*>(ch.v[i]);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* out = static_cast<T*>(dx);
  if (act)
    bn_act_dx_kernel<T, V, true><<<grid, block, 0, s>>>(
        xt, gt, f[0], f[1], f[2], f[3], f[4], f[5], f[6], n, m, c,
        rows_per_group, out);
  else
    bn_act_dx_kernel<T, V, false><<<grid, block, 0, s>>>(
        xt, gt, f[0], f[1], f[2], f[3], f[4], f[5], f[6], n, m, c,
        rows_per_group, out);
}

}  // namespace

extern "C" {

// x: n uint8 values, channels innermost, the channel count a multiple of
// nstats. y: n values of f32 (out_bf16 == 0) or bf16. scale, shift: nstats
// host floats (nstats <= kMaxStats), passed to the kernel by value. The plan
// of ops/fused.py:_normalize_plan: blocks of kNormThreads; the first n_vec
// 16-byte chunks go through the vector loop (x and y 16-byte aligned) with
// vec_stride threads, the rest one element at a time with scalar_stride.
int rppe_normalize_u8(const void* x, void* y, int64_t n, int nstats,
                      const float* scale, const float* shift, int out_bf16,
                      int blocks, int64_t n_vec, int vec_stride,
                      int scalar_stride, int device, void* stream) {
  if (!normalize_plan_ok(x, y, n, nstats, blocks, n_vec, vec_stride,
                         scalar_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  NormalizeStats st;
  for (int c = 0; c < nstats; ++c) {
    st.scale[c] = scale[c];
    st.shift[c] = shift[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xin = static_cast<const uint8_t*>(x);
  if (out_bf16) {
    normalize_u8_kernel<__nv_bfloat16><<<blocks, kNormThreads, 0, s>>>(
        xin, static_cast<__nv_bfloat16*>(y), n, n_vec, vec_stride,
        scalar_stride, nstats, st);
  } else {
    normalize_u8_kernel<float><<<blocks, kNormThreads, 0, s>>>(
        xin, static_cast<float*>(y), n, n_vec, vec_stride, scalar_stride,
        nstats, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (m, c) values of f32 (is_bf16 == 0) or bf16, channels innermost.
// scale, bias: c device floats. The plan of ops/fused.py:_sbr_forward_plan:
// vec (1, or 16 bytes of x's dtype), tx, tiles, groups, rows_per_group.
int rppe_scale_bias_relu(const void* x, void* y, const void* scale,
                         const void* bias, int64_t m, int c, int is_bf16,
                         int vec, int tx, int tiles, int groups,
                         int rows_per_group, int device, void* stream) {
  const RowPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRowThreads / tx);
  if (is_bf16 && vec == 8)
    launch_sbr_forward<__nv_bfloat16, 8>(grid, block, s, x, y, scale, bias, m,
                                         c, rows_per_group);
  else if (is_bf16)
    launch_sbr_forward<__nv_bfloat16, 1>(grid, block, s, x, y, scale, bias, m,
                                         c, rows_per_group);
  else if (vec == 4)
    launch_sbr_forward<float, 4>(grid, block, s, x, y, scale, bias, m, c,
                                 rows_per_group);
  else
    launch_sbr_forward<float, 1>(grid, block, s, x, y, scale, bias, m, c,
                                 rows_per_group);
  return static_cast<int>(cudaGetLastError());
}

// The reductions take the plan of ops/fused.py:_reduction_plan: vec (1, or
// 16 bytes of x's dtype), tx, tiles, groups, rows_per_group. part: (2,
// groups, c) device floats of scratch. tickets: tiles device ints, all 0,
// that no other launch uses until this one has ended (the kernel leaves
// them 0 again). The kernel writes all c channels of both outputs.

// x: (m, c) values of f32 (is_bf16 == 0) or bf16, channels innermost.
// sum, sumsq: c device floats.
int rppe_channel_stats(const void* x, int64_t m, int c, int is_bf16, int vec,
                       int tx, int tiles, int groups, int rows_per_group,
                       void* part, void* tickets, void* sum, void* sumsq,
                       int device, void* stream) {
  const RowPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRowThreads / tx);
  if (is_bf16 && vec == 8)
    launch_channel_stats<__nv_bfloat16, 8>(grid, block, s, x, m, c,
                                           rows_per_group, part, tickets, sum,
                                           sumsq);
  else if (is_bf16)
    launch_channel_stats<__nv_bfloat16, 1>(grid, block, s, x, m, c,
                                           rows_per_group, part, tickets, sum,
                                           sumsq);
  else if (vec == 4)
    launch_channel_stats<float, 4>(grid, block, s, x, m, c, rows_per_group,
                                   part, tickets, sum, sumsq);
  else
    launch_channel_stats<float, 1>(grid, block, s, x, m, c, rows_per_group,
                                   part, tickets, sum, sumsq);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: (m, c) values of f32 (is_bf16 == 0) or bf16, channels
// innermost. scale, bias: c device floats. dscale, dbias: c device floats.
int rppe_scale_bias_relu_backward(const void* x, const void* g,
                                  const void* scale, const void* bias,
                                  int64_t m, int c, int is_bf16, int vec,
                                  int tx, int tiles, int groups,
                                  int rows_per_group, void* dx, void* part,
                                  void* tickets, void* dscale, void* dbias,
                                  int device, void* stream) {
  const RowPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x, g, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRowThreads / tx);
  if (is_bf16 && vec == 8)
    launch_sbr_backward<__nv_bfloat16, 8>(grid, block, s, x, g, scale, bias, m,
                                          c, rows_per_group, dx, part, tickets,
                                          dscale, dbias);
  else if (is_bf16)
    launch_sbr_backward<__nv_bfloat16, 1>(grid, block, s, x, g, scale, bias, m,
                                          c, rows_per_group, dx, part, tickets,
                                          dscale, dbias);
  else if (vec == 4)
    launch_sbr_backward<float, 4>(grid, block, s, x, g, scale, bias, m, c,
                                  rows_per_group, dx, part, tickets, dscale,
                                  dbias);
  else
    launch_sbr_backward<float, 1>(grid, block, s, x, g, scale, bias, m, c,
                                  rows_per_group, dx, part, tickets, dscale,
                                  dbias);
  return static_cast<int>(cudaGetLastError());
}

// The training BatchNorm's epilogue (ops/fused.py bn_affine_act,
// bn_act_sums, bn_act_dx): x, y, g, dx are (m, c) values of f32 (is_bf16
// == 0) or bf16, channels innermost; every per-channel vector is c device
// floats; act != 0 applies the ReLU. rppe_bn_affine_act and rppe_bn_act_dx
// take the plan of ops/fused.py:_sbr_forward_plan (the latter at
// _DX_BLOCKS_PER_SM blocks per SM), rppe_bn_act_sums that of
// _reduction_plan (with part and tickets as the reductions above take them).
int rppe_bn_affine_act(const void* x, void* y, const void* scale,
                       const void* bias, int64_t m, int c, int is_bf16,
                       int act, int vec, int tx, int tiles, int groups,
                       int rows_per_group, int device, void* stream) {
  const RowPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRowThreads / tx);
  if (is_bf16 && vec == 8)
    launch_bn_affine_act<__nv_bfloat16, 8>(act, grid, block, s, x, y, scale,
                                           bias, m, c, rows_per_group);
  else if (is_bf16)
    launch_bn_affine_act<__nv_bfloat16, 1>(act, grid, block, s, x, y, scale,
                                           bias, m, c, rows_per_group);
  else if (vec == 4)
    launch_bn_affine_act<float, 4>(act, grid, block, s, x, y, scale, bias, m,
                                   c, rows_per_group);
  else
    launch_bn_affine_act<float, 1>(act, grid, block, s, x, y, scale, bias, m,
                                   c, rows_per_group);
  return static_cast<int>(cudaGetLastError());
}

// sum_g, sum_gx: c device floats each.
int rppe_bn_act_sums(const void* x, const void* g, const void* scale,
                     const void* bias, int64_t m, int c, int is_bf16, int act,
                     int vec, int tx, int tiles, int groups,
                     int rows_per_group, void* part, void* tickets,
                     void* sum_g, void* sum_gx, int device, void* stream) {
  const RowPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x, g}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRowThreads / tx);
  if (is_bf16 && vec == 8)
    launch_bn_act_sums<__nv_bfloat16, 8>(act, grid, block, s, x, g, scale,
                                         bias, m, c, rows_per_group, part,
                                         tickets, sum_g, sum_gx);
  else if (is_bf16)
    launch_bn_act_sums<__nv_bfloat16, 1>(act, grid, block, s, x, g, scale,
                                         bias, m, c, rows_per_group, part,
                                         tickets, sum_g, sum_gx);
  else if (vec == 4)
    launch_bn_act_sums<float, 4>(act, grid, block, s, x, g, scale, bias, m, c,
                                 rows_per_group, part, tickets, sum_g,
                                 sum_gx);
  else
    launch_bn_act_sums<float, 1>(act, grid, block, s, x, g, scale, bias, m, c,
                                 rows_per_group, part, tickets, sum_g,
                                 sum_gx);
  return static_cast<int>(cudaGetLastError());
}

// scale, bias, sum_g, sum_gx, gamma, mean, inv: c device floats each; n: the
// count the statistics divide by, as an f32.
int rppe_bn_act_dx(const void* x, const void* g, const void* scale,
                   const void* bias, const void* sum_g, const void* sum_gx,
                   const void* gamma, const void* mean, const void* inv,
                   float n, int64_t m, int c, int is_bf16, int act, int vec,
                   int tx, int tiles, int groups, int rows_per_group,
                   void* dx, int device, void* stream) {
  const RowPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x, g, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRowThreads / tx);
  const DxChannels ch{{scale, bias, sum_g, sum_gx, gamma, mean, inv}};
  if (is_bf16 && vec == 8)
    launch_bn_act_dx<__nv_bfloat16, 8>(act, grid, block, s, x, g, ch, n, m, c,
                                       rows_per_group, dx);
  else if (is_bf16)
    launch_bn_act_dx<__nv_bfloat16, 1>(act, grid, block, s, x, g, ch, n, m, c,
                                       rows_per_group, dx);
  else if (vec == 4)
    launch_bn_act_dx<float, 4>(act, grid, block, s, x, g, ch, n, m, c,
                               rows_per_group, dx);
  else
    launch_bn_act_dx<float, 1>(act, grid, block, s, x, g, ch, n, m, c,
                               rows_per_group, dx);
  return static_cast<int>(cudaGetLastError());
}

const char* rppe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
