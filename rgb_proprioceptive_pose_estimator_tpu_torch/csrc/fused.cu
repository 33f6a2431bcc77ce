// Hand-written Hopper kernels for the memory-bound Pallas kernels and the
// scale-bias-ReLU gradient. Built for sm_90a by ops/_build.py with nvcc into
// a shared library with a plain C interface; ops/fused.py binds it with
// ctypes.
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
// data as (rows, lcm(C, 128)) lanes to broadcast the per-channel constants;
// here each thread keeps one channel for its whole life instead: the
// grid-stride loop's stride is a multiple of C, so a thread's channel, and
// with it its scale and shift, is fixed and held in registers, and no index
// is divided inside the loop. Neighbouring threads touch neighbouring
// addresses, so every warp access is coalesced, whatever C is.
//
// What this simple design leaves for later: 16-byte vector loads and stores
// (a thread now moves 1, 2 or 4 bytes per access, so small accesses, not
// bytes, may limit it), and fusing the epilogue into the convolution that
// writes x, which would save a whole read and write of the activation.
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
// so that it is the plain version's mask bit for bit.
//
// The tickets are the caller's: ops/fused.py keeps one zeroed int32 buffer
// per device and stream. Launches on one stream run one after another, and
// each leaves its tickets at 0; two launches that ran at once on two
// streams with one buffer would mix their tickets, which is why the buffer
// is per stream.

#include <cstdint>
#include <cstring>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
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

// The loop stride: all threads of the grid, rounded down to a multiple of c.
// Threads at or above it stay idle.
__device__ __forceinline__ int64_t channel_stride(int c) {
  const int64_t total = static_cast<int64_t>(gridDim.x) * blockDim.x;
  return total - total % c;
}

template <typename Out>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x,
                                    Out* __restrict__ y, int64_t n,
                                    int nstats, NormalizeStats st) {
  const int64_t stride = channel_stride(nstats);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= stride) return;
  // the image's C is a multiple of nstats, so element i has constants i % nstats
  const int c = static_cast<int>(tid % nstats);
  const float scale = st.scale[c];
  const float shift = st.shift[c];
  for (int64_t i = tid; i < n; i += stride) {
    store_f32(y + i, static_cast<float>(x[i]) * scale + shift);
  }
}

template <typename T>
__global__ void scale_bias_relu_kernel(const T* __restrict__ x,
                                       T* __restrict__ y,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       int64_t n, int channels) {
  const int64_t stride = channel_stride(channels);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= stride) return;
  const int c = static_cast<int>(tid % channels);
  const float s = scale[c];
  const float b = bias[c];
  for (int64_t i = tid; i < n; i += stride) {
    store_f32(y + i, fmaxf(load_f32(x + i) * s + b, 0.0f));
  }
}

// ---------------------------------------------------------------------------
// The two reductions. A block of kRedThreads threads is tx x (kRedThreads /
// tx): threadIdx.x picks a chunk of V neighbouring channels, threadIdx.y a
// row slot. The grid is (tiles, groups): blockIdx.x picks a tile of tx
// chunks, blockIdx.y a group of rows_per_group neighbouring rows. The plan
// (V, tx, tiles, groups, rows_per_group) comes from ops/fused.py's
// _reduction_plan.

constexpr int kRedThreads = 512;
constexpr int kRedWarps = kRedThreads / 32;
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
  __shared__ float red[(kRedWarps * 32 * 2 * V > kRedThreads)
                           ? kRedWarps * 32 * 2 * V : kRedThreads];
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
    for (int w = 0; w < kRedWarps; ++w) s += red[(w * blockDim.x + chunk) * 2 * V + k];
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
  const int slices = kRedThreads / pairs;
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
__global__ void __launch_bounds__(kRedThreads)
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
__global__ void __launch_bounds__(kRedThreads)
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
            // two roundings, as the plain version: the mask is the same bit
            const float pre = __fadd_rn(__fmul_rn(xv[i], s[i]), b[i]);
            const float gm = pre > 0.0f ? gv[i] : 0.0f;
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

// The plan a host function was given, checked: any mistake returns
// cudaErrorInvalidValue before anything is launched.
struct ReductionPlan {
  int vec, tx, tiles, groups, rows_per_group;
};

bool plan_ok(const ReductionPlan& p, int64_t m, int c, int is_bf16,
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

// Enough blocks to fill the card (kBlocksPerSm per SM), fewer for small n,
// and never fewer threads than channels.
cudaError_t grid_for(int64_t n, int channels, int device, int* blocks) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (want > cap) want = cap;
  const int64_t least = (channels + kThreads - 1) / kThreads;
  if (want < least) want = least;
  *blocks = static_cast<int>(want);
  return cudaSuccess;
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

}  // namespace

extern "C" {

// x: n uint8 values, channels innermost, the channel count a multiple of
// nstats. y: n values of f32 (out_bf16 == 0) or bf16. scale, shift: nstats
// host floats (nstats <= kMaxStats), passed to the kernel by value.
int rppe_normalize_u8(const void* x, void* y, int64_t n, int nstats,
                      const float* scale, const float* shift, int out_bf16,
                      int device, void* stream) {
  if (nstats < 1 || nstats > kMaxStats) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  NormalizeStats st;
  for (int c = 0; c < nstats; ++c) {
    st.scale[c] = scale[c];
    st.shift[c] = shift[c];
  }
  int blocks = 0;
  err = grid_for(n, nstats, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xin = static_cast<const uint8_t*>(x);
  if (out_bf16) {
    normalize_u8_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        xin, static_cast<__nv_bfloat16*>(y), n, nstats, st);
  } else {
    normalize_u8_kernel<float><<<blocks, kThreads, 0, s>>>(
        xin, static_cast<float*>(y), n, nstats, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: n values of f32 (is_bf16 == 0) or bf16 laid out as (n / channels,
// channels). scale, bias: channels device floats.
int rppe_scale_bias_relu(const void* x, void* y, const void* scale,
                         const void* bias, int64_t n, int channels,
                         int is_bf16, int device, void* stream) {
  if (channels < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = grid_for(n, channels, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    scale_bias_relu_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        sc, bi, n, channels);
  } else {
    scale_bias_relu_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), sc, bi, n,
        channels);
  }
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
  const ReductionPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRedThreads / tx);
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
  const ReductionPlan plan{vec, tx, tiles, groups, rows_per_group};
  if (!plan_ok(plan, m, c, is_bf16, {x, g, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, groups), block(tx, kRedThreads / tx);
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

const char* rppe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
