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
//   pallas_fused.py:channel_stats (body _channel_stats_kernel): per-channel
//   f32 (sum x, sum x^2) in one read of x.
// rppe_scale_bias_relu_backward replaces the VJP of pallas_fused.py:
//   scale_bias_relu (_sbr_bwd, XLA inside the kernel's custom_vjp): with
//   mask = x*scale + bias > 0, dx = g*mask*scale in x's dtype, and the f32
//   per-channel sums dscale = sum g*mask*x and dbias = sum g*mask, in one
//   read of x and g.
//
// Both are bound by device-memory bytes (a few flops per element). The TPU
// kernel carried its sums in VMEM scratch from one sequential grid step to
// the next; blocks on the card run in parallel and in no order, so the
// reduction has two stages and no float atomics, which makes it
// deterministic: two launches on one card give bitwise-equal sums.
//   1. A block of kRedX x kRedY threads owns kRedX neighbouring channels
//      (a warp reads neighbouring addresses of one row) and one of `groups`
//      row groups: its rows are kRedY * group + ty, stepping by kRedY *
//      groups. Each thread sums its rows in order, the block folds its kRedY
//      rows of threads in order, and writes one f32 partial per channel and
//      group.
//   2. One block per channel folds the `groups` partials with a fixed tree.
// The wrapper picks `groups` from the SM count and m, and allocates the
// (2, groups, c) partials with torch. The mask of the backward is computed
// as round(round(x*scale) + bias), without the fused multiply-add, so that
// it is the plain version's mask bit for bit.

#include <cstdint>

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

constexpr int kRedX = 32;        // channels of a reduction block
constexpr int kRedY = 8;         // rows of threads of a reduction block
constexpr int kFoldThreads = 256;

// Stage 1 of both reductions: the block's kRedY per-thread sums of one
// channel, folded in order and stored as partial (group, channel) of the
// two (groups, c) planes that start at part0 and part1.
__device__ __forceinline__ void store_block_partials(float s0, float s1,
                                                     int ch, int c,
                                                     float* __restrict__ part0,
                                                     float* __restrict__ part1) {
  __shared__ float red0[kRedY][kRedX];
  __shared__ float red1[kRedY][kRedX];
  red0[threadIdx.y][threadIdx.x] = s0;
  red1[threadIdx.y][threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < kRedY; ++i) {
      t0 += red0[i][threadIdx.x];
      t1 += red1[i][threadIdx.x];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * c + ch;
    part0[at] = t0;
    part1[at] = t1;
  }
}

template <typename T>
__global__ void channel_stats_partial_kernel(const T* __restrict__ x,
                                             int64_t m, int c,
                                             float* __restrict__ part) {
  const int ch = blockIdx.x * kRedX + threadIdx.x;
  float s = 0.0f, ss = 0.0f;
  if (ch < c) {
    const int64_t step = static_cast<int64_t>(gridDim.y) * kRedY;
    for (int64_t r = static_cast<int64_t>(blockIdx.y) * kRedY + threadIdx.y;
         r < m; r += step) {
      const float v = load_f32(x + r * c + ch);
      s += v;
      ss += v * v;
    }
  }
  store_block_partials(s, ss, ch, c, part,
                       part + static_cast<int64_t>(gridDim.y) * c);
}

template <typename T>
__global__ void sbr_backward_partial_kernel(const T* __restrict__ x,
                                            const T* __restrict__ g,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            int64_t m, int c,
                                            T* __restrict__ dx,
                                            float* __restrict__ part) {
  const int ch = blockIdx.x * kRedX + threadIdx.x;
  float dscale = 0.0f, dbias = 0.0f;
  if (ch < c) {
    const float s = scale[ch];
    const float b = bias[ch];
    const int64_t step = static_cast<int64_t>(gridDim.y) * kRedY;
    for (int64_t r = static_cast<int64_t>(blockIdx.y) * kRedY + threadIdx.y;
         r < m; r += step) {
      const int64_t i = r * c + ch;
      const float xv = load_f32(x + i);
      const float gv = load_f32(g + i);
      // two roundings, as the plain version: the mask is the same bit
      const float pre = __fadd_rn(__fmul_rn(xv, s), b);
      const float gm = pre > 0.0f ? gv : 0.0f;
      store_f32(dx + i, gm * s);
      dscale += gm * xv;
      dbias += gm;
    }
  }
  store_block_partials(dscale, dbias, ch, c, part,
                       part + static_cast<int64_t>(gridDim.y) * c);
}

// Stage 2: out0[ch] = sum over groups of part[0][group][ch], out1 likewise
// from part[1]; one block per channel, a fixed-order tree.
__global__ void fold_partials_kernel(const float* __restrict__ part,
                                     int groups, int c,
                                     float* __restrict__ out0,
                                     float* __restrict__ out1) {
  __shared__ float a[kFoldThreads];
  __shared__ float b[kFoldThreads];
  const int ch = blockIdx.x;
  const int t = threadIdx.x;
  const float* p1 = part + static_cast<int64_t>(groups) * c;
  float s0 = 0.0f, s1 = 0.0f;
  for (int i = t; i < groups; i += kFoldThreads) {
    s0 += part[static_cast<int64_t>(i) * c + ch];
    s1 += p1[static_cast<int64_t>(i) * c + ch];
  }
  a[t] = s0;
  b[t] = s1;
  __syncthreads();
  for (int w = kFoldThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      a[t] += a[t + w];
      b[t] += b[t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    out0[ch] = a[0];
    out1[ch] = b[0];
  }
}

cudaError_t fold(const float* part, int groups, int c, float* out0,
                 float* out1, cudaStream_t s) {
  fold_partials_kernel<<<c, kFoldThreads, 0, s>>>(part, groups, c, out0, out1);
  return cudaGetLastError();
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

// x: (m, c) values of f32 (is_bf16 == 0) or bf16, channels innermost.
// part: (2, groups, c) device floats of scratch. sum, sumsq: c device floats.
int rppe_channel_stats(const void* x, int64_t m, int c, int is_bf16,
                       int groups, void* part, void* sum, void* sumsq,
                       int device, void* stream) {
  if (c < 1 || groups < 1 || groups > 65535 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + kRedX - 1) / kRedX, groups);
  const dim3 block(kRedX, kRedY);
  float* p = static_cast<float*>(part);
  if (is_bf16) {
    channel_stats_partial_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), m, c, p);
  } else {
    channel_stats_partial_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), m, c, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fold(p, groups, c, static_cast<float*>(sum),
                               static_cast<float*>(sumsq), s));
}

// x, g, dx: (m, c) values of f32 (is_bf16 == 0) or bf16, channels
// innermost. scale, bias: c device floats. part: (2, groups, c) device
// floats of scratch. dscale, dbias: c device floats.
int rppe_scale_bias_relu_backward(const void* x, const void* g,
                                  const void* scale, const void* bias,
                                  int64_t m, int c, int is_bf16, int groups,
                                  void* dx, void* part, void* dscale,
                                  void* dbias, int device, void* stream) {
  if (c < 1 || groups < 1 || groups > 65535 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + kRedX - 1) / kRedX, groups);
  const dim3 block(kRedX, kRedY);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* p = static_cast<float*>(part);
  if (is_bf16) {
    sbr_backward_partial_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), sc, bi, m, c,
        static_cast<__nv_bfloat16*>(dx), p);
  } else {
    sbr_backward_partial_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), sc, bi,
        m, c, static_cast<float*>(dx), p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fold(p, groups, c, static_cast<float*>(dscale),
                               static_cast<float*>(dbias), s));
}

const char* rppe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
