// Hand-written Hopper kernels for the two memory-bound Pallas kernels of the
// serving path. Built for sm_90a by ops/_build.py with nvcc into a shared
// library with a plain C interface; ops/fused.py binds it with ctypes.
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

const char* rppe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
