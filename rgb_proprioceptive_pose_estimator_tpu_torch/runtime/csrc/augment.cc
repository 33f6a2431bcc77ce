// Native host-pipeline augmentation engine.
//
// The reference's host-side image work lived in dependency-native code
// (torchvision/PIL/cuDNN -- SURVEY.md section 3.1); this is the TPU-build's
// equivalent: a C++ engine for the throughput-critical decode/augment stage
// (SURVEY.md section 8 hard-part 1: ~160k images/sec across a v5e-8 host).
//
// Division of labor: Python samples per-image augmentation parameters with
// numpy RNG (determinism semantics identical to the numpy fallback);
// C++ does the pixel work -- rectangular crop window, bilinear resize,
// horizontal flip, brightness/contrast/saturation/hue jitter --
// parallelized over a persistent
// std::thread pool. uint8 in, uint8 out; per-channel normalization stays on
// device (BASELINE.json:5).
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Persistent thread pool (created once; sized by the first caller).
// ---------------------------------------------------------------------------

// Work-sharing job. Heap-allocated and held via shared_ptr by every thread
// that touches it, so a straggler worker waking after the submitting call
// returned still dereferences live memory (a by-reference capture here is a
// use-after-return race).
struct Job {
  explicit Job(int64_t n_, std::function<void(int64_t)> fn_)
      : n(n_), fn(std::move(fn_)) {}
  const int64_t n;
  const std::function<void(int64_t)> fn;
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> done{0};
  std::mutex mu;
  std::condition_variable cv;

  void Run() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
      if (done.fetch_add(1) + 1 == n) {
        std::unique_lock<std::mutex> lk(mu);
        cv.notify_all();
      }
    }
  }
};

class Pool {
 public:
  explicit Pool(int n_threads) {
    n_threads = std::max(1, n_threads);
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int size() const { return static_cast<int>(workers_.size()); }

  // Blocks until fn(i) has run for all i in [0, n).
  void ParallelFor(int64_t n, std::function<void(int64_t)> fn) {
    if (n <= 0) return;
    auto job = std::make_shared<Job>(n, std::move(fn));
    {
      std::unique_lock<std::mutex> lk(mu_);
      job_ = job;
      epoch_++;
    }
    cv_.notify_all();
    job->Run();  // caller participates
    {
      std::unique_lock<std::mutex> lk(job->mu);
      job->cv.wait(lk, [&] { return job->done.load() >= n; });
    }
    {
      std::unique_lock<std::mutex> lk(mu_);
      if (job_ == job) job_ = nullptr;
    }
  }

 private:
  void WorkerLoop() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || (job_ && epoch_ != seen); });
        if (stop_) return;
        seen = epoch_;
        job = job_;  // shared_ptr copy keeps the job alive past completion
      }
      if (job) job->Run();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::shared_ptr<Job> job_;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

Pool* g_pool = nullptr;
std::mutex g_pool_mu;

Pool& GetPool(int n_threads) {
  std::unique_lock<std::mutex> lk(g_pool_mu);
  if (g_pool == nullptr) {
    g_pool = new Pool(n_threads > 0 ? n_threads
                                    : (int)std::thread::hardware_concurrency());
  }
  return *g_pool;
}

// ---------------------------------------------------------------------------
// Pixel kernels (uint8 HWC, C channels).
// ---------------------------------------------------------------------------

// numpy's `np.clip(x, 0, 255).astype(uint8)` truncates -- match it for
// jittered pixels; resize output rounds (cv2.INTER_LINEAR convention).
inline uint8_t TruncClamp8(float v) {
  return (uint8_t)std::min(255.0f, std::max(0.0f, v));
}
inline uint8_t RoundClamp8(float v) {
  return (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
}

// Hue rotation of one float RGB pixel (0-255 scale) by `shift` full
// turns -- the same RGB<->HSV math as torchvision's tensor adjust_hue
// (mirrors data/augment.adjust_hue; parity-tested against numpy).
inline void HueRotate(float* px, float shift) {
  float r = px[0] * (1.0f / 255.0f);
  float g = px[1] * (1.0f / 255.0f);
  float b = px[2] * (1.0f / 255.0f);
  float maxc = std::max(r, std::max(g, b));
  float minc = std::min(r, std::min(g, b));
  float cr = maxc - minc;
  float div = cr == 0.0f ? 1.0f : cr;
  float sat = maxc == minc ? 0.0f : cr / maxc;
  float rc = (maxc - r) / div, gc = (maxc - g) / div, bc = (maxc - b) / div;
  float h = (maxc == r) ? (bc - gc) : (maxc == g) ? (2.0f + rc - bc)
                                                  : (4.0f + gc - rc);
  h = std::fmod(h / 6.0f + 1.0f, 1.0f);
  h = std::fmod(h + shift + 1.0f, 1.0f);
  float i6 = std::floor(h * 6.0f);
  float f = h * 6.0f - i6;
  int i = ((int)i6) % 6;
  float pv = maxc * (1.0f - sat);
  float qv = maxc * (1.0f - sat * f);
  float tv = maxc * (1.0f - sat * (1.0f - f));
  float rr, gg, bb;
  switch (i) {
    case 0: rr = maxc; gg = tv; bb = pv; break;
    case 1: rr = qv; gg = maxc; bb = pv; break;
    case 2: rr = pv; gg = maxc; bb = tv; break;
    case 3: rr = pv; gg = qv; bb = maxc; break;
    case 4: rr = tv; gg = pv; bb = maxc; break;
    default: rr = maxc; gg = pv; bb = qv; break;
  }
  px[0] = rr * 255.0f;
  px[1] = gg * 255.0f;
  px[2] = bb * 255.0f;
}

// Bilinear resize of the crop window [y0, y0+ch) x [x0, x0+cw) of src
// (sh x sw x c) into dst (oh x ow x c), with optional horizontal flip and
// color jitter. Half-pixel-center mapping (cv2.INTER_LINEAR convention).
// Separable two-pass: each needed source row is horizontally resized once
// (cached; the row index is monotone in oy), then rows blend vertically.
void CropResizeOne(const uint8_t* src, int sh, int sw, int c,
                   uint8_t* dst, int oh, int ow,
                   int y0, int x0, int ch_sz, int cw_sz, bool flip,
                   float fb, float fc, float fs, float fh) {
  const float scale_y = (float)ch_sz / oh;
  const float scale_x = (float)cw_sz / ow;
  const bool jitter = fb > 0.0f || fc > 0.0f || fs > 0.0f || fh != 0.0f;

  // horizontal interpolation tables; flip folds into the table
  std::vector<int> tx1(ow), tx2(ow);
  std::vector<float> twx(ow);
  for (int ox = 0; ox < ow; ++ox) {
    int sx = flip ? (ow - 1 - ox) : ox;
    float fx = (sx + 0.5f) * scale_x - 0.5f;
    int ix = (int)std::floor(fx);
    twx[ox] = fx - ix;
    tx1[ox] = std::min(std::max(ix, 0), cw_sz - 1);
    tx2[ox] = std::min(ix + 1, cw_sz - 1);
  }

  // two-row cache of horizontally-resized source rows
  std::vector<float> rbuf0((size_t)ow * c), rbuf1((size_t)ow * c);
  float* rows[2] = {rbuf0.data(), rbuf1.data()};
  int row_y[2] = {-1, -1};

  auto hresize = [&](int sy, float* out) {
    const uint8_t* r = src + ((int64_t)(y0 + sy) * sw + x0) * c;
    for (int ox = 0; ox < ow; ++ox) {
      const uint8_t* p1 = r + tx1[ox] * c;
      const uint8_t* p2 = r + tx2[ox] * c;
      const float w = twx[ox];
      float* o = out + (size_t)ox * c;
      for (int ch = 0; ch < c; ++ch) {
        o[ch] = p1[ch] + w * (p2[ch] - p1[ch]);
      }
    }
  };

  auto get_row = [&](int sy) -> const float* {
    if (row_y[0] == sy) return rows[0];
    if (row_y[1] == sy) return rows[1];
    // evict the older slot (row indices are nondecreasing in oy)
    int slot = (row_y[0] <= row_y[1]) ? 0 : 1;
    hresize(sy, rows[slot]);
    row_y[slot] = sy;
    return rows[slot];
  };

  // Jitter contrast anchors on the mean of the GRAYSCALE resized crop
  // (torchvision adjust_contrast convention, matching the numpy backend;
  // non-RGB channel counts use the channel mean), so the jitter path stages
  // the resized image first and applies the color transform in a second
  // pass.
  std::vector<float> stage;
  float mean = 0.0f;

  if (jitter) {
    // stage holds the rounded (uint8-equivalent) resized crop, matching the
    // numpy backend which jitters the cv2-resized uint8 image
    stage.resize((size_t)oh * ow * c);
    double acc = 0.0;
    const bool gray_anchor = (c == 3);
    for (int oy = 0; oy < oh; ++oy) {
      float fy = (oy + 0.5f) * scale_y - 0.5f;
      int iy = (int)std::floor(fy);
      float wy = fy - iy;
      const float* top = get_row(std::min(std::max(iy, 0), ch_sz - 1));
      const float* bot = get_row(std::min(iy + 1, ch_sz - 1));
      float* srow = &stage[(size_t)oy * ow * c];
      for (size_t i = 0; i < (size_t)ow * c; ++i) {
        float v = (float)RoundClamp8(top[i] + wy * (bot[i] - top[i]));
        srow[i] = v;
        if (!gray_anchor) acc += v;
      }
      if (gray_anchor) {
        for (int ox = 0; ox < ow; ++ox) {
          const float* px = srow + (size_t)ox * c;
          acc += 0.299 * px[0] + 0.587 * px[1] + 0.114 * px[2];
        }
      }
    }
    mean = (float)(acc / ((double)oh * ow * (gray_anchor ? 1 : c)));

    const float rb = fb > 0 ? fb : 1.0f;
    const float rc = fc > 0 ? fc : 1.0f;
    const float rs = fs > 0 ? fs : 1.0f;
    const float m = mean * rb;  // contrast anchor on brightness-scaled mean
    const bool saturate = fs > 0 && c == 3;  // luma is RGB-only
    const bool hue = fh != 0.0f && c == 3;
    for (int oy = 0; oy < oh; ++oy) {
      for (int ox = 0; ox < ow; ++ox) {
        float* px = &stage[((size_t)oy * ow + ox) * c];
        uint8_t* d = dst + ((size_t)oy * ow + ox) * c;
        if (c == 3) {
          float v0 = m + (px[0] * rb - m) * rc;
          float v1 = m + (px[1] * rb - m) * rc;
          float v2 = m + (px[2] * rb - m) * rc;
          if (saturate) {
            float gray = 0.299f * v0 + 0.587f * v1 + 0.114f * v2;
            v0 = gray + (v0 - gray) * rs;
            v1 = gray + (v1 - gray) * rs;
            v2 = gray + (v2 - gray) * rs;
          }
          if (hue) {
            // hue operates on the clipped intermediate (valid RGB cube),
            // matching the numpy backend
            float hp[3] = {std::min(255.0f, std::max(0.0f, v0)),
                           std::min(255.0f, std::max(0.0f, v1)),
                           std::min(255.0f, std::max(0.0f, v2))};
            HueRotate(hp, fh);
            v0 = hp[0]; v1 = hp[1]; v2 = hp[2];
          }
          d[0] = TruncClamp8(v0);
          d[1] = TruncClamp8(v1);
          d[2] = TruncClamp8(v2);
        } else {
          for (int ch = 0; ch < c; ++ch) {
            d[ch] = TruncClamp8(m + (px[ch] * rb - m) * rc);
          }
        }
      }
    }
  } else {
    for (int oy = 0; oy < oh; ++oy) {
      float fy = (oy + 0.5f) * scale_y - 0.5f;
      int iy = (int)std::floor(fy);
      float wy = fy - iy;
      const float* top = get_row(std::min(std::max(iy, 0), ch_sz - 1));
      const float* bot = get_row(std::min(iy + 1, ch_sz - 1));
      uint8_t* d = dst + (size_t)oy * ow * c;
      for (size_t i = 0; i < (size_t)ow * c; ++i) {
        d[i] = RoundClamp8(top[i] + wy * (bot[i] - top[i]));
      }
    }
  }
}

}  // namespace

extern "C" {

#define RPPE_EXPORT __attribute__((visibility("default")))

// Returns the thread-pool size actually in use.
RPPE_EXPORT int rppe_init(int n_threads) { return GetPool(n_threads).size(); }

// Augment a batch of n images.
//   src:    n * sh * sw * c uint8, contiguous
//   dst:    n * oh * ow * c uint8, contiguous (preallocated)
//   crops:  n * 4 int32   -- y0, x0, crop_h, crop_w (rectangular window)
//   flips:  n uint8       -- 0/1 horizontal flip
//   jitter: n * 4 float32 -- brightness/contrast/saturation/hue
//                            (<= 0 skips b/c/s; hue 0.0 = identity)
RPPE_EXPORT void rppe_augment_batch(const uint8_t* src, int64_t n, int sh, int sw, int c,
                        uint8_t* dst, int oh, int ow,
                        const int32_t* crops, const uint8_t* flips,
                        const float* jitter, int n_threads) {
  Pool& pool = GetPool(n_threads);
  const int64_t in_stride = (int64_t)sh * sw * c;
  const int64_t out_stride = (int64_t)oh * ow * c;
  pool.ParallelFor(n, [&](int64_t i) {
    CropResizeOne(src + i * in_stride, sh, sw, c, dst + i * out_stride, oh, ow,
                  crops[i * 4 + 0], crops[i * 4 + 1], crops[i * 4 + 2],
                  crops[i * 4 + 3],
                  flips[i] != 0, jitter[i * 4 + 0], jitter[i * 4 + 1],
                  jitter[i * 4 + 2], jitter[i * 4 + 3]);
  });
}

// Deterministic eval transform: center square crop + bilinear resize.
RPPE_EXPORT void rppe_center_crop_resize_batch(const uint8_t* src, int64_t n, int sh,
                                   int sw, int c, uint8_t* dst, int oh, int ow,
                                   int n_threads) {
  Pool& pool = GetPool(n_threads);
  const int s = std::min(sh, sw);
  const int y0 = (sh - s) / 2;
  const int x0 = (sw - s) / 2;
  const int64_t in_stride = (int64_t)sh * sw * c;
  const int64_t out_stride = (int64_t)oh * ow * c;
  pool.ParallelFor(n, [&](int64_t i) {
    CropResizeOne(src + i * in_stride, sh, sw, c, dst + i * out_stride, oh, ow,
                  y0, x0, s, s, false, 0.0f, 0.0f, 0.0f, 0.0f);
  });
}

}  // extern "C"
