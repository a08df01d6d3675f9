// Native batch image augmentation: fused pad-to-aspect + affine warp +
// bilinear resize, multi-threaded over the batch. The port's copy of the JAX
// package's native/augment.cpp, the arithmetic unchanged so that its output is
// bit-equal to that build's; built by
// anytime3d_tpu_torch/kernels/build.py::build_host (the Makefile's g++ flags)
// and called through ctypes by data/augment.py.
//
// Pad the image to the output aspect ratio, apply a random scale/translate
// affine about the padded center, resize to the output size, and report the
// transform params so box labels can be remapped. The whole chain is ONE
// inverse-map bilinear gather per output pixel (no intermediate padded or
// warped buffers, a single resampling), and the batch fans out over a thread
// pool; each worker owns disjoint output images.
//
// Build: g++ -O3 -march=native -std=c++17 -fPIC -shared -o libaugment.so augment.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Bilinear sample with zero border (cv2 BORDER_CONSTANT(0) analogue).
inline void sample_bilinear(const float* img, int rows, int cols, int ch,
                            float x, float y, float* out) {
  if (x <= -1.0f || y <= -1.0f || x >= (float)cols || y >= (float)rows) {
    for (int c = 0; c < ch; ++c) out[c] = 0.0f;
    return;
  }
  int x0 = (int)std::floor(x), y0 = (int)std::floor(y);
  float wx = x - x0, wy = y - y0;
  int x1 = x0 + 1, y1 = y0 + 1;
  const bool x0_in = x0 >= 0 && x0 < cols, x1_in = x1 >= 0 && x1 < cols;
  const bool y0_in = y0 >= 0 && y0 < rows, y1_in = y1 >= 0 && y1 < rows;
  const float w00 = (1 - wx) * (1 - wy), w01 = wx * (1 - wy);
  const float w10 = (1 - wx) * wy, w11 = wx * wy;
  const float* r0 = img + (int64_t)y0 * cols * ch;
  const float* r1 = img + (int64_t)y1 * cols * ch;
  for (int c = 0; c < ch; ++c) {
    float v = 0.0f;
    if (y0_in) {
      if (x0_in) v += w00 * r0[x0 * ch + c];
      if (x1_in) v += w01 * r0[x1 * ch + c];
    }
    if (y1_in) {
      if (x0_in) v += w10 * r1[x0 * ch + c];
      if (x1_in) v += w11 * r1[x1 * ch + c];
    }
    out[c] = v;
  }
}

struct Job {
  const float* img;
  int rows, cols, ch;
  float scale, tx, ty;
  uint8_t flip;
  float* out;      // out_r * out_c * ch
  float* params;   // 7
};

void run_job(const Job& j, int out_r, int out_c, bool pad_to_aspect) {
  // pad-to-aspect geometry (integer math identical to the Python path)
  int pad_l = 0, pad_t = 0;
  int padded_r = j.rows, padded_c = j.cols;
  if (pad_to_aspect) {
    const double target_ar = (double)out_c / (double)out_r;
    const double ar = (double)j.cols / (double)j.rows;
    // half-up rounding (floor(x+0.5)): the ONE rule shared with the Python
    // oracle (_augment_one_numpy) so both backends agree at half-integer
    // padded sizes (e.g. 26 rows -> 40x32 output: 32.5 pads to 33 in both).
    if (ar < target_ar) {  // too narrow: pad cols
      int new_c = (int)std::floor(j.rows * target_ar + 0.5);
      pad_l = (new_c - j.cols) / 2;
      padded_c = new_c;
    } else if (ar > target_ar) {  // too wide: pad rows
      int new_r = (int)std::floor(j.cols / target_ar + 0.5);
      pad_t = (new_r - j.rows) / 2;
      padded_r = new_r;
    }
  }
  // affine about padded center: dst = s*src + (1-s)*C/2 + t*C  (the cv2
  // warpAffine forward matrix of the reference's path; we sample its inverse)
  const float off_x = (1.0f - j.scale) * padded_c * 0.5f + j.tx * padded_c;
  const float off_y = (1.0f - j.scale) * padded_r * 0.5f + j.ty * padded_r;
  const float inv_s = 1.0f / j.scale;
  // resize: padded -> out with pixel-center alignment
  const float rx = (float)padded_c / (float)out_c;
  const float ry = (float)padded_r / (float)out_r;

  for (int yo = 0; yo < out_r; ++yo) {
    const float yp = ((float)yo + 0.5f) * ry - 0.5f;           // resize^-1
    const float y_src = (yp - off_y) * inv_s;                   // warp^-1
    const float y_orig = y_src - (float)pad_t;                  // pad^-1
    float* orow = j.out + (int64_t)yo * out_c * j.ch;
    for (int xo = 0; xo < out_c; ++xo) {
      const float xp = ((float)xo + 0.5f) * rx - 0.5f;
      const float x_src = (xp - off_x) * inv_s;
      float x_orig = x_src - (float)pad_l;
      if (j.flip) x_orig = (float)(j.cols - 1) - x_orig;
      sample_bilinear(j.img, j.rows, j.cols, j.ch, x_orig, y_orig,
                      orow + (int64_t)xo * j.ch);
    }
  }
  j.params[0] = j.scale;
  j.params[1] = j.tx;
  j.params[2] = j.ty;
  j.params[3] = (float)pad_l / (float)padded_c;
  j.params[4] = (float)pad_t / (float)padded_r;
  j.params[5] = (float)j.cols / (float)padded_c;
  j.params[6] = (float)j.rows / (float)padded_r;
}

}  // namespace

extern "C" {

// imgs: n pointers to HWC float32 images (no concatenation — images stay
// where NumPy allocated them); shapes = n x (rows, cols, channels); aug =
// n x (scale, tx, ty) drawn by the caller's RNG (keeps randomness in NumPy
// for reproducibility); flip = n bytes (horizontal flip of the ORIGINAL
// image, pascal3D.py:227-248); out = n * out_r * out_c * ch_out floats —
// ch_out is the channel count the CALLER sized `out` for, and every input
// image must match it exactly (code 2 otherwise; the output buffer is never
// written past what the caller allocated); params_out = n x 7 (scale, tx,
// ty, pad_l_frac, pad_t_frac, w_frac, h_frac — the
// image_random_augmentation params contract). Returns 0 on success.
int augment_batch(const float* const* imgs, const int32_t* shapes, int32_t n,
                  int32_t out_r, int32_t out_c, const float* aug,
                  const uint8_t* flip, int32_t pad_to_aspect, float* out,
                  float* params_out, int32_t ch_out, int32_t n_threads) {
  if (n <= 0 || out_r <= 0 || out_c <= 0 || ch_out <= 0) return 1;
  std::vector<Job> jobs((size_t)n);
  const int ch = ch_out;
  for (int i = 0; i < n; ++i) {
    if (shapes[3 * i + 2] != ch) return 2;  // every image must match ch_out
    jobs[i] = Job{imgs[i],
                  shapes[3 * i],
                  shapes[3 * i + 1],
                  ch,
                  aug[3 * i],
                  aug[3 * i + 1],
                  aug[3 * i + 2],
                  flip ? flip[i] : (uint8_t)0,
                  out + (int64_t)i * out_r * out_c * ch,
                  params_out + (int64_t)i * 7};
    if (jobs[i].scale <= 0.0f) return 3;
  }
  int hw = (int)std::thread::hardware_concurrency();
  int workers = n_threads > 0 ? n_threads : std::max(1, hw);
  workers = std::min(workers, n);
  if (workers <= 1) {
    for (int i = 0; i < n; ++i) run_job(jobs[i], out_r, out_c, pad_to_aspect != 0);
    return 0;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1))
        run_job(jobs[i], out_r, out_c, pad_to_aspect != 0);
    });
  }
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
