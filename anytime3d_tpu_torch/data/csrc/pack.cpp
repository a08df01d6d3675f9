// Native blocked bit-packer: occupancy grid -> 1 bit/voxel in the
// space-to-depth coarse-layout order. The port's copy of the JAX package's
// native/pack.cpp, built by anytime3d_tpu_torch/kernels/build.py::build_host
// and called through ctypes by data/packing.py::pack_voxels_blocked.
//
// The NumPy formulation of the blocked pack is an 8-d transpose of the full
// float grid before np.packbits, tens of ms for a (32, 64^3) batch on the
// host. This fuses threshold + blocked reorder + bit-pack into one
// single-pass loop over the source floats (one read per voxel, one write per
// 8 voxels), parallelized over the batch. A ctypes call releases the GIL, so
// a prefetch thread packs while the main thread drives the device.
//
// Bit order matches np.packbits (MSB-first) over the flatten order of the
// (B, D/b, H/b, W/b, b, b, b, C) transpose: the contract pinned by
// tests/test_torch_anytime.py against the NumPy path.
//
// Build: g++ -O3 -march=native -std=c++17 -fPIC -shared pack.cpp -lpthread -o libpack.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX__)
#include <immintrin.h>
#endif

namespace {

#if defined(__AVX__)
// movemask emits LSB-first (bit i = lane i); np.packbits wants MSB-first.
// 256-entry bit-reverse table, built once.
struct BitRev {
  uint8_t t[256];
  BitRev() {
    for (int i = 0; i < 256; ++i) {
      uint8_t r = 0;
      for (int j = 0; j < 8; ++j) r = (uint8_t)((r << 1) | ((i >> j) & 1));
      t[i] = r;
    }
  }
};
const BitRev kBitRev;
#endif

// Specialized C=1, block=4 path (the production 64^3 layout): each byte is
// built from 8 independent comparisons (two 4-voxel fine-row segments),
// breaking the 1-bit-per-cycle serial dependence of the generic
// shift-accumulate loop.
void pack_one_b4c1(const float* vox, int32_t D, int32_t H, int32_t W,
                   uint8_t* out) {
  int64_t obyte = 0;
  const int64_t sh = W;           // fine h stride
  const int64_t sd = (int64_t)H * W;  // fine d stride
  for (int32_t d0 = 0; d0 < D / 4; ++d0)
    for (int32_t h0 = 0; h0 < H / 4; ++h0)
      for (int32_t w0 = 0; w0 < W / 4; ++w0) {
        const float* base = vox + (int64_t)d0 * 4 * sd + (int64_t)h0 * 4 * sh + w0 * 4;
        for (int32_t bd = 0; bd < 4; ++bd) {
          const float* p = base + bd * sd;
          for (int32_t bh = 0; bh < 4; bh += 2) {
            const float* r0 = p + bh * sh;
            const float* r1 = r0 + sh;
#if defined(__AVX__)
            // one byte per 8 lanes: [r0[0..3], r1[0..3]] -> cmp -> movemask
            // (LSB-first) -> bit-reverse to packbits' MSB-first order.
            __m256 v8 = _mm256_insertf128_ps(
                _mm256_castps128_ps256(_mm_loadu_ps(r0)), _mm_loadu_ps(r1), 1);
            int m = _mm256_movemask_ps(
                _mm256_cmp_ps(v8, _mm256_set1_ps(0.5f), _CMP_GT_OQ));
            out[obyte++] = kBitRev.t[m & 0xff];
#else
            out[obyte++] = (uint8_t)(
                ((r0[0] > 0.5f) << 7) | ((r0[1] > 0.5f) << 6) |
                ((r0[2] > 0.5f) << 5) | ((r0[3] > 0.5f) << 4) |
                ((r1[0] > 0.5f) << 3) | ((r1[1] > 0.5f) << 2) |
                ((r1[2] > 0.5f) << 1) | ((r1[3] > 0.5f) << 0));
#endif
          }
        }
      }
}

void pack_one(const float* vox, int32_t D, int32_t H, int32_t W, int32_t C,
              int32_t b, uint8_t* out) {
  if (C == 1 && b == 4) {
    pack_one_b4c1(vox, D, H, W, out);
    return;
  }
  const int64_t bits_total = (int64_t)D * H * W * C;
  uint8_t acc = 0;
  int nb = 0;
  int64_t obyte = 0;
  for (int32_t d0 = 0; d0 < D / b; ++d0)
    for (int32_t h0 = 0; h0 < H / b; ++h0)
      for (int32_t w0 = 0; w0 < W / b; ++w0)
        for (int32_t bd = 0; bd < b; ++bd)
          for (int32_t bh = 0; bh < b; ++bh) {
            // contiguous fine-row segment: (d0*b+bd, h0*b+bh, w0*b .. +b, :)
            const float* row =
                vox + ((((int64_t)d0 * b + bd) * H + (int64_t)h0 * b + bh) * W +
                       (int64_t)w0 * b) *
                          C;
            for (int32_t i = 0; i < b * C; ++i) {
              acc = (uint8_t)((acc << 1) | (row[i] > 0.5f ? 1 : 0));
              if (++nb == 8) {
                out[obyte++] = acc;
                acc = 0;
                nb = 0;
              }
            }
          }
  if (nb) out[obyte++] = (uint8_t)(acc << (8 - nb));  // packbits zero-pad
  (void)bits_total;
}

}  // namespace

extern "C" {

// vox: (B, D, H, W, C) contiguous float32. out: (B, ceil(D*H*W*C/8)) uint8.
// Returns 0 on success, nonzero on invalid arguments.
int32_t pack_blocked_batch(const float* vox, int64_t B, int32_t D, int32_t H,
                           int32_t W, int32_t C, int32_t block, uint8_t* out,
                           int32_t n_threads) {
  if (B < 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || block <= 0) return 1;
  if (D % block || H % block || W % block) return 2;
  const int64_t voxels = (int64_t)D * H * W * C;
  const int64_t nbytes = (voxels + 7) / 8;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = (int32_t)(B > 0 ? B : 1);

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      pack_one(vox + i * voxels, D, H, W, C, block, out + i * nbytes);
  };
  if (n_threads == 1) {
    work(0, B);
    return 0;
  }
  std::vector<std::thread> threads;
  const int64_t per = (B + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = (int64_t)t * per;
    const int64_t hi = lo + per < B ? lo + per : B;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
