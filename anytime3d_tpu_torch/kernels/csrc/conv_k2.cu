// conv_k2: 2x2x2 stride-1 SAME 3-D convolution, no bias, for Hopper (sm_90a):
// the forward and the two products of its gradient, dx and dw.
//
// Replaces the TPU kernel anytime3d_tpu/kernels/conv_k2.py::_conv_k2_pallas
// (its pallas_call at conv_k2.py:156) and the backward of its custom_vjp,
// _conv_k2_bwd_impl (conv_k2.py:172-205). It computes what conv_k2_xla and
// _conv_k2_bwd_impl compute, not the Pallas body block by block:
//
//     x [B, D, H, W, C] (NDHWC), w [2, 2, 2, C, N] (DHWIO), y [B, D, H, W, N]
//     y[b, d, h, w, n] = sum_{dz,dy,dx,c} x[b, d+dz, h+dy, w+dx, c] * w[dz, dy, dx, c, n]
//
// with x read as zero past the high edge of each spatial axis (SAME padding
// for an even kernel pads lo 0, hi 1). With g = dL/dy:
//
//     dx[b, d, h, w, c]     = sum_{dz,dy,dx,n} g[b, d-dz, h-dy, w-dx, n] * w[dz, dy, dx, c, n]
//     dw[dz, dy, dx, c, n]  = sum_{b,d,h,w}    x[b, d+dz, h+dy, w+dx, c] * g[b, d, h, w, n]
//
// with g read as zero below the low edge and x as zero past the high edge.
//
// Forward: an implicit GEMM. Flatten the output to M = B*D*H*W rows and N
// columns; the reduction depth is K = 8*C, ordered (tap, c) with
// tap = dz*4 + dy*2 + dx, which is exactly the row order of w viewed as
// [8C, N]. Row m of the A operand for tap t is row m + (dz*H + dy)*W + dx of
// x viewed as [M, C], zeroed where d+dz, h+dy or w+dx leaves the grid. The
// 8 shifted row gathers never materialise an im2col buffer in device memory.
//
// dx: the same implicit GEMM with the shift mirrored (the BWD instance of the
// kernel). The A operand is g viewed as [M, N]; row m for tap t is row
// m - ((dz*H + dy)*W + dx), zeroed where d-dz, h-dy or w-dx is below 0. The
// depth is 8*N in (tap, n) order and the B operand is w re-laid to
// [2, 2, 2, N, C] (each tap transposed; the wrapper does that for the FFMA
// kernel, no flip: the mirrored shift already pairs tap t with w[t]).
//
// dw: a GEMM whose reduction axis is M. Its output is [8C, N] (row (tap, c));
// A^T for output row (t, c) at depth m is x[m + shift(t), c], edge-masked as
// in the forward, and B at depth m is row m of g. Both operands are already
// depth-major in memory, so a stage is consecutive rows of x and of g and
// lands in shared memory without a transpose. The output has few tiles
// (16 or 32 of 128 x 128 at the flagship stages) against 132 SMs, and
// each reduces over up to 131,072 rows, so the reduction is split over
// blockIdx.z: every split writes its partial [8C, N] tile into a workspace
// and a second small kernel sums the splits in a fixed order. No atomics:
// the result is the same from run to run. dw is accumulated and written in
// f32 whatever the type of x and g.
//
// What bounds it on this card: at the flagship shapes (B=8, 16^3, C->N of
// 64->512, 512->128, 128->512, 512->64) the depth is 512 to 4096 and the
// four stages need ~1.03e11 FLOPs per batch against ~0.2 GB of traffic, so
// the work is compute bound, forward and backward alike.
//
// Three designs live here. The kernels of this file are tiled SIMT GEMMs (FFMA)
// with f32 accumulators in registers: f32 is computed in true f32 (no TF32),
// bf16 is read as bf16, widened to f32, accumulated in f32 and rounded once on
// store. They take float32 calls without a narrow plan (the flagship stages
// among them) and bfloat16 calls with neither plan. The
// bfloat16 forward, dx and dw of the shapes that have a wgmma plan (C and N
// multiples of 64, rows that tile into boxes: the flagship stages) run on the
// tensor cores: conv_k2_wgmma.cuh holds those kernels (wgmma products,
// operands brought in by TMA box copies into a ring of swizzled shared-memory
// tiles) and says how they are formed; on grids of at most 8^3 an item
// whose output tiles fill at most half a wave (the mid_blocked stages at 4^3
// and 8^3, B=8), the forward and dx split their depth over blocks and
// conv_k2_split_reduce_kernel adds the splits; at 4^3 (the mid_blocked
// stages' short reductions) dw runs on persistent blocks whose f32 tiles the
// TMA stores from shared memory (conv_k2_dw_persistent_kernel). Narrow outputs (N = 8, 16, 32; C = 8,
// 16, 32, 64, and at most 32 in float32: the detector decoder's last conv) run
// over one halo box of x a block, conv_k2_narrow.cuh: the forward, dw and dx
// (the forward from N to C channels, the box one voxel lower), on mma.sync in
// bfloat16 and on FFMA in float32; so does the bfloat16 dw of a narrow input
// and N = 64 (the s2d(2) stem's 8 -> 64); and, walking C in chunks of 64, the
// bfloat16 forward and dw of a wide input (C a multiple of 64 above 64: the
// tensor-parallel shard 512 -> 32), in chunks of 16 the float32 forward (C a
// multiple of 32 above 32). That shard's bfloat16 dx, a narrow g and a wide dx,
// runs on the tensor cores over halo boxes of g, a column chunk of dx a block
// (conv_k2_chunked_dx.cuh). Which design a call takes is settled by the
// Python wrapper from shape and dtype, before the launch: the wgmma plan,
// else the narrow plan, else the dw-only narrow plan (dw) or the chunked dx
// plan (dx), else FFMA.
//
// The FFMA forward and dx (conv_k2_gemm_kernel, namespace gemm). The float32
// serving path launches it four times a batch, and what bounds it is the FFMA
// rate, so the design spends as few instruction slots as it can on anything else:
// - a block owns 128 rows by 128 columns: four warps of 64 x 64, a thread 16
//   rows by 8 columns (128 accumulators, up to 255 registers, two blocks an
//   SM): 128 FFMA for every 16 + 8 operand values read. Where N <= 64 the
//   tile is 128 x 64, a warp 32 x 64 and a thread 8 x 8. A thread's columns
//   are two runs of 4, 32 apart, so the eight lanes of a quarter warp read
//   128 consecutive bytes of B; its rows are 4 apart (row r of a warp belongs
//   to lane group r % 4) and a row of A is padded by 16 bytes, so the lane
//   groups' reads of A fall into different banks.
// - A is read without a transpose. A stage lies in shared memory as it lies
//   in device memory, [row][k] with k contiguous, and a thread reads 2 (or 4)
//   consecutive k of each of its rows as one vector: as many bytes as a
//   k-major layout would give it, all lanes of a group on one address (a
//   broadcast), and nothing to scatter on the way in.
// - three stages of 16 k in dynamic shared memory, filled by cp.async in
//   16-byte pieces (8-byte for bf16's B, whose rows are only 8-byte aligned):
//   a source size of 0 writes zeros, which is the edge mask of the gather and
//   the mask of the ragged last rows and columns. One __syncthreads a stage;
//   the loads of the next two stages are in flight under this one's FFMAs.
//   The (tap, channel) of a thread's pieces advances with the stages: no
//   division in the loop.
// - the depth split: on grids of at most 8^3 voxels an item whose tiles fill at
//   most half a wave (the mid_blocked stages in float32: 4^3 2048 -> 512 at
//   B=8 is 16 tiles of 128 x 128 on 132 SMs, each 16384 deep), the SPLIT
//   instance gives blockIdx.z a run of stages and stores f32 partials to a
//   workspace; conv_k2_dw_reduce_kernel, launched by the same C entry, sums
//   them in ascending order (no atomics: the same bits every run). The plan is
//   kernels/conv_k2.py::ffma_split: as many splits as fill one wave, each at
//   least 16 stages deep; float32 only.
// `python -m anytime3d_tpu_torch.cli.probe_ffma` (csrc/ffma_probe.cu) times the
// inner loop alone, which is what this kernel can at most reach as compiled.
//
// The FFMA dw (conv_k2_dw_kernel, namespace gemm; the float32 train step
// launches it four times a step) is built on the same pipeline, on tiles of
// its own (gemm::DwTile):
// - a block owns 128 output rows r = (tap, c) by 128 columns n (by 64 where
//   N <= 64) on 128 threads, 16 (or 8) rows by 8 columns a thread, the
//   forward's tiles. Where a side is narrow the tile fits it: 128 rows by 32
//   columns where N <= 32 (the tensor-parallel shard 512 -> 32), 64 rows by
//   64 columns where 8C <= 64 (the s2d(2) stem's 8 -> 64), each on 64
//   threads of 8 x 8, whose warps take 32 (or 64) columns; a 128 x 64 tile
//   left half its columns, or half its rows, idle there (29% and 28% of the
//   bound on an H100).
// - both operands are depth-major, so a stage is 16 rows m of x, shifted by
//   the tile's taps, and the same 16 rows of g, and each lands in shared
//   memory as it lies, [m][r] and [m][n]: no transpose, no padding. A thread
//   reads its rows as runs of 4 (16 apart; a warp's lane groups 4 apart) and
//   its columns as two runs of 4, 32 apart, each run one float4 (8 bytes of
//   bfloat16): a quarter warp reads one address of A (a broadcast) and 128
//   consecutive bytes of B.
// - a thread loads all its pieces of a stage from one row m (8 threads a row,
//   its pieces 8 apart). A piece's tap and channel are fixed for the tile, so
//   its source is row m of x plus a constant. One (d, h, w) a thread,
//   advanced 16 rows a stage with carries, gives the edge mask of all 8 taps
//   as 8 bits; a source size of 0 writes the zeros of a masked tap, of rows
//   past 8C and columns past N, and of rows past the end of the split.
// - the row reduction is split over blockIdx.z into whole stages (the Python
//   wrapper chooses the splits: one wave of blocks, kernels/conv_k2.py::
//   ffma_dw_split, which mirrors the tiles); every split writes its
//   partial [8C, N] tile into a workspace and conv_k2_dw_reduce_kernel sums
//   them in ascending order.
//
// Preconditions, checked by the Python wrapper: all tensors contiguous and
// 16-byte aligned; the depth's channel count a multiple of 8 (so every
// 8-wide slice of the depth lies in one tap and loads as one vector) and the
// output's column count a multiple of 4. That is C % 8 and N % 4 for the
// forward and dw, N % 8 and C % 4 for dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "conv_k2_chunked_dx.cuh"
#include "conv_k2_narrow.cuh"
#include "conv_k2_wgmma.cuh"

namespace {

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---- the forward and dx, and dw ----

namespace gemm {

constexpr int BM = 128;       // output rows per block
constexpr int BK = 16;        // depth per shared-memory stage
constexpr int STAGES = 3;     // stages in flight
constexpr int TN = 8;         // output columns per thread: two runs of 4, 32 apart
constexpr int WARP_N = 64;    // a warp's columns: 8 lanes of 4, twice
constexpr int LANE_ROWS = 4;  // a warp's rows: 4 lane groups, row r of the warp to group r % 4

static_assert(BK % 8 == 0 && 64 % BK == 0, "a stage is whole 16-byte pieces and divides the depth 8C (C % 8 == 0)");
static_assert(STAGES >= 2, "one stage computes while another loads");

// A block of BM rows by BN columns (128 or 64) whose threads hold TM rows (8
// or 16) by TN columns each, and how it loads a stage: A as BM rows of BK
// elements in 16-byte pieces, B as BK rows of BN elements in pieces of 4
// elements; piece i of a thread is `*_ROW_STEP` rows below its piece i - 1.
template <typename T, int BN, int TM>
struct Tile {
  static constexpr int WARP_M = LANE_ROWS * TM;
  static constexpr int THREADS = (BM / WARP_M) * (BN / WARP_N) * 32;
  static constexpr int KV = TM == 8 ? 4 : 2;  // consecutive k a thread reads of each of its rows at once
  static constexpr int A_ELEMS = 16 / sizeof(T);
  static constexpr int A_PIECES_ROW = BK / A_ELEMS;
  static constexpr int A_PER_THREAD = BM * A_PIECES_ROW / THREADS;
  static constexpr int A_ROW_STEP = THREADS / A_PIECES_ROW;
  // a row of A in shared memory: BK elements and 16 bytes of padding, so that the rows of a
  // warp's four lane groups (neighbours) start in different banks
  static constexpr int A_PITCH = BK + A_ELEMS;
  static constexpr int B_PIECES_ROW = BN / 4;
  static constexpr int B_PER_THREAD = BK * B_PIECES_ROW / THREADS;
  static constexpr int B_ROW_STEP = THREADS / B_PIECES_ROW;
  static constexpr int STAGE_ELEMS = BM * A_PITCH + BK * BN;
  static constexpr size_t SMEM_BYTES = static_cast<size_t>(STAGES) * STAGE_ELEMS * sizeof(T);
  // blocks an SM: 128 registers a thread for 8 x 8 outputs, up to 255 for 16 x 8
  static constexpr int MIN_BLOCKS = (TM == 8 ? 512 : 256) / THREADS;
  static_assert(TM == 8 || TM == 16, "KV and MIN_BLOCKS are set for these");
  static_assert(BM % WARP_M == 0 && BN % WARP_N == 0, "warps tile the block");
  static_assert(A_PER_THREAD >= 1 && A_PER_THREAD <= 4 && A_PER_THREAD * THREADS == BM * A_PIECES_ROW, "A pieces");
  static_assert(B_PER_THREAD >= 1 && B_PER_THREAD * THREADS == BK * B_PIECES_ROW, "B pieces");
};

// 16 bytes from device to shared memory, or 16 zero bytes where !ok (`src` is
// then not read, but must be an address of the tensor).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wg::smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 elements of B: 16 bytes of float, 8 of bfloat16 (a row of w [K, N] with
// N % 4 == 0 is only 8-byte aligned there).
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool ok) { cp_async_16(dst, src, ok); }

__device__ __forceinline__ void cp_async_4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(wg::smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// KV (2 or 4) consecutive elements as floats.
template <int KV, typename T>
__device__ __forceinline__ void load_k(const T* p, float* out) {
  if constexpr (KV == 4) {
    load4(p, out);
  } else if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
}

// Forward (BWD = false): y = conv(x, w), x [M, C], w [8C, N], y [M, N].
// dx (BWD = true): called with x := g [M, N'], w := w^T [8N', C'], y := dx
// [M, C'], C := N', N := C'; tap t reads row m - shift(t), masked at the low edge.
// SPLIT: blockIdx.z is a split of the depth, the stages [z * split_stages,
// min(8C/BK, (z + 1) * split_stages)), and the block stores its f32 partial to
// part[z] [M, N] instead of y. Without it `part` and `split_stages` are not
// read and the instance carries none of the split's state.
template <typename T, bool BWD, int BN, int TM, bool SPLIT>
__global__ void __launch_bounds__(Tile<T, BN, TM>::THREADS, Tile<T, BN, TM>::MIN_BLOCKS)
conv_k2_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, float* __restrict__ part,
                    int D, int H, int W, int C, int N, long long M, int split_stages) {
  using L = Tile<T, BN, TM>;
  // stage s: A [BM][A_PITCH] as it lies in x (k contiguous), then B [BK][BN]
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  T* const smem = reinterpret_cast<T*>(gemm_smem);

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int first = SPLIT ? static_cast<int>(blockIdx.z) * split_stages : 0;  // the split's first stage
  const int n_stages = SPLIT ? min(split_stages, 8 * C / BK - first) : 8 * C / BK;

  // A loader: pieces of 16 bytes, L::A_PIECES_ROW consecutive threads on one
  // row; this thread's piece i is row a_row + i * A_ROW_STEP, elements a_k ..
  const int a_row = tid / L::A_PIECES_ROW;
  const int a_k = (tid % L::A_PIECES_ROW) * L::A_ELEMS;
  unsigned tap_ok = 0;  // bit 8 i + t: tap t of piece i's row lies inside the grid
  {
    const long long S = static_cast<long long>(D) * H * W;
#pragma unroll
    for (int i = 0; i < L::A_PER_THREAD; ++i) {
      const long long m = m0 + a_row + i * L::A_ROW_STEP;
      if (m >= M) continue;
      const long long s = m % S;
      const int d = static_cast<int>(s / (static_cast<long long>(H) * W));
      const int h = static_cast<int>((s / W) % H);
      const int ww = static_cast<int>(s % W);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int dz = t >> 2, dy = (t >> 1) & 1, dx = t & 1;
        const bool ok = BWD ? (d - dz >= 0 && h - dy >= 0 && ww - dx >= 0)
                            : (d + dz < D && h + dy < H && ww + dx < W);
        if (ok) tap_ok |= 1u << (8 * i + t);
      }
    }
  }
  const long long a_off = (m0 + a_row) * C;  // of piece 0's row in x; only read where tap_ok says so

  // B loader: pieces of 4 columns, L::B_PIECES_ROW consecutive threads on one
  // k; this thread's piece i is row b_k + i * B_ROW_STEP of the stage.
  const int b_k = tid / L::B_PIECES_ROW;
  const int b_n = (tid % L::B_PIECES_ROW) * 4;
  const bool b_ok = n0 + b_n < N;
  const long long b_off = static_cast<long long>(b_k) * N + n0 + b_n;

  // (tap, channel) of this thread's pieces of A in the next stage to load: a piece is 4 or 8
  // elements from a multiple of as many, and C % 8 == 0, so it lies in one tap
  int tap = (first * BK + a_k) / C;
  int c = first * BK + a_k - tap * C;

  auto load_stage = [&](int stage, int slot) {
    T* const As = smem + slot * L::STAGE_ELEMS;
    T* const Bs = As + BM * L::A_PITCH;
    const long long shift = (static_cast<long long>((tap >> 2) * H + ((tap >> 1) & 1)) * W + (tap & 1)) * C;
    const long long src = a_off + (BWD ? -shift : shift) + c;
#pragma unroll
    for (int i = 0; i < L::A_PER_THREAD; ++i) {
      const bool ok = (tap_ok >> (8 * i + tap)) & 1u;
      cp_async_16(As + (a_row + i * L::A_ROW_STEP) * L::A_PITCH + a_k,
                  ok ? x + src + static_cast<long long>(i * L::A_ROW_STEP) * C : x, ok);
    }
#pragma unroll
    for (int i = 0; i < L::B_PER_THREAD; ++i) {
      const long long row = static_cast<long long>(stage) * BK + i * L::B_ROW_STEP;
      cp_async_4(Bs + (b_k + i * L::B_ROW_STEP) * BN + b_n, b_ok ? w + b_off + row * N : w, b_ok);
    }
    c += BK;  // stages are loaded in order: on to the next one's tap and channel
    while (c >= C) {
      c -= C;
      ++tap;
    }
  };

  // this thread's outputs: rows row0, row0 + 4, ... (TM of them), columns col0 .. + 3 and
  // col0 + 32 .. + 35 of the block's tile
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (warp / (BN / WARP_N)) * L::WARP_M + (lane >> 3);
  const int col0 = (warp % (BN / WARP_N)) * WARP_N + (lane & 7) * 4;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(first + s, s);
    cp_async_commit();
  }
  int slot = 0, load_slot = STAGES - 1;
  for (int stage = 0; stage < n_stages; ++stage) {
    cp_async_wait<STAGES - 2>();  // this thread's pieces of `stage` have landed
    __syncthreads();              // everyone's have, and everyone is done with the slot loaded next
    if (stage + STAGES - 1 < n_stages) load_stage(first + stage + STAGES - 1, load_slot);
    cp_async_commit();  // an empty group at the tail keeps the count of pending groups
    const T* const a_base = smem + slot * L::STAGE_ELEMS + row0 * L::A_PITCH;
    const T* const b_base = smem + slot * L::STAGE_ELEMS + BM * L::A_PITCH + col0;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += L::KV) {
      float a[TM][L::KV];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_k<L::KV>(a_base + i * LANE_ROWS * L::A_PITCH + k0, a[i]);
#pragma unroll
      for (int kk = 0; kk < L::KV; ++kk) {
        float b[TN];
        load4(b_base + (k0 + kk) * BN, b);
        load4(b_base + (k0 + kk) * BN + WARP_N / 2, b + 4);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    if (++slot == STAGES) slot = 0;
    if (++load_slot == STAGES) load_slot = 0;
  }

  auto* const out = [&] {
    if constexpr (SPLIT) return part + blockIdx.z * M * N;
    else return y;
  }();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long mo = m0 + row0 + i * LANE_ROWS;
    if (mo >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + col0 + half * (WARP_N / 2);
      if (n < N) store4(out + mo * N + n, acc[i] + 4 * half);
    }
  }
}

// dw's tile: BM output rows r = (tap, c) by BN columns n on warps of WARP_M
// rows by WARP_N columns, LC lanes of a warp along the columns and 32 / LC
// along the rows; a thread holds TM rows (runs of 4, RUN_STEP apart) by 8
// columns (two runs of 4, WARP_N / 2 apart). LC = 8 gives the forward Tile's
// warps (64 columns); LC = 4 warps of 32 columns. A stage is BK rows m of x,
// shifted by the tile's taps, as [BK][BM] and the same rows of g as [BK][BN],
// each as it lies in device memory. Thread tid loads row tid / ROW_THREADS of
// the stage; its pieces of x are 16 bytes (A_ELEMS rows r), A_STEP rows r
// apart, and of g 4 elements, B_STEP columns apart.
template <typename T, int BM_, int BN, int TM, int LC>
struct DwTile {
  static constexpr int BM = BM_;
  static constexpr int LANE_ROWS = 32 / LC;
  static constexpr int WARP_N = 8 * LC;
  static constexpr int WARP_M = LANE_ROWS * TM;
  static constexpr int THREADS = (BM / WARP_M) * (BN / WARP_N) * 32;
  // blocks an SM: 128 registers a thread for 8 x 8 outputs, up to 255 for 16 x 8
  static constexpr int MIN_BLOCKS = (TM == 8 ? 512 : 256) / THREADS;
  static constexpr int A_ELEMS = 16 / sizeof(T);
  static constexpr int ROW_THREADS = THREADS / BK;
  static constexpr int A_PER_THREAD = BM / A_ELEMS / ROW_THREADS;
  static constexpr int A_STEP = ROW_THREADS * A_ELEMS;
  static constexpr int B_PER_THREAD = BN / 4 / ROW_THREADS;
  static constexpr int B_STEP = ROW_THREADS * 4;
  static constexpr int RUN_STEP = LANE_ROWS * 4;  // a thread's rows: runs of 4, this far apart
  static constexpr int STAGE_ELEMS = BK * (BM + BN);
  static constexpr size_t SMEM_BYTES = static_cast<size_t>(STAGES) * STAGE_ELEMS * sizeof(T);
  static_assert(LC == 4 || LC == 8, "a quarter warp reads one or two addresses of A and 128 or 64 bytes of B");
  static_assert(TM == 8 || TM == 16, "MIN_BLOCKS is set for these");
  static_assert(BM % WARP_M == 0 && BN % WARP_N == 0, "warps tile the block");
  static_assert(ROW_THREADS * BK == THREADS, "the threads cover the stage's rows");
  static_assert(A_PER_THREAD >= 1 && A_PER_THREAD <= 8 && A_PER_THREAD * A_STEP == BM, "A pieces, 4 tap bits each");
  static_assert(B_PER_THREAD >= 1 && B_PER_THREAD * B_STEP == BN, "B pieces");
  static_assert(TM % 4 == 0 && RUN_STEP * (TM / 4) == WARP_M, "a thread's runs cover its warp's rows");
};

// dw partial: part[z][r][n] = sum over the rows m of split z of x[m + shift(t), c] * g[m, n],
// r = t*C + c; x [M, C], g [M, N], part [gridDim.z][8C][N] in f32. blockIdx.x is the row tile,
// blockIdx.y the column tile; split z reduces the rows [z * BK * stages_per_split, min(M, (z + 1)
// * BK * stages_per_split)).
template <typename T, int BM_, int BN, int TM, int LC>
__global__ void __launch_bounds__(DwTile<T, BM_, BN, TM, LC>::THREADS, DwTile<T, BM_, BN, TM, LC>::MIN_BLOCKS)
conv_k2_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                  int D, int H, int W, int C, int N, long long M, int stages_per_split) {
  using DL = DwTile<T, BM_, BN, TM, LC>;
  constexpr int BM = DL::BM;
  // stage s: A [BK][BM], then B [BK][BN]
  extern __shared__ __align__(16) uint8_t dw_smem[];
  T* const smem = reinterpret_cast<T*>(dw_smem);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int R = 8 * C;
  const long long m_begin = static_cast<long long>(blockIdx.z) * stages_per_split * BK;
  const long long split_end = m_begin + static_cast<long long>(stages_per_split) * BK;
  const int split_rows = static_cast<int>((split_end < M ? split_end : M) - m_begin);
  const int n_stages = (split_rows + BK - 1) / BK;

  // the loaders: row `lr` of every stage, pieces from `lp`
  const int lr = tid / DL::ROW_THREADS;
  const int lp = tid % DL::ROW_THREADS;
  // A piece i: rows lp * A_ELEMS + i * A_STEP of the tile, all of one tap t (C % 8 == 0), read from row
  // m + shift(t) of x: `a_off[i]` elements from row m. `a_tap` holds t in bits 4i..4i+3, or 8 (a bit of
  // `inside` that is never set) for rows past 8C.
  int a_off[DL::A_PER_THREAD];
  unsigned a_tap = 0;
#pragma unroll
  for (int i = 0; i < DL::A_PER_THREAD; ++i) {
    const int r = r0 + lp * DL::A_ELEMS + i * DL::A_STEP;
    const int t = r < R ? r / C : 8;
    const int c = r - t * C;
    a_off[i] = t < 8 ? (((t >> 2) * H + ((t >> 1) & 1)) * W + (t & 1)) * C + c : 0;
    a_tap |= static_cast<unsigned>(t) << (4 * i);
  }
  // B piece i: columns n0 + lp * 4 + i * B_STEP; bit i of `b_ok`: they lie below N
  unsigned b_ok = 0;
#pragma unroll
  for (int i = 0; i < DL::B_PER_THREAD; ++i)
    if (n0 + lp * 4 + i * DL::B_STEP < N) b_ok |= 1u << i;

  // (d, h, w) of the loaders' row, advanced by BK rows a stage: by (sd, sh, sw) with carries
  const long long m = m_begin + lr;
  const long long S = static_cast<long long>(D) * H * W;
  const long long s0 = m % S;
  int d = static_cast<int>(s0 / (static_cast<long long>(H) * W));
  int h = static_cast<int>((s0 / W) % H);
  int w = static_cast<int>(s0 % W);
  const int step = static_cast<int>(BK % S);
  const int sd = step / (H * W), sh = (step / W) % H, sw = step % W;
  const T* xm = x + m * C;
  const T* gm = g + m * N + n0 + lp * 4;
  int rows_left = split_rows - lr;  // the loaders' row lies in the split while this is > 0

  auto load_stage = [&](int slot) {
    T* const As = smem + slot * DL::STAGE_ELEMS + lr * BM + lp * DL::A_ELEMS;
    T* const Bs = smem + slot * DL::STAGE_ELEMS + BK * BM + lr * BN + lp * 4;
    // bit t: tap t of this row lies inside the grid (odd taps step in w, taps 2, 3, 6, 7 in h, 4-7 in d)
    unsigned inside = rows_left > 0 ? 0xFFu : 0u;
    if (w + 1 >= W) inside &= 0x55u;
    if (h + 1 >= H) inside &= 0x33u;
    if (d + 1 >= D) inside &= 0x0Fu;
#pragma unroll
    for (int i = 0; i < DL::A_PER_THREAD; ++i) {
      const bool ok = (inside >> ((a_tap >> (4 * i)) & 15u)) & 1u;
      cp_async_16(As + i * DL::A_STEP, ok ? xm + a_off[i] : x, ok);
    }
#pragma unroll
    for (int i = 0; i < DL::B_PER_THREAD; ++i) {
      const bool ok = rows_left > 0 && ((b_ok >> i) & 1u);
      cp_async_4(Bs + i * DL::B_STEP, ok ? gm + i * DL::B_STEP : g, ok);
    }
    rows_left -= BK;
    xm += BK * C;
    gm += BK * N;
    w += sw;
    if (w >= W) { w -= W; ++h; }
    h += sh;
    if (h >= H) { h -= H; ++d; }
    d += sd;
    if (d >= D) d -= D;
  };

  // this thread's outputs: rows row0 + RUN_STEP * j + 0..3 (j < TM / 4), columns col0 .. + 3 and
  // col0 + WARP_N / 2 .. + 3 of the block's tile
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (warp / (BN / DL::WARP_N)) * DL::WARP_M + (lane / LC) * 4;
  const int col0 = (warp % (BN / DL::WARP_N)) * DL::WARP_N + (lane % LC) * 4;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // CONV_K2_NARROW_PROBE (cli/probe_narrow.py's builds): 1 without the loads, 2 without the products
  constexpr bool LOADS = !(nr::PROBE & 1), PRODUCTS = !(nr::PROBE & 2);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (LOADS && s < n_stages) load_stage(s);
    cp_async_commit();
  }
  int slot = 0, load_slot = STAGES - 1;
  for (int stage = 0; stage < n_stages; ++stage) {
    cp_async_wait<STAGES - 2>();  // this thread's pieces of `stage` have landed
    __syncthreads();              // everyone's have, and everyone is done with the slot loaded next
    if (LOADS && stage + STAGES - 1 < n_stages) load_stage(load_slot);
    cp_async_commit();  // an empty group at the tail keeps the count of pending groups
    const T* const a_base = smem + slot * DL::STAGE_ELEMS + row0;
    const T* const b_base = smem + slot * DL::STAGE_ELEMS + BK * BM + col0;
#pragma unroll
    for (int kk = 0; kk < (PRODUCTS ? BK : 0); ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int j = 0; j < TM / 4; ++j) load4(a_base + kk * BM + j * DL::RUN_STEP, a + 4 * j);
      load4(b_base + kk * BN, b);
      load4(b_base + kk * BN + DL::WARP_N / 2, b + 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (++slot == STAGES) slot = 0;
    if (++load_slot == STAGES) load_slot = 0;
  }

  float* const out = part + static_cast<long long>(blockIdx.z) * R * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + row0 + (i / 4) * DL::RUN_STEP + i % 4;
    if (r >= R) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + col0 + half * (DL::WARP_N / 2);
      if (n < N) store4(out + static_cast<long long>(r) * N + n, acc[i] + 4 * half);
    }
  }
}

}  // namespace gemm

__device__ __forceinline__ void add_to(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, const float b) { a += b; }

// dw[i] = sum_z part[z][i], z ascending: the same order in every run, so the
// same bits whether a thread takes one entry (Vec = float) or four (float4).
// The loop is unrolled so that a thread has 16 loads in flight, not one: the
// adds keep their order, the loads of a run of splits go out together.
template <typename Vec>
__global__ void conv_k2_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, long long count,
                                         int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const Vec* p = reinterpret_cast<const Vec*>(part);
  Vec sum = p[i];
#pragma unroll 16
  for (int z = 1; z < splits; ++z) add_to(sum, p[static_cast<long long>(z) * count + i]);
  reinterpret_cast<Vec*>(dw)[i] = sum;
}

// The dw reduce of `count` entries (a multiple of 4): four a thread in blocks
// of 256 where that fills the card; else (the narrow kernels' dw, a few
// thousand entries over ~128 splits) one a thread in blocks of 64, so that the
// loads spread over as many SMs as there are 64 entries. Four a thread in
// blocks of 256 put the s2d(2) stem's 128 x 4096 partials on 4 SMs, whose
// load rate then bounded the reduce (the stem's dw at B=8 on an H100 took
// 0.0378 ms with that launch, 0.0331 with this one; PERF.md section 6).
cudaError_t launch_dw_reduce(const float* part, float* dw, long long count, int splits, cudaStream_t s) {
  const long long count4 = count / 4;
  if (count4 >= 132LL * 256)
    conv_k2_dw_reduce_kernel<float4><<<static_cast<unsigned>((count4 + 255) / 256), 256, 0, s>>>(part, dw, count4,
                                                                                                 splits);
  else
    conv_k2_dw_reduce_kernel<float><<<static_cast<unsigned>((count + 63) / 64), 64, 0, s>>>(part, dw, count, splits);
  return cudaGetLastError();
}

// The split forward's (and dx's) y[i] = bf16(sum_z part[z][i]), z ascending,
// rounded once: the f32 partials of conv_k2_fwd_wgmma_kernel's splits
// (conv_k2_wgmma.cuh), 4 elements a thread, 16 loads in flight as above. What
// bounds it: bytes, splits x 4 bytes read for 2 written an element; the
// partials were written just before, so most come from L2.
__global__ void conv_k2_split_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ y,
                                            long long count4, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  const float4* p = reinterpret_cast<const float4*>(part);
  float4 sum = p[i];
#pragma unroll 16
  for (int z = 1; z < splits; ++z) add_to(sum, p[static_cast<long long>(z) * count4 + i]);
  reinterpret_cast<uint2*>(y)[i] = make_uint2(wg::pack_bf16(sum.x, sum.y), wg::pack_bf16(sum.z, sum.w));
}

// `splits` parts of `per_split` stages each cover `total` stages, the last part possibly shorter, none empty.
bool splits_cover(int splits, int per_split, long long total) {
  return splits >= 1 && per_split >= 1 && static_cast<long long>(splits - 1) * per_split < total &&
         static_cast<long long>(splits) * per_split >= total;
}

// The forward or dx at one tile; with splits > 1 (float32 only) the SPLIT instance writes the f32
// partials of its runs of stages to `part` [splits, M, N], and conv_k2_dw_reduce_kernel sums them into
// y in ascending order, launched next: one call from the host for both.
template <typename T, bool BWD, int TILE_N, int TM>
cudaError_t launch_gemm_tile(const void* x, const void* w, void* y, float* part, int splits, int per_split, int D,
                             int H, int W, int C, int N, long long M, cudaStream_t s) {
  using L = gemm::Tile<T, TILE_N, TM>;
  auto kernel = gemm::conv_k2_gemm_kernel<T, BWD, TILE_N, TM, false>;
  if constexpr (sizeof(T) == 4) {
    if (splits > 1) kernel = gemm::conv_k2_gemm_kernel<T, BWD, TILE_N, TM, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((M + gemm::BM - 1) / gemm::BM),
                  static_cast<unsigned>((N + TILE_N - 1) / TILE_N), static_cast<unsigned>(splits));
  kernel<<<grid, L::THREADS, L::SMEM_BYTES, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                  static_cast<T*>(y), part, D, H, W, C, N, M, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_dw_reduce(part, static_cast<float*>(y), M * N, splits, s);
}

// Tiles of 128 columns and 16 rows a thread, or of 64 and 8 where the output is no wider: there 16
// rows a thread would leave an SM four warps at the flagship sizes, too few to hide anything. Outputs of
// 8, 16 or 32 columns come here only without a narrow plan (float32 at C = 64, shapes whose box does not
// fit), and then leave most of the 64 idle. The depth's 8C/16 stages are cut into `splits` runs of
// `per_split` (kernels/conv_k2.py::ffma_split; only float32 splits).
template <typename T, bool BWD>
cudaError_t launch_gemm(const void* x, const void* w, void* y, float* part, int splits, int per_split, int D, int H,
                        int W, int C, int N, long long M, cudaStream_t s) {
  if (!splits_cover(splits, per_split, 8LL * C / gemm::BK) || (splits > 1 && (sizeof(T) != 4 || part == nullptr)))
    return cudaErrorInvalidValue;
  if (N <= 64) return launch_gemm_tile<T, BWD, 64, 8>(x, w, y, part, splits, per_split, D, H, W, C, N, M, s);
  return launch_gemm_tile<T, BWD, 128, 16>(x, w, y, part, splits, per_split, D, H, W, C, N, M, s);
}

// dw's partial sums (into dw itself where splits == 1), then their sum, at one tile.
template <typename T, int TILE_M, int TILE_N, int TM, int LC>
cudaError_t launch_dw_tile(const void* x, const void* g, float* dw, float* workspace, int splits, int stages_per_split,
                           int D, int H, int W, int C, int N, long long M, cudaStream_t s) {
  using DL = gemm::DwTile<T, TILE_M, TILE_N, TM, LC>;
  auto kernel = gemm::conv_k2_dw_kernel<T, TILE_M, TILE_N, TM, LC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(DL::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((8 * C + TILE_M - 1) / TILE_M),
                  static_cast<unsigned>((N + TILE_N - 1) / TILE_N), static_cast<unsigned>(splits));
  kernel<<<grid, DL::THREADS, DL::SMEM_BYTES, s>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                                   splits == 1 ? dw : workspace, D, H, W, C, N, M, stages_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_dw_reduce(workspace, dw, static_cast<long long>(8) * C * N, splits, s);
}

// The tile (kernels/conv_k2.py::_ffma_dw_tile mirrors it): where a side is narrow, one that fits it, 128 rows
// by 32 columns where N <= 32 (the tensor-parallel shard 512 -> 32) and 64 rows by 64 columns where 8C <= 64
// (the s2d(2) stem's 8 -> 64), each on 64 threads of 8 x 8 outputs: the 128 x 64 tile left half its
// columns or rows idle there. Else the forward's tiles: 128 columns and 16 rows a thread, or 64 and 8 where
// N <= 64.
template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* dw, float* workspace, int splits, int stages_per_split,
                      int D, int H, int W, int C, int N, long long M, cudaStream_t s) {
  if (!splits_cover(splits, stages_per_split, (M + gemm::BK - 1) / gemm::BK)) return cudaErrorInvalidValue;
#define DW_ARGS x, g, dw, workspace, splits, stages_per_split, D, H, W, C, N, M, s
  if (N <= 32) return launch_dw_tile<T, 128, 32, 8, 4>(DW_ARGS);
  if (8 * C <= 64) return launch_dw_tile<T, 64, 64, 8, 8>(DW_ARGS);
  if (N <= 64) return launch_dw_tile<T, 128, 64, 8, 8>(DW_ARGS);
  return launch_dw_tile<T, 128, 128, 16, 8>(DW_ARGS);
#undef DW_ARGS
}

// The tensor-core forward (DX = false: `depth` = C, `cols` = N) or dx (DX =
// true: x := g, `depth` = N, `cols` = C, y := dx) at the tile the plan names.
// With splits > 1 the depth's 8 depth/64 stages are cut into `splits` runs of
// `stages_per_split`, the kernel writes f32 partials to `part` [splits, M,
// cols], and conv_k2_split_reduce_kernel then sums them into y (as the dw
// entries launch their reduce: one call from the host for both). K4: the
// lowered stride-2 k=4 conv's (conv_k4s2_* below).
template <bool DX, bool K4 = false>
int launch_wgmma_gemm(const void* x, const void* w, void* y, float* part, int B, int D, int H, int W, int depth,
                      int cols, int bw, int bh, int bd, int bb, int bm, int bn, int stages, int grid, int smem_bytes,
                      int tiles, int splits, int stages_per_split, cudaStream_t s) {
  if (depth % wg::BK || cols % bn || !wg::box_tiles(B, D, H, W, bw, bh, bd, bb, bm) || stages < 2 ||
      stages > wg::MAX_STAGES || grid < 1 || !splits_cover(splits, stages_per_split, 8LL * depth / wg::BK))
    return static_cast<int>(cudaErrorInvalidValue);
#define GEMM_ARGS x, w, y, part, B, D, H, W, depth, cols, bw, bh, bd, bb, stages, grid, smem_bytes, tiles, splits, \
                  stages_per_split, s
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128 && bn == 128) rc = wg::launch_fwd<128, 1, DX, K4>(GEMM_ARGS);
  else if (bm == 128 && bn == 64) rc = wg::launch_fwd<64, 1, DX, K4>(GEMM_ARGS);
  else if (bm == 256 && bn == 128) rc = wg::launch_fwd<128, 2, DX, K4>(GEMM_ARGS);
  else if (bm == 256 && bn == 64) rc = wg::launch_fwd<64, 2, DX, K4>(GEMM_ARGS);
#undef GEMM_ARGS
  if (rc || splits == 1) return rc;
  // cols % 64 == 0: whole float4 groups; 4 outputs a thread
  const long long count4 = static_cast<long long>(B) * D * H * W * cols / 4;
  conv_k2_split_reduce_kernel<<<static_cast<unsigned>((count4 + 255) / 256), 256, 0, s>>>(
      part, static_cast<__nv_bfloat16*>(y), count4, splits);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core dw (the entries' checks, the kernel, the reduce of its splits). K4: the lowered conv's, C
// = 8 cf the channels of X, D, H, W g's grid.
template <bool K4>
int launch_wgmma_dw(const void* x, const void* g, void* dw, void* workspace, int splits, int stages_per_split, int B,
                    int D, int H, int W, int C, int N, int bw, int bh, int bd, int bb, int bn, int stages,
                    int smem_bytes, cudaStream_t s) {
  const long long total = static_cast<long long>(B) * D * H * W / wg::BK;
  if (C % wg::BK || N % bn || !wg::box_tiles(B, D, H, W, bw, bh, bd, bb, wg::BK) || stages < 2 ||
      stages > wg::MAX_STAGES || !splits_cover(splits, stages_per_split, total))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = static_cast<float*>(dw);
  float* part = splits == 1 ? out : static_cast<float*>(workspace);
  int rc;
  if (bn == 128)
    rc = wg::launch_dw<128, K4>(x, g, part, splits, stages_per_split, B, D, H, W, C, N, bw, bh, bd, bb, stages,
                                smem_bytes, s);
  else if (bn == 64)
    rc = wg::launch_dw<64, K4>(x, g, part, splits, stages_per_split, B, D, H, W, C, N, bw, bh, bd, bb, stages,
                               smem_bytes, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc || splits == 1) return rc;
  return static_cast<int>(launch_dw_reduce(part, out, static_cast<long long>(8) * C * N, splits, s));
}

// The persistent tensor-core dw, as launch_wgmma_dw.
template <bool K4>
int launch_persistent_dw(const void* x, const void* g, void* dw, void* workspace, int B, int D, int H, int W, int C,
                         int N, int bw, int bh, int bd, int bb, int bn, int stages, int grid, int smem_bytes, int tiles,
                         int splits, int stages_per_split, cudaStream_t s) {
  const long long total = static_cast<long long>(B) * D * H * W / wg::BK;
  if (C % wg::BK || N % bn || !wg::box_tiles(B, D, H, W, bw, bh, bd, bb, wg::BK) || stages < 2 ||
      stages > wg::MAX_STAGES || !splits_cover(splits, stages_per_split, total))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = static_cast<float*>(dw);
  float* part = splits == 1 ? out : static_cast<float*>(workspace);
  if (bn != wg::DW_PERSISTENT_BN) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = wg::launch_dw_persistent<K4>(x, g, part, B, D, H, W, C, N, bw, bh, bd, bb, stages, grid,
                                              smem_bytes, tiles, splits, stages_per_split, s);
  if (rc || splits == 1) return rc;
  return static_cast<int>(launch_dw_reduce(part, out, static_cast<long long>(8) * C * N, splits, s));
}

}  // namespace

extern "C" {

// Every entry point: dtype 0 = float32, 1 = bfloat16. Launches on `stream`
// (a cudaStream_t) of `device`, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

// y [B,D,H,W,N] = conv_k2(x [B,D,H,W,C], w [2,2,2,C,N]). The 8C/16 stages of
// the depth are cut into `splits` runs of `stages_per_split` (the last may be
// shorter, none is empty; more than one in float32 only); `workspace` holds
// splits*B*D*H*W*N floats of partials (null when splits == 1), which the
// reduce launched next sums into y.
int conv_k2_forward(const void* x, const void* w, void* y, void* workspace, int splits, int stages_per_split, int B,
                    int D, int H, int W, int C, int N, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(B) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(workspace);
#define GEMM_ARGS x, w, y, part, splits, stages_per_split, D, H, W, C, N, M, s
  if (dtype == 0) return static_cast<int>(launch_gemm<float, false>(GEMM_ARGS));
  if (dtype == 1) return static_cast<int>(launch_gemm<__nv_bfloat16, false>(GEMM_ARGS));
#undef GEMM_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx [B,D,H,W,C] from g [B,D,H,W,N] and wt [2,2,2,N,C] (each tap of w
// transposed); the 8N/16 stages of its depth split as the forward's.
int conv_k2_backward_input(const void* g, const void* wt, void* dx, void* workspace, int splits, int stages_per_split,
                           int B, int D, int H, int W, int C, int N, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(B) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(workspace);
#define GEMM_ARGS g, wt, dx, part, splits, stages_per_split, D, H, W, N, C, M, s
  if (dtype == 0) return static_cast<int>(launch_gemm<float, true>(GEMM_ARGS));
  if (dtype == 1) return static_cast<int>(launch_gemm<__nv_bfloat16, true>(GEMM_ARGS));
#undef GEMM_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw [2,2,2,C,N] in float32 from x [B,D,H,W,C] and g [B,D,H,W,N]. The
// ceil(B*D*H*W / 16) stages of 16 rows of the row reduction are cut into
// `splits` parts of `stages_per_split` (the last may be shorter, none is
// empty); `workspace` holds splits*8*C*N floats (unused when splits == 1).
int conv_k2_backward_weight(const void* x, const void* g, void* dw, void* workspace, int splits,
                            int stages_per_split, int B, int D, int H, int W, int C, int N, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(B) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* ws = static_cast<float*>(workspace);
#define DW_ARGS x, g, out, ws, splits, stages_per_split, D, H, W, C, N, M, s
  if (dtype == 0) return static_cast<int>(launch_dw<float>(DW_ARGS));
  if (dtype == 1) return static_cast<int>(launch_dw<__nv_bfloat16>(DW_ARGS));
#undef DW_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 tensor-core forward. The wrapper's plan gives the output tile
// (bm rows, 128 or 256, by bn columns, 64 or 128), the box of its bm rows
// (bw, bh, bd) in (w, h, d) by bb batch items (bb > 1 only where the box is
// the whole grid of each item), the ring's stages, the number of blocks that
// share the work items (tile, split), and the dynamic shared memory and the
// tile count it worked out, which must be this file's own (else
// wg::PLAN_MISMATCH). With `splits` > 1 the 8C/64 stages of the sum are cut
// into runs of `stages_per_split` (the last may be shorter, none is empty),
// `workspace` [splits, B*D*H*W, N] f32 receives the partials, and
// conv_k2_split_reduce_kernel, launched next on the same stream, sums them
// into y. Needs C % 64 == 0, N % bn == 0 and boxes that tile the rows
// (wg::box_tiles).
int conv_k2_forward_wgmma(const void* x, const void* w, void* y, void* workspace, int B, int D, int H, int W,
                          int C, int N, int bw, int bh, int bd, int bb, int bm, int bn, int stages, int grid,
                          int smem_bytes, int tiles, int splits, int stages_per_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_wgmma_gemm<false>(x, w, y, static_cast<float*>(workspace), B, D, H, W, C, N, bw, bh, bd, bb, bm, bn,
                                  stages, grid, smem_bytes, tiles, splits, stages_per_split,
                                  static_cast<cudaStream_t>(stream));
}

// The bfloat16 tensor-core dx [B,D,H,W,C] from g [B,D,H,W,N] and w [2,2,2,C,N]
// as it lies (no re-lay). The plan is that of a forward from N to C channels:
// tiles of bm rows by bn columns of C, the same box, ring, grid, shared memory,
// tile count and splits (of the 8N/64 stages; partials [splits, B*D*H*W, C]).
// Needs N % 64 == 0, C % bn == 0 and boxes that tile the rows.
int conv_k2_backward_input_wgmma(const void* g, const void* w, void* dx, void* workspace, int B, int D, int H,
                                 int W, int C, int N, int bw, int bh, int bd, int bb, int bm, int bn, int stages,
                                 int grid, int smem_bytes, int tiles, int splits, int stages_per_split, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_wgmma_gemm<true>(g, w, dx, static_cast<float*>(workspace), B, D, H, W, N, C, bw, bh, bd, bb, bm, bn,
                                 stages, grid, smem_bytes, tiles, splits, stages_per_split,
                                 static_cast<cudaStream_t>(stream));
}

// The bfloat16 tensor-core dw: the box of a stage's 64 rows (bw, bh, bd) by bb
// batch items; the M/64 stages of the row reduction are cut into `splits`
// parts of `stages_per_split` (the last may be shorter, none is empty);
// `workspace` holds splits*8*C*N floats (unused when splits == 1);
// `smem_bytes` is the plan's dynamic shared memory, held to this file's own.
int conv_k2_backward_weight_wgmma(const void* x, const void* g, void* dw, void* workspace, int splits,
                                  int stages_per_split, int B, int D, int H, int W, int C, int N, int bw,
                                  int bh, int bd, int bb, int bn, int stages, int smem_bytes, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_wgmma_dw<false>(x, g, dw, workspace, splits, stages_per_split, B, D, H, W, C, N, bw, bh, bd, bb, bn,
                                stages, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The bfloat16 tensor-core dw on persistent blocks (the plan's dw_persistent):
// tiles of 128 rows (tap, c) by bn = 256 columns, `tiles` of them, the
// M/64 stages of the row reduction cut into `splits` runs of
// `stages_per_split` (the last may be shorter, none is empty); `grid` blocks
// walk the (tile, split) items; `workspace` holds splits*8*C*N floats (unused
// when splits == 1), summed into dw by conv_k2_dw_reduce_kernel, launched
// next. The box of a stage's 64 rows is (bw, bh, bd) by bb batch items;
// `smem_bytes` and `tiles` are the plan's, held to this file's own.
int conv_k2_backward_weight_persistent(const void* x, const void* g, void* dw, void* workspace, int B, int D, int H,
                                       int W, int C, int N, int bw, int bh, int bd, int bb, int bn, int stages,
                                       int grid, int smem_bytes, int tiles, int splits, int stages_per_split,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_persistent_dw<false>(x, g, dw, workspace, B, D, H, W, C, N, bw, bh, bd, bb, bn, stages, grid,
                                     smem_bytes, tiles, splits, stages_per_split, static_cast<cudaStream_t>(stream));
}

// The forward for narrow outputs, bfloat16 on mma.sync or float32 on FFMA:
// the output box (bw, bh, bd) of the wrapper's narrow plan, `grid` blocks
// walking the boxes, the dynamic shared memory it worked out, which must be
// this file's own (else wg::PLAN_MISMATCH), and its `chunk_d`: the d-planes of
// the float32 output chunk stored through shared memory, or 0 (see
// nr::make_geom). Needs C in {8, 16, 32, 64} (float32: up to 32) and N in {8,
// 16, 32}.
int conv_k2_forward_narrow(const void* x, const void* w, void* y, int B, int D, int H, int W, int C, int N, int bw,
                           int bh, int bd, int grid, int smem_bytes, int chunk_d, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return nr::launch_fwd(x, w, y, B, D, H, W, C, N, bw, bh, bd, grid, smem_bytes, chunk_d, dtype, false,
                        static_cast<cudaStream_t>(stream));
}

// dx [B,D,H,W,C] for narrow shapes, bfloat16 on mma.sync or float32 on FFMA,
// from g [B,D,H,W,N] and wm [2,2,2,N,C], w's taps mirrored and each
// transposed (wm[s] = w[7 - s]^T): the forward from N to C channels over g
// read one voxel lower, at the box, grid, shared memory and chunk_d of the
// plan of that forward. Needs N in {8, 16, 32, 64} (float32: up to 32) and C
// in {8, 16, 32}.
int conv_k2_backward_input_narrow(const void* g, const void* wm, void* dx, int B, int D, int H, int W, int C, int N,
                                  int bw, int bh, int bd, int grid, int smem_bytes, int chunk_d, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return nr::launch_fwd(g, wm, dx, B, D, H, W, N, C, bw, bh, bd, grid, smem_bytes, chunk_d, dtype, true,
                        static_cast<cudaStream_t>(stream));
}

// The chunked forward for wide inputs and narrow outputs: x [B,D,H,W,C], N in
// {8, 16, 32}, w [2,2,2,C,N] as it lies; bfloat16 on mma.sync with C a
// multiple of 64 above 64, or float32 on FFMA with C a multiple of 32 above
// 32; the output box (bw, bh, bd), `grid` blocks and the dynamic shared memory
// of the plan (held to this file's own); two stages.
int conv_k2_forward_chunked(const void* x, const void* w, void* y, int B, int D, int H, int W, int C, int N, int bw,
                            int bh, int bd, int grid, int smem_bytes, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return nr::launch_chunked_fwd(x, w, y, B, D, H, W, C, N, bw, bh, bd, grid, smem_bytes, dtype,
                                static_cast<cudaStream_t>(stream));
}

// The bfloat16 dx of a narrow g and a wide dx on the tensor cores: dx
// [B,D,H,W,C] with C a multiple of bn (128, or 64) above 64 from g
// [B,D,H,W,N], N in {8, 16, 32}, and wt [C, 8N], w laid out by the wrapper
// (wt[c, t N + n] = w[t, c, n]); the plan's box of 128 voxels (bw, bh,
// bd), column chunk bn, halo stages, `grid` blocks (a multiple of C / bn) and
// dynamic shared memory, held to this file's own.
int conv_k2_backward_input_chunked(const void* g, const void* wt, void* dx, int B, int D, int H, int W, int C, int N,
                                   int bw, int bh, int bd, int bn, int stages, int grid, int smem_bytes, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return cdx::launch<false>(g, wt, dx, B, D, H, W, C, N, bw, bh, bd, bn, stages, grid, smem_bytes,
                            static_cast<cudaStream_t>(stream));
}

// The bfloat16 forward of a narrow x and a wide y on the tensor cores, the
// chunked dx's kernel run forward: y [B,D,H,W,N] with N a multiple of bn (128,
// or 64), at least 64, from x [B,D,H,W,C], C in {8, 16, 32}, and wt [N, 8C],
// w laid out by the wrapper (wt[n, t C + c] = w[t, c, n]); the plan's box of
// 128 voxels (bw, bh, bd), column chunk bn, halo stages, `grid` blocks (a
// multiple of N / bn) and dynamic shared memory, held to this file's own.
int conv_k2_forward_wide(const void* x, const void* wt, void* y, int B, int D, int H, int W, int C, int N, int bw,
                         int bh, int bd, int bn, int stages, int grid, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the kernel's narrow operand is x (its "N" = C) and its wide result y (its "C" = N)
  return cdx::launch<true>(x, wt, y, B, D, H, W, N, C, bw, bh, bd, bn, stages, grid, smem_bytes,
                           static_cast<cudaStream_t>(stream));
}

// dw for narrow outputs, bfloat16 on mma.sync or float32 on FFMA: the boxes
// (bw, bh, bd) of the grid are cut into `splits` runs of `boxes_per_split`
// (the last may be shorter, none is empty); `workspace` holds splits*8*C*N
// floats (unused when splits == 1); `smem_bytes` is the plan's dynamic shared
// memory, held to this file's own, and `stages` its copies of x and g a block
// (2; the float32 dw's 3; 2 or 3 for a bfloat16 C that is a multiple of 64
// above 64, whose blocks take C in chunks of 64, one chunk a block).
int conv_k2_backward_weight_narrow(const void* x, const void* g, void* dw, void* workspace, int splits,
                                   int boxes_per_split, int B, int D, int H, int W, int C, int N, int bw, int bh,
                                   int bd, int smem_bytes, int stages, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* part = splits == 1 ? out : static_cast<float*>(workspace);
  const int rc = nr::launch_dw(x, g, part, splits, boxes_per_split, B, D, H, W, C, N, bw, bh, bd, smem_bytes, stages,
                               dtype, s);
  if (rc || splits == 1) return rc;
  return static_cast<int>(launch_dw_reduce(part, out, static_cast<long long>(8) * C * N, splits, s));
}

// The lowered stride-2 k=4 SAME conv (kernels/conv_k4s2.py; conv_k2_wgmma.cuh says how it is formed): y
// [B,D,H,W,N] = conv(x [B,2D,2H,2W,C], w) with w2 [2,2,2,8C,N], the weight re-laid by phase (row (tap,
// (pd, ph, pw), c)). The plan is the tensor-core forward's of (B, D, H, W, 8C, N), splits and reduce included.
// Needs C % 64 == 0.
int conv_k4s2_forward_wgmma(const void* x, const void* w2, void* y, void* workspace, int B, int D, int H, int W,
                            int C, int N, int bw, int bh, int bd, int bb, int bm, int bn, int stages, int grid,
                            int smem_bytes, int tiles, int splits, int stages_per_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % wg::BK) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma_gemm<false, true>(x, w2, y, static_cast<float*>(workspace), B, D, H, W, 8 * C, N, bw, bh, bd,
                                        bb, bm, bn, stages, grid, smem_bytes, tiles, splits, stages_per_split,
                                        static_cast<cudaStream_t>(stream));
}

// Its dx [B,2D,2H,2W,C] from g [B,D,H,W,N] and w2 as the forward's, on the unsplit plan of a forward from N
// to 8C channels. A column tile holds channels of one phase: C % bn == 0.
int conv_k4s2_backward_input_wgmma(const void* g, const void* w2, void* dx, int B, int D, int H, int W, int C, int N,
                                   int bw, int bh, int bd, int bb, int bm, int bn, int stages, int grid,
                                   int smem_bytes, int tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % wg::BK || C % bn) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma_gemm<true, true>(g, w2, dx, nullptr, B, D, H, W, N, 8 * C, bw, bh, bd, bb, bm, bn, stages,
                                       grid, smem_bytes, tiles, 1, 8 * N / wg::BK, static_cast<cudaStream_t>(stream));
}

// Its dw2 [2,2,2,8C,N] in float32 (w2's layout) from x [B,2D,2H,2W,C] and g [B,D,H,W,N], on the dw fields of
// the forward's plan: as conv_k2_backward_weight_wgmma at 8C channels.
int conv_k4s2_backward_weight_wgmma(const void* x, const void* g, void* dw2, void* workspace, int splits,
                                    int stages_per_split, int B, int D, int H, int W, int C, int N, int bw, int bh,
                                    int bd, int bb, int bn, int stages, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % wg::BK) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma_dw<true>(x, g, dw2, workspace, splits, stages_per_split, B, D, H, W, 8 * C, N, bw, bh, bd, bb,
                               bn, stages, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The same on persistent blocks: as conv_k2_backward_weight_persistent at 8C channels.
int conv_k4s2_backward_weight_persistent(const void* x, const void* g, void* dw2, void* workspace, int B, int D,
                                         int H, int W, int C, int N, int bw, int bh, int bd, int bb, int bn,
                                         int stages, int grid, int smem_bytes, int tiles, int splits,
                                         int stages_per_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % wg::BK) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent_dw<true>(x, g, dw2, workspace, B, D, H, W, 8 * C, N, bw, bh, bd, bb, bn, stages, grid,
                                    smem_bytes, tiles, splits, stages_per_split, static_cast<cudaStream_t>(stream));
}

// Codes from wg::PLAN_MISMATCH up are this library's own, not cudaError_t.
const char* conv_k2_error_string(int code) {
  if (code == wg::PLAN_MISMATCH) return "the plan's shared memory or tile count is not the kernel's";
  if (code == wg::NO_ENCODER) return "cuTensorMapEncodeTiled not found in libcuda";
  if (code >= wg::ENCODE_FAILED) return "cuTensorMapEncodeTiled refused the tensor map (code - 10000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
