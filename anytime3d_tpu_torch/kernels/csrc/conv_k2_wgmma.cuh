// conv_k2 in bfloat16 on Hopper's tensor cores: the forward, dx and dw.
// Included by conv_k2.cu, which states what the operation computes.
//
// Replaces, for bfloat16 operands whose shape has a plan (see
// kernels/conv_k2.py::wgmma_plan), the forward of the TPU kernel
// anytime3d_tpu/kernels/conv_k2.py::_conv_k2_pallas (pallas_call at :156) and
// the dx and dw products of its backward (_conv_k2_bwd_impl, :172-205).
//
// What bounds them: operations. A flagship stage at B=32 is 6e10 to 1.2e11
// operations against at most 0.17 GB of traffic, and only the tensor cores
// reach the card's bf16 rate. So all three kernels are built around wgmma:
//
// - Products: wgmma.mma_async m64nNk16, bf16 operands read from shared
//   memory through descriptors, f32 accumulators in registers. A block owns a
//   128 x BN output tile (BN = 128, or 64 where N is an odd multiple of 64):
//   two consumer warpgroups of 64 rows each, 64 (or 32) accumulators a thread,
//   two blocks an SM. The forward also has a 256-row tile (MT = 2: two
//   accumulators a warpgroup, one block an SM), which fetches the B tile from
//   L2 half as often for the same products; the wrapper's plan takes it where
//   a tile is deep enough (C >= 128) to hide its store without a second block
//   on the SM. dx is the forward's kernel (the DX instance) and has its tiles.
//   dw gained nothing from 256 rows and keeps 128.
//
// - The gather is a box copy. x is described to the TMA as the 5-D tensor it
//   is, (C, W, H, D, B) innermost first. The rows of an output tile are a box
//   of one batch item (at 16^3: 8 h-lines of one (b, d)), or on a grid of
//   fewer rows than the tile (4^3) a box of whole items, so the A tile of tap
//   (dz, dy, dx) is that box at coordinates shifted by the tap. Where the box
//   leaves the tensor the TMA writes zeros, axis by axis, which is SAME
//   padding (lo 0, hi 1) in every item: no mask, no division and no address
//   register in any consumer thread.
//   The inner 64 channels are 128 bytes, written with the 128-byte swizzle
//   that a wgmma descriptor reads directly.
//
// - A ring of stages in dynamic shared memory, each 64 deep, filled by one
//   producer thread (lane 0 of warp 8) and drained by the two consumer
//   warpgroups (warps 0-7). Each slot has a `full` mbarrier, which the
//   producer arms with the stage's byte count (zero-filled bytes included)
//   and the TMA completes, and an `empty` mbarrier, on which one lane of
//   every consumer warp arrives once wgmma.wait_group has shown that the
//   products reading the slot are done. One group of products stays in flight
//   while the next stage is awaited.
//
// Forward: y [M, N] = A [M, 8C] * w [8C, N], one stage = one tap and 64
//   channels. A is K-major (c contiguous); w lies [8C, N] with n contiguous,
//   which is the MN-major B operand (transpose bit set), loaded as 64 x 64
//   boxes: no re-lay of w. A block walks over several output tiles and the
//   ring runs on across them, so the next tile's loads are in flight while
//   this tile is stored. Epilogue: accumulators rounded once to bf16,
//   exchanged within each quad of lanes so that a lane holds 8 consecutive
//   columns, and stored from registers 16 bytes a lane.
//
// The forward's split depth (forward and dx). Where the output tiles fill at
//   most half a wave of blocks, the card idles: the mid_blocked encoder's last
//   stage at 4^3 and B=8 (2048 -> 512) has 512 rows, 16 tiles of 128 x 128 on
//   132 SMs, each summing 16384 deep (256 stages) and streaming 4 MB of w
//   through one ring: 0.11 ms for 8.6 GFLOP, 1.6x cuDNN. The plan then cuts the
//   8C/64 stages into `splits` runs of `stages_per_split` (at least 16, the
//   last may be shorter), so that tiles x splits fill one wave; it does so only
//   on grids of at most 8^3 voxels an item (the mid_blocked stages, where the
//   split was measured), so the 16^3 convs keep one split. A work item is
//   (tile, split), column tiles fastest, then splits, then row tiles; with one
//   split the items are the tiles, in the same order. A split's block reduces
//   its run into f32 accumulators from zero and stores them from registers (8
//   bytes a lane) to part[split][row][col], a workspace the wrapper allocates;
//   conv_k2_split_reduce_kernel (conv_k2.cu), launched by the same host call,
//   sums the splits in ascending order and rounds once to bf16. No atomics: the same bits every run, and as
//   accurate as one block's sum (f32 partials, one rounding).
//
// dx: dx [M, C] = A [M, 8N] * B [8N, C], depth in (tap, n) order, one stage =
//   one tap and 64 channels n. It is the forward with the roles of C and N
//   swapped and two differences. A is the box of g at mirrored coordinates:
//   tap (dz, dy, dx) reads it at the tile's origin minus the tap, and the
//   TMA's zero fill below coordinate 0 is the low-edge mask. B[(tap, n), c] =
//   w[tap, c, n]: in w viewed [8C, N] the depth n is contiguous, so a 64 (c) x
//   64 (n) box at (n0, tap C + c0) lands as a K-major tile under the same
//   swizzle as A, read through A's kind of descriptor with the transpose bit
//   clear: no re-lay of w here either, and no flip (the mirrored shift already
//   pairs tap t with w[t]). The j-th 64 columns of a tile are the j-th box,
//   8 KB on, which continues the 1024-byte stride of its 8-row groups. Ring,
//   barriers, tile walk and epilogue are the forward's.
//
// dw: dw [8C, N] = A^T [8C, M] * g [M, N], depth m, one stage = 64 rows m:
//   for each warpgroup the box of x (64 c x 64 rows) at its tap's shift (at
//   C = 64 the two warpgroups of a tile hold two taps, else two channel
//   blocks of one tap) and 64 rows of g. Both operands are MN-major (c and n
//   contiguous), both transpose bits set. The rows are split over blockIdx.z;
//   each split stores its f32 partial tile from registers (8 bytes a lane)
//   to the workspace and conv_k2_dw_reduce_kernel sums the splits in
//   ascending order. No atomics: the same bits every run.
//
// dw on persistent blocks (conv_k2_dw_persistent_kernel): the same stages and
//   products for short reductions over many output tiles, the mid_blocked
//   stages at 4^3 (8 to 32 stages a tile). There the grid kernel above ran 512
//   blocks of 8 stages at B=8, each filling its ring from cold and storing a
//   64 KB f32 tile from registers at its end, and read 134 MB from L2 for a
//   33.5 MB output (g once for each of 128 row tiles, x once for each of 4
//   column tiles). Here one block an SM walks the work items (row tile,
//   column tile, split), splits fastest, then row tiles; the ring runs on
//   across items, so the producer loads the next item's stages while the
//   consumers store this one's. A tile is 128 rows by 256 columns (two
//   m64n128 accumulators a warpgroup), which reads 48 KB of L2 a stage for
//   twice the products of the 32 KB of a 128 x 128 tile. The store goes
//   through shared memory: each consumer warp writes its 16 rows in chunks of
//   32 f32 columns (2 KB, the 128-byte swizzle, so a warp's 8-byte writes fall
//   into two wavefronts) and one lane hands each chunk to the TMA
//   (cp.async.bulk.tensor store, DW_STORE_BUFS chunk buffers a warp), which
//   writes dw in whole lines. What bounds it: the f32 store, 33.5 MB at 4^3
//   (0.010 ms at the card's memory rate), which every block makes at once at
//   the end of each item (cli/probe_split.py). Where the tiles fill at most
//   half the SMs the rows split, each split's partial stored the same way
//   into the workspace, then conv_k2_dw_reduce_kernel.
//
// The lowered stride-2 k=4 SAME conv (conv_k4s2_*_kernel, kernels/conv_k4s2.py).
//   It replaces no TPU kernel: the JAX package leaves the voxel encoder's
//   stride-2 k=4 convs to XLA, and on the card cuDNN ran them on its legacy
//   engines (implicit_convolveNd_sgemm, wgrad_alg1_nd_float_engine), off the
//   tensor cores. Such a conv of x [B, 2D, 2H, 2W, C] is exactly a k=2 VALID
//   conv over X, the space-to-depth(2) of x padded by one voxel on each side:
//   X [B, D+1, H+1, W+1, 8C], channels (pd, ph, pw, c), with
//   W2 [tap (bd, bh, bw), (pd, ph, pw, c), n] = w[n, c, 2bd+pd, 2bh+ph, 2bw+pw].
//   The output grid is D x H x W, one voxel smaller than X's, and it tiles as
//   the mid_blocked stages' do (8^3 1024 -> 256, 4^3 2048 -> 512), so the
//   three products are this file's kernels on the plan of (B, D, H, W, 8C, N).
//   What bounds them is the same: operations (69 GFLOP a product at the first
//   flagship stage, B=32). X is never written: X[j + tap] at phase p is x's
//   own phase grid 7 - p (the voxels (2d + 1 - pd, ...)) at j + tap - 1 + p,
//   and each of x's eight phase grids is a strided 5-D tensor map
//   (encode_phase_maps), whose zero fill at -1 and at D is the SAME pad. The
//   forward and dw pick the map by the phase of their depth chunk or row tile
//   (tma_load_phase); the rest of the walk is conv_k2's.
//   dx is written straight into x's fine grid: a column tile of dx (bn
//   channels of one phase q of x's own space-to-depth, C % bn == 0) is a
//   2x2x2-tap correlation of g with the phase-flipped weights W2[tap][7 - q],
//   read one voxel higher along each axis where q is 1 (per axis, fine voxel
//   2i reads g at i and i - 1, 2i + 1 at i + 1 and i). It is the DX instance
//   with g's box shifted by the tile's phase, w's rows taken from phase 7 - q
//   and an epilogue that stores each row at its fine voxel. The dx is unsplit.
//
// Shared memory of a stage: A 2 MT tiles of 8 KB (64 rows each) + B BN/64
// tiles of 8 KB; every tile starts on a 1024-byte boundary (the swizzle's
// period). Built with -DCONV_K2_WAIT_TRAP_NS=<ns> (bring-up and the card
// tests; kernels/build.py::EXTRA_DEFINES), a wait on an mbarrier that lasts
// that long traps instead of hanging the card. The default build has no such
// bound: the timer runs on while a kernel is preempted or the card is shared,
// and a trap poisons the context of a healthy process.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace wg {

constexpr int BM = 128;            // output rows per block: 64 for each of two consumer warpgroups (x MT)
constexpr int BK = 64;             // depth per stage: 64 bf16 = one 128-byte swizzled row
constexpr int CONSUMER_WARPS = 8;  // warps 0-7; warp 8 is the producer
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;
constexpr int MAX_STAGES = 8;
constexpr uint32_t TILE_BYTES = 64 * 128;  // a 64 x 64 bf16 box
constexpr uint32_t SWIZZLE_PERIOD = 1024;  // 8 rows of 128 bytes
constexpr uint32_t K16_IN_ROW = 32;        // K-major: 16 bf16 further along a 128-byte row
constexpr uint32_t K16_ROWS = 16 * 128;    // MN-major: 16 rows further down
// the persistent dw: tiles of 128 x DW_PERSISTENT_BN, stored through shared memory behind the ring's barriers,
// a consumer warp's 16 rows in chunks of 32 f32 columns (one 128-byte swizzled row each), DW_STORE_BUFS chunk
// buffers a warp (CONV_K2_DW_STORE_BUFS: 2 in the port, fewer ring stages for more in cli/probe_split.py)
#ifndef CONV_K2_DW_STORE_BUFS
#define CONV_K2_DW_STORE_BUFS 2
#endif
constexpr int DW_PERSISTENT_BN = 256;
constexpr uint32_t DW_CHUNK_BYTES = 16 * 128;
constexpr int DW_STORE_BUFS = CONV_K2_DW_STORE_BUFS;
constexpr uint32_t DW_STAGING_BYTES = CONSUMER_WARPS * DW_STORE_BUFS * DW_CHUNK_BYTES;

// x's eight phase grids, the A source of the lowered conv's forward and dw (encode_phase_maps); its dx reads
// g through one map, as conv_k2's kernels read x.
struct PhaseMaps {
  CUtensorMap m[8];
};
template <bool PHASES>
using XSource = std::conditional_t<PHASES, PhaseMaps, CUtensorMap>;

// CONV_K2_DW_PROBE (cli/probe_split.py's builds): 1 leaves out dw's store, 2 its loads of g. 0 in the port.
#ifndef CONV_K2_DW_PROBE
#define CONV_K2_DW_PROBE 0
#endif

// A stage holds MT tiles of A for each of the two warpgroups, then BN/64 tiles of B.
template <int MT>
__host__ __device__ constexpr uint32_t a_bytes() {
  return 2 * MT * TILE_BYTES;
}

template <int BN, int MT>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return a_bytes<MT>() + (BN / 64) * TILE_BYTES;
}

// Dynamic shared memory of a launch: the ring, room to align it, the barriers.
template <int BN, int MT>
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return SWIZZLE_PERIOD + static_cast<size_t>(stages) * stage_bytes<BN, MT>() + 2 * MAX_STAGES * 8;
}

// The persistent dw's: the ring, room to align it, the barriers in a swizzle period of their own (so that
// the store's chunk buffers after them start on one), the chunk buffers.
__host__ __device__ constexpr size_t dw_persistent_smem_bytes(int stages) {
  return 2 * SWIZZLE_PERIOD + static_cast<size_t>(stages) * stage_bytes<DW_PERSISTENT_BN, 1>() + DW_STAGING_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

#ifdef CONV_K2_WAIT_TRAP_NS
__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
#endif

// Wait until the phase of `bar` with this parity is over. A wrong phase or
// byte count waits for ever; a debug build (CONV_K2_WAIT_TRAP_NS) traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifdef CONV_K2_WAIT_TRAP_NS
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_timer_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_timer_ns() - t0 > CONV_K2_WAIT_TRAP_NS) __trap();
  }
#else
  while (!mbar_try_wait(bar, parity)) {
  }
#endif
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// The lowered conv's A box for the output box at (w0, h0, d0, b0): tap `tap` (bd, bh, bw) and the 64 channels
// from c0 of X's 8 cf, phase p = c0 / cf (pd, ph, pw), channel c0 % cf. X[j + tap] at phase p is x's phase
// grid 7 - p at j + tap - 1 + p; below 0 and past the grid the TMA writes zeros, the SAME pad.
__device__ __forceinline__ void tma_load_phase(uint32_t dst, const PhaseMaps& xs, uint32_t full, int tap, int c0,
                                               int cf, int w0, int h0, int d0, int b0) {
  const int p = c0 / cf;
  tma_load_5d(dst, &xs.m[7 - p], full, c0 - p * cf, w0 + (tap & 1) - 1 + (p & 1),
              h0 + ((tap >> 1) & 1) - 1 + ((p >> 1) & 1), d0 + (tap >> 2) - 1 + (p >> 2), b0);
}

// A box of `map` from shared memory at `src` to coordinates (c0, c1), in this thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Until at most PENDING of this thread's bulk groups still read shared memory (READ) or are still running.
template <int PENDING, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Orders this thread's shared-memory writes before a later TMA read of them.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile. K-major: rows
// of 128 bytes, groups of 8 rows `sbo` bytes apart (lbo unused). MN-major:
// 64 elements of M or N contiguous in a 128-byte row, one row per k, groups
// of 8 k `sbo` bytes apart, the next 64 elements of M or N `lbo` bytes on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x N, f32) (+)= a (64 x 16) * b (16 x N): a from `desc_a`, b from
// `desc_b`, each K-major for TRANS_ = 0 and MN-major for 1.
// scale_d = 0 overwrites d. Row lane/4 (+8) of the warp's 16 rows and columns
// 8j + 2(lane%4) + {0, 1} are d[4j + {0, 1}] (+2).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// The compiler must not read or move an accumulator between the launch of a
// product and the wait that ends it.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct Ring {
  uint32_t base;   // first stage, 1024-byte aligned (shared-space address)
  uint32_t full;   // `full` barrier of slot 0; slot s at + 8 s
  uint32_t empty;  // `empty` barrier of slot 0
};

// Called by every thread of the block, before the roles part.
__device__ __forceinline__ Ring ring_setup(uint8_t* smem_raw, int stages, uint32_t stage_size) {
  Ring r;
  r.base = (smem_u32(smem_raw) + SWIZZLE_PERIOD - 1) & ~(SWIZZLE_PERIOD - 1);
  r.full = r.base + stages * stage_size;
  r.empty = r.full + MAX_STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full + 8 * s, 1);                // the producer's arrive; the TMA completes the bytes
      mbar_init(r.empty + 8 * s, CONSUMER_WARPS);  // one lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The consumer side of the ring: n_iter stages, four k16 products each, into
// this warpgroup's MT accumulators of 64 x BN (rows 64 (MT wgroup + i) ..
// of the tile), overwriting them. A_MN: the A tiles are MN-major (dw). B_K:
// the B tiles are K-major (dx), else MN-major. `slot` and `parity` carry the
// ring's state from one output tile to the next; every slot read is released
// before the return.
template <int BN, bool A_MN, int MT, bool B_K = false>
__device__ __forceinline__ void consume(const Ring& r, int stages, int n_iter, int wgroup, int& slot,
                                        uint32_t& parity, float (&acc)[MT][BN / 2]) {
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int it = 0; it < n_iter; ++it) {
    mbar_wait(r.full + 8 * slot, parity);
    const uint32_t a = r.base + slot * stage_bytes<BN, MT>() + wgroup * MT * TILE_BYTES;
    const uint32_t b = r.base + slot * stage_bytes<BN, MT>() + a_bytes<MT>();
#pragma unroll
    for (int i = 0; i < MT; ++i) pin(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t db = B_K ? smem_desc(b + k * K16_IN_ROW, 16, SWIZZLE_PERIOD)
                              : smem_desc(b + k * K16_ROWS, TILE_BYTES, SWIZZLE_PERIOD);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint64_t da = smem_desc(a + i * TILE_BYTES + k * (A_MN ? K16_ROWS : K16_IN_ROW),
                                      A_MN ? TILE_BYTES : 16, SWIZZLE_PERIOD);
        wgmma_bf16<A_MN ? 1 : 0, B_K ? 0 : 1>(acc[i], da, db, (it | k) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: its slot is free
    if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
    prev = slot;
    if (++slot == stages) {
      slot = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
  if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
#pragma unroll
  for (int i = 0; i < MT; ++i) pin(acc[i]);
}

// Within a quad, lane q holds columns 2q, 2q+1 (one packed pair) of each of
// four neighbouring 8-column blocks, p[0..3]. Returns all 8 columns of block
// q, for one 16-byte store. Round r: send the pair of block q^r to lane q^r.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&p)[4], int q) {
  uint32_t out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int peer = q ^ r;
    const uint32_t send = peer == 0 ? p[0] : peer == 1 ? p[1] : peer == 2 ? p[2] : p[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (peer == i) out[i] = got;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Forward. Each block walks over output tiles blockIdx.x, + gridDim.x, ...
// (column tiles fastest, so that the blocks sharing an A tile run together);
// the ring runs on across tiles, so the producer fills the next tile's first
// stages while the consumers store this tile. A tile is 128 MT rows: with
// MT = 2 a warpgroup keeps two accumulators, B is read from L2 half as often
// for the same products, and one block fits an SM instead of two.
//
// DX: the same walk computes dx. Then x is g, C its channel count (the depth's),
// N the channel count of dx and y is dx; map_w still describes w [8N, C] as it
// lies (rows (tap, channel of dx), the depth's channel contiguous).
//
// SPLIT: the walk is over work items (tile, split), `tiles` x `splits` of
// them, and the block stores its f32 partial to `part`, leaving y to the
// reduce (see "The forward's split depth" above). Without it `split_count`,
// `split_stages` and `part` are not read: one split of all stages, the items
// are the tiles, and the instance carries none of the split's state (a
// runtime branch cost the 16^3 stages a register spill).
//
// K4: the lowered stride-2 k=4 conv (above); conv_k4s2_fwd_wgmma_kernel.
template <int BN, int MT, bool DX, bool SPLIT, bool K4, class XS>
__device__ __forceinline__ void fwd_wgmma(const XS& src_x, const CUtensorMap& map_w, __nv_bfloat16* __restrict__ y,
                                          float* __restrict__ part, int D, int H, int W, int C, int N, long long tiles,
                                          int stages, int split_count, int split_stages) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring_setup(smem_raw, stages, stage_bytes<BN, MT>());

  const int n_tiles = N / BN;
  const int c_blocks = C / BK;
  const int total = 8 * c_blocks;  // stages of the whole sum
  const int splits = SPLIT ? split_count : 1;
  const int stages_per_split = SPLIT ? split_stages : total;
  const long long items = tiles * splits;
  const int warp = threadIdx.x >> 5;
  const int cf = (DX ? N : C) / 8;  // K4: x's channels, of which X and dx's columns hold 8 phases

  if (warp == CONSUMER_WARPS) {
    if ((threadIdx.x & 31) != 0) return;
    int slot = 0;
    uint32_t parity = 1;  // a fresh slot is empty
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int n0 = static_cast<int>(item % n_tiles) * BN;
      // K4 dx: the phase (pd, ph, pw) of x's grid whose channels the column tile holds
      const int phase = K4 && DX ? n0 / cf : 0;
      const long long rest = item / n_tiles;
      const int first = static_cast<int>(rest % splits) * stages_per_split;
      const int last = min(total, first + stages_per_split);
      // origin of the tile's box in (w, h, d, b)
      long long t = rest / splits * (BM * MT);
      const int w0 = static_cast<int>(t % W); t /= W;
      const int h0 = static_cast<int>(t % H); t /= H;
      const int d0 = static_cast<int>(t % D);
      const int b0 = static_cast<int>(t / D);
      for (int it = first; it < last; ++it) {
        const int tap = it / c_blocks;
        const int c0 = (it - tap * c_blocks) * BK;
        const uint32_t full = r.full + 8 * slot;
        const uint32_t dst = r.base + slot * stage_bytes<BN, MT>();
        mbar_wait(r.empty + 8 * slot, parity);
        mbar_arrive_expect_tx(full, stage_bytes<BN, MT>());
        if constexpr (K4 && !DX) {
          tma_load_phase(dst, src_x, full, tap, c0, cf, w0, h0, d0, b0);
        } else {
          // dx reads g at the origin minus the tap (K4: plus the phase); below 0 the TMA writes zeros
          const int sign = DX ? -1 : 1;
          tma_load_5d(dst, &src_x, full, c0, w0 + sign * (tap & 1) + (phase & 1),
                      h0 + sign * ((tap >> 1) & 1) + ((phase >> 1) & 1), d0 + sign * (tap >> 2) + (phase >> 2), b0);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          if (DX)  // rows (tap, n0 + 64 j ..) of w [8N, C] (K4: of phase 7 - phase), columns c0 .. of the depth
            tma_load_2d(dst + a_bytes<MT>() + j * TILE_BYTES, &map_w, full, c0,
                        tap * N + n0 + (K4 ? (7 - 2 * phase) * cf : 0) + 64 * j);
          else  // rows it*64 .. of w [8C, N]: (tap, c) order
            tma_load_2d(dst + a_bytes<MT>() + j * TILE_BYTES, &map_w, full, n0 + 64 * j, it * BK);
        }
        if (++slot == stages) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  const int wgroup = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  int slot = 0;
  uint32_t parity = 0;
  float acc[MT][BN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long rest = item / n_tiles;
    const int split = static_cast<int>(rest % splits);
    const int n_iter = min(stages_per_split, total - split * stages_per_split);
    consume<BN, false, MT, DX>(r, stages, n_iter, wgroup, slot, parity, acc);
    const int n0 = static_cast<int>(item % n_tiles) * BN;
    const long long row = rest / splits * (BM * MT) + wgroup * (64 * MT) + (warp & 3) * 16 + (lane >> 2);
    if (SPLIT) {  // the f32 partial: rows lane/4 and lane/4 + 8, columns 8j + 2q, 8j + 2q + 1
      const long long M = tiles / n_tiles * (BM * MT);
      float* out = part + (split * M + row) * N + n0 + 2 * q;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<float2*>(out + 64 * i * static_cast<long long>(N) + 8 * j) =
              make_float2(acc[i][4 * j], acc[i][4 * j + 1]);
          *reinterpret_cast<float2*>(out + (64 * i + 8) * static_cast<long long>(N) + 8 * j) =
              make_float2(acc[i][4 * j + 2], acc[i][4 * j + 3]);
        }
      continue;
    }
    if constexpr (K4 && DX) {
      // dx in x's own grid [B, 2D, 2H, 2W, cf]: row rr is g's voxel (b, d, h, w), stored at the fine voxel
      // (2d + pd, 2h + ph, 2w + pw) of the tile's phase, in that phase's channels n0 - phase cf ..
      const int phase = n0 / cf;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows lane/4 and lane/4 + 8
          long long v = row + 64 * i + 8 * half;
          const int ww = static_cast<int>(v % W); v /= W;
          const int hh = static_cast<int>(v % H); v /= H;
          const int dd = static_cast<int>(v % D); v /= D;
          const long long fine =
              ((v * 2 * D + 2 * dd + (phase >> 2)) * 2 * H + 2 * hh + ((phase >> 1) & 1)) * 2 * W + 2 * ww + (phase & 1);
          __nv_bfloat16* out = y + fine * cf + (n0 - phase * cf) + 8 * q;
#pragma unroll
          for (int j = 0; j < BN / 8; j += 4) {
            uint32_t p[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              p[u] = pack_bf16(acc[i][4 * (j + u) + 2 * half], acc[i][4 * (j + u) + 2 * half + 1]);
            *reinterpret_cast<uint4*>(out + 8 * j) = quad_transpose(p, q);
          }
        }
      }
    } else {
      __nv_bfloat16* out = y + row * N + n0 + 8 * q;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows lane/4 and lane/4 + 8
#pragma unroll
          for (int j = 0; j < BN / 8; j += 4) {
            uint32_t p[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              p[u] = pack_bf16(acc[i][4 * (j + u) + 2 * half], acc[i][4 * (j + u) + 2 * half + 1]);
            *reinterpret_cast<uint4*>(out + (64 * i + 8 * half) * static_cast<long long>(N) + 8 * j) =
                quad_transpose(p, q);
          }
        }
      }
    }
  }
}

template <int BN, int MT, bool DX, bool SPLIT>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 2 : 1)
conv_k2_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ part, int D, int H, int W, int C, int N,
                         long long tiles, int stages, int split_count, int split_stages) {
  fwd_wgmma<BN, MT, DX, SPLIT, false>(map_x, map_w, y, part, D, H, W, C, N, tiles, stages, split_count, split_stages);
}

// The lowered stride-2 k=4 conv's forward (src_x: x's phase grids; C = 8 cf, the depth of X; D, H, W the
// output grid) and, DX, its dx (src_x: g; N = 8 cf, y = dx in x's grid [B, 2D, 2H, 2W, cf]; never split).
template <int BN, int MT, bool DX, bool SPLIT>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 2 : 1)
conv_k4s2_fwd_wgmma_kernel(const __grid_constant__ XSource<!DX> src_x, const __grid_constant__ CUtensorMap map_w,
                           __nv_bfloat16* __restrict__ y, float* __restrict__ part, int D, int H, int W, int C, int N,
                           long long tiles, int stages, int split_count, int split_stages) {
  fwd_wgmma<BN, MT, DX, SPLIT, true>(src_x, map_w, y, part, D, H, W, C, N, tiles, stages, split_count, split_stages);
}

// dw partial: part[z][r][n] over the stages [z * stages_per_split, ...) of the
// rows m. Grid: (N / BN, 8C / 128, splits). Always 128 rows a tile: 256 gained
// nothing here.
// K4: the lowered conv's (src_x: x's phase grids; C = 8 cf, the channels of X; D, H, W g's grid).
template <int BN, bool K4, class XS>
__device__ __forceinline__ void dw_wgmma(const XS& src_x, const CUtensorMap& map_g, float* __restrict__ part, int D,
                                         int H, int W, int C, int N, int total_stages, int stages_per_split,
                                         int stages) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring_setup(smem_raw, stages, stage_bytes<BN, 1>());

  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int first = blockIdx.z * stages_per_split;
  const int n_iter = min(stages_per_split, total_stages - first);
  const int warp = threadIdx.x >> 5;

  if (warp == CONSUMER_WARPS) {
    if ((threadIdx.x & 31) != 0) return;
    int tap[2], c0[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 64 output rows (tap, c) of warpgroup i
      tap[i] = (r0 + 64 * i) / C;
      c0[i] = (r0 + 64 * i) - tap[i] * C;
    }
    int slot = 0;
    uint32_t parity = 1;
    for (int it = 0; it < n_iter; ++it) {
      const long long m0 = static_cast<long long>(first + it) * BK;
      long long t = m0;
      const int w0 = static_cast<int>(t % W); t /= W;
      const int h0 = static_cast<int>(t % H); t /= H;
      const int d0 = static_cast<int>(t % D);
      const int b0 = static_cast<int>(t / D);
      const uint32_t full = r.full + 8 * slot;
      const uint32_t dst = r.base + slot * stage_bytes<BN, 1>();
      mbar_wait(r.empty + 8 * slot, parity);
      mbar_arrive_expect_tx(full, CONV_K2_DW_PROBE == 2 ? a_bytes<1>() : stage_bytes<BN, 1>());
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (K4)
          tma_load_phase(dst + i * TILE_BYTES, src_x, full, tap[i], c0[i], C / 8, w0, h0, d0, b0);
        else
          tma_load_5d(dst + i * TILE_BYTES, &src_x, full, c0[i], w0 + (tap[i] & 1), h0 + ((tap[i] >> 1) & 1),
                      d0 + (tap[i] >> 2), b0);
      }
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        if (CONV_K2_DW_PROBE != 2)
          tma_load_2d(dst + a_bytes<1>() + j * TILE_BYTES, &map_g, full, n0 + 64 * j, static_cast<int>(m0));
      if (++slot == stages) {
        slot = 0;
        parity ^= 1;
      }
    }
    return;
  }

  const int wgroup = warp >> 2;
  float acc[1][BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[0][j] = 0.f;
  int slot = 0;
  uint32_t parity = 0;
  consume<BN, true, 1>(r, stages, n_iter, wgroup, slot, parity, acc);

  const int lane = threadIdx.x & 31;
  const long long row = r0 + wgroup * 64 + (warp & 3) * 16 + (lane >> 2);
  float* out = part + (static_cast<long long>(blockIdx.z) * 8 * C + row) * N + n0 + 2 * (lane & 3);
  if (CONV_K2_DW_PROBE == 1) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[0][4 * j], acc[0][4 * j + 1]);
    *reinterpret_cast<float2*>(out + 8 * static_cast<long long>(N) + 8 * j) =
        make_float2(acc[0][4 * j + 2], acc[0][4 * j + 3]);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_k2_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                        float* __restrict__ part, int D, int H, int W, int C, int N, int total_stages,
                        int stages_per_split, int stages) {
  dw_wgmma<BN, false>(map_x, map_g, part, D, H, W, C, N, total_stages, stages_per_split, stages);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_k4s2_dw_wgmma_kernel(const __grid_constant__ PhaseMaps src_x, const __grid_constant__ CUtensorMap map_g,
                          float* __restrict__ part, int D, int H, int W, int C, int N, int total_stages,
                          int stages_per_split, int stages) {
  dw_wgmma<BN, true>(src_x, map_g, part, D, H, W, C, N, total_stages, stages_per_split, stages);
}

// The persistent dw's consumer side of the ring: as consume (A and B both
// MN-major), into NB accumulators of 64 x 128 a warpgroup, columns 128 h ..
// of the tile for accumulator h.
template <int NB>
__device__ __forceinline__ void consume_dw(const Ring& r, int stages, int n_iter, int wgroup, int& slot,
                                           uint32_t& parity, float (&acc)[NB][64]) {
  constexpr int BN = 128 * NB;
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int it = 0; it < n_iter; ++it) {
    mbar_wait(r.full + 8 * slot, parity);
    const uint32_t a = r.base + slot * stage_bytes<BN, 1>() + wgroup * TILE_BYTES;
    const uint32_t b = r.base + slot * stage_bytes<BN, 1>() + a_bytes<1>();
#pragma unroll
    for (int h = 0; h < NB; ++h) pin(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = smem_desc(a + k * K16_ROWS, TILE_BYTES, SWIZZLE_PERIOD);
#pragma unroll
      for (int h = 0; h < NB; ++h)
        wgmma_bf16<1, 1>(acc[h], da, smem_desc(b + 2 * h * TILE_BYTES + k * K16_ROWS, TILE_BYTES, SWIZZLE_PERIOD),
                         (it | k) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: its slot is free
    if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
    prev = slot;
    if (++slot == stages) {
      slot = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
  if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
#pragma unroll
  for (int h = 0; h < NB; ++h) pin(acc[h]);
}

// dw (or its split partials) on persistent blocks: `gridDim.x` blocks, one an
// SM, walk the work items (split fastest, then the 8C/128 row tiles, then the
// N/256 column tiles), block i taking items i, i + gridDim.x, ...; an item
// reduces the stages [split * stages_per_split, ...) of 64 rows m into a 128 x
// 256 tile. map_out is the f32 matrix [splits * 8C, N]: dw itself with one
// split, else the workspace, whose split z holds rows z 8C .. K4: the lowered
// conv's, as dw_wgmma's.
template <bool K4, class XS>
__device__ __forceinline__ void dw_persistent(const XS& src_x, const CUtensorMap& map_g, const CUtensorMap& map_out,
                                              int D, int H, int W, int C, int N, int total_stages, int splits,
                                              int stages_per_split, int stages) {
  constexpr int BN = DW_PERSISTENT_BN;
  constexpr int NB = BN / 128;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring_setup(smem_raw, stages, stage_bytes<BN, 1>());

  const int row_tiles = 8 * C / BM;
  const long long items = static_cast<long long>(row_tiles) * (N / BN) * splits;
  const int warp = threadIdx.x >> 5;

  if (warp == CONSUMER_WARPS) {
    if ((threadIdx.x & 31) != 0) return;
    int slot = 0;
    uint32_t parity = 1;  // a fresh slot is empty
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int first = static_cast<int>(item % splits) * stages_per_split;
      const int last = min(total_stages, first + stages_per_split);
      const long long rest = item / splits;
      const int r0 = static_cast<int>(rest % row_tiles) * BM;
      const int n0 = static_cast<int>(rest / row_tiles) * BN;
      int tap[2], c0[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the 64 output rows (tap, c) of warpgroup i
        tap[i] = (r0 + 64 * i) / C;
        c0[i] = (r0 + 64 * i) - tap[i] * C;
      }
      for (int st = first; st < last; ++st) {
        long long t = static_cast<long long>(st) * BK;
        const int m0 = static_cast<int>(t);
        const int w0 = static_cast<int>(t % W); t /= W;
        const int h0 = static_cast<int>(t % H); t /= H;
        const int d0 = static_cast<int>(t % D);
        const int b0 = static_cast<int>(t / D);
        const uint32_t full = r.full + 8 * slot;
        const uint32_t dst = r.base + slot * stage_bytes<BN, 1>();
        mbar_wait(r.empty + 8 * slot, parity);
        mbar_arrive_expect_tx(full, CONV_K2_DW_PROBE == 2 ? a_bytes<1>() : stage_bytes<BN, 1>());
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (K4)
            tma_load_phase(dst + i * TILE_BYTES, src_x, full, tap[i], c0[i], C / 8, w0, h0, d0, b0);
          else
            tma_load_5d(dst + i * TILE_BYTES, &src_x, full, c0[i], w0 + (tap[i] & 1), h0 + ((tap[i] >> 1) & 1),
                        d0 + (tap[i] >> 2), b0);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (CONV_K2_DW_PROBE != 2) tma_load_2d(dst + a_bytes<1>() + j * TILE_BYTES, &map_g, full, n0 + 64 * j, m0);
        if (++slot == stages) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  const int wgroup = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3, lr = lane >> 2;
  // this warp's chunk buffers, after the barriers' swizzle period
  const uint32_t staging = r.full + SWIZZLE_PERIOD + warp * DW_STORE_BUFS * DW_CHUNK_BYTES;
  int slot = 0, chunk = 0;
  uint32_t parity = 0;
  float acc[NB][64];
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int split = static_cast<int>(item % splits);
    const long long rest = item / splits;
    const int r0 = static_cast<int>(rest % row_tiles) * BM;
    const int n0 = static_cast<int>(rest / row_tiles) * BN;
    consume_dw<NB>(r, stages, min(stages_per_split, total_stages - split * stages_per_split), wgroup, slot, parity,
                   acc);
    if (CONV_K2_DW_PROBE == 1) continue;
    // the warp's 16 rows, in chunks of 32 columns: row lr (and lr + 8) of a chunk holds columns 8 jj + 2 q, + 1
    // of accumulator entries 4 j (4 j + 2), j = 4 (k % 4) + jj, in 16-byte unit 2 jj + q / 2 of its 128-byte
    // row, at unit ^ (row % 8) under the swizzle (lr + 8 falls on the same units, 1 KB on)
    const int row = split * 8 * C + r0 + wgroup * 64 + (warp & 3) * 16;
#pragma unroll
    for (int k = 0; k < BN / 32; ++k, ++chunk) {
      const uint32_t buf = staging + (chunk % DW_STORE_BUFS) * DW_CHUNK_BYTES;
      if (lane == 0) bulk_wait<DW_STORE_BUFS - 1, true>();  // the store that last read this buffer has read it
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * (k % 4) + jj;
        const uint32_t addr = buf + lr * 128 + (((2 * jj + (q >> 1)) ^ lr) << 4) + (q & 1) * 8;
        st_shared_f32x2(addr, acc[k / 4][4 * j], acc[k / 4][4 * j + 1]);
        st_shared_f32x2(addr + 8 * 128, acc[k / 4][4 * j + 2], acc[k / 4][4 * j + 3]);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store_2d(&map_out, buf, n0 + 32 * k, row);
        bulk_commit();
      }
    }
  }
  if (lane == 0) bulk_wait<0, false>();  // every store has landed before the block's shared memory goes
}

__global__ void __launch_bounds__(THREADS, 1)
conv_k2_dw_persistent_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                             const __grid_constant__ CUtensorMap map_out, int D, int H, int W, int C, int N,
                             int total_stages, int splits, int stages_per_split, int stages) {
  dw_persistent<false>(map_x, map_g, map_out, D, H, W, C, N, total_stages, splits, stages_per_split, stages);
}

__global__ void __launch_bounds__(THREADS, 1)
conv_k4s2_dw_persistent_kernel(const __grid_constant__ PhaseMaps src_x, const __grid_constant__ CUtensorMap map_g,
                               const __grid_constant__ CUtensorMap map_out, int D, int H, int W, int C, int N,
                               int total_stages, int splits, int stages_per_split, int stages) {
  dw_persistent<true>(src_x, map_g, map_out, D, H, W, C, N, total_stages, splits, stages_per_split, stages);
}

// ---- host side ----

// cuTensorMapEncodeTiled, looked up in the loaded libcuda: the library links
// against the runtime only.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of the entry points above cudaError_t's range: ENCODE_FAILED + CUresult.
constexpr int ENCODE_FAILED = 10000;
constexpr int NO_ENCODER = 9999;
constexpr int PLAN_MISMATCH = 9998;  // the wrapper's shared-memory size or tile count is not this file's

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 (or f32) tensor of `rank` dims (innermost first, dense) and its box,
// written with the 128-byte swizzle, zeros where the box leaves the tensor.
inline int encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint32_t* box,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return NO_ENCODER;
  cuuint64_t strides[4];  // bytes, from dim 1 on
  cuuint64_t stride = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, static_cast<cuuint32_t>(rank),
                              const_cast<void*>(ptr), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(res);
}

// Whether boxes of (bw, bh, bd) voxels by bb batch items, `rows` rows each,
// laid one after the other, tile the rows of x [B, D, H, W, .] in order:
// inside one item (bb == 1), whole w-lines before a second h and whole (h, w)
// planes before a second d; or whole items (bb > 1, the box the whole grid).
__host__ __device__ inline bool box_tiles(int B, int D, int H, int W, int bw, int bh, int bd, int bb, int rows) {
  if (bw < 1 || bh < 1 || bd < 1 || bb < 1 || bw > 256 || bh > 256 || bd > 256 || bb > 256 ||
      bw * bh * bd * bb != rows || W % bw || H % bh || D % bd || B % bb)
    return false;
  if (bb > 1) return bw == W && bh == H && bd == D;
  return (bh == 1 || bw == W) && (bd == 1 || bh == H);
}

// x [B, D, H, W, C] with a box of 64 channels by bw * bh * bd voxels of bb
// batch items. A tap shifts only w, h and d, so the zero fill past the grid
// is per item even where a box spans items.
inline int encode_x_map(CUtensorMap* map, const void* x, int B, int D, int H, int W, int C, int bw, int bh, int bd,
                        int bb) {
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
  const cuuint32_t box[5] = {BK, static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bd), static_cast<cuuint32_t>(bb)};
  return encode_map(map, x, 5, dims, box);
}

// A matrix [rows, cols], cols contiguous, in boxes of 64 x 64.
inline int encode_matrix_map(CUtensorMap* map, const void* p, long long rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[2] = {64, BK};
  return encode_map(map, p, 2, dims, box);
}

// x [B, 2D, 2H, 2W, cf] as its eight phase grids, the A source of the lowered
// conv's forward and dw: grid p = 4 pd + 2 ph + pw is the 5-D tensor (cf, W, H,
// D, B) of the voxels (2d + pd, 2h + ph, 2w + pw), strided, in boxes of 64
// channels by bw * bh * bd voxels of bb batch items.
inline int encode_phase_maps(PhaseMaps* maps, const void* x, int B, int D, int H, int W, int cf, int bw, int bh,
                             int bd, int bb) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return NO_ENCODER;
  const cuuint64_t voxel = 2ull * cf;  // bytes of a voxel's channels
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(cf), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
  // bytes, from dim 1 on: every other voxel of a line, of a plane's lines, of an item's planes; whole items
  const cuuint64_t strides[4] = {2 * voxel, 4ull * W * voxel, 8ull * H * W * voxel, 8ull * D * H * W * voxel};
  const cuuint32_t box[5] = {BK, static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bd), static_cast<cuuint32_t>(bb)};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  for (int p = 0; p < 8; ++p) {
    const long long first = ((p >> 2) * 2LL * H + ((p >> 1) & 1)) * 2LL * W + (p & 1);  // the voxel (pd, ph, pw)
    const CUresult res = encode(&maps->m[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                                const_cast<char*>(static_cast<const char*>(x)) + first * voxel, dims, strides, box,
                                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);
  }
  return 0;
}

// The A source of the forward or dw: x [B, D, H, W, C] as it lies, or (PHASES) the phase grids of x [B, 2D,
// 2H, 2W, C / 8].
template <bool PHASES>
inline int encode_x_source(XSource<PHASES>* src, const void* x, int B, int D, int H, int W, int C, int bw, int bh,
                           int bd, int bb) {
  if constexpr (PHASES)
    return encode_phase_maps(src, x, B, D, H, W, C / 8, bw, bh, bd, bb);
  else
    return encode_x_map(src, x, B, D, H, W, C, bw, bh, bd, bb);
}

// The forward, or (DX) dx with x := g, C := g's channel count, N := dx's, y := dx;
// with splits > 1 into the f32 partials `part` [splits, M, N] instead of y.
// K4: the lowered conv's (D, H, W the output grid; the forward's C = 8 cf over
// x [B, 2D, 2H, 2W, cf], dx's N = 8 cf into dx of that shape).
template <int BN, int MT, bool DX, bool K4 = false>
int launch_fwd(const void* x, const void* w, void* y, float* part, int B, int D, int H, int W, int C, int N, int bw,
               int bh, int bd, int bb, int stages, int grid, int plan_smem, int plan_tiles, int splits,
               int stages_per_split, cudaStream_t s) {
  // the wrapper's plan and this file must agree on the ring's size and the tile count
  const size_t smem = smem_bytes<BN, MT>(stages);
  const long long M = static_cast<long long>(B) * D * H * W;
  const long long tiles = (M / (BM * MT)) * (N / BN);
  if (static_cast<size_t>(plan_smem) != smem || plan_tiles != tiles) return PLAN_MISMATCH;
  if (grid > tiles * splits || (splits > 1 && part == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  XSource<K4 && !DX> src_x;
  CUtensorMap map_w;
  int rc = encode_x_source<K4 && !DX>(&src_x, x, B, D, H, W, C, bw, bh, bd, bb);
  if (rc) return rc;
  rc = DX ? encode_matrix_map(&map_w, w, 8LL * N, C) : encode_matrix_map(&map_w, w, 8LL * C, N);
  if (rc) return rc;
  if constexpr (K4) {
    auto kernel =
        splits > 1 ? conv_k4s2_fwd_wgmma_kernel<BN, MT, DX, true> : conv_k4s2_fwd_wgmma_kernel<BN, MT, DX, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(src_x, map_w, static_cast<__nv_bfloat16*>(y), part, D,
                                                              H, W, C, N, tiles, stages, splits, stages_per_split);
  } else {
    auto kernel =
        splits > 1 ? conv_k2_fwd_wgmma_kernel<BN, MT, DX, true> : conv_k2_fwd_wgmma_kernel<BN, MT, DX, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(src_x, map_w, static_cast<__nv_bfloat16*>(y), part, D,
                                                              H, W, C, N, tiles, stages, splits, stages_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: the lowered conv's dw [8 8cf, N] over x [B, 2D, 2H, 2W, cf] (C = 8 cf) and g [B, D, H, W, N].
template <int BN, bool K4 = false>
int launch_dw(const void* x, const void* g, float* part, int splits, int stages_per_split, int B, int D, int H,
              int W, int C, int N, int bw, int bh, int bd, int bb, int stages, int plan_smem, cudaStream_t s) {
  const size_t smem = smem_bytes<BN, 1>(stages);
  if (static_cast<size_t>(plan_smem) != smem) return PLAN_MISMATCH;
  const long long M = static_cast<long long>(B) * D * H * W;
  XSource<K4> src_x;
  CUtensorMap map_g;
  int rc = encode_x_source<K4>(&src_x, x, B, D, H, W, C, bw, bh, bd, bb);
  if (rc) return rc;
  rc = encode_matrix_map(&map_g, g, M, N);
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(N / BN), static_cast<unsigned>(8 * C / BM), static_cast<unsigned>(splits));
  if constexpr (K4) {
    cudaError_t err = cudaFuncSetAttribute(conv_k4s2_dw_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_k4s2_dw_wgmma_kernel<BN><<<grid, THREADS, smem, s>>>(src_x, map_g, part, D, H, W, C, N,
                                                             static_cast<int>(M / BK), stages_per_split, stages);
  } else {
    cudaError_t err = cudaFuncSetAttribute(conv_k2_dw_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_k2_dw_wgmma_kernel<BN><<<grid, THREADS, smem, s>>>(src_x, map_g, part, D, H, W, C, N,
                                                           static_cast<int>(M / BK), stages_per_split, stages);
  }
  return static_cast<int>(cudaGetLastError());
}

// The persistent dw into `out`, the f32 matrix [splits * 8C, N] (dw, or with
// splits > 1 the workspace of partials), on `grid` blocks. K4: as launch_dw's.
template <bool K4 = false>
int launch_dw_persistent(const void* x, const void* g, float* out, int B, int D, int H, int W, int C, int N, int bw,
                         int bh, int bd, int bb, int stages, int grid, int plan_smem, int plan_tiles, int splits,
                         int stages_per_split, cudaStream_t s) {
  const size_t smem = dw_persistent_smem_bytes(stages);
  const long long tiles = (8LL * C / BM) * (N / DW_PERSISTENT_BN);
  if (static_cast<size_t>(plan_smem) != smem || plan_tiles != tiles) return PLAN_MISMATCH;
  if (grid < 1 || grid > tiles * splits) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * D * H * W;
  XSource<K4> src_x;
  CUtensorMap map_g, map_out;
  int rc = encode_x_source<K4>(&src_x, x, B, D, H, W, C, bw, bh, bd, bb);
  if (rc) return rc;
  rc = encode_matrix_map(&map_g, g, M, N);
  if (rc) return rc;
  // a chunk: 32 f32 columns (128 bytes) by a warp's 16 rows
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(splits) * 8 * C};
  const cuuint32_t box[2] = {32, 16};
  rc = encode_map(&map_out, out, 2, dims, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (rc) return rc;
  if constexpr (K4) {
    cudaError_t err = cudaFuncSetAttribute(conv_k4s2_dw_persistent_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_k4s2_dw_persistent_kernel<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(
        src_x, map_g, map_out, D, H, W, C, N, static_cast<int>(M / BK), splits, stages_per_split, stages);
  } else {
    cudaError_t err = cudaFuncSetAttribute(conv_k2_dw_persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_k2_dw_persistent_kernel<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(
        src_x, map_g, map_out, D, H, W, C, N, static_cast<int>(M / BK), splits, stages_per_split, stages);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
