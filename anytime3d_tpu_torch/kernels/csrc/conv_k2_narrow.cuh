// conv_k2 for narrow outputs (N = 8, 16 or 32) on Hopper: in bfloat16 the
// forward, dx and dw on mma.sync, in float32 the forward, dx and dw on FFMA;
// and the bfloat16 dw of a narrow input with N = 64 (C = 8), on mma.sync.
// Included by conv_k2.cu, which states what the operation computes; the
// barrier and TMA helpers are conv_k2_wgmma.cuh's.
//
// Replaces, for operands whose shape has a narrow plan (see
// kernels/conv_k2.py::narrow_plan), the forward of the TPU kernel
// anytime3d_tpu/kernels/conv_k2.py::_conv_k2_pallas (:129-169) and the dx and
// dw products of its backward (_conv_k2_bwd_impl, :172-205), in both types;
// for bfloat16 shapes with a dw-only narrow plan (narrow_dw_plan), the dw
// product (_conv_k2_bwd_impl, :181-205).
//
// What bounds them on this card: bytes. At the detector decoder's last conv
// (32 decodes of 32^3, C = 32 -> N = 8) the forward reads 67 MB of x and
// writes 17 MB of y for 4.3 GFLOP, about 1 operation a byte, where the tensor
// cores become the limit only at ~295. So the design reads each byte of x
// from device memory once and asks of the products only that they keep up:
//
// - The halo box. A block's outputs are a box of bd x bh x bw voxels of one
//   batch item (8 x 8 x 16 at 32^3, C = 32). One 5-D TMA copy brings the box
//   grown by one voxel along d, h and w, all C channels, into shared memory;
//   where it leaves the grid the TMA writes zeros, which is the SAME padding
//   (lo 0, hi 1). All 8 taps read that one copy: tap (dz, dy, dx) of an
//   output voxel is the halo voxel that far on. The halos of neighbouring
//   boxes overlap (1.34x the box at 8 x 8 x 16); the overlap comes from L2.
//   The FFMA kernel this replaces read 8 shifted copies of its rows and
//   computed 64 columns for N = 8.
// - Shared-memory layout: a voxel's C channels are one row of 2C bytes (16 to
//   128), written by the TMA under the swizzle of that width, which XORs the
//   16-byte piece of a row with bits 7.. of its offset. The 8 rows an ldmatrix
//   reads are 8 consecutive voxels; under the swizzle they fall into 8
//   different 16-byte bank groups whatever voxel they start at (a tap moves
//   them by one). Without it a 64-byte row (C = 32) is 4-way conflicted.
// - Products: mma.sync.m16n8k16, bf16 operands, f32 accumulators. Its n8 is
//   N = 8 (N = 16 and 32 are 2 and 4 of them) and it needs no 64-row
//   warpgroup tile; 4.3 GFLOP is under 0.02 ms at a fraction of the
//   tensor-core rate.
//   Forward: y [rows, N] = A [rows, 8C] w [8C, N], depth in (tap, c) order. A
//   k-step of 16 is two pieces of 8 channels, each inside one tap (C % 8 ==
//   0), so ldmatrix's row addresses pick each output row's shifted halo voxel
//   directly: no gather, no copy. w is laid out once a block in shared memory
//   as mma fragments (one 8-byte read a lane a k-step and n8 tile). The
//   accumulators are rounded once to bf16 and stored from registers; rows
//   past the grid's edge (a ragged last box) are not stored.
//   dx: the forward's kernel (its DX instance) over g. dx[p, c] =
//   sum_s sum_n g[p - 1 + s, n] w'[s, n, c] with w'[s] = w[7 - s]^T (each bit
//   of the tap flipped): a forward from N to C channels whose halo box starts
//   one voxel lower along d, h and w, where the TMA's zeros at coordinate -1
//   are the low-edge mask. The wrapper lays out w' ([8N, C]) on its 2K
//   elements; the row table, tap offsets, ldmatrix and store are the forward's.
//   dw: dw [8C, N] = A [8C, rows] g [rows, N] over the box's rows. g's box is
//   copied as x's is (no halo; its rows past the grid are zeros, and so are
//   the rows that round the box up to 16). Both operands lie [row][channel],
//   so both are read with ldmatrix.trans. All 8C x N accumulators stay in
//   registers, spread over the warps (at C = 32, N = 8: 16 m16n8 tiles, 2 a
//   warp). Each k-step's product is formed from zero and added to them with a
//   rounded f32 add: the tensor cores' own accumulation does not round to
//   nearest, and a chain of thousands of k-steps would drift by ~1e-5.
// - A block walks boxes (the forward: boxes i, i + grid, ...; dw: a run of
//   consecutive boxes, its split) through two stages: the TMA fills the next
//   box's stage while the warps compute on this one. One thread issues the
//   copies; a `full` mbarrier a stage counts their bytes, and a __syncthreads
//   after each box frees its stage for the copy after next.
// - dw's splits write partial [8C, N] sums to a workspace, which
//   conv_k2_dw_reduce_kernel adds in ascending order: no atomics, the same
//   bits every run.
// - float32 forward (conv_k2_narrow_fwd_f32_kernel): exact FFMA, no TF32. At
//   the detector's shape it is bound by operations (4.3 GFLOP against 84 MB),
//   and the FFMA tile it replaces computed 64 columns for 8. The same box
//   walk, copied by the TMA as float32 rows of 4C bytes (32 to 128: C = 8, 16,
//   32) under the swizzle of that width, so that 8 lanes reading one 16-byte
//   piece of 8 consecutive voxels hit 8 bank groups. Two stages of 4 x 8 x 16
//   outputs at C = 32 take 2 x 98 KB. A thread owns 4 rows of the box and all
//   N columns; w (8C x N, 8 KB at C = 32) lies in shared memory and is read
//   as float4 broadcasts. A k-step of 4 channels reads one float4 of each row
//   and N float4 of w for 16 N FFMA: the operands as vectors and broadcasts,
//   nothing else in the inner loop. Shared memory's 128 bytes a clock are
//   then the other limit beside the FFMA rate: at N = 8 the rows' float4 take
//   half of it. Where the box has at most 512 rows (C = 32) the block's two
//   halves each take 4 of the 8 taps for all rows, so w is read once for 4
//   rows, not 2; the second half's partial sums meet the first's in shared
//   memory. A row's result is stored as N/4 float4, or, where the box has no
//   split and is a whole number of 256-row chunks of d-planes, through
//   shared memory: each chunk written swizzled into one of two buffers and
//   stored by the TMA (clipped at the grid) while the block goes on. float32
//   dx is its DX instance, as the bf16 forward's: the halo box of g one voxel
//   lower, w' from the wrapper. At the detector (8 -> 32 channels, a 16 x 8 x
//   8 box of 1024 rows, 4 rows and 32 columns a thread) dx writes 134 MB: as
//   8 float4 a row at a 128-byte stride a lane, the store alone took longer
//   than the products.
// - float32 dw (conv_k2_narrow_dw_f32_kernel): the bf16 dw's walk (a run of
//   consecutive boxes a block, the halo box of x and the box of g by one TMA
//   copy each), exact FFMA, three stages. The output is small (8C x N, 2048
//   floats at C = 32, N = 8), so a thread keeps a register tile of it: 8
//   channels of one tap by 8 outputs, 64 accumulators. The C N / 8 tiles make
//   a group of threads (32 at the detector: one warp, lane = tap * C/8 +
//   channel group), and the block's 256 / (C N / 8) groups deal the box's
//   rows among them, row r to group r % groups. A row costs a thread two
//   swizzled float4 of x and two float4 of g, which every lane of a group
//   reads at once (a broadcast), for 64 FFMA: shared memory's 128 bytes a
//   clock stay under the FFMA rate. In a warp, lanes of taps 2k and 2k + 1 read
//   voxels v and v + 1, whose swizzles differ in the low bit, so a phase of 8
//   lanes hits 8 bank groups. After the run the groups' tiles are added in
//   shared memory, group 0 first, then 1, ...; the split's partial goes to the
//   workspace and conv_k2_dw_reduce_kernel adds the splits in order: the same
//   bits every run.
// - Wide inputs, chunked (bfloat16, C a multiple of 64 above 64, N = 8, 16,
//   32; kernels/conv_k2.py::narrow_plan's c_chunks): the flagship's 512 -> 64
//   stage with its output split over a model axis of 2 is 512 -> 32 on each
//   rank. A voxel's 512 channels are 1 KB, so the halo box cannot hold them
//   all: the walk takes C in chunks of 64, one 128-byte swizzled row a voxel
//   as at C = 64, the chunk's channels cut out of x by the TMA box itself.
//   At B=32 on 16^3 the forward reads 134 MB of x for 34.4 GFLOP (240
//   operations a byte), so it is bound by bytes; the FFMA GEMM it replaces
//   read x through 8 shifted gathers (1.07 GB of L2 traffic) and computed 64
//   columns for 32.
//   Forward (conv_k2_chunked_fwd_kernel): a block keeps the N f32
//   accumulators of a whole box in registers (8 warps, at most 2 m-tiles
//   each at N = 32 and 4 at N = 8 and 16: boxes of 256 or 512 rows) across
//   the chunks. A stage of the ring holds one chunk's halo box and that
//   chunk's w, 8 x 64 x N bf16 as it lies (32 KB at N = 32; one TMA copy of
//   128-byte rows under the 128-byte swizzle), and the ring walks (box,
//   chunk) steps: the TMA fills the next steps' stages while the warps take
//   the 32 k-steps of this one, A from the row table with ldmatrix as the C
//   <= 64 forward does, B with ldmatrix.trans as dw reads g. After a box's
//   last chunk the accumulators are rounded to bf16 once and stored. x
//   comes from device memory once; the halo overlap and w's re-reads (once
//   a box) come from L2.
//   dw (conv_k2_narrow_dw_kernel, blockIdx.y the chunk): a block reduces one
//   64-channel chunk of x's halo boxes against g's boxes (all N) over its
//   run of boxes, exactly as the C = 64 dw does, and writes its [8 x 64, N]
//   partial to the chunk's rows (tap, c) of its split's [8C, N]; the splits
//   are added by conv_k2_dw_reduce_kernel in order. g is read once a chunk,
//   from L2. The forward walks two stages a block; dw g.stages (2, or 3
//   where its box has room for a third).
//   Forward in float32 (conv_k2_chunked_fwd_f32_kernel; C a multiple of 32
//   above 32, the same shard in the float32 step): bound by operations (34.4
//   GFLOP of FFMA at 67 TFLOP/s against 285 MB, at B=32 on 16^3); the FFMA
//   GEMM it replaces computed 64 columns for 32. The float32 forward's inner
//   loop (f32_tap_products: 4 rows and all N columns a thread, w as float4
//   broadcasts) on a box of 1024 rows, its accumulators in registers across
//   the chunks. A chunk is 16 channels, 64-byte rows under the 64-byte
//   swizzle: a 1024-row box's halo of 128-byte rows (32 channels) is 176 KB,
//   room for one stage, where the ring needs two (2 x 103 KB at 16 channels,
//   with the chunk's w, 16 KB at N = 32). The result is stored once, from
//   registers: y is 17 MB of the 285, and the two stages leave no room for
//   the chunk buffers. dx and dw of these shapes keep the FFMA kernels.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "conv_k2_wgmma.cuh"

namespace nr {

constexpr int THREADS = 256;  // 8 warps, one block an SM
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 1024;      // output rows of a box
constexpr int MAX_EXTENT = 255;     // a box extent; its halo's is one more, within the TMA's 256
constexpr int DW_MAX_M_TILES = 4;   // m16 tiles of dw's 8C rows a warp: C <= 64
constexpr int DW_WIDE_ACCUMULATORS = 4096;  // 8C x N of the bfloat16 dw at N = 64: 16 a lane, one unit a warp
constexpr uint32_t ALIGN = 1024;    // stage alignment: the longest swizzle's period

// CONV_K2_NARROW_PROBE builds the float32 kernels and those of the walk in
// chunks (the chunked forward, and the bfloat16 dw where g.chunks > 1) with a
// part left out, to time the rest (cli/probe_narrow.py; the port's build has
// 0, all of it; conv_k2_chunked_dx.cuh reads it too). The forwards and dx: 1
// without the store of y (dx), 2 without the products (chunked: no ldmatrix,
// no mma or wgmma), 3 without both. The float32 dw: 1
// without each row's loads (every row's products on the first row's
// operands), 2 with 8 FFMA a row for 64, 3 without the loop over rows. The
// chunked dw: 1 each k-step's products added by the tensor cores' own
// accumulation (no rounded adds), 3 without the loop over k-steps (2 is
// whole). conv_k2.cu's FFMA dw reads it too: 1 without its loads (no
// cp.async of x or g: every stage's products on what shared memory holds),
// 2 without its products, 3 without both.
#ifndef CONV_K2_NARROW_PROBE
#define CONV_K2_NARROW_PROBE 0
#endif
constexpr int PROBE = CONV_K2_NARROW_PROBE;

// Where a launch's shapes meet: the grid, the box and the byte counts, worked
// out on the host and passed by value.
struct Geom {
  int D, H, W, C;       // C: the channels of a box's row, a chunk's 64 where the walk takes C in chunks
  int c_total, chunks;  // x's channels, and the chunks of 64 of them (1: the box holds them all)
  int row;              // bytes of a voxel's C channels: 2C (bfloat16) or 4C (float32)
  int bw, bh, bd;       // output box
  int nw, nh, nd;       // boxes along w, h and d, the last ones ragged
  int boxes;            // B * nd * nh * nw
  int rows, rows16;     // bw * bh * bd, and that rounded up to 16
  uint32_t halo_bytes;  // (bw + 1)(bh + 1)(bd + 1) * row: one TMA copy of x
  uint32_t g_bytes;     // rows * esize N: one TMA copy of g (dw)
  uint32_t stage_x;     // halo_bytes rounded up to ALIGN
  uint32_t stage_g;     // rows16 * esize N rounded up to ALIGN (dw; 0 for the forward)
  uint32_t stage_w;     // a chunk's w, 8 x 64 x N bf16 (the chunked forward; else 0)
  int split;            // the float32 forward's parts of the taps: 2 where rows <= 2 THREADS, else 1
  uint32_t sums;        // float32 partial sums: the split forward's second part (rows x N), dw's tile (8C x N)
  uint32_t stage_y;     // the float32 forward's output chunk (THREADS rows x 4N, two of them), or 0: see make_geom
  int chunk_d;          // d-planes of the box in a chunk, THREADS / (bw bh), or 0: the plan's
  int stages;           // copies of x (and g, or w) a block holds: the plan's, 2 or (the float32 dw, chunked dw) 3
};

__host__ __device__ constexpr uint32_t round_up(uint32_t v, uint32_t a) { return (v + a - 1) / a * a; }

// m-tiles a warp of the chunked forward holds across the chunks, N = 8 NT: 32 accumulators a lane at N = 16
// and 32; 16 at N = 8, where 8 m-tiles' operands took every register and spilled. Its box has at most
// 16 WARPS chunked_mw(NT) rows.
__host__ __device__ constexpr int chunked_mw(int nt) { return nt == 1 ? 4 : 8 / nt; }

// Dynamic shared memory of a launch: alignment room, the stages (and the
// float32 forward's two output chunks), the forward's w (8C x N elements: 8 N
// row bytes; the chunked forward's is in its stages) and its table of output
// rows, the table of halo rows, a barrier a stage (their room a multiple of 16
// bytes), and the float32 kernels' partial sums.
__host__ __device__ inline size_t smem_bytes(const Geom& g, int N, bool dw) {
  return ALIGN + static_cast<size_t>(g.stages) * (g.stage_x + g.stage_g + g.stage_w) +
         2 * static_cast<size_t>(g.stage_y) + (dw || g.chunks > 1 ? 0 : 8 * N * g.row) + (dw ? 0 : 4 * g.rows16) +
         4 * g.rows16 + round_up(8 * g.stages, 16) + g.sums;
}

// Byte offset `off` of a buffer of rows of `mask` + 1 16-byte pieces, as the
// TMA's swizzle of that row width placed it: piece ^= bits 7.. of the offset.
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// The TMA's store of a box from shared memory (the bulk-group form): one
// thread issues it after the writing threads' proxy fence and a barrier; a
// chunk buffer is written again only once its store has read it.
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3,
                                             int c4) {
  asm volatile("cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {  // at most PENDING stores still reading shared memory
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {  // this thread's shared-memory writes, seen by the TMA
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d = a (16 x 16, row) * b (16 x 8, col) + c. Lane l holds rows l/4 and l/4 + 8,
// columns 2(l%4) + {0, 1} of d: d[0], d[1] and d[2], d[3].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                    const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Origin (w, h, d, b) of box `box`: w fastest, as the rows of y.
__device__ __forceinline__ void box_origin(const Geom& g, int box, int& w0, int& h0, int& d0, int& b) {
  int t = box;
  w0 = (t % g.nw) * g.bw; t /= g.nw;
  h0 = (t % g.nh) * g.bh; t /= g.nh;
  d0 = (t % g.nd) * g.bd;
  b = t / g.nd;
}

// Byte offset of tap t's halo voxel from an output voxel's own.
__device__ __forceinline__ int tap_offset(const Geom& g, int t) {
  return (((t >> 2) * (g.bh + 1) + ((t >> 1) & 1)) * (g.bw + 1) + (t & 1)) * g.row;
}

// The tables of the box's rows, the same for every box: vrow[r] = byte
// offset of output row r's own halo voxel (tap 0), rows past the box (up to
// rows16) at voxel 0; and where `loc` is given, loc[r] = (d, h, w) of row r
// in the box, 10 bits each, -1 past the box.
__device__ __forceinline__ void fill_rows(const Geom& g, int* vrow, int* loc) {
  for (int r = threadIdx.x; r < g.rows16; r += THREADS) {
    int v = 0, l = -1;
    if (r < g.rows) {
      const int rw = r % g.bw, t = r / g.bw, rh = t % g.bh, rd = t / g.bh;
      v = ((rd * (g.bh + 1) + rh) * (g.bw + 1) + rw) * g.row;
      l = rd << 20 | rh << 10 | rw;
    }
    vrow[r] = v;
    if (loc) loc[r] = l;
  }
}

__device__ __forceinline__ void init_barriers(uint32_t bar, int n = 2) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) wg::mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Forward: y [B, D, H, W, N] from x [B, D, H, W, C] and w [8C, N] (N = 8 NT);
// DX: dx [B, D, H, W, N] from g [B, D, H, W, C] and w' [8C, N], the halo box
// one voxel lower (C and N here are the depth's and the output's channels).
// Block i computes boxes i, i + gridDim.x, ... (gridDim.x <= boxes). A warp
// takes m-tiles (16 rows of the box) warp, warp + 8, ..., MW of them a pass,
// which share one read of w's fragments a k-step. A k-step issues all its
// ldmatrix first and then its products, so that the loads' latencies overlap
// instead of each product waiting on its own load.
template <int NT, bool DX>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_narrow_fwd_kernel(const __grid_constant__ CUtensorMap map_x, const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, const Geom g) {
  constexpr int N = 8 * NT;
  constexpr int MW = 8 / NT;  // 8, 4 or 2 m-tiles a pass: 32 accumulators a lane
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = round_up(raw, ALIGN);
  uint8_t* const base_p = smem_raw + (base - raw);
  uint2* const wfrag = reinterpret_cast<uint2*>(base_p + 2 * g.stage_x);
  int* const vrow = reinterpret_cast<int*>(base_p + 2 * g.stage_x + 8 * N * g.row);
  int* const loc = vrow + g.rows16;
  const uint32_t bar = base + 2 * g.stage_x + 8 * N * g.row + 8 * g.rows16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grid = gridDim.x, n_boxes = (g.boxes - static_cast<int>(blockIdx.x) + grid - 1) / grid;

  const CUtensorMap* mx = &map_x;
  auto issue = [&](int s, int box) {  // thread 0: the halo box of `box` into stage s
    int w0, h0, d0, b;
    box_origin(g, box, w0, h0, d0, b);
    const int lo = DX ? 1 : 0;  // dx reads g one voxel lower; below 0 the TMA writes zeros
    wg::mbar_arrive_expect_tx(bar + 8 * s, g.halo_bytes);
    wg::tma_load_5d(base + s * g.stage_x, mx, bar + 8 * s, 0, w0 - lo, h0 - lo, d0 - lo, b);
  };

  init_barriers(bar);
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < 2 && s < n_boxes; ++s) issue(s, blockIdx.x + s * grid);
  // while the first boxes land: w as mma fragments, entry (k-step, n8 tile, lane); b0 holds
  // rows k = 16 ks + 2 (lane % 4) + {0, 1} of column 8 j + lane / 4, b1 the rows 8 further
  {
    const uint16_t* wr = reinterpret_cast<const uint16_t*>(w);
    for (int i = tid; i < g.C / 2 * NT * 32; i += THREADS) {
      const int l = i & 31, j = (i >> 5) % NT, ks = (i >> 5) / NT;
      const int k = 16 * ks + 2 * (l & 3), n = 8 * j + (l >> 2);
      wfrag[i] = make_uint2(wr[k * N + n] | static_cast<uint32_t>(wr[(k + 1) * N + n]) << 16,
                            wr[(k + 8) * N + n] | static_cast<uint32_t>(wr[(k + 9) * N + n]) << 16);
    }
  }
  fill_rows(g, vrow, loc);
  __syncthreads();

  const uint32_t mask = g.row / 16 - 1;
  const int log_c = __ffs(g.C) - 1;  // C is a power of two
  const int mtiles = g.rows16 / 16;
  // this lane's ldmatrix row: row lane % 16 of an m-tile, channels 8 (lane / 16) .. of a k-step
  const int a_row = lane & 15, a_half = lane >> 4;
  for (int i = 0; i < n_boxes; ++i) {
    const int s = i & 1;
    int w0, h0, d0, b;
    box_origin(g, blockIdx.x + i * grid, w0, h0, d0, b);
    wg::mbar_wait(bar + 8 * s, (i >> 1) & 1);
    const uint32_t xs = base + s * g.stage_x;
    for (int p = warp; p < mtiles; p += WARPS * MW) {  // m-tiles p, p + 8, ... (MW of them)
      float acc[MW][NT][4];
      uint32_t vr[MW];
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        vr[m] = p + WARPS * m < mtiles ? vrow[16 * (p + WARPS * m) + a_row] : 0;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
      }
      for (int ks = 0; ks < g.C / 2; ++ks) {
        const int k = 16 * ks + 8 * a_half;  // this lane's 8 channels: one tap
        const uint32_t koff = tap_offset(g, k >> log_c) + 2 * (k & (g.C - 1));
        uint2 bf[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) bf[j] = wfrag[(ks * NT + j) * 32 + lane];
        uint32_t a[MW][4];
#pragma unroll
        for (int m = 0; m < MW; ++m)  // the same for the whole warp
          if (p + WARPS * m < mtiles) ldsm_x4(xs + swizzle(vr[m] + koff, mask), a[m]);
#pragma unroll
        for (int m = 0; m < MW; ++m)
          if (p + WARPS * m < mtiles)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(acc[m][j], a[m], bf[j].x, bf[j].y, acc[m][j]);
      }
      // rows past the grid (a ragged last box) are not stored
      const int lim_w = g.W - w0, lim_h = g.H - h0, lim_d = g.D - d0;
      const long long row0 = ((static_cast<long long>(b) * g.D + d0) * g.H + h0) * g.W + w0;
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        if (p + WARPS * m >= mtiles) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows lane/4 and lane/4 + 8 of the m-tile
          const int l = loc[16 * (p + WARPS * m) + (lane >> 2) + 8 * half];
          const int rw = l & 1023, rh = (l >> 10) & 1023, rd = l >> 20;
          if (l < 0 || rw >= lim_w || rh >= lim_h || rd >= lim_d) continue;
          __nv_bfloat16* out = y + (row0 + (static_cast<long long>(rd) * g.H + rh) * g.W + rw) * N + 2 * (lane & 3);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            *reinterpret_cast<uint32_t*>(out + 8 * j) = wg::pack_bf16(acc[m][j][2 * half], acc[m][j][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + 2 < n_boxes) issue(s, blockIdx.x + (i + 2) * grid);
  }
}

// The chunked forward: y [B, D, H, W, N] (N = 8 NT) from x [B, D, H, W, 64
// g.chunks] and w [8, 64 g.chunks, N] as it lies: a stage's w is the chunk's
// [8 taps][64 c][N] by one TMA copy of 128-byte rows (2N-byte rows of (tap,
// c), 128 / 2N of them a row) under the 128-byte swizzle, read as the mma's
// B fragments by ldmatrix.trans (as dw reads g; any 8 consecutive (tap, c)
// rows fall in 8 bank groups). Block i computes boxes i, i + gridDim.x, ...;
// step t of its walk is chunk t % chunks of its box t / chunks, through the
// ring's two stages. Warp w owns m-tiles w, w + 8, ... of the box (MW =
// chunked_mw(NT) at most: the plan's box has at most 128 MW rows) and their
// accumulators across the chunks.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_chunked_fwd_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                           __nv_bfloat16* __restrict__ y, const Geom g) {
  constexpr int N = 8 * NT;
  constexpr int MW = chunked_mw(NT);  // m-tiles a warp
  constexpr int KSTEPS = 8 * 64 / 16;  // a chunk's depth, 8 taps x 64 channels, in k-steps of 16
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = round_up(raw, ALIGN);
  uint8_t* const base_p = smem_raw + (base - raw);
  constexpr int S = 2;  // stages of the ring (make_geom's g.stages)
  const uint32_t stage = g.stage_x + g.stage_w;
  int* const vrow = reinterpret_cast<int*>(base_p + S * stage);
  int* const loc = vrow + g.rows16;
  const uint32_t bar = base + S * stage + 8 * g.rows16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grid = gridDim.x, n_boxes = (g.boxes - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int n_steps = n_boxes * g.chunks;

  const CUtensorMap *mx = &map_x, *mwt = &map_w;
  auto issue = [&](int s, int t) {  // thread 0: step t's halo box of its chunk and the chunk's w into stage s
    int w0, h0, d0, b;
    box_origin(g, blockIdx.x + t / g.chunks * grid, w0, h0, d0, b);
    const int chunk = t % g.chunks;
    const uint32_t full = bar + 8 * s, dst = base + s * stage;
    wg::mbar_arrive_expect_tx(full, g.halo_bytes + g.stage_w);
    wg::tma_load_5d(dst, mx, full, 64 * chunk, w0, h0, d0, b);
    tma_load_3d(dst + g.stage_x, mwt, full, 0, N * chunk, 0);
  };

  init_barriers(bar, S);
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && s < n_steps; ++s) issue(s, s);
  fill_rows(g, vrow, loc);
  __syncthreads();

  const int mtiles = g.rows16 / 16;
  const int mw = (mtiles - warp + WARPS - 1) / WARPS;  // this warp's m-tiles: warp, warp + 8, ...
  // m-tile m of this warp, kept inside the box's tables where the warp has fewer than MW
  auto mtile = [&](int m) { return min(warp + WARPS * m, mtiles - 1); };
  // this lane's ldmatrix row: row lane % 16 of an m-tile, channels 8 (lane / 16) .. of a k-step
  const int a_row = lane & 15, a_half = lane >> 4;
  uint32_t vr[MW], toff[8];
#pragma unroll
  for (int m = 0; m < MW; ++m) vr[m] = vrow[16 * mtile(m) + a_row];
#pragma unroll
  for (int t = 0; t < 8; ++t) toff[t] = tap_offset(g, t) + 16 * a_half;
  // B: a k-step is 16 rows of w's [512][N], 32 N bytes, so the 128-byte swizzle's 1024-byte period holds P of
  // them; this lane's ldmatrix row (16 p + lane % 16, n8 tile 2 jj + lane / 16: .x4 takes two tiles, .x2 at
  // N = 8 one) swizzled once for each p, so that a k-step's B address is the period's base and a constant
  constexpr int P = 1024 / (32 * N), NB = NT > 1 ? NT / 2 : 1;
  uint32_t bsw[NB][P];
#pragma unroll
  for (int jj = 0; jj < NB; ++jj)
#pragma unroll
    for (int p = 0; p < P; ++p)
      bsw[jj][p] = swizzle(static_cast<uint32_t>((16 * p + a_row) * 2 * N + 32 * jj + (NT > 1 ? 16 * a_half : 0)),
                           7);
  float acc[MW][NT][4];
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % S, chunk = i % g.chunks;
    if (chunk == 0)
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
    wg::mbar_wait(bar + 8 * s, (i / S) & 1);
    const uint32_t xs = base + s * stage, wsm = xs + g.stage_x;
#pragma unroll
    for (int ks = 0; ks < (PROBE & 2 ? 0 : KSTEPS); ++ks) {
      // A: tap ks / 4, channels 16 (ks % 4) .. of the chunk, this lane's 8 of them from its row's halo voxel;
      // B: rows 16 ks + lane % 16 of the chunk's w [512][N] (ldmatrix.trans, as dw reads g)
      uint32_t bf[NT][2], a[MW][4];
      const uint32_t wk = wsm + (ks / P) * 1024;
      if constexpr (NT > 1) {
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          uint32_t r[4];
          ldsm_x4_trans(wk + bsw[jj][ks % P], r);
          bf[2 * jj][0] = r[0], bf[2 * jj][1] = r[1], bf[2 * jj + 1][0] = r[2], bf[2 * jj + 1][1] = r[3];
        }
      } else {
        ldsm_x2_trans(wk + bsw[0][ks % P], bf[0]);
      }
      const uint32_t koff = toff[ks >> 2] + 32 * (ks & 3);
#pragma unroll
      for (int m = 0; m < MW; ++m)
        if (m < mw) ldsm_x4(xs + swizzle(vr[m] + koff, 7), a[m]);
#pragma unroll
      for (int m = 0; m < MW; ++m)
        if (m < mw)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma(acc[m][j], a[m], bf[j][0], bf[j][1], acc[m][j]);
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + S < n_steps) issue(s, i + S);
    // the probe without the store: g.D > 0 always holds, but the compiler cannot know it and keeps the products
    if (chunk != g.chunks - 1 || (PROBE & 1 && g.D > 0)) continue;
    // the box's last chunk: its rows inside the grid (a ragged last box stores fewer), rounded once
    int w0, h0, d0, b;
    box_origin(g, blockIdx.x + i / g.chunks * grid, w0, h0, d0, b);
    const int lim_w = g.W - w0, lim_h = g.H - h0, lim_d = g.D - d0;
    const long long row0 = ((static_cast<long long>(b) * g.D + d0) * g.H + h0) * g.W + w0;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (m >= mw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows lane/4 and lane/4 + 8 of the m-tile
        const int l = loc[16 * mtile(m) + (lane >> 2) + 8 * half];
        const int rw = l & 1023, rh = (l >> 10) & 1023, rd = l >> 20;
        if (l < 0 || rw >= lim_w || rh >= lim_h || rd >= lim_d) continue;
        __nv_bfloat16* out = y + (row0 + (static_cast<long long>(rd) * g.H + rh) * g.W + rw) * N + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) = wg::pack_bf16(acc[m][j][2 * half], acc[m][j][2 * half + 1]);
      }
    }
  }
}

// The float32 products of one tap: acc[q][n] += sum over c < C of x[c] of the
// halo voxel toff bytes past vr[q] (this thread's row q) times wt[c][n], wt
// the tap's C rows of w (N floats each) in shared memory. A k-step of 4
// channels reads one float4 of each row, under the swizzle of `mask` (a row's
// pieces lie inside its row bytes, so its swizzle is one XOR key a tap:
// swizzle(rb + 16 c4) = rb + (16 c4 ^ key)), and N float4 of w, the same for
// every lane (broadcasts), for 16 N FFMA a row.
template <int RT, int N>
__device__ __forceinline__ void f32_tap_products(float (&acc)[RT][N], const uint8_t* xs, const uint32_t (&vr)[RT],
                                                 uint32_t toff, uint32_t mask, const float4* wt, int C) {
  constexpr int NV = N / 4;  // float4 a row of w
  uint32_t rb[RT], key[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    rb[q] = vr[q] + toff;
    key[q] = ((rb[q] >> 7) & mask) << 4;
  }
#pragma unroll 2
  for (int c4 = 0; c4 < C / 4; ++c4) {
    float4 a[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) a[q] = *reinterpret_cast<const float4*>(xs + rb[q] + ((c4 << 4) ^ key[q]));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 wv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) wv[j] = wt[(4 * c4 + kk) * NV + j];  // the same for every lane
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const float av = kk == 0 ? a[q].x : kk == 1 ? a[q].y : kk == 2 ? a[q].z : a[q].w;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          acc[q][4 * j] = fmaf(av, wv[j].x, acc[q][4 * j]);
          acc[q][4 * j + 1] = fmaf(av, wv[j].y, acc[q][4 * j + 1]);
          acc[q][4 * j + 2] = fmaf(av, wv[j].z, acc[q][4 * j + 2]);
          acc[q][4 * j + 3] = fmaf(av, wv[j].w, acc[q][4 * j + 3]);
        }
      }
    }
  }
}

// Forward in float32: y [B, D, H, W, N] from x [B, D, H, W, C] and w [8C, N]
// (N = 8 NT), each product an FFMA; DX: dx from g and w' with the halo box one
// voxel lower, as the bf16 kernel's DX instance. The walk, stages and tables
// are the bf16 forward's. The block is g.split parts of THREADS / split
// threads, part p taking taps [8p / split, 8(p + 1) / split); a thread owns
// rows lt + q THREADS / split (q < RT) of the box, lt its index in its part,
// and all N columns: 8 consecutive lanes read 8 consecutive voxels,
// conflict-free under the swizzle. Rows past the box compute on voxel 0 and
// are not stored. Where g.stage_y is set (no split, the box a whole number of
// THREADS-row chunks of d-planes) row q of each thread, chunk q of the box, is
// written swizzled into one of two chunk buffers and stored by the TMA, which
// clips it at the grid's edge, while the block goes on: 16-byte stores a lane
// at a row's stride left most of each line unwritten a request.
template <int NT, bool DX>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_narrow_fwd_f32_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_y,
                              const float* __restrict__ w, float* __restrict__ y, const Geom g) {
  constexpr int N = 8 * NT;
  constexpr int NV = N / 4;  // float4 a row of w or y
  constexpr int RT = MAX_ROWS / THREADS;  // rows a thread: split * RT * (THREADS / split) covers any box
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = round_up(raw, ALIGN);
  uint8_t* const base_p = smem_raw + (base - raw);
  const uint32_t ys = 2 * g.stage_x, rest = 2 * (g.stage_x + g.stage_y);  // the chunk buffers, then the rest
  float4* const ws = reinterpret_cast<float4*>(base_p + rest);
  int* const vrow = reinterpret_cast<int*>(base_p + rest + 8 * N * g.row);
  int* const loc = vrow + g.rows16;
  const uint32_t bar = base + rest + 8 * N * g.row + 8 * g.rows16;
  float4* const part_sum = reinterpret_cast<float4*>(base_p + rest + 8 * N * g.row + 8 * g.rows16 + 16);
  const int tid = threadIdx.x;
  const int grid = gridDim.x, n_boxes = (g.boxes - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int part_threads = THREADS / g.split, part = tid / part_threads, lt = tid % part_threads;
  const int tap0 = 8 * part / g.split, tap1 = 8 * (part + 1) / g.split;

  const CUtensorMap* mx = &map_x;
  auto issue = [&](int s, int box) {  // thread 0: the halo box of `box` into stage s
    int w0, h0, d0, b;
    box_origin(g, box, w0, h0, d0, b);
    const int lo = DX ? 1 : 0;  // dx reads g one voxel lower; below 0 the TMA writes zeros
    wg::mbar_arrive_expect_tx(bar + 8 * s, g.halo_bytes);
    wg::tma_load_5d(base + s * g.stage_x, mx, bar + 8 * s, 0, w0 - lo, h0 - lo, d0 - lo, b);
  };

  init_barriers(bar);
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < 2 && s < n_boxes; ++s) issue(s, blockIdx.x + s * grid);
  // while the first boxes land: w [8C, N] as it lies
  for (int i = tid; i < 2 * g.C * N; i += THREADS) ws[i] = reinterpret_cast<const float4*>(w)[i];
  fill_rows(g, vrow, loc);
  __syncthreads();

  const uint32_t mask = g.row / 16 - 1;
  for (int i = 0; i < n_boxes; ++i) {
    const int s = i & 1;
    int w0, h0, d0, b;
    box_origin(g, blockIdx.x + i * grid, w0, h0, d0, b);
    wg::mbar_wait(bar + 8 * s, (i >> 1) & 1);
    const uint8_t* const xs = base_p + s * g.stage_x;
    {
      uint32_t vr[RT];
      float acc[RT][N];
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int r = lt + part_threads * q;
        vr[q] = r < g.rows ? vrow[r] : 0;
#pragma unroll
        for (int n = 0; n < N; ++n) acc[q][n] = 0.f;
      }
      for (int t = tap0; t < (PROBE & 2 ? tap0 : tap1); ++t)
        f32_tap_products(acc, xs, vr, tap_offset(g, t), mask, ws + t * g.C * NV, g.C);
      if (g.split > 1) {  // the second part's sums into the first's: [row][N] floats
        if (part == 1)
#pragma unroll
          for (int q = 0; q < RT; ++q) {
            const int r = lt + part_threads * q;
            if (r < g.rows)
#pragma unroll
              for (int j = 0; j < NV; ++j)
                part_sum[r * NV + j] = make_float4(acc[q][4 * j], acc[q][4 * j + 1], acc[q][4 * j + 2],
                                                   acc[q][4 * j + 3]);
          }
        __syncthreads();
        if (part == 0)
#pragma unroll
          for (int q = 0; q < RT; ++q) {
            const int r = lt + part_threads * q;
            if (r < g.rows)
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                const float4 v = part_sum[r * NV + j];
                acc[q][4 * j] += v.x;
                acc[q][4 * j + 1] += v.y;
                acc[q][4 * j + 2] += v.z;
                acc[q][4 * j + 3] += v.w;
              }
          }
      }
      if (PROBE & 1 && g.D > 0) {
        // the probe without the store: g.D > 0 always holds, but the compiler cannot know it and keeps the products
      } else if (g.stage_y) {  // chunk q (rows q THREADS ..) through buffer (i * chunks + q) % 2 and the TMA
        const uint32_t omask = 4 * N / 16 - 1;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          if (THREADS * q >= g.rows) break;
          const uint32_t buf = ys + ((i * (g.rows / THREADS) + q) & 1) * g.stage_y;
          if (tid == 0) bulk_wait_read<1>();  // the buffer's last store has read it
          __syncthreads();
#pragma unroll
          for (int j = 0; j < NV; ++j)
            *reinterpret_cast<float4*>(base_p + buf + swizzle(tid * 4 * N + 16 * j, omask)) =
                make_float4(acc[q][4 * j], acc[q][4 * j + 1], acc[q][4 * j + 2], acc[q][4 * j + 3]);
          fence_proxy_async();
          __syncthreads();
          if (tid == 0) tma_store_5d(&map_y, base + buf, 0, w0, h0, d0 + q * g.chunk_d, b);
        }
      } else {  // rows past the box or the grid (a ragged last box) are not stored; the first part stores
        const int lim_w = g.W - w0, lim_h = g.H - h0, lim_d = g.D - d0;
        const long long row0 = ((static_cast<long long>(b) * g.D + d0) * g.H + h0) * g.W + w0;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          const int r = lt + part_threads * q;
          if (part != 0 || r >= g.rows) continue;
          const int l = loc[r];
          const int rw = l & 1023, rh = (l >> 10) & 1023, rd = l >> 20;
          if (rw >= lim_w || rh >= lim_h || rd >= lim_d) continue;
          float4* out =
              reinterpret_cast<float4*>(y + (row0 + (static_cast<long long>(rd) * g.H + rh) * g.W + rw) * N);
#pragma unroll
          for (int j = 0; j < NV; ++j)
            out[j] = make_float4(acc[q][4 * j], acc[q][4 * j + 1], acc[q][4 * j + 2], acc[q][4 * j + 3]);
        }
      }
    }
    __syncthreads();  // every thread is done with stage s and the partial sums
    if (tid == 0 && i + 2 < n_boxes) issue(s, blockIdx.x + (i + 2) * grid);
  }
  if (g.stage_y && tid == 0) bulk_wait_all();  // the chunk buffers stay until the last store has read them
}

// The chunked forward in float32: y [B, D, H, W, N] (N = 8 NT) from x [B, D,
// H, W, 16 g.chunks] and w [8, 16 g.chunks, N] as it lies, each product an
// FFMA. Block i computes boxes i, i + gridDim.x, ...; step t of its walk is
// chunk t % chunks of its box t / chunks, through the ring's two stages, each
// the chunk's halo box (64-byte rows under the 64-byte swizzle) and the
// chunk's w, [8 taps][16 c][N] floats, by one TMA copy each. A thread owns
// rows tid + THREADS q (q < RT) of the box and all N columns, their
// accumulators in registers across the chunks (rows past the box compute on
// voxel 0); after the box's last chunk the rows inside the grid are stored
// from registers.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_chunked_fwd_f32_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                               float* __restrict__ y, const Geom g) {
  constexpr int N = 8 * NT;
  constexpr int NV = N / 4;  // float4 a row of w or y
  constexpr int RT = MAX_ROWS / THREADS;
  constexpr int S = 2;  // stages of the ring (make_geom's g.stages)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = round_up(raw, ALIGN);
  uint8_t* const base_p = smem_raw + (base - raw);
  const uint32_t stage = g.stage_x + g.stage_w;
  int* const vrow = reinterpret_cast<int*>(base_p + S * stage);
  int* const loc = vrow + g.rows16;
  const uint32_t bar = base + S * stage + 8 * g.rows16;
  const int tid = threadIdx.x;
  const int grid = gridDim.x, n_boxes = (g.boxes - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int n_steps = n_boxes * g.chunks;

  const CUtensorMap *mx = &map_x, *mwt = &map_w;
  auto issue = [&](int s, int t) {  // thread 0: step t's halo box of its chunk and the chunk's w into stage s
    int w0, h0, d0, b;
    box_origin(g, blockIdx.x + t / g.chunks * grid, w0, h0, d0, b);
    const int c0 = g.C * (t % g.chunks);
    const uint32_t full = bar + 8 * s, dst = base + s * stage;
    wg::mbar_arrive_expect_tx(full, g.halo_bytes + g.stage_w);
    wg::tma_load_5d(dst, mx, full, c0, w0, h0, d0, b);
    tma_load_3d(dst + g.stage_x, mwt, full, 0, c0, 0);
  };

  init_barriers(bar, S);
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && s < n_steps; ++s) issue(s, s);
  fill_rows(g, vrow, loc);
  __syncthreads();

  const uint32_t mask = g.row / 16 - 1;
  uint32_t vr[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int r = tid + THREADS * q;
    vr[q] = r < g.rows ? vrow[r] : 0;
  }
  float acc[RT][N];
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % S, chunk = i % g.chunks;
    if (chunk == 0)
#pragma unroll
      for (int q = 0; q < RT; ++q)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[q][n] = 0.f;
    wg::mbar_wait(bar + 8 * s, (i / S) & 1);
    const uint8_t* const xs = base_p + s * stage;
    const float4* const ws = reinterpret_cast<const float4*>(xs + g.stage_x);  // rows (t, c) of the chunk's w
    for (int t = 0; t < (PROBE & 2 ? 0 : 8); ++t)
      f32_tap_products(acc, xs, vr, tap_offset(g, t), mask, ws + t * g.C * NV, g.C);
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + S < n_steps) issue(s, i + S);
    // the probe without the store: g.D > 0 always holds, but the compiler cannot know it and keeps the products
    if (chunk != g.chunks - 1 || (PROBE & 1 && g.D > 0)) continue;
    // the box's last chunk: its rows inside the grid (a ragged last box stores fewer), N / 4 float4 a row
    int w0, h0, d0, b;
    box_origin(g, blockIdx.x + i / g.chunks * grid, w0, h0, d0, b);
    const int lim_w = g.W - w0, lim_h = g.H - h0, lim_d = g.D - d0;
    const long long row0 = ((static_cast<long long>(b) * g.D + d0) * g.H + h0) * g.W + w0;
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int r = tid + THREADS * q;
      if (r >= g.rows) continue;
      const int l = loc[r];
      const int rw = l & 1023, rh = (l >> 10) & 1023, rd = l >> 20;
      if (rw >= lim_w || rh >= lim_h || rd >= lim_d) continue;
      float4* out = reinterpret_cast<float4*>(y + (row0 + (static_cast<long long>(rd) * g.H + rh) * g.W + rw) * N);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        out[j] = make_float4(acc[q][4 * j], acc[q][4 * j + 1], acc[q][4 * j + 2], acc[q][4 * j + 3]);
    }
  }
}

// dw partial: part[z] [8C, N] (N = 8 NT) over the boxes [z * per_split,
// min(boxes, (z + 1) * per_split)) of block z. dw's accumulators are units of
// one m16 tile of its rows (tap, c) by NW n8 tiles: all NT of them for N <= 32,
// half of them (4) for N = 64. The units are dealt to the warps, `mw` a warp
// (1, 2 or 4; the unit u is m-tile u % (8C/16) of the column half u /
// (8C/16)); where there are fewer than 8 (C = 8, N <= 32: 4), the other warps
// only take part in the barriers. Where the walk takes C in chunks
// (g.chunks > 1), block (z, k) reduces chunk k (C = 64 of g.c_total channels)
// over split z's run and writes the chunk's rows of part[z] [8 c_total, N].
// S copies a block: 2, or 3 where the plan of a chunked dw finds room
// (g.stages, which picks the instance).
//
// N = 64 (NT = 8), the dw-only route of a narrow input and a wide output:
// the s2d(2) stem's 8 -> 64 at 32^3 (kernels/conv_k2.py::narrow_dw_plan). It
// replaces there the FFMA dw (0.18 ms at B=8 against cuDNN's 0.08), which
// computed a 64-deep contraction with 128-row tiles of (tap, c) for 64 rows.
// What bounds it: bytes, g's 33.5 MB of the 37.7 at B=8 for 2.1 GFLOP (~57
// operations a byte). The box keeps two stages of g's 128-byte rows under
// the 128-byte swizzle in shared memory (16 x 8 x 4 voxels at 32^3: 2 x 76
// KB); the 4 m-tiles x 8 n8 tiles (8C x N = 4096 accumulators, 16 a lane) are
// 8 units, one a warp, so every warp computes; a k-step is one ldmatrix of x
// and 4 of g for 4 products.
template <int NT, int S>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_narrow_dw_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                         float* __restrict__ part, const Geom g, int per_split) {
  constexpr int N = 8 * NT;
  constexpr int NW = NT > 4 ? 4 : NT;  // n8 tiles a unit
  constexpr int MAX_MW = NT > 4 ? 1 : DW_MAX_M_TILES;  // units a warp: N = 64 keeps 8C N <= 4096, one a warp
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = round_up(raw, ALIGN);
  uint8_t* const base_p = smem_raw + (base - raw);
  const uint32_t stage = g.stage_x + g.stage_g;
  int* const vrow = reinterpret_cast<int*>(base_p + S * stage);
  const uint32_t bar = base + S * stage + 4 * g.rows16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = static_cast<int>(blockIdx.x) * per_split;
  const int n_boxes = min(per_split, g.boxes - first);
  const int c0 = static_cast<int>(blockIdx.y) * g.C;  // the chunk's first channel of x: 0 unchunked

  const CUtensorMap *mx = &map_x, *mg = &map_g;
  auto issue = [&](int s, int box) {  // thread 0: the halo box of x (the chunk's channels) and the box of g
    int w0, h0, d0, b;
    box_origin(g, box, w0, h0, d0, b);
    const uint32_t full = bar + 8 * s, dst = base + s * stage;
    wg::mbar_arrive_expect_tx(full, g.halo_bytes + g.g_bytes);
    wg::tma_load_5d(dst, mx, full, c0, w0, h0, d0, b);
    wg::tma_load_5d(dst + g.stage_x, mg, full, 0, w0, h0, d0, b);
  };

  init_barriers(bar, S);
  // g's rows from `rows` to `rows16` stay zero: the copies never write them
  for (int s = 0; s < S; ++s)
    for (int i = g.rows * 2 * N / 16 + tid; i < g.rows16 * 2 * N / 16; i += THREADS)
      reinterpret_cast<uint4*>(base_p + s * stage + g.stage_x)[i] = make_uint4(0, 0, 0, 0);
  fill_rows(g, vrow, nullptr);
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && s < n_boxes; ++s) issue(s, first + s);

  const int mtiles = g.C / 2;  // 8C / 16
  const int units = mtiles * (NT / NW);
  const int wpg = min(WARPS, units), mw = units / wpg;  // warps that compute, units each
  const int col0 = 8 * NW * (warp / mtiles);  // the first column of this warp's units: one half of N a warp
  const uint32_t xmask = g.row / 16 - 1, gmask = 2 * N / 16 - 1;
  const int log_c = __ffs(g.C) - 1;
  // A (x, transposed): lane l gives row m = 16 ks + (l % 8) + 8 (l / 16) of the k-step, the 8 channels
  // of half (l / 8) % 2 of its m-tile's 16 rows (tap, c), one tap each
  uint32_t aoff[MAX_MW];
#pragma unroll
  for (int m = 0; m < MAX_MW; ++m) {
    const int tc = 16 * ((warp + wpg * m) % mtiles) + 8 * ((lane >> 3) & 1);
    aoff[m] = m < mw ? tap_offset(g, tc >> log_c) + 2 * (tc & (g.C - 1)) : 0;
  }
  const int a_row = (lane & 7) + 8 * (lane >> 4);
  const int b_row = lane & 15;  // B (g, transposed): rows 16 ks + l % 16 of the k-step
  float acc[MAX_MW][NW][4];
#pragma unroll
  for (int m = 0; m < MAX_MW; ++m)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int i = 0; i < n_boxes; ++i) {
    const int s = i % S;
    wg::mbar_wait(bar + 8 * s, (i / S) & 1);
    const uint32_t xs = base + s * stage, gs = xs + g.stage_x;
    const bool probe = g.chunks > 1;  // a probe build leaves a part out of the walk in chunks only
    const int ksteps = PROBE == 3 && probe ? 0 : g.rows16 / 16;
    for (int ks = 0; warp < wpg && ks < ksteps; ++ks) {
      // every ldmatrix of the k-step first, then its products: the loads' latencies overlap
      const uint32_t va = vrow[16 * ks + a_row];
      uint32_t bf[NW][2], a[MAX_MW][4];
#pragma unroll
      for (int j = 0; j < NW; ++j)
        ldsm_x2_trans(gs + swizzle(static_cast<uint32_t>((16 * ks + b_row) * 2 * N + 2 * col0 + 16 * j), gmask),
                      bf[j]);
#pragma unroll
      for (int m = 0; m < MAX_MW; ++m)
        if (m < mw) ldsm_x4_trans(xs + swizzle(va + aoff[m], xmask), a[m]);
#pragma unroll
      for (int m = 0; m < MAX_MW; ++m) {
        if (m >= mw) continue;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          if (PROBE == 1 && probe) {  // the probe: the tensor cores' own accumulation
            mma(acc[m][j], a[m], bf[j][0], bf[j][1], acc[m][j]);
            continue;
          }
          float d[4];
          mma(d, a[m], bf[j][0], bf[j][1], zero);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] += d[q];
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + S < n_boxes) issue(s, first + i + S);
  }

  if (warp >= wpg) return;
  // the split's [8C, N] partial (C = g.c_total); the chunk's rows (t, c) are rows t C + c0 + c of it
  float* out = part + static_cast<long long>(blockIdx.x) * 8 * g.c_total * N;
  auto out_row = [&](int r) { return (r >> log_c) * g.c_total + c0 + (r & (g.C - 1)); };
#pragma unroll
  for (int m = 0; m < MAX_MW; ++m) {
    if (m >= mw) break;
    const int row = 16 * ((warp + wpg * m) % mtiles) + (lane >> 2);
    const int lo = out_row(row), hi = out_row(row + 8);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int n = col0 + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + lo * N + n) = make_float2(acc[m][j][0], acc[m][j][1]);
      *reinterpret_cast<float2*>(out + hi * N + n) = make_float2(acc[m][j][2], acc[m][j][3]);
    }
  }
}

// dw in float32: part[z] [8C, N] (N = 8 NT) over the run of boxes of block z,
// as the bf16 dw walks it, each product an FFMA. Thread tid is tile tid % tiles
// of group tid / tiles; tile (t, cg, og) = (tap, 8 channels 8 cg.., 8 outputs
// 8 og..), numbered og fastest. Group q reduces rows q, q + groups, ... of each
// box (rows past the grid are zeros in both boxes), one row ahead in registers.
// The walk holds g.stages boxes a block (the plan's: three).
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_narrow_dw_f32_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                             float* __restrict__ part, const Geom g, int per_split) {
  constexpr int N = 8 * NT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = round_up(raw, ALIGN);
  uint8_t* const base_p = smem_raw + (base - raw);
  const int S = g.stages;
  const uint32_t stage = g.stage_x + g.stage_g;
  int* const vrow = reinterpret_cast<int*>(base_p + S * stage);
  const uint32_t bar = base + S * stage + 4 * g.rows16;
  float* const sums = reinterpret_cast<float*>(base_p + S * stage + 4 * g.rows16 + round_up(8 * S, 16));  // [8C, N]
  const int tid = threadIdx.x;
  const int first = static_cast<int>(blockIdx.x) * per_split;
  const int n_boxes = min(per_split, g.boxes - first);

  const CUtensorMap *mx = &map_x, *mg = &map_g;
  auto issue = [&](int s, int box) {  // thread 0: the halo box of x and the box of g into stage s
    int w0, h0, d0, b;
    box_origin(g, box, w0, h0, d0, b);
    const uint32_t full = bar + 8 * s, dst = base + s * stage;
    wg::mbar_arrive_expect_tx(full, g.halo_bytes + g.g_bytes);
    wg::tma_load_5d(dst, mx, full, 0, w0, h0, d0, b);
    wg::tma_load_5d(dst + g.stage_x, mg, full, 0, w0, h0, d0, b);
  };

  init_barriers(bar, S);
  fill_rows(g, vrow, nullptr);
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && s < n_boxes; ++s) issue(s, first + s);

  const int groups_c = g.C / 8, tiles = g.C * NT, groups = THREADS / tiles;  // tiles: 8 taps x C/8 x N/8
  const int grp = tid / tiles, tile = tid % tiles;
  const int og = tile % NT, cg = tile / NT % groups_c, t = tile / NT / groups_c;
  const uint32_t xoff = tap_offset(g, t) + 32 * cg, goff = 32 * og;  // bytes of this tile's 8 channels, 8 outputs
  const uint32_t xmask = g.row / 16 - 1, gmask = 4 * N / 16 - 1;
  float acc[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  for (int i = 0; i < n_boxes; ++i) {
    const int s = i % S;
    wg::mbar_wait(bar + 8 * s, (i / S) & 1);
    const uint8_t* const xs = base_p + s * stage;
    const uint8_t* const gs = xs + g.stage_x;
    // row r's operands: its tap's halo voxel, 8 channels; its g row, 8 outputs (the same for the whole group).
    // Both offsets are 32-byte aligned, so the second piece's swizzle is the first's with bit 4 flipped
    auto load = [&](int r, float4 (&a)[2], float4 (&b)[2]) {
      const uint32_t xo = swizzle(vrow[r] + xoff, xmask);
      const uint32_t go = swizzle(static_cast<uint32_t>(r) * 4 * N + goff, gmask);
      a[0] = *reinterpret_cast<const float4*>(xs + xo);
      a[1] = *reinterpret_cast<const float4*>(xs + (xo ^ 16));
      b[0] = *reinterpret_cast<const float4*>(gs + go);
      b[1] = *reinterpret_cast<const float4*>(gs + (go ^ 16));
    };
    const int rows = PROBE == 3 ? 0 : g.rows;
    float4 a[2], b[2];
    if (grp < rows) load(grp, a, b);
    for (int r = grp; r < rows; r += groups) {
      float4 an[2] = {a[0], a[1]}, bn[2] = {b[0], b[1]};
      if (PROBE != 1) load(r + groups < rows ? r + groups : r, an, bn);  // the next row's, under this one's products
      const float av[8] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w};
      const float bv[8] = {b[0].x, b[0].y, b[0].z, b[0].w, b[1].x, b[1].y, b[1].z, b[1].w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (PROBE != 2 || j == k) acc[k][j] = fmaf(av[k], bv[j], acc[k][j]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[q] = an[q];
        b[q] = bn[q];
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + S < n_boxes) issue(s, first + i + S);
  }

  // the groups' tiles into sums, group 0 first, then 1, ...: the same order every run
  for (int q = 0; q < groups; ++q) {
    if (grp == q)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* row = sums + (t * g.C + 8 * cg + k) * N + 8 * og;
#pragma unroll
        for (int j = 0; j < 8; ++j) row[j] = q == 0 ? acc[k][j] : row[j] + acc[k][j];
      }
    __syncthreads();
  }
  float4* out = reinterpret_cast<float4*>(part + static_cast<long long>(blockIdx.x) * 8 * g.C * N);
  for (int i = tid; i < 2 * g.C * N; i += THREADS) out[i] = reinterpret_cast<const float4*>(sums)[i];
}

// ---- host side ----

// The box of a launch, checked: C a power of two from 8 to 64 whose rows of
// `esize` C bytes (esize 2: bfloat16, 4: float32) are 16 to 128 bytes (one TMA
// box of all C channels), N = 8, 16 or 32 (the bfloat16 dw also N = 64 where
// 8C N <= 4096, so C = 8: g's rows of 128 bytes), extents within the grid and
// MAX_EXTENT, at most MAX_ROWS rows; `dw` adds the stage of g (rows of esize N
// bytes). The plan's choices are checked, not made here: `stages` copies a
// block holds (2; the float32 dw may take 3) and `chunk_d`, the d-planes of
// the float32 forward's output chunk of THREADS rows where it stores through
// shared memory (0: from registers; else the box has no tap split and is
// whole chunks of whole d-planes). A bfloat16 C that is a multiple of 64
// above 64 is walked in chunks of 64 (g.chunks = C / 64, N = 8, 16 or 32; the
// forward two stages, dw 2 or 3): the box holds a chunk's channels, and the
// forward's box at most 16 WARPS chunked_mw(NT) rows (its accumulators stay
// in registers across the chunks). A float32 C that is a multiple of 32 above
// 32 is walked by the forward alone in chunks of 16 (g.chunks = C / 16,
// 64-byte rows; no tap split, rows stored from registers).
// Returns false where the kernels do not apply.
inline bool make_geom(Geom& g, int B, int D, int H, int W, int C, int N, int bw, int bh, int bd, bool dw,
                      int esize, int stages, int chunk_d) {
  const int chunks = esize == 2 && C > 64 && C % 64 == 0   ? C / 64
                     : esize == 4 && C > 32 && C % 32 == 0 ? C / 16
                                                           : 1;
  const int c_total = C;
  C /= chunks;
  const bool wide_dw = dw && esize == 2 && N == 64 && 8 * C * N <= DW_WIDE_ACCUMULATORS;
  const bool narrow_n = N == 8 || N == 16 || N == 32;
  if ((C != 8 && C != 16 && C != 32 && C != 64) || (esize != 2 && esize != 4) || esize * C > 128 ||
      (!narrow_n && !wide_dw) || B < 1 ||
      (stages != 2 && !(dw && stages == 3 && (esize == 4 || chunks > 1))))
    return false;
  if (bw < 1 || bh < 1 || bd < 1 || bw > W || bh > H || bd > D || bw > MAX_EXTENT || bh > MAX_EXTENT ||
      bd > MAX_EXTENT || bw * bh * bd > MAX_ROWS)
    return false;
  if (chunks > 1 && (!narrow_n || chunk_d != 0 || (dw && esize == 4) ||
                     (!dw && esize == 2 && round_up(bw * bh * bd, 16) > 16u * WARPS * chunked_mw(N / 8))))
    return false;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.c_total = c_total;
  g.chunks = chunks;
  g.row = esize * C;
  g.bw = bw; g.bh = bh; g.bd = bd;
  g.nw = (W + bw - 1) / bw; g.nh = (H + bh - 1) / bh; g.nd = (D + bd - 1) / bd;
  const long long boxes = static_cast<long long>(B) * g.nd * g.nh * g.nw;
  if (boxes >= (1LL << 31)) return false;
  g.boxes = static_cast<int>(boxes);
  g.rows = bw * bh * bd;
  g.rows16 = static_cast<int>(round_up(g.rows, 16));
  g.halo_bytes = static_cast<uint32_t>((bw + 1) * (bh + 1) * (bd + 1) * g.row);
  g.g_bytes = dw ? static_cast<uint32_t>(g.rows * esize * N) : 0;
  g.stage_x = round_up(g.halo_bytes, ALIGN);
  g.stage_g = dw ? round_up(g.rows16 * esize * N, ALIGN) : 0;
  g.stage_w = !dw && chunks > 1 ? 8 * C * N * esize : 0;
  g.split = !dw && esize == 4 && chunks == 1 && g.rows <= 2 * THREADS ? 2 : 1;
  g.sums = esize != 4 ? 0 : dw ? 32 * C * N : g.split > 1 ? 4 * g.rows * N : 0;
  if (chunk_d != 0 && (dw || esize != 4 || g.split != 1 || chunk_d * bw * bh != THREADS || g.rows % THREADS != 0))
    return false;
  g.stage_y = chunk_d ? round_up(THREADS * 4 * N, ALIGN) : 0;
  g.chunk_d = chunk_d;
  g.stages = stages;
  return true;
}

// A tensor [B, D, H, W, ch] of bfloat16 (esize 2) or float32 (esize 4) as the
// TMA sees it, (ch, W, H, D, B) innermost first, in boxes of (box_ch, bw, bh,
// bd, 1) (box_ch: all ch, or a chunk's 64 of them): rows of esize box_ch bytes
// (16 to 128) under the swizzle of that width, zeros where a box leaves the
// tensor.
inline int encode_box_map(CUtensorMap* map, const void* p, int B, int D, int H, int W, int ch, int bw, int bh,
                          int bd, int esize, int box_ch = 0) {
  if (box_ch == 0) box_ch = ch;
  wg::EncodeTiledFn encode = wg::encode_tiled_fn();
  if (!encode) return wg::NO_ENCODER;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(ch), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[4];
  cuuint64_t stride = static_cast<cuuint64_t>(esize);
  for (int i = 0; i < 4; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(box_ch), static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh), static_cast<cuuint32_t>(bd), 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const int row = esize * box_ch;
  const CUtensorMapSwizzle swizzle = row == 16   ? CU_TENSOR_MAP_SWIZZLE_NONE
                                     : row == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapDataType type = esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult res = encode(map, type, 5, const_cast<void*>(p), dims, strides, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : wg::ENCODE_FAILED + static_cast<int>(res);
}

// w [8, C, N] bfloat16 (C a multiple of 64) as the TMA sees it: each tap's C N
// elements as rows of 64 (128 bytes), in boxes of a chunk's 8 x N rows (its
// [8 taps][64 c][N]) under the 128-byte swizzle.
inline int encode_chunk_w_map(CUtensorMap* map, const void* w, int C, int N) {
  wg::EncodeTiledFn encode = wg::encode_tiled_fn();
  if (!encode) return wg::NO_ENCODER;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(C) * N / 64, 8};
  const cuuint64_t strides[2] = {128, 2ull * N * C};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(N), 8}, ones[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : wg::ENCODE_FAILED + static_cast<int>(res);
}

template <int NT, bool DX>
int launch_fwd_nt(const CUtensorMap& map_x, const void* w, void* y, const Geom& g, int grid, size_t smem,
                  cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv_k2_narrow_fwd_kernel<NT, DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_k2_narrow_fwd_kernel<NT, DX><<<static_cast<unsigned>(grid), THREADS, smem, s>>>(
      map_x, static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool DX>
int launch_fwd_f32_nt(const CUtensorMap& map_x, const CUtensorMap& map_y, const void* w, void* y, const Geom& g,
                      int grid, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv_k2_narrow_fwd_f32_kernel<NT, DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_k2_narrow_fwd_f32_kernel<NT, DX><<<static_cast<unsigned>(grid), THREADS, smem, s>>>(
      map_x, map_y, static_cast<const float*>(w), static_cast<float*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <bool DX>
int launch_fwd_bf16(const CUtensorMap& map_x, const void* w, void* y, const Geom& g, int N, int grid, size_t smem,
                    cudaStream_t s) {
  if (N == 8) return launch_fwd_nt<1, DX>(map_x, w, y, g, grid, smem, s);
  if (N == 16) return launch_fwd_nt<2, DX>(map_x, w, y, g, grid, smem, s);
  return launch_fwd_nt<4, DX>(map_x, w, y, g, grid, smem, s);
}

// The float32 forward; y's tensor map, in chunks of the box, where the kernel stores through shared memory.
template <bool DX>
int launch_fwd_f32(const CUtensorMap& map_x, const void* w, void* y, int B, const Geom& g, int N, int grid,
                   size_t smem, cudaStream_t s) {
  CUtensorMap map_y = map_x;  // unused without chunk buffers
  if (g.stage_y) {
    const int rc = encode_box_map(&map_y, y, B, g.D, g.H, g.W, N, g.bw, g.bh, g.chunk_d, 4);
    if (rc) return rc;
  }
  if (N == 8) return launch_fwd_f32_nt<1, DX>(map_x, map_y, w, y, g, grid, smem, s);
  if (N == 16) return launch_fwd_f32_nt<2, DX>(map_x, map_y, w, y, g, grid, smem, s);
  return launch_fwd_f32_nt<4, DX>(map_x, map_y, w, y, g, grid, smem, s);
}

// The forward of bfloat16 (dtype 1) or float32 (dtype 0) operands at the box
// (bw, bh, bd) with `grid` blocks, or with `dx` dx: x := g, C := g's channels,
// N := dx's, w := w' [8C, N]. `chunk_d` as make_geom takes it; `plan_smem` is
// the wrapper's dynamic shared memory, held to this file's own.
inline int launch_fwd(const void* x, const void* w, void* y, int B, int D, int H, int W, int C, int N, int bw, int bh,
                      int bd, int grid, int plan_smem, int chunk_d, int dtype, bool dx, cudaStream_t s) {
  const int esize = dtype == 0 ? 4 : 2;
  Geom g;
  if ((dtype != 0 && dtype != 1) || !make_geom(g, B, D, H, W, C, N, bw, bh, bd, false, esize, 2, chunk_d) ||
      g.chunks > 1 || grid < 1 || grid > g.boxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(g, N, false);
  if (static_cast<size_t>(plan_smem) != smem) return wg::PLAN_MISMATCH;
  CUtensorMap map_x;
  const int rc = encode_box_map(&map_x, x, B, D, H, W, C, bw + 1, bh + 1, bd + 1, esize);
  if (rc) return rc;
  if (dtype == 0)
    return dx ? launch_fwd_f32<true>(map_x, w, y, B, g, N, grid, smem, s)
              : launch_fwd_f32<false>(map_x, w, y, B, g, N, grid, smem, s);
  return dx ? launch_fwd_bf16<true>(map_x, w, y, g, N, grid, smem, s)
            : launch_fwd_bf16<false>(map_x, w, y, g, N, grid, smem, s);
}

// w [8, C, N] float32 as the TMA sees it, (n, c, tap) innermost first, in
// boxes of a chunk's [8 taps][chunk c][N] (rows of 4N bytes, no swizzle: the
// kernel reads them as broadcasts).
inline int encode_chunk_w_f32_map(CUtensorMap* map, const void* w, int C, int N, int chunk) {
  wg::EncodeTiledFn encode = wg::encode_tiled_fn();
  if (!encode) return wg::NO_ENCODER;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(C), 8};
  const cuuint64_t strides[2] = {4ull * N, 4ull * N * C};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(N), static_cast<cuuint32_t>(chunk), 8}, ones[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), dims, strides, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : wg::ENCODE_FAILED + static_cast<int>(res);
}

template <typename T, typename Kernel>
int launch_chunked_fwd_kernel(Kernel kernel, const CUtensorMap& map_x, const CUtensorMap& map_w, void* y,
                              const Geom& g, int grid, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(map_x, map_w, static_cast<T*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_chunked_fwd_nt(const CUtensorMap& map_x, const CUtensorMap& map_w, void* y, const Geom& g, int esize,
                          int grid, size_t smem, cudaStream_t s) {
  if (esize == 4)
    return launch_chunked_fwd_kernel<float>(conv_k2_chunked_fwd_f32_kernel<NT>, map_x, map_w, y, g, grid, smem, s);
  return launch_chunked_fwd_kernel<__nv_bfloat16>(conv_k2_chunked_fwd_kernel<NT>, map_x, map_w, y, g, grid, smem, s);
}

// The chunked forward (N = 8, 16, 32) of bfloat16 (dtype 1: C a multiple of 64
// above 64, chunks of 64) or float32 (dtype 0: C a multiple of 32 above 32,
// chunks of 16) at the box (bw, bh, bd) with `grid` blocks and two stages, w
// [2,2,2,C,N] as it lies; `plan_smem` is the wrapper's dynamic shared memory,
// held to this file's own.
inline int launch_chunked_fwd(const void* x, const void* w, void* y, int B, int D, int H, int W, int C, int N,
                              int bw, int bh, int bd, int grid, int plan_smem, int dtype, cudaStream_t s) {
  const int esize = dtype == 0 ? 4 : 2;
  Geom g;
  if ((dtype != 0 && dtype != 1) || !make_geom(g, B, D, H, W, C, N, bw, bh, bd, false, esize, 2, 0) ||
      g.chunks < 2 || grid < 1 || grid > g.boxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(g, N, false);
  if (static_cast<size_t>(plan_smem) != smem) return wg::PLAN_MISMATCH;
  CUtensorMap map_x, map_w;
  int rc = encode_box_map(&map_x, x, B, D, H, W, C, bw + 1, bh + 1, bd + 1, esize, g.C);
  if (rc) return rc;
  rc = esize == 4 ? encode_chunk_w_f32_map(&map_w, w, C, N, g.C) : encode_chunk_w_map(&map_w, w, C, N);
  if (rc) return rc;
  if (N == 8) return launch_chunked_fwd_nt<1>(map_x, map_w, y, g, esize, grid, smem, s);
  if (N == 16) return launch_chunked_fwd_nt<2>(map_x, map_w, y, g, esize, grid, smem, s);
  return launch_chunked_fwd_nt<4>(map_x, map_w, y, g, esize, grid, smem, s);
}

template <typename Kernel>
int launch_dw_kernel(Kernel kernel, const CUtensorMap& map_x, const CUtensorMap& map_g, float* part, const Geom& g,
                     int splits, int per_split, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(g.chunks));
  kernel<<<grid, THREADS, smem, s>>>(map_x, map_g, part, g, per_split);
  return static_cast<int>(cudaGetLastError());
}

// Only the instance of the dtype: the bfloat16 dw has an N = 64 one, the float32 dw none.
template <int NT, bool F32>
int launch_dw_nt(const CUtensorMap& map_x, const CUtensorMap& map_g, float* part, const Geom& g, int splits,
                 int per_split, size_t smem, cudaStream_t s) {
  if constexpr (F32) {
    return launch_dw_kernel(conv_k2_narrow_dw_f32_kernel<NT>, map_x, map_g, part, g, splits, per_split, smem, s);
  } else {
    if constexpr (NT <= 4) {  // make_geom lets three stages through for a chunked dw only: N <= 32
      if (g.stages == 3)
        return launch_dw_kernel(conv_k2_narrow_dw_kernel<NT, 3>, map_x, map_g, part, g, splits, per_split, smem, s);
    }
    return launch_dw_kernel(conv_k2_narrow_dw_kernel<NT, 2>, map_x, map_g, part, g, splits, per_split, smem, s);
  }
}

template <bool F32>
int launch_dw_n(const CUtensorMap& map_x, const CUtensorMap& map_g, float* part, const Geom& g, int N, int splits,
                int per_split, size_t smem, cudaStream_t s) {
  if constexpr (!F32) {  // make_geom lets N = 64 through for the bfloat16 dw only
    if (N == 64) return launch_dw_nt<8, false>(map_x, map_g, part, g, splits, per_split, smem, s);
  }
  if (N == 8) return launch_dw_nt<1, F32>(map_x, map_g, part, g, splits, per_split, smem, s);
  if (N == 16) return launch_dw_nt<2, F32>(map_x, map_g, part, g, splits, per_split, smem, s);
  return launch_dw_nt<4, F32>(map_x, map_g, part, g, splits, per_split, smem, s);
}

// dw's partial sums of bfloat16 (dtype 1) or float32 (dtype 0) operands, one
// [8C, N] a split, into `part`: the splits are runs of `per_split` boxes (the
// last may be shorter, none is empty), walked through `stages` copies; a
// bfloat16 C that is a multiple of 64 above 64 by blocks (split, chunk).
inline int launch_dw(const void* x, const void* gr, float* part, int splits, int per_split, int B, int D, int H, int W,
                     int C, int N, int bw, int bh, int bd, int plan_smem, int stages, int dtype, cudaStream_t s) {
  const int esize = dtype == 0 ? 4 : 2;
  Geom g;
  if ((dtype != 0 && dtype != 1) || !make_geom(g, B, D, H, W, C, N, bw, bh, bd, true, esize, stages, 0) ||
      splits < 1 || per_split < 1 || static_cast<long long>(splits - 1) * per_split >= g.boxes ||
      static_cast<long long>(splits) * per_split < g.boxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(g, N, true);
  if (static_cast<size_t>(plan_smem) != smem) return wg::PLAN_MISMATCH;
  CUtensorMap map_x, map_g;
  int rc = encode_box_map(&map_x, x, B, D, H, W, C, bw + 1, bh + 1, bd + 1, esize, g.C);
  if (rc) return rc;
  rc = encode_box_map(&map_g, gr, B, D, H, W, N, bw, bh, bd, esize);
  if (rc) return rc;
  return dtype == 0 ? launch_dw_n<true>(map_x, map_g, part, g, N, splits, per_split, smem, s)
                    : launch_dw_n<false>(map_x, map_g, part, g, N, splits, per_split, smem, s);
}

}  // namespace nr
