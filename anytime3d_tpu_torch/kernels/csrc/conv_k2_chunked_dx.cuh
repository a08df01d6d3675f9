// conv_k2's products of a narrow operand (8, 16 or 32 channels) and a wide
// result (a multiple of 64 channels), bfloat16, on Hopper's tensor cores, in
// two instances. Included by conv_k2.cu, which states what the operation
// computes; the barrier, TMA and wgmma helpers are conv_k2_wgmma.cuh's, the
// halo-box helpers conv_k2_narrow.cuh's.
//
// - dx (FWD = false): dx of a narrow g and a wide dx, the tensor-parallel
//   shards 512 -> 32, -> 16 and -> 8 (the flagship's last 16^3 stage over a
//   model axis of 2, 4 and 8). Replaces, for shapes with a plan
//   (kernels/conv_k2.py::chunked_dx_plan), the dx product of the TPU kernel's
//   backward anytime3d_tpu/kernels/conv_k2.py::_conv_k2_bwd_impl (:172-180):
//   dx[p, c] = sum_s sum_n g[p - 1 + s, n] w'[s, n, c], w'[s] = w[7 - s]^T,
//   the forward from N to C channels over g read one voxel lower.
// - the forward (FWD = true) of a narrow x and a wide y: the classic
//   encoder's space-to-depth(2) stem, 8 -> 64 at 32^3. Replaces, for shapes
//   with a plan (kernels/conv_k2.py::wide_plan), the TPU kernel
//   anytime3d_tpu/kernels/conv_k2.py::_conv_k2_pallas (:129-169): y[p, n] =
//   sum_t sum_c x[p + t, c] w[t, c, n], x read as zeros past the grid.
//
// The two differ in where a box's halo starts (one voxel lower for dx, at the
// box for the forward, whose halo grows on the high side) and in the tap that
// A's rows pair with B's (mirrored for dx, the same for the forward). Below,
// "g" is the narrow operand (g, or x), N its channels, "dx" the wide result
// (dx, or y) and C its channels, as for dx.
//
// What bounds it on this card: bytes, nearly as much as operations. At B=32 on
// 16^3, 32 -> 512 stores 134.2 MB of dx for 8.4 MB of g and 31.2 GFLOP of
// on-grid products: 0.0401 ms of store at 3.35 TB/s, 0.0316 ms of products at
// 989 TFLOP/s. The stem's forward at B=32 stores 134.2 MB of y for 16.8 MB of
// x and 8.2 GFLOP: store-bound, 0.0451 ms. The FFMA GEMMs they replace ran at
// ~32 TFLOP/s (0.98 ms) and at 15% of the bound (0.30 ms). So the products go
// to the tensor cores and the store streams behind them:
//
// - A block owns one column chunk of dx, BN = 128 (or 64) channels, for its
//   whole life: the chunk's rows of w, [8N, BN] (64 KB at N = 32, 8 KB for the
//   stem), are brought in once by the TMA, K-major under the 128-byte swizzle
//   (the wrapper lays w out as [C, 8N], its taps in order, in one copy of <=
//   256 KB), and are the B operand of every product. Blocks b, b + chunks, ...
//   share a chunk and walk its boxes.
// - A box is 128 output voxels (bw x bh x bd; 8 x 4 x 4 at 16^3 and 32^3), one
//   batch item. A TMA copy brings the box's halo of g, grown by one voxel
//   (starting one voxel lower along d, h and w for dx, at the box for the
//   forward), into a ring of stages: rows of 2N bytes under the swizzle of
//   that width, zeros below 0 and past the grid (dx's low-edge mask, the
//   forward's high pad, the ragged edge). g is read from device memory once;
//   the halo overlap and the re-reads by the other chunks' blocks come from
//   L2.
// - Each of two consumer warpgroups takes 64 of the box's rows (a sub-box:
//   8 x 4 x 2 at 16^3). Its warps load the A fragments of their 16 rows for
//   the whole depth, 8 taps x N channels (16 k-steps at N = 32), by ldmatrix
//   from the halo stage: each lane's row address picks its row's voxel shifted
//   by the k-step's tap, as the narrow kernels' row table does; the depth
//   (t, n) of B is w's tap t, so A's is the mirrored tap 7 - t for dx (w'[s] =
//   w[7 - s]^T) and tap t for the forward. The stage goes back to the
//   producer once the products that
//   read those fragments are done: released right after the ldmatrix issue,
//   the next copy overwrote rows whose loads were still in flight (at N = 32,
//   16 of them a warp, most launches at B=32 came out wrong).
// - Products: wgmma.mma_async m64nBNk16 with A from registers and B from
//   shared memory, so the chunk's w is read once a warpgroup, not once a
//   warp; f32 accumulators, rounded once to bf16.
// - The store streams: each warpgroup writes its 64 x BN tile, swizzled, into
//   one of two staging buffers and one thread hands it to the TMA (64-channel
//   boxes of the sub-box, clipped at the grid), which writes whole 128-byte
//   lines while the warpgroup goes on to its next box.
// - One producer warp (a single thread) brings w and keeps the halo ring
//   full; a `full` mbarrier a stage counts the copy's bytes, an `empty` one
//   the 8 consumer warps whose products on it are done.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "conv_k2_narrow.cuh"
#include "conv_k2_wgmma.cuh"

namespace cdx {

constexpr int WARPGROUPS = 2;                       // consumer warpgroups, 64 rows of a box each
constexpr int BOX_ROWS = 64 * WARPGROUPS;           // output voxels of a box
constexpr int THREADS = (4 * WARPGROUPS + 1) * 32;  // + the producer warp
constexpr int MAX_STAGES = 4;                       // halo stages of the ring
constexpr uint32_t BARRIER_BYTES = 128;             // full[MAX_STAGES], empty[MAX_STAGES], the w barrier
constexpr uint32_t SUB_TILE_BYTES = 64 * 128;       // 64 rows x 64 channels bf16: one TMA store box

// Where a launch's shapes meet, worked out on the host and passed by value.
struct Geom {
  int D, H, W, C, N;
  int bw, bh, bd;       // the box of 128 output voxels
  int sw, sh, sd;       // the second warpgroup's sub-box origin in the box (the first's is 0)
  int nw, nh, nd;       // boxes along w, h and d, the last ones ragged
  int boxes;            // B * nd * nh * nw
  int chunks;           // C / BN
  uint32_t halo_bytes;  // (bw + 1)(bh + 1)(bd + 1) * 2N: one TMA copy of g
  uint32_t stage_x;     // halo_bytes rounded up to the swizzle period
  int stages;           // halo stages of the ring, 2 to MAX_STAGES: the plan's
};

// Dynamic shared memory: alignment room, the chunk's w (8N / 64 tiles of BN
// rows x 128 bytes), two staging buffers a warpgroup (64 rows x BN bf16), the
// halo ring, the barriers.
__host__ __device__ constexpr size_t w_bytes(int N, int bn) { return static_cast<size_t>(8 * N / 64) * bn * 128; }

__host__ __device__ inline size_t smem_bytes(const Geom& g, int bn) {
  return wg::SWIZZLE_PERIOD + w_bytes(g.N, bn) + 2 * WARPGROUPS * static_cast<size_t>(bn) * 128 +
         static_cast<size_t>(g.stages) * g.stage_x + BARRIER_BYTES;
}

// CONV_K2_NARROW_PROBE (cli/probe_narrow.py's builds): 1 without the store of
// dx, 2 without the products (no ldmatrix, no wgmma), 3 without both.
constexpr int PROBE = nr::PROBE;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The compiler must not reuse an A fragment's registers between the launch of
// a product and the wait that ends it.
__device__ __forceinline__ void pin_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 128, f32) (+)= a (64 x 16, each warp's 16 rows in registers, the
// mma.sync A fragment) * b (16 x 128) from `desc_b`, K-major. scale_d = 0
// overwrites d. Row lane/4 (+8) of the warp's 16 rows and columns
// 8j + 2(lane%4) + {0, 1} are d[4j + {0, 1}] (+2).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The same with 64 columns (C an odd multiple of 64).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Origin (w, h, d, b) of box `box`: w fastest.
__device__ __forceinline__ void box_origin(const Geom& g, int box, int& w0, int& h0, int& d0, int& b) {
  int t = box;
  w0 = (t % g.nw) * g.bw; t /= g.nw;
  h0 = (t % g.nh) * g.bh; t /= g.nh;
  d0 = (t % g.nd) * g.bd;
  b = t / g.nd;
}

// dx [B, D, H, W, C] (bf16) from g [B, D, H, W, N] (N = 8 NT) and w laid out
// as [C, 8N] (wt[c, t N + n] = w[t, c, n]); with FWD, y [B, D, H, W, C] from
// x [B, D, H, W, N] and w [2, 2, 2, N, C] laid out as [C, 8N] (wt[c, t N + n] =
// w[t, n, c]). Block i owns column chunk i % g.chunks (BN channels) and walks
// the boxes i / chunks, + gridDim.x / chunks, ... (gridDim.x a multiple of
// g.chunks).
template <int NT, int BN, bool FWD>
__global__ void __launch_bounds__(THREADS, 1)
conv_k2_chunked_dx_kernel(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_dx, const Geom g) {
  constexpr int N = 8 * NT;
  constexpr int KSTEPS = 8 * N / 16;    // the depth, 8 taps x N channels, in k-steps of 16
  constexpr int ROW = 2 * N;            // bytes of a voxel of g
  constexpr uint32_t TILE = BN * 128;   // a k-block of w (64 deep) and a warpgroup's staging buffer
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = nr::round_up(wg::smem_u32(smem_raw), wg::SWIZZLE_PERIOD);
  const uint32_t wsm = base, staging = wsm + static_cast<uint32_t>(w_bytes(N, BN));
  const uint32_t ring = staging + 2 * WARPGROUPS * TILE;
  const uint32_t full = ring + g.stages * g.stage_x, empty = full + 8 * MAX_STAGES, wfull = empty + 8 * MAX_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = static_cast<int>(blockIdx.x) % g.chunks, per = static_cast<int>(gridDim.x) / g.chunks;
  const int first = static_cast<int>(blockIdx.x) / g.chunks;
  const int n_boxes = (g.boxes - first + per - 1) / per;

  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);                // the producer's arrive; the TMA completes the bytes
      wg::mbar_init(empty + 8 * s, 4 * WARPGROUPS);  // one lane of every consumer warp
    }
    wg::mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WARPGROUPS) {  // the producer: w once, then the halo ring
    if (lane != 0) return;
    wg::mbar_arrive_expect_tx(wfull, static_cast<uint32_t>(w_bytes(N, BN)));
#pragma unroll
    for (int kb = 0; kb < 8 * N / 64; ++kb) wg::tma_load_2d(wsm + kb * TILE, &map_w, wfull, 64 * kb, chunk * BN);
    int slot = 0;
    uint32_t parity = 1;  // a fresh slot is empty
    for (int i = 0; i < n_boxes; ++i) {
      int w0, h0, d0, b;
      box_origin(g, first + i * per, w0, h0, d0, b);
      wg::mbar_wait(empty + 8 * slot, parity);
      wg::mbar_arrive_expect_tx(full + 8 * slot, g.halo_bytes);
      // dx reads g one voxel lower (below 0 the TMA writes zeros), the forward x from the box (zeros past the grid)
      constexpr int lo = FWD ? 0 : 1;
      wg::tma_load_5d(ring + slot * g.stage_x, &map_g, full + 8 * slot, 0, w0 - lo, h0 - lo, d0 - lo, b);
      if (++slot == g.stages) {
        slot = 0;
        parity ^= 1;
      }
    }
    return;
  }

  const int wgroup = warp >> 2, wtid = tid & 127;
  // this lane's ldmatrix row: row 64 wgroup + 16 (warp % 4) + lane % 16 of the box, its own halo voxel; its
  // channels of a k-step 8 (lane / 16) ..: k-step ks is w's tap (16 ks + 8 (lane / 16)) / N, g's the mirror for
  // dx and the same tap for the forward
  uint32_t vr;
  {
    const int r = 64 * wgroup + 16 * (warp & 3) + (lane & 15);
    const int rw = r % g.bw, rh = r / g.bw % g.bh, rd = r / g.bw / g.bh;
    vr = ((rd * (g.bh + 1) + rh) * (g.bw + 1) + rw) * ROW;
  }
  uint32_t koff[KSTEPS];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k = 16 * ks + 8 * (lane >> 4), t = FWD ? k / N : 7 - k / N;
    koff[ks] = (((t >> 2) * (g.bh + 1) + ((t >> 1) & 1)) * (g.bw + 1) + (t & 1)) * ROW + 2 * (k % N);
  }
  const uint32_t mask = ROW / 16 - 1;
  // the warpgroup's sub-box: the first's at the box's origin, the second's at (sw, sh, sd)
  const int sw = wgroup ? g.sw : 0, sh = wgroup ? g.sh : 0, sd = wgroup ? g.sd : 0;
  const int row0 = 16 * (warp & 3) + (lane >> 2);  // this lane's rows of the D fragment: row0, row0 + 8
  wg::mbar_wait(wfull, 0);

  int slot = 0;
  uint32_t parity = 0;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < n_boxes; ++i) {
    int w0, h0, d0, b;
    box_origin(g, first + i * per, w0, h0, d0, b);
    wg::mbar_wait(full + 8 * slot, parity);
    uint32_t a[KSTEPS][4];
    const uint32_t xs = ring + slot * g.stage_x;
    if (!(PROBE & 2)) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) nr::ldsm_x4(xs + nr::swizzle(vr + koff[ks], mask), a[ks]);
      wg::pin(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)  // k-block ks / 4 of w (64 deep), 32 bytes a k-step along its rows
        wgmma_rs(acc, a[ks], wg::smem_desc(wsm + (ks >> 2) * TILE + (ks & 3) * wg::K16_IN_ROW, 16, wg::SWIZZLE_PERIOD),
                 ks != 0);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::pin(acc);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) pin_a(a[ks]);
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * slot);  // the products have read the fragments: the stage is free
    if (++slot == g.stages) {
      slot = 0;
      parity ^= 1;
    }
    // the probe without the store: g.D > 0 always holds, but the compiler cannot know it and keeps the products
    if (PROBE & 1 && g.D > 0) continue;
    // the tile rounded once to bf16 into staging buffer i % 2 of this warpgroup, BN / 64 boxes of 64 rows x 128
    // bytes under the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)): a warp's 32 lanes write 8 rows
    // x 4 bytes of one unit each, 32 distinct banks
    const uint32_t buf = staging + (2 * wgroup + (i & 1)) * TILE;
    if (wtid == 0) nr::bulk_wait_read<1>();  // the store that last read this buffer has read it
    named_sync(1 + wgroup, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + 8 * half;
        st_shared_b32(buf + (j >> 3) * SUB_TILE_BYTES + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3),
                      wg::pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]));
      }
    nr::fence_proxy_async();
    named_sync(1 + wgroup, 128);
    if (wtid == 0) {  // the TMA clips the sub-box at the grid's edge (a ragged last box)
#pragma unroll
      for (int q = 0; q < BN / 64; ++q)
        asm volatile("cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
                     ::"l"(reinterpret_cast<uint64_t>(&map_dx)), "r"(buf + q * SUB_TILE_BYTES),
                     "r"(chunk * BN + 64 * q), "r"(w0 + sw), "r"(h0 + sh), "r"(d0 + sd), "r"(b)
                     : "memory");
      wg::bulk_commit();
    }
  }
  if (wtid == 0) nr::bulk_wait_all();  // the staging buffers stay until the last store has read them
}

// ---- host side ----

// The geometry of a launch, checked: N = 8, 16 or 32; C a multiple of bn (128,
// or 64), at least 64; a box of 128 voxels, each extent at most 255, whose first
// 64 rows (w fastest) are a sub-box that tiles it (the second warpgroup's at
// the returned origin); 2 to MAX_STAGES halo stages. Returns false where the
// kernel does not apply.
inline bool make_geom(Geom& g, int B, int D, int H, int W, int C, int N, int bw, int bh, int bd, int bn,
                      int stages, int& sbw, int& sbh, int& sbd) {
  if ((N != 8 && N != 16 && N != 32) || (bn != 64 && bn != 128) || C < 64 || C % bn || B < 1 || D < 1 ||
      H < 1 || W < 1 || stages < 2 || stages > MAX_STAGES)
    return false;
  if (bw < 1 || bh < 1 || bd < 1 || bw > nr::MAX_EXTENT || bh > nr::MAX_EXTENT || bd > nr::MAX_EXTENT ||
      bw * bh * bd != BOX_ROWS)
    return false;
  // the first 64 rows: whole w-lines before a second h, whole (h, w) planes before a second d
  sbw = bw < 64 ? bw : 64;
  if (64 % sbw || bw % sbw) return false;
  sbh = 64 / sbw < bh ? 64 / sbw : bh;
  if (sbw != bw && sbh != 1) return false;
  if ((64 / sbw) % sbh || bh % sbh) return false;
  sbd = 64 / (sbw * sbh);
  if ((sbh != bh && sbd != 1) || bd % sbd) return false;
  const int second = 64;  // the second warpgroup's first row
  g.D = D; g.H = H; g.W = W; g.C = C; g.N = N;
  g.bw = bw; g.bh = bh; g.bd = bd;
  g.sw = second % bw; g.sh = second / bw % bh; g.sd = second / bw / bh;
  g.nw = (W + bw - 1) / bw; g.nh = (H + bh - 1) / bh; g.nd = (D + bd - 1) / bd;
  const long long boxes = static_cast<long long>(B) * g.nd * g.nh * g.nw;
  if (boxes >= (1LL << 31)) return false;
  g.boxes = static_cast<int>(boxes);
  g.chunks = C / bn;
  g.halo_bytes = static_cast<uint32_t>((bw + 1) * (bh + 1) * (bd + 1) * 2 * N);
  g.stage_x = nr::round_up(g.halo_bytes, wg::SWIZZLE_PERIOD);
  g.stages = stages;
  return true;
}

template <int NT, int BN, bool FWD>
int launch_nt(const CUtensorMap& map_g, const CUtensorMap& map_w, const CUtensorMap& map_dx, const Geom& g, int grid,
              size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv_k2_chunked_dx_kernel<NT, BN, FWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_k2_chunked_dx_kernel<NT, BN, FWD><<<static_cast<unsigned>(grid), THREADS, smem, s>>>(map_g, map_w, map_dx, g);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool FWD>
int launch_bn(const CUtensorMap& map_g, const CUtensorMap& map_w, const CUtensorMap& map_dx, const Geom& g, int grid,
              size_t smem, cudaStream_t s) {
  if (g.N == 8) return launch_nt<1, BN, FWD>(map_g, map_w, map_dx, g, grid, smem, s);
  if (g.N == 16) return launch_nt<2, BN, FWD>(map_g, map_w, map_dx, g, grid, smem, s);
  return launch_nt<4, BN, FWD>(map_g, map_w, map_dx, g, grid, smem, s);
}

// dx [B,D,H,W,C] from g [B,D,H,W,N] and wt [C, 8N] (w), or with FWD y
// [B,D,H,W,C] from x [B,D,H,W,N] (passed as `gr`) and wt [C, 8N], at the
// plan's box (bw, bh, bd), chunk width bn, halo stages and `grid` blocks (a
// multiple of C / bn); `plan_smem` is the wrapper's dynamic shared memory,
// held to this file's own.
template <bool FWD>
inline int launch(const void* gr, const void* wt, void* dx, int B, int D, int H, int W, int C, int N, int bw, int bh,
                  int bd, int bn, int stages, int grid, int plan_smem, cudaStream_t s) {
  Geom g;
  int sbw, sbh, sbd;
  if (!make_geom(g, B, D, H, W, C, N, bw, bh, bd, bn, stages, sbw, sbh, sbd) || grid < g.chunks ||
      grid % g.chunks || grid / g.chunks > g.boxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(g, bn);
  if (static_cast<size_t>(plan_smem) != smem) return wg::PLAN_MISMATCH;
  CUtensorMap map_g, map_w, map_dx;
  int rc = nr::encode_box_map(&map_g, gr, B, D, H, W, N, bw + 1, bh + 1, bd + 1, 2);
  if (rc) return rc;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(8 * N), static_cast<cuuint64_t>(C)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(bn)};
  rc = wg::encode_map(&map_w, wt, 2, dims, box);
  if (rc) return rc;
  rc = nr::encode_box_map(&map_dx, dx, B, D, H, W, C, sbw, sbh, sbd, 2, 64);
  if (rc) return rc;
  return bn == 128 ? launch_bn<128, FWD>(map_g, map_w, map_dx, g, grid, smem, s)
                   : launch_bn<64, FWD>(map_g, map_w, map_dx, g, grid, smem, s);
}

}  // namespace cdx
