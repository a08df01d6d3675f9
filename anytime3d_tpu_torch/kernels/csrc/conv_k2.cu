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
// [2, 2, 2, N, C] (each tap transposed; the wrapper does that, no flip: the
// mirrored shift already pairs tap t with w[t]).
//
// dw: a GEMM whose reduction axis is M. Its output is [8C, N] (row (tap, c));
// A^T for output row (t, c) at depth m is x[m + shift(t), c], edge-masked as
// in the forward, and B at depth m is row m of g. Both operands are already
// depth-major in memory, so a stage is BK consecutive rows of x and of g and
// lands in shared memory without a transpose. The output has few tiles
// (8C*N / (128*64) = 32 or 64 at the flagship stages) against 132 SMs, and
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
// Two designs live here. The kernels of this file are plain tiled SIMT GEMMs
// (FFMA): a 128x64 output tile per block, 8x4 outputs per thread held in f32
// registers, a 16-deep chunk of A and B staged in shared memory, and the next
// chunk prefetched into registers while the current one is consumed. f32 is
// computed in true f32 (FFMA, no TF32); bf16 is read as bf16, widened to f32
// in shared memory, accumulated in f32 and rounded once on store. They take
// float32 of any shape, dx in both types, and the bfloat16 shapes that have
// no plan. The bfloat16 forward and dw of the shapes that have a plan (C and
// N multiples of 64, rows that tile into boxes: the flagship stages) run on
// the tensor cores: conv_k2_wgmma.cuh holds those kernels (wgmma products,
// operands brought in by TMA box copies into a ring of swizzled shared-memory
// tiles) and says how they are formed. Which design a call takes is settled
// by the Python wrapper from shape and dtype, before the launch. dx on the
// tensor cores (the same box copy at mirrored coordinates) is later work.
//
// Preconditions, checked by the Python wrapper: all tensors contiguous and
// 16-byte aligned; the depth's channel count a multiple of 8 (so every
// 8-wide slice of the depth lies in one tap and loads as one vector) and the
// output's column count a multiple of 4. That is C % 8 and N % 4 for the
// forward and dw, N % 8 and C % 4 for dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "conv_k2_wgmma.cuh"

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // reduction depth per shared-memory stage
constexpr int TM = 8;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

static_assert(THREADS == 256, "loader mapping below assumes 256 threads");
static_assert(BM * BK == THREADS * 8, "each thread loads 8 A values per stage");
static_assert(BK * BN == THREADS * 4, "each thread loads 4 B values per stage");

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

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

// One 8x4 register tile step over a staged chunk: acc += As[kk]^T * Bs[kk].
__device__ __forceinline__ void fma_stage(float (*As)[BM], float (*Bs)[BN], int ty, int tx,
                                          float (*acc)[TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
    const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
    const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
    const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Forward (BWD = false): y = conv(x, w), x [M, C], w [8C, N], y [M, N].
// dx (BWD = true): called with x := g [M, N'], w := w^T [8N', C'], y := dx
// [M, C'], C := N', N := C'; tap t reads row m - shift(t), masked at the low edge.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
conv_k2_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                    int D, int H, int W, int C, int N, long long M) {
  // A is stored transposed (k-major) so a thread reads its TM rows as vectors.
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 8 * C;
  const long long S = static_cast<long long>(D) * H * W;

  // A loader: one output row per thread, 8 consecutive k of the stage.
  // Consecutive threads take consecutive rows, so the transposed store into
  // As hits 32 distinct banks.
  const int a_row = tid % BM;
  const int a_k = (tid / BM) * 8;
  const long long m = m0 + a_row;
  const T* xrow = x;
  unsigned tap_ok = 0;  // bit t set: tap t of this row lies inside the grid
  if (m < M) {
    const long long s = m % S;
    const int d = static_cast<int>(s / (static_cast<long long>(H) * W));
    const int h = static_cast<int>((s / W) % H);
    const int ww = static_cast<int>(s % W);
    xrow = x + m * C;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int dz = t >> 2, dy = (t >> 1) & 1, dx = t & 1;
      const bool ok = BWD ? (d - dz >= 0 && h - dy >= 0 && ww - dx >= 0)
                          : (d + dz < D && h + dy < H && ww + dx < W);
      if (ok) tap_ok |= 1u << t;
    }
  }

  // B loader: one k row of the stage per 16 threads, 4 consecutive columns.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  const bool b_col_ok = n0 + b_n < N;

  float a_reg[8];
  float b_reg[4];

  auto load_stage = [&](int k0) {
    const int k = k0 + a_k;  // multiple of 8, so k .. k+7 share one tap
    const int tap = k / C;
    const int c = k - tap * C;
    if ((tap_ok >> tap) & 1u) {
      const long long shift =
          (static_cast<long long>((tap >> 2) * H + ((tap >> 1) & 1)) * W + (tap & 1)) * C;
      load8(xrow + (BWD ? -shift : shift) + c, a_reg);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) a_reg[i] = 0.f;
    }
    if (b_col_ok) {
      load4(w + static_cast<long long>(k0 + b_k) * N + n0 + b_n, b_reg);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) b_reg[j] = 0.f;
    }
  };

  auto store_stage = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[a_k + i][a_row] = a_reg[i];
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  const int ty = tid / (BN / TN);  // this thread's rows: ty*TM .. ty*TM+TM-1
  const int tx = tid % (BN / TN);  // this thread's columns: tx*TN .. tx*TN+TN-1
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_stage(0);
  store_stage();
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_stage(k0 + BK);  // in flight while this stage computes

    fma_stage(As, Bs, ty, tx, acc);
    __syncthreads();
    if (more) {
      store_stage();
      __syncthreads();
    }
  }

  const int n = n0 + tx * TN;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long mo = m0 + ty * TM + i;
      if (mo < M) store4(y + mo * N + n, acc[i]);
    }
  }
}

// dw partial: part[z][r][n] = sum over rows m of split z of x_t[m, c] * g[m, n],
// r = t*C + c. x [M, C], g [M, N], part [gridDim.z, 8C, N] in f32. Split z
// reduces rows [z*rows_per_split, min(M, (z+1)*rows_per_split)).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_k2_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                  int D, int H, int W, int C, int N, long long M, long long rows_per_split) {
  // Both operands arrive depth-major: a stage is BK rows m, stored as they lie.
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int R = 8 * C;
  const long long m_begin = static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long m_end = (m_begin + rows_per_split < M) ? m_begin + rows_per_split : M;

  // A loader: one row m of the stage per 16 threads, 8 consecutive output
  // rows r (8 channels of one tap, since C % 8 == 0) each.
  const int a_k = tid / (BM / 8);
  const int a_r = (tid % (BM / 8)) * 8;
  const int r = r0 + a_r;
  const bool a_row_ok = r < R;
  const int tap = a_row_ok ? r / C : 0;
  const int c = a_row_ok ? r - tap * C : 0;
  const int dz = tap >> 2, dy = (tap >> 1) & 1, dx = tap & 1;
  const T* xcol = x + (static_cast<long long>(dz * H + dy) * W + dx) * C + c;

  // B loader: the same row m, 4 consecutive columns.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  const bool b_col_ok = n0 + b_n < N;

  // (d, h, w) of this thread's A row, advanced by BK rows a stage with carries
  long long m_a = m_begin + a_k;
  const long long S = static_cast<long long>(D) * H * W;
  const long long s0 = m_a % S;
  int d = static_cast<int>(s0 / (static_cast<long long>(H) * W));
  int h = static_cast<int>((s0 / W) % H);
  int ww = static_cast<int>(s0 % W);

  float a_reg[8];
  float b_reg[4];

  auto load_stage = [&](long long k0) {
    if (a_row_ok && m_a < m_end && d + dz < D && h + dy < H && ww + dx < W) {
      load8(xcol + m_a * C, a_reg);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) a_reg[i] = 0.f;
    }
    const long long m_b = k0 + b_k;
    if (b_col_ok && m_b < m_end) {
      load4(g + m_b * N + n0 + b_n, b_reg);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) b_reg[j] = 0.f;
    }
    m_a += BK;
    ww += BK;
    while (ww >= W) { ww -= W; ++h; }
    while (h >= H) { h -= H; ++d; }
    while (d >= D) d -= D;
  };

  auto store_stage = [&]() {
    *reinterpret_cast<float4*>(&As[a_k][a_r]) = make_float4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
    *reinterpret_cast<float4*>(&As[a_k][a_r + 4]) = make_float4(a_reg[4], a_reg[5], a_reg[6], a_reg[7]);
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_stage(m_begin);
  store_stage();
  __syncthreads();

  for (long long k0 = m_begin; k0 < m_end; k0 += BK) {
    const bool more = k0 + BK < m_end;
    if (more) load_stage(k0 + BK);  // in flight while this stage computes
    fma_stage(As, Bs, ty, tx, acc);
    __syncthreads();
    if (more) {
      store_stage();
      __syncthreads();
    }
  }

  const int n = n0 + tx * TN;
  if (n < N) {
    float* out = part + static_cast<long long>(blockIdx.z) * R * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ro = r0 + ty * TM + i;
      if (ro < R) store4(out + static_cast<long long>(ro) * N + n, acc[i]);
    }
  }
}

// dw[i] = sum_z part[z][i], z ascending: the same order in every run.
__global__ void conv_k2_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                         long long count4, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  const float4* p = reinterpret_cast<const float4*>(part);
  float4 sum = p[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = p[static_cast<long long>(z) * count4 + i];
    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
  }
  reinterpret_cast<float4*>(dw)[i] = sum;
}

template <typename T, bool BWD>
cudaError_t launch_gemm(const void* x, const void* w, void* y, int D, int H, int W, int C, int N,
                        long long M, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((N + BN - 1) / BN));
  conv_k2_gemm_kernel<T, BWD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), D, H, W, C, N, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* dw, float* workspace, int splits, int D,
                      int H, int W, int C, int N, long long M, cudaStream_t s) {
  const long long rows_per_split = ((M + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid(static_cast<unsigned>((8 * C + BM - 1) / BM), static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>(splits));
  conv_k2_dw_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), splits == 1 ? dw : workspace,
      D, H, W, C, N, M, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long count4 = static_cast<long long>(8) * C * N / 4;
  conv_k2_dw_reduce_kernel<<<static_cast<unsigned>((count4 + 255) / 256), 256, 0, s>>>(
      workspace, dw, count4, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point: dtype 0 = float32, 1 = bfloat16. Launches on `stream`
// (a cudaStream_t) of `device`, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

// y [B,D,H,W,N] = conv_k2(x [B,D,H,W,C], w [2,2,2,C,N]).
int conv_k2_forward(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                    int N, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(B) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_gemm<float, false>(x, w, y, D, H, W, C, N, M, s));
  if (dtype == 1) return static_cast<int>(launch_gemm<__nv_bfloat16, false>(x, w, y, D, H, W, C, N, M, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx [B,D,H,W,C] from g [B,D,H,W,N] and wt [2,2,2,N,C] (each tap of w transposed).
int conv_k2_backward_input(const void* g, const void* wt, void* dx, int B, int D, int H, int W,
                           int C, int N, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(B) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_gemm<float, true>(g, wt, dx, D, H, W, N, C, M, s));
  if (dtype == 1) return static_cast<int>(launch_gemm<__nv_bfloat16, true>(g, wt, dx, D, H, W, N, C, M, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw [2,2,2,C,N] in float32 from x [B,D,H,W,C] and g [B,D,H,W,N]. The row
// reduction is cut into `splits` parts; `workspace` holds splits*8*C*N floats
// (unused when splits == 1).
int conv_k2_backward_weight(const void* x, const void* g, void* dw, void* workspace, int splits,
                            int B, int D, int H, int W, int C, int N, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0) return static_cast<int>(launch_dw<float>(x, g, out, ws, splits, D, H, W, C, N, M, s));
  if (dtype == 1) return static_cast<int>(launch_dw<__nv_bfloat16>(x, g, out, ws, splits, D, H, W, C, N, M, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 tensor-core forward. The wrapper's plan gives the output tile
// (bm rows, 128 or 256, by bn columns, 64 or 128), the box of its bm rows
// (bw, bh, bd) in (w, h, d), the ring's stages, the number of blocks that
// share the output tiles, and the dynamic shared memory and the tile count it
// worked out, which must be this file's own (else wg::PLAN_MISMATCH). Needs
// C % 64 == 0, N % bn == 0 and D*H*W % bm == 0.
int conv_k2_forward_wgmma(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                          int N, int bw, int bh, int bd, int bm, int bn, int stages, int grid, int smem_bytes,
                          int tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % wg::BK || N % bn || bw * bh * bd != bm || static_cast<long long>(D) * H * W % bm || stages < 2 ||
      stages > wg::MAX_STAGES || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_ARGS x, w, y, B, D, H, W, C, N, bw, bh, bd, stages, grid, smem_bytes, tiles, s
  if (bm == 128 && bn == 128) return wg::launch_fwd<128, 1>(FWD_ARGS);
  if (bm == 128 && bn == 64) return wg::launch_fwd<64, 1>(FWD_ARGS);
  if (bm == 256 && bn == 128) return wg::launch_fwd<128, 2>(FWD_ARGS);
  if (bm == 256 && bn == 64) return wg::launch_fwd<64, 2>(FWD_ARGS);
#undef FWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 tensor-core dw: the box of a stage's 64 rows (bw, bh, bd); the
// M/64 stages of the row reduction are cut into `splits` parts of
// `stages_per_split` (the last may be shorter, none is empty); `workspace`
// holds splits*8*C*N floats (unused when splits == 1); `smem_bytes` is the
// plan's dynamic shared memory, held to this file's own.
int conv_k2_backward_weight_wgmma(const void* x, const void* g, void* dw, void* workspace, int splits,
                                  int stages_per_split, int B, int D, int H, int W, int C, int N, int bw,
                                  int bh, int bd, int bn, int stages, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * D * H * W / wg::BK;
  if (C % wg::BK || N % bn || bw * bh * bd != wg::BK || stages < 2 || stages > wg::MAX_STAGES || splits < 1 ||
      static_cast<long long>(splits - 1) * stages_per_split >= total ||
      static_cast<long long>(splits) * stages_per_split < total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* part = splits == 1 ? out : static_cast<float*>(workspace);
  int rc;
  if (bn == 128)
    rc = wg::launch_dw<128>(x, g, part, splits, stages_per_split, B, D, H, W, C, N, bw, bh, bd, stages, smem_bytes,
                            s);
  else if (bn == 64)
    rc = wg::launch_dw<64>(x, g, part, splits, stages_per_split, B, D, H, W, C, N, bw, bh, bd, stages, smem_bytes,
                           s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc || splits == 1) return rc;
  const long long count4 = static_cast<long long>(8) * C * N / 4;
  conv_k2_dw_reduce_kernel<<<static_cast<unsigned>((count4 + 255) / 256), 256, 0, s>>>(part, out, count4, splits);
  return static_cast<int>(cudaGetLastError());
}

// Codes from wg::PLAN_MISMATCH up are this library's own, not cudaError_t.
const char* conv_k2_error_string(int code) {
  if (code == wg::PLAN_MISMATCH) return "the plan's shared memory or tile count is not the kernel's";
  if (code == wg::NO_ENCODER) return "cuTensorMapEncodeTiled not found in libcuda";
  if (code >= wg::ENCODE_FAILED) return "cuTensorMapEncodeTiled refused the tensor map (code - 10000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
