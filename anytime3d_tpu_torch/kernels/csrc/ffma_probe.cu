// What the FFMA pipe gives the inner loop of conv_k2_gemm_kernel (conv_k2.cu)
// on this card, as nvcc compiles it: the thread's outer products alone, from
// registers, and with the kernel's shared-memory reads and its one barrier a
// stage, but with no loads from device memory. A yardstick for that kernel,
// run by `python -m anytime3d_tpu_torch.cli.probe_ffma`; nothing of the port
// calls it.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16, BN = 128, A_PITCH = 20, TN = 8;  // the GEMM's float32 stage

// TM x 8 outputs a thread (rows 4 apart, columns in two runs of 4, as in the
// GEMM), KV consecutive k of a row read at once. LDS: operands from shared
// memory each step, else from registers.
template <int TM, int KV, bool LDS, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) probe_kernel(float* out, const float* in, int stages) {
  __shared__ __align__(16) float As[128 * A_PITCH];
  __shared__ __align__(16) float Bs[BK * BN];
  for (int i = threadIdx.x; i < 128 * A_PITCH; i += THREADS) As[i] = in[i % 1024];
  for (int i = threadIdx.x; i < BK * BN; i += THREADS) Bs[i] = in[(i * 7) % 1024];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* a_base = As + ((warp / 2) * (4 * TM) + (lane >> 3)) * A_PITCH;
  const float* b_base = Bs + (warp % 2) * 64 + (lane & 7) * 4;
  float acc[TM][TN], a_reg[TM][KV], b_reg[KV][TN];
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < TM; ++i)
    for (int k = 0; k < KV; ++k) a_reg[i][k] = in[(threadIdx.x + i * KV + k) % 1024];
  for (int k = 0; k < KV; ++k)
    for (int j = 0; j < TN; ++j) b_reg[k][j] = in[(threadIdx.x * 3 + k * TN + j) % 1024];
  for (int stage = 0; stage < stages; ++stage) {
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += KV) {
      float a[TM][KV];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int k = 0; k < KV; k += 2) {
          const float2 v = LDS ? *reinterpret_cast<const float2*>(a_base + i * 4 * A_PITCH + k0 + k)
                               : make_float2(a_reg[i][k], a_reg[i][k + 1]);
          a[i][k] = v.x;
          a[i][k + 1] = v.y;
        }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        float b[TN];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = LDS ? *reinterpret_cast<const float4*>(b_base + (k0 + kk) * BN + 32 * h)
                               : make_float4(b_reg[kk][4 * h], b_reg[kk][4 * h + 1], b_reg[kk][4 * h + 2],
                                             b_reg[kk][4 * h + 3]);
          b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    if (LDS) __syncthreads();  // the GEMM's barrier; shared memory is read anew after it
  }
  float sum = 0.f;
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) sum += acc[i][j];
  out[blockIdx.x * THREADS + threadIdx.x] = sum;
}

template <int TM, int KV, bool LDS, int THREADS, int MIN_BLOCKS>
int run(float* out, const float* in, int stages, float* ms, double* flop) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * MIN_BLOCKS * 4;  // four full waves
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  probe_kernel<TM, KV, LDS, THREADS, MIN_BLOCKS><<<blocks, THREADS>>>(out, in, 10);  // warm-up
  cudaEventRecord(start);
  probe_kernel<TM, KV, LDS, THREADS, MIN_BLOCKS><<<blocks, THREADS>>>(out, in, stages);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  cudaEventElapsedTime(ms, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  *flop = 2.0 * blocks * THREADS * TM * TN * BK * stages;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One variant on device 0: tm = 8 (256 threads a block, 128 registers) or 16
// (128 threads, up to 255), operands from shared memory or registers, `stages`
// stages of 16 k. `scratch` holds 1 M floats (zeroed input in its first 1024).
// Writes the kernel's milliseconds and its operations; returns a cudaError_t.
extern "C" int ffma_probe(int tm, int with_lds, int stages, float* scratch, float* ms, double* flop) {
  float* out = scratch + 1024;
  if (tm == 8 && with_lds) return run<8, 4, true, 256, 2>(out, scratch, stages, ms, flop);
  if (tm == 8) return run<8, 4, false, 256, 2>(out, scratch, stages, ms, flop);
  if (tm == 16 && with_lds) return run<16, 2, true, 128, 2>(out, scratch, stages, ms, flop);
  if (tm == 16) return run<16, 2, false, 128, 2>(out, scratch, stages, ms, flop);
  return static_cast<int>(cudaErrorInvalidValue);
}
