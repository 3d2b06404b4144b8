// Fused combined-similarity tiles for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_fusion_tpu/ops/pallas_similarity.py:
// _sim_kernel (called from pallas_combined_similarity_rect).  Computes
//
//   K[i, j] = exp(-( max(lh*|f_i|^2 + lh*|f_j|^2 - 2*lh*<f_i, f_j>, 0)
//                    + sum_p (g_ip - g_jp)^2 ))
//
// with positions pre-scaled by sqrt(lambda_g) by the caller, so the squared
// coordinate differences are already the lambda_g-weighted spatial term.
//
// Bound on the H100: compute.  The feature dot is M*N*D fused multiply-adds
// in true float32 (2*4096^2*1024 = 34.4 GFLOP at the build's shape, 0.51 ms
// at the 67 TFLOP/s non-tensor f32 peak) against 64 MB of output (0.02 ms
// at 3.35 TB/s).  TF32 tensor cores are ruled out: the norm expansion
// cancels catastrophically below f32.
//
// Design (simple first): one 256-thread block per 64x64 output tile, each
// thread a 4x4 register micro-tile.  Row and column feature tiles are staged
// through shared memory in chunks of 16 along D; the same staged chunks
// give the row and column squared norms (threads 0-63 and 64-127), so
// lambda_h folds into the norms exactly as in _sim_kernel.  The epilogue adds
// the direct position differences, applies one exp, and writes each output
// once.  Ragged M, N and D are masked at the loads and the store.  The
// scalar shared-memory loads (8 per 16 FMAs) bound this tiling well below
// the FMA peak; PERF.md has its time beside the bound.
// Determinism: every sum runs in a fixed order with no atomics and no split
// over D, so two launches give bit-identical output.
// bf16_exact: features arrive as bf16 (half the bytes), are widened to f32
// in shared memory, and every product of two bf16 values is exact in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(NT) sim_kernel(
    const T* __restrict__ rf, const float* __restrict__ rp,
    const T* __restrict__ cf, const float* __restrict__ cp,
    float* __restrict__ out, int M, int N, int D, int P, float lambda_h) {
  __shared__ float As[BK][TM + 1];  // row features, transposed chunk
  __shared__ float Bs[BK][TN + 1];  // column features, transposed chunk
  __shared__ float rnorm[TM];
  __shared__ float cnorm[TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;  // squared-norm partial: row tid (<64) or column tid-64 (<128)

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int t = 0; t < (TM * BK) / NT; ++t) {
      const int i = tid + t * NT;
      const int r = i / BK, c = i % BK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < D) ? to_f32(rf[(size_t)gr * D + gc]) : 0.f;
      const int gn = n0 + r;
      Bs[c][r] = (gn < N && gc < D) ? to_f32(cf[(size_t)gn * D + gc]) : 0.f;
    }
    __syncthreads();
    // Two-level sums: each chunk of BK products is summed on its own, then
    // added to the running total.  One FMA chain over D = 1024 drifts by up
    // to ~1e-5 in K from a float64 evaluation at the build's shape; chunked,
    // the kernel stays within ~1.5e-6 of it (chip_smoke.py, H100).  Norms
    // and dot use the same order, so a point against itself gets arg == 0
    // up to one rounding of lambda_h (exactly 0, K == 1, at lambda_h = 1).
    if (tid < TM + TN) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float v = tid < TM ? As[c][tid] : Bs[c][tid - TM];
        part = fmaf(v, v, part);
      }
      nacc += part;
    }
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
  if (tid < TM) {
    rnorm[tid] = lambda_h * nacc;
  } else if (tid < TM + TN) {
    cnorm[tid - TM] = lambda_h * nacc;
  }
  __syncthreads();

  const float dot_coef = -2.f * lambda_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i;
    const int r = m0 + lr;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lc = tx + 16 * j;
      const int c = n0 + lc;
      if (c >= N) continue;
      float arg = fmaxf((rnorm[lr] + cnorm[lc]) + dot_coef * acc[i][j], 0.f);
      for (int p = 0; p < P; ++p) {
        const float diff = rp[(size_t)r * P + p] - cp[(size_t)c * P + p];
        arg = arg + diff * diff;
      }
      out[(size_t)r * N + c] = expf(-arg);
    }
  }
}

template <typename T>
int launch(const void* rf, const void* rp, const void* cf, const void* cp, void* out,
           int M, int N, int D, int P, float lambda_h, void* stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  sim_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rf), static_cast<const float*>(rp),
      static_cast<const T*>(cf), static_cast<const float*>(cp),
      static_cast<float*>(out), M, N, D, P, lambda_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmf_similarity_f32(const void* rf, const void* rp, const void* cf,
                                  const void* cp, void* out, int M, int N, int D, int P,
                                  float lambda_h, void* stream) {
  return launch<float>(rf, rp, cf, cp, out, M, N, D, P, lambda_h, stream);
}

extern "C" int mmf_similarity_bf16(const void* rf, const void* rp, const void* cf,
                                   const void* cp, void* out, int M, int N, int D, int P,
                                   float lambda_h, void* stream) {
  return launch<__nv_bfloat16>(rf, rp, cf, cp, out, M, N, D, P, lambda_h, stream);
}
