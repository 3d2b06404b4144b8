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
// Design: a register-blocked f32 core.  One 256-thread block per 128x128
// output tile; each thread holds an 8x8 micro-tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise from tx), so one step along D reads
// its 8 row and 8 column values as four 16-byte shared loads for 64 FMAs:
// 4 FMAs per float, the most that shared memory (32 floats a clock against
// 128 FMA lanes) can feed, with no headroom.  A warp is 4 x 8 threads, so
// its row loads cover 64 contiguous bytes and its column loads 128.
// Features pass through two shared buffers in stages of 32 along D (two
// chunks of the summation order), transposed ([32][128 + 4], 67.6 KB in
// all); the next stage's 16-byte global loads (4 f32 or 8 bf16 values of
// one row) are issued before this stage's FMAs and stored into the other
// buffer after them, so there is one __syncthreads per 32 along D (stages
// of 16, with loads one or two stages ahead, read slower).  Each of the 256
// threads keeps one of the block's 128 row or 128 column squared norms
// from the same staged values, so lambda_h folds into the norms exactly as
// in _sim_kernel.  The epilogue stages the block's row and column positions
// in shared memory (8 coordinates at a time), adds the direct differences,
// applies one exp and writes each of a thread's rows as two 16-byte stores.
// Ragged M and N are masked at the loads (zero-fill) and at the store; the
// caller hands rows whose width D is a multiple of 16 bytes (zero-padded
// where it was not), and the stage's tail past D is zero-filled.  Zeros add
// nothing to the dot or the norms.
//
// Summation order (kept from the first version of this kernel, so the
// output is the same bit for bit): D runs in chunks of 16; inside a chunk
// the 16 products form one FMA chain that starts from 0 and runs in d
// order; chunk sums are added to a running total in d order; the norms use
// the same order as the dot.  One FMA chain over D = 1024 drifts by up to
// ~1e-5 in K from a float64 evaluation at the build's shape; chunked, the
// kernel stays within ~1.5e-6 of it (chip_smoke.py, H100).  A point against
// itself gets arg == 0 up to one rounding of lambda_h (exactly 0, K == 1,
// at lambda_h = 1).  The two accumulator sets take 128 registers a thread
// (about 240 in all): one block of 8 warps per SM, each thread issuing 64
// independent FMAs per step.  PERF.md has the kernel's time beside its
// bound and what holds it there.
// Determinism: every sum runs in a fixed order with no atomics and no split
// over D, so two launches give bit-identical output.
// bf16_exact: features arrive as bf16 (half the bytes), are widened to f32
// on their way into shared memory, and every product of two bf16 values is
// exact in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;       // block tile rows (and columns)
constexpr int BK = 16;        // chunk along D: the unit of the summation order
constexpr int SK = 2 * BK;    // stage along D: one shared buffer, one barrier
constexpr int NT = 256;       // threads per block
constexpr int LDS = TM + 4;   // shared row length: 16-byte aligned, padded
constexpr int MAXP = 8;       // position coordinates staged per pass

// A 16-byte vector of T widened to f32.
__device__ __forceinline__ void widen(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> f32 is exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One operand's share of a stage: LOADS 16-byte vectors per thread.
template <typename T>
struct Stage {
  static constexpr int VEC = 16 / sizeof(T);      // values per 16 bytes
  static constexpr int PER_ROW = SK / VEC;        // vectors per row of a stage
  static constexpr int LOADS = TM * PER_ROW / NT; // vectors per thread
  uint4 r[LOADS];

  // Vector f of a stage: a warp takes 16 rows x 2 neighbouring vectors, so
  // its global loads read whole 32-byte sectors and (f32) its transposing
  // shared stores hit 32 distinct banks.
  static __device__ __forceinline__ int row_of(int f) { return (f / 32 % 8) * 16 + f % 16; }
  static __device__ __forceinline__ int vec_of(int f) { return (f / 256) * 2 + f % 32 / 16; }

  __device__ __forceinline__ void load(const T* __restrict__ src, int rows, int row0, int D,
                                       int k0, int tid) {
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      const int row = row0 + row_of(tid + t * NT);
      const int col = k0 + vec_of(tid + t * NT) * VEC;
      r[t] = (row < rows && col < D)
                 ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)row * D + col))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float (*dst)[LDS], int tid) const {
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      const int row = row_of(tid + t * NT);
      const int c0 = vec_of(tid + t * NT) * VEC;
      float v[VEC];
      widen(r[t], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[c0 + e][row] = v[e];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) sim_kernel(
    const T* __restrict__ rf, const float* __restrict__ rp,
    const T* __restrict__ cf, const float* __restrict__ cp,
    float* __restrict__ out, int M, int N, int D, int P, float lambda_h) {
  // [buffer][0 rows, 1 columns][d in the stage][row or column of the tile]
  extern __shared__ __align__(16) float fs_raw[];
  float (*fs)[2][SK][LDS] = reinterpret_cast<float (*)[2][SK][LDS]>(fs_raw);
  __shared__ __align__(16) float norms[2][TM];        // [rows, columns][...]
  __shared__ __align__(16) float pos[2][MAXP][TM];    // [rows, columns][coordinate][...]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;  // 0..15: rows ty*4 + i, 64 + ty*4 + i
  const int tx = (warp % 2) * 8 + lane % 8;  // 0..15: columns tx*4 + j, 64 + tx*4 + j
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TM;
  // the one norm (and, in the epilogue, the one position row) this thread
  // keeps: row tid of the tile, or column tid - TM
  const int side = tid / TM, own = tid % TM;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;

  const int stages = (D + SK - 1) / SK;
  Stage<T> sa, sb;
  if (stages > 0) {
    sa.load(rf, M, m0, D, 0, tid);
    sb.load(cf, N, n0, D, 0, tid);
    sa.store(fs[0][0], tid);
    sb.store(fs[0][1], tid);
  }
  __syncthreads();

  for (int t = 0; t < stages; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < stages;
    if (more) {  // in flight during this stage's FMAs
      sa.load(rf, M, m0, D, (t + 1) * SK, tid);
      sb.load(cf, N, n0, D, (t + 1) * SK, tid);
    }
#pragma unroll
    for (int h = 0; h < SK / BK; ++h) {  // the stage's two chunks, in d order
      if (t * SK + h * BK >= D) break;  // no chunk starts past D
      {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < BK; ++c) {
          const float v = fs[cur][side][h * BK + c][own];
          part = fmaf(v, v, part);
        }
        nacc += part;
      }
      float part[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float* ra = fs[cur][0][h * BK + kk];
        const float* rb = fs[cur][1][h * BK + kk];
        const float4 a0 = *reinterpret_cast<const float4*>(ra + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(ra + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(rb + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(rb + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    }
    if (more) {  // the other buffer was last read before the previous barrier
      sa.store(fs[cur ^ 1][0], tid);
      sb.store(fs[cur ^ 1][1], tid);
    }
    __syncthreads();
  }

  // ---- epilogue: arg = max(norms - 2 lh dot, 0) + spatial term; K = exp(-arg)
  norms[side][own] = lambda_h * nacc;
  const float dot_coef = -2.f * lambda_h;
  const int g = (side ? n0 : m0) + own;  // this thread's position row
  const bool g_ok = g < (side ? N : M);
  const float* g_src = (side ? cp : rp) + (size_t)g * P;
  for (int p0 = 0; p0 == 0 || p0 < P; p0 += MAXP) {
    const int np = min(MAXP, P - p0);
    if (p0 > 0) __syncthreads();  // the previous coordinates have been read
    for (int p = 0; p < np; ++p) pos[side][p][own] = g_ok ? g_src[p0 + p] : 0.f;
    __syncthreads();
    if (p0 == 0) {
      const float4 cn0 = *reinterpret_cast<const float4*>(&norms[1][tx * 4]);
      const float4 cn1 = *reinterpret_cast<const float4*>(&norms[1][64 + tx * 4]);
      const float cn[8] = {cn0.x, cn0.y, cn0.z, cn0.w, cn1.x, cn1.y, cn1.z, cn1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float rn = norms[0][(i / 4) * 64 + ty * 4 + i % 4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaxf((rn + cn[j]) + dot_coef * acc[i][j], 0.f);
      }
    }
    for (int p = 0; p < np; ++p) {
      const float4 c0 = *reinterpret_cast<const float4*>(&pos[1][p][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&pos[1][p][64 + tx * 4]);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float rv = pos[0][p][(i / 4) * 64 + ty * 4 + i % 4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float diff = rv - cv[j];
          acc[i][j] = acc[i][j] + diff * diff;
        }
      }
    }
  }

  const bool vec_rows = N % 4 == 0;  // every output row starts on 16 bytes
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      float k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = expf(-acc[i][h * 4 + j]);
      float* dst = out + (size_t)r * N + c;
      if (vec_rows && c + 3 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(k[0], k[1], k[2], k[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) dst[j] = k[j];
      }
    }
  }
}

template <typename T>
int launch(const void* rf, const void* rp, const void* cf, const void* cp, void* out,
           int M, int N, int D, int P, float lambda_h, void* stream) {
  // 16-byte row loads: D a multiple of 16 bytes, feature bases on 16 bytes
  // (the wrapper pads and copies rows that are not), output rows on 16 bytes
  // where N allows
  if (D % Stage<T>::VEC != 0 || reinterpret_cast<uintptr_t>(rf) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cf) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = 2 * 2 * SK * LDS * sizeof(float);  // two buffers, above 48 KB
  static const cudaError_t attr =
      cudaFuncSetAttribute(sim_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + TM - 1) / TM, (M + TM - 1) / TM);
  sim_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rf), static_cast<const float*>(rp),
      static_cast<const T*>(cf), static_cast<const float*>(cp),
      static_cast<float*>(out), M, N, D, P, lambda_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D is the width of the feature rows as stored (a multiple of 4 for f32 and
// 8 for bf16, zero-padded past the true width); rows are contiguous.
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
