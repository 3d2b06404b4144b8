// Self-KNN with a running top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_fusion_tpu/ops/pallas_knn.py:
// _knn_kernel (called from pallas_knn).  For every row i of x [N, D] it
// returns the k <= 128 rows with the smallest squared distance
//
//   d(i, j) = max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0),  d(i, i) := 0,
//
// ordered by (distance, smallest index), as sqrt distances ascending and
// int32 indices; self sits in slot 0.
//
// Bound on the H100: compute.  The distances are N*N*D fused multiply-adds
// in true float32 (2*4096^2*1024 = 34.4 GFLOP at the build's 4096-node
// shape, 0.51 ms at the 67 TFLOP/s non-tensor f32 peak); the inputs are
// N*D*4 bytes and the outputs N*k*8 bytes.  The [N, N] distance matrix never
// exists in device memory.
//
// Design (simple first): one 256-thread block per tile of 32 query rows.
// The TPU walked key tiles on a sequential grid axis with the running lists
// in a revisited output block; here the block itself loops over key tiles of
// 64, so nothing carries between blocks.  Each key tile's [32, 64] distances
// are computed like a small GEMM (feature chunks of 16 staged in shared
// memory, each thread a 4x2 register micro-tile; the staged chunks also give
// the key norms, and the query norms on the first key tile), written to
// shared memory, and merged into the per-row sorted lists (k x (f32, int32)
// each, 32 KB in all at k = 128, in dynamic shared memory).  One warp merges
// one row at a time: a ballot finds the candidates below the row's current
// k-th entry; each is placed by a warp-wide count of smaller entries and a
// parallel shift.  The result is the k smallest of a strict total order, so
// it does not depend on the order of insertion.  Columns >= N never enter.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;   // query rows per block
constexpr int KT = 64;   // keys per tile
constexpr int BK = 16;   // feature chunk
constexpr int NT = 256;  // threads
constexpr int KMAX = 128;

__device__ __forceinline__ bool less_than(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(NT) knn_kernel(const float* __restrict__ x,
                                                 float* __restrict__ out_d,
                                                 int* __restrict__ out_i, int N, int D,
                                                 int k) {
  extern __shared__ unsigned char smem[];
  float* best_v = reinterpret_cast<float*>(smem);  // [QT][k]
  int* best_i = reinterpret_cast<int*>(best_v + QT * k);  // [QT][k]
  __shared__ float Qs[BK][QT + 1];
  __shared__ float Ks[BK][KT + 1];
  __shared__ float dist[QT][KT + 1];
  __shared__ float qn[QT];
  __shared__ float kn[KT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 31;  // key columns tx, tx + 32
  const int ty = tid >> 5;  // query rows ty, ty + 8, ty + 16, ty + 24
  const int q0 = blockIdx.x * QT;

  for (int i = tid; i < QT * k; i += NT) {
    best_v[i] = INFINITY;
    best_i[i] = INT32_MAX;
  }
  float qacc = 0.f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    float acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
    float kacc = 0.f;
    for (int d0 = 0; d0 < D; d0 += BK) {
#pragma unroll
      for (int t = 0; t < (QT * BK) / NT; ++t) {
        const int i = tid + t * NT;
        const int r = i / BK, c = i % BK;
        const int gr = q0 + r, gc = d0 + c;
        Qs[c][r] = (gr < N && gc < D) ? x[(size_t)gr * D + gc] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < (KT * BK) / NT; ++t) {
        const int i = tid + t * NT;
        const int r = i / BK, c = i % BK;
        const int gr = k0 + r, gc = d0 + c;
        Ks[c][r] = (gr < N && gc < D) ? x[(size_t)gr * D + gc] : 0.f;
      }
      __syncthreads();
      if (k0 == 0 && tid < QT) {
#pragma unroll
        for (int c = 0; c < BK; ++c) qacc = fmaf(Qs[c][tid], Qs[c][tid], qacc);
      }
      if (tid >= 64 && tid < 64 + KT) {
#pragma unroll
        for (int c = 0; c < BK; ++c) kacc = fmaf(Ks[c][tid - 64], Ks[c][tid - 64], kacc);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[kk][ty + 8 * i];
        const float b0 = Ks[kk][tx];
        const float b1 = Ks[kk][tx + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], b0, acc[i][0]);
          acc[i][1] = fmaf(a[i], b1, acc[i][1]);
        }
      }
      __syncthreads();
    }
    if (k0 == 0 && tid < QT) qn[tid] = qacc;
    if (tid >= 64 && tid < 64 + KT) kn[tid - 64] = kacc;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 32 * j;
        const int gk = k0 + c;
        float dv = fmaxf(qn[r] + kn[c] - 2.f * acc[i][j], 0.f);
        if (gk >= N) {
          dv = INFINITY;
        } else if (gk == q0 + r) {
          dv = 0.f;  // the expansion leaves eps*|x|^2 on the diagonal
        }
        dist[r][c] = dv;
      }
    }
    __syncthreads();

    for (int rr = warp; rr < QT; rr += NT / 32) {
      if (q0 + rr >= N) break;  // warp-uniform; later rows are out of range too
      float* bv = best_v + rr * k;
      int* bi = best_i + rr * k;
#pragma unroll
      for (int h = 0; h < KT / 32; ++h) {
        const int c = lane + 32 * h;
        const float v = dist[rr][c];
        const int gi = k0 + c;
        unsigned pass = __ballot_sync(0xffffffffu,
                                      gi < N && less_than(v, gi, bv[k - 1], bi[k - 1]));
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float cv = __shfl_sync(0xffffffffu, v, src);
          const int ci = __shfl_sync(0xffffffffu, gi, src);
          // the list moved since the ballot: test against its current k-th
          if (!less_than(cv, ci, bv[k - 1], bi[k - 1])) continue;
          int cnt = 0;
          for (int s = lane; s < k; s += 32) cnt += less_than(bv[s], bi[s], cv, ci) ? 1 : 0;
          const int pos = __reduce_add_sync(0xffffffffu, cnt);
          float tv[KMAX / 32];
          int ti[KMAX / 32];
#pragma unroll
          for (int t = 0; t < KMAX / 32; ++t) {
            const int s = lane + 32 * t;
            if (s >= pos && s < k - 1) {
              tv[t] = bv[s];
              ti[t] = bi[s];
            }
          }
          __syncwarp();
#pragma unroll
          for (int t = 0; t < KMAX / 32; ++t) {
            const int s = lane + 32 * t;
            if (s >= pos && s < k - 1) {
              bv[s + 1] = tv[t];
              bi[s + 1] = ti[t];
            }
          }
          if (lane == 0) {
            bv[pos] = cv;
            bi[pos] = ci;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < QT * k; i += NT) {
    const int r = i / k, s = i % k;
    const int gq = q0 + r;
    if (gq < N) {
      out_d[(size_t)gq * k + s] = sqrtf(best_v[i]);
      out_i[(size_t)gq * k + s] = best_i[i];
    }
  }
}

}  // namespace

extern "C" int mmf_knn(const void* x, void* out_d, void* out_i, int N, int D, int k,
                       void* stream) {
  if (k < 1 || k > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = static_cast<size_t>(QT) * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + QT - 1) / QT);
  knn_kernel<<<grid, NT, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out_d), static_cast<int*>(out_i), N, D,
      k);
  return static_cast<int>(cudaGetLastError());
}
