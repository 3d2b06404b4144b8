// Self-KNN for Hopper (sm_90a): a key-split running top-k and a merge.
//
// Replaces the Pallas TPU kernel multimodal_fusion_tpu/ops/pallas_knn.py:
// _knn_kernel (called from pallas_knn).  For every row i of x [N, D] it
// returns the k <= 128 rows with the smallest squared distance
//
//   d(i, j) = max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0),  d(i, i) := 0,
//
// ordered by (distance, smallest index), as sqrt distances ascending and
// int32 indices; self sits in slot 0.  Columns >= N never enter.
//
// Bound on the H100: operations.  The distances are N*N*D fused
// multiply-adds in true float32 (2*4096^2*1024 = 34.4 GFLOP at the build's
// 4096-node shape, 0.51 ms at the 67 TFLOP/s non-tensor f32 peak); the
// inputs are N*D*4 bytes and the outputs N*k*8 bytes.  The [N, N] distance
// matrix never exists in device memory.  TF32 tensor cores are ruled out:
// the norm expansion cancels catastrophically below f32.
//
// Distance core (the register-blocked core of similarity.cu): one
// 256-thread block per 128-row query tile and key segment; each key tile of
// 128 is a 128 x 128 product in which a thread holds an 8x8 register
// micro-tile (4 FMAs per float read from shared memory).  Rows pass through
// two shared buffers in stages of 32 along D, transposed, with the next
// stage's 16-byte global loads issued before this stage's FMAs and one
// barrier per stage; the last stage of a key tile loads the next key tile's
// first stage, so the pipeline runs on across tiles.  Each of the 256
// threads keeps one of the tile's 128 query or 128 key squared norms from
// the staged values (the query norms on the segment's first tile only).
//
// Split: the grid is (query tiles) x (S key segments).  The wrapper picks
// S from N, k and the SM count: with ~210 registers a thread one block fits
// an SM, and one full wave of larger segments beats two waves of smaller
// ones (N 4096: 32 x 4 = 128 blocks).  A segment is a run of whole key
// tiles; the last may be short or empty.  Each block keeps one sorted list
// per query row, k x (f32, int32), in shared memory (1 KB a row at k = 128)
// and writes its lists to a scratch [S, N, k] pair.  A second launch merges
// each row's S lists, one thread per row taking the smallest head of the S
// in segment order at each step, into the final k and applies sqrt; at
// S = 1 the first launch writes the result itself and there is no merge.
//
// Selection: while a tile's distances are still in registers, each thread
// tests its 64 candidates against its rows' current k-th entries and writes
// the survivors, the others as NaN, into a [128][132] distance tile that
// overlays the staging buffers.  One warp per row then merges its m
// survivors (4 per lane) into the row's list in one of two ways.
// Extraction (a segment's first tile at small k, and any few survivors):
// survivors leave in ascending order, each found by two warp-wide
// __reduce_min_sync (value bits, then the smallest index at that value; the
// distances are >= +0, so their bits order like the values), and the j-th
// goes to slot j + (old entries below it) until that reaches k.  Rank
// (16 < m <= 2k, the later tiles at large k): each survivor's slot is
// (survivors below it, m shuffle steps) + (old entries below it, a binary
// search).  Either way each old entry moves down by the survivors below
// it.  On random data a segment's first tile inserts k per row and each
// later one about k * ln(1 + 1/t).  The result is the k smallest of a
// strict total order, so neither the order in which rows, tiles or
// segments are merged nor the split changes it; the merge launch's fixed
// order makes it deterministic besides.  No atomics.
//
// Summation order, the same as the first version of this kernel, so the
// output is bit-identical to it: each distance is one FMA chain
// acc = fmaf(q_d, k_d, acc) from 0 along D in d order; each norm is one
// chain n = fmaf(x_d, x_d, n) in d order; the epilogue is
// fmaxf(qn + kn - 2.f * acc, 0.f) (2 * acc is exact, so a contracted and an
// uncontracted evaluation agree) with self pinned to 0 and sqrtf at the end.
// Rows are zero-padded to a multiple of 4 (by the wrapper) and the stage
// tail to 32: the first version zero-padded to 16, and a zero product adds
// nothing to a chain.
//
// Rows are read 16 bytes at a time: the C entry refuses (cudaErrorInvalidValue)
// rows whose width D is not a multiple of 4 or whose base is off 16 bytes
// (the wrapper copies such rows into zero-padded ones first), k outside
// [1, 128] or N, and S outside [1, 16].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;      // query rows per block, keys per tile
constexpr int SK = 32;       // stage along D: one shared buffer, one barrier
constexpr int NT = 256;      // threads per block
constexpr int LDS = TM + 4;  // shared row length: 16-byte aligned, padded
constexpr int KMAX = 128;    // longest list
constexpr int SMAX = 16;     // most key segments
constexpr int SLOTS = KMAX / 32;  // list entries a lane holds while merging
constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGE_FLOATS = 2 * 2 * SK * LDS;  // [buffer][query, key][SK][LDS]

// A row's survivors are ranked (m shuffle steps) when 16 < m <= 2k, and
// extracted (min(m, k) steps of two reductions) otherwise.
constexpr int RANK_MIN = 16;
constexpr int RANK_FACTOR = 2;

__device__ __forceinline__ bool less_than(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// One operand's share of a stage: 4 16-byte vectors per thread.  A warp
// takes 16 rows x 2 neighbouring vectors, so its global loads read whole
// 32-byte sectors and its transposing shared stores hit 32 distinct banks.
struct Stage {
  static constexpr int PER_ROW = SK / 4;            // vectors per row of a stage
  static constexpr int LOADS = TM * PER_ROW / NT;   // vectors per thread
  float4 r[LOADS];

  static __device__ __forceinline__ int row_of(int f) { return (f / 32 % 8) * 16 + f % 16; }
  static __device__ __forceinline__ int vec_of(int f) { return (f / 256) * 2 + f % 32 / 16; }

  __device__ __forceinline__ void load(const float* __restrict__ x, int N, int row0, int D,
                                       int d0, int tid) {
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      const int row = row0 + row_of(tid + t * NT);
      const int col = d0 + vec_of(tid + t * NT) * 4;
      r[t] = (row < N && col < D)
                 ? __ldg(reinterpret_cast<const float4*>(x + (size_t)row * D + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float (*dst)[LDS], int tid) const {
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      const int row = row_of(tid + t * NT);
      const int c0 = vec_of(tid + t * NT) * 4;
      dst[c0 + 0][row] = r[t].x;
      dst[c0 + 1][row] = r[t].y;
      dst[c0 + 2][row] = r[t].z;
      dst[c0 + 3][row] = r[t].w;
    }
  }
};

// Rows [q0, q0 + 128) against the key tiles [t_begin, t_end) of one segment.
__global__ void __launch_bounds__(NT, 1) knn_partial_kernel(
    const float* __restrict__ x, float* __restrict__ part_d, int* __restrict__ part_i,
    float* __restrict__ out_d, int* __restrict__ out_i, int N, int D, int k,
    int tiles_per_seg) {
  extern __shared__ __align__(16) float smem[];
  float (*fs)[2][SK][LDS] = reinterpret_cast<float (*)[2][SK][LDS]>(smem);
  float (*dist)[LDS] = reinterpret_cast<float (*)[LDS]>(smem);  // overlays fs
  float* list_v = smem + STAGE_FLOATS;                            // [TM][k]
  int* list_i = reinterpret_cast<int*>(list_v + TM * k);          // [TM][k]
  __shared__ __align__(16) float norms[2][TM];                    // [query, key][...]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;  // rows ty*4 + i, 64 + ty*4 + i
  const int tx = (warp % 2) * 8 + lane % 8;  // keys tx*4 + j, 64 + tx*4 + j
  const int side = tid / TM, own = tid % TM;  // the norm this thread keeps
  const int q0 = blockIdx.x * TM;
  const int key_tiles = (N + TM - 1) / TM;
  const int t_begin = blockIdx.y * tiles_per_seg;
  const int t_end = min(t_begin + tiles_per_seg, key_tiles);
  const int stages = (D + SK - 1) / SK;

  for (int i = tid; i < TM * k; i += NT) {
    list_v[i] = INFINITY;
    list_i[i] = INT32_MAX;
  }
  Stage sq, sk;
  if (t_begin < t_end && stages > 0) {
    sq.load(x, N, q0, D, 0, tid);
    sk.load(x, N, t_begin * TM, D, 0, tid);
    sq.store(fs[0][0], tid);
    sk.store(fs[0][1], tid);
  }
  __syncthreads();

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * TM;
    const bool next_tile = tile + 1 < t_end;
    const bool keep_norm = side == 1 || tile == t_begin;  // query norms once
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float nacc = 0.f;

    for (int t = 0; t < stages; ++t) {
      const int cur = t & 1;
      const bool more = t + 1 < stages;
      if (more) {  // in flight during this stage's FMAs
        sq.load(x, N, q0, D, (t + 1) * SK, tid);
        sk.load(x, N, n0, D, (t + 1) * SK, tid);
      } else if (next_tile) {  // the next tile's first stage, stored after the merge
        sq.load(x, N, q0, D, 0, tid);
        sk.load(x, N, n0 + TM, D, 0, tid);
      }
      if (keep_norm) {
#pragma unroll
        for (int c = 0; c < SK; ++c) {
          const float v = fs[cur][side][c][own];
          nacc = fmaf(v, v, nacc);
        }
      }
#pragma unroll
      for (int kk = 0; kk < SK; ++kk) {
        const float* ra = fs[cur][0][kk];
        const float* rb = fs[cur][1][kk];
        const float4 a0 = *reinterpret_cast<const float4*>(ra + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(ra + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(rb + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(rb + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {  // the other buffer was last read before the previous barrier
        sq.store(fs[cur ^ 1][0], tid);
        sk.store(fs[cur ^ 1][1], tid);
      }
      __syncthreads();
    }
    if (keep_norm) norms[side][own] = nacc;
    __syncthreads();

    // ---- filter in registers: survivors (or NaN) into the distance tile
    {
      const float4 kn0 = *reinterpret_cast<const float4*>(&norms[1][tx * 4]);
      const float4 kn1 = *reinterpret_cast<const float4*>(&norms[1][64 + tx * 4]);
      const float kn[8] = {kn0.x, kn0.y, kn0.z, kn0.w, kn1.x, kn1.y, kn1.z, kn1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i / 4) * 64 + ty * 4 + i % 4;
        const float qn = norms[0][r];
        const float thr_v = list_v[r * k + k - 1];
        const int thr_i = list_i[r * k + k - 1];
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gk = n0 + (j / 4) * 64 + tx * 4 + j % 4;
          float dv = fmaxf(qn + kn[j] - 2.f * acc[i][j], 0.f);
          if (gk == q0 + r) dv = 0.f;  // the expansion leaves eps*|x|^2 on the diagonal
          o[j] = (gk < N && less_than(dv, gk, thr_v, thr_i)) ? dv : __int_as_float(0x7fffffff);
        }
        *reinterpret_cast<float4*>(&dist[r][tx * 4]) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(&dist[r][64 + tx * 4]) = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncthreads();

    // ---- merge: one warp per row
    for (int r = warp; r < TM; r += NT / 32) {
      if (q0 + r >= N) break;  // warp-uniform; later rows are out of range too
      float cv[4];
      int ci[4];
      int m = 0;  // survivors in the row
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float v = dist[r][lane + 32 * h];
        const bool ok = !isnan(v);
        cv[h] = ok ? v : INFINITY;
        ci[h] = ok ? n0 + lane + 32 * h : INT32_MAX;
        m += __popc(__ballot_sync(FULL, ok));
      }
      if (m == 0) continue;
      float* lv_s = list_v + r * k;
      int* li_s = list_i + r * k;
      float lv[SLOTS];
      int li[SLOTS], moved[SLOTS];
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const int s = lane + 32 * t;
        lv[t] = s < k ? lv_s[s] : INFINITY;
        li[t] = s < k ? li_s[s] : INT32_MAX;
        moved[t] = 0;
      }
      if (m > RANK_MIN && m <= RANK_FACTOR * k) {
        // rank: each survivor's place is (survivors below it) + (old
        // entries below it, by binary search); each old entry's is its slot
        // + (survivors below it).  m steps of two shuffles each.
        int below[4] = {0, 0, 0, 0};
#pragma unroll
        for (int h2 = 0; h2 < 4; ++h2) {
          unsigned mask = __ballot_sync(FULL, ci[h2] != INT32_MAX);
          while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const float v = __shfl_sync(FULL, cv[h2], src);
            const int gi = __shfl_sync(FULL, ci[h2], src);
#pragma unroll
            for (int h = 0; h < 4; ++h) below[h] += less_than(v, gi, cv[h], ci[h]) ? 1 : 0;
#pragma unroll
            for (int t = 0; t < SLOTS; ++t) moved[t] += less_than(v, gi, lv[t], li[t]) ? 1 : 0;
          }
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          if (ci[h] == INT32_MAX || below[h] >= k) {
            below[h] = k;
            continue;
          }
          int lo = 0, hi = k;
          while (lo < hi) {
            const int mid = (lo + hi) / 2;
            if (less_than(lv_s[mid], li_s[mid], cv[h], ci[h])) lo = mid + 1;
            else hi = mid;
          }
          below[h] += lo;
        }
        __syncwarp();  // every lane has searched the old list
#pragma unroll
        for (int h = 0; h < 4; ++h)
          if (below[h] < k) {
            lv_s[below[h]] = cv[h];
            li_s[below[h]] = ci[h];
          }
      } else {
        // extraction: survivors leave in ascending order, two warp-wide
        // reductions each, and the j-th goes to slot j + (old entries below
        // it) until that reaches k
        __syncwarp();  // the old list is in registers before it is rewritten
        for (int j = 0; j < k; ++j) {
          float bv = cv[0];
          int bi = ci[0];
#pragma unroll
          for (int h = 1; h < 4; ++h)
            if (less_than(cv[h], ci[h], bv, bi)) {
              bv = cv[h];
              bi = ci[h];
            }
          const unsigned mv = __reduce_min_sync(FULL, __float_as_uint(bv));
          const unsigned mi = __reduce_min_sync(
              FULL, __float_as_uint(bv) == mv ? static_cast<unsigned>(bi) : FULL);
          if (mi == static_cast<unsigned>(INT32_MAX)) break;  // no survivor left
          const float v = __uint_as_float(mv);
          const int gi = static_cast<int>(mi);
          int below = 0;  // entries of the old list below the survivor
#pragma unroll
          for (int t = 0; t < SLOTS; ++t)
            below += __popc(__ballot_sync(FULL, less_than(lv[t], li[t], v, gi)));
          if (j + below >= k) break;  // it, and every later survivor, falls off
          if (lane == 0) {
            lv_s[j + below] = v;
            li_s[j + below] = gi;
          }
#pragma unroll
          for (int t = 0; t < SLOTS; ++t) moved[t] += lane + 32 * t >= below ? 1 : 0;
          const int c = gi - n0;
          if (lane == c % 32) {
#pragma unroll
            for (int h = 0; h < 4; ++h)
              if (h == c / 32) {
                cv[h] = INFINITY;
                ci[h] = INT32_MAX;
              }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const int s = lane + 32 * t;
        if (s < k && s + moved[t] < k) {
          lv_s[s + moved[t]] = lv[t];
          li_s[s + moved[t]] = li[t];
        }
      }
      __syncwarp();
    }
    __syncthreads();
    if (next_tile && stages > 0) {  // the distance tile has been read
      sq.store(fs[0][0], tid);
      sk.store(fs[0][1], tid);
      __syncthreads();
    }
  }

  const bool whole = gridDim.y == 1;  // S = 1: the result itself
  for (int i = tid; i < TM * k; i += NT) {
    const int r = i / k, s = i % k;
    const int gq = q0 + r;
    if (gq >= N) continue;
    if (whole) {
      out_d[(size_t)gq * k + s] = sqrtf(list_v[i]);
      out_i[(size_t)gq * k + s] = list_i[i];
    } else {
      const size_t o = ((size_t)blockIdx.y * N + gq) * k + s;
      part_d[o] = list_v[i];
      part_i[o] = list_i[i];
    }
  }
}

// One thread per row: the S sorted lists of the row merged, segment by
// segment in a fixed order at each step, into its k smallest; sqrt last.
__global__ void __launch_bounds__(TM) knn_merge_kernel(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    float* __restrict__ out_d, int* __restrict__ out_i, int N, int k, int S) {
  __shared__ float hv[SMAX][TM];  // each list's head: value, index, position
  __shared__ int hi[SMAX][TM];
  __shared__ int hp[SMAX][TM];
  const int t = threadIdx.x;
  const int row = blockIdx.x * TM + t;
  if (row >= N) return;
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)s * N + row) * k;
    hv[s][t] = part_d[o];
    hi[s][t] = part_i[o];
    hp[s][t] = 0;
  }
  for (int p = 0; p < k; ++p) {
    int best = 0;
    float bv = hv[0][t];
    int bi = hi[0][t];
    for (int s = 1; s < S; ++s)
      if (less_than(hv[s][t], hi[s][t], bv, bi)) {
        best = s;
        bv = hv[s][t];
        bi = hi[s][t];
      }
    out_d[(size_t)row * k + p] = sqrtf(bv);
    out_i[(size_t)row * k + p] = bi;
    const int next = ++hp[best][t];
    const size_t o = ((size_t)best * N + row) * k + next;
    hv[best][t] = next < k ? part_d[o] : INFINITY;
    hi[best][t] = next < k ? part_i[o] : INT32_MAX;
  }
}

}  // namespace

// x: N rows of width D (a multiple of 4, zero-padded past the true width),
// contiguous, base on 16 bytes.  out_d / out_i: [N, k].  part_d / part_i:
// [S, N, k] scratch, unused (may be null) at S = 1.
extern "C" int mmf_knn(const void* x, void* out_d, void* out_i, void* part_d, void* part_i,
                       int N, int D, int k, int S, void* stream) {
  if (N < 1 || k < 1 || k > KMAX || k > N || S < 1 || S > SMAX || D < 0 || D % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || (S > 1 && (part_d == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int max_smem = (STAGE_FLOATS + 2 * TM * KMAX) * 4;  // above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      knn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = (STAGE_FLOATS + 2 * TM * k) * 4;
  const int tiles = (N + TM - 1) / TM;
  const int tiles_per_seg = (tiles + S - 1) / S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  knn_partial_kernel<<<dim3(tiles, S), NT, smem, st>>>(
      static_cast<const float*>(x), static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), N, D, k, tiles_per_seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  knn_merge_kernel<<<tiles, TM, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), N, k, S);
  return static_cast<int>(cudaGetLastError());
}
