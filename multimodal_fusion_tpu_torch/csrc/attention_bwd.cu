// Fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_fusion_tpu/ops/pallas_attention.py:
// _attn_bwd_kernel (called from _fused_attention_bwd_hxd).  Given q, k, v,
// the output cotangent do, the forward's row max m and pre-dropout exp-sum
// l, and dsum = rowsum(do * o) (computed outside, as the JAX VJP does), it
// recomputes the probabilities and returns dq, dk and dv:
//
//   s  = q k^T * scale, a user-masked key's score REPLACED by -1e9
//   p  = exp(s - m) * (1 / l)
//   dp = do v^T;  with dropout: pd = keep ? p / (1 - rate) : 0 and
//        dp = keep ? dp / (1 - rate) : 0 (the forward's hash mask at the
//        absolute (head, q, k) index, per-case or shared seed)
//   ds = p * (dp - dsum) * scale, 0 on masked keys and rows past Tq
//   dq = ds k,  dk = ds^T q,  dv = pd^T do
//
// Keys past Tk take no part.  An all-masked row gets the uniform p = 1/l
// (dv flows) and ds = 0 (dq = dk = 0), as the forward's where makes every
// score a constant.  Scores, p, ds and every sum are float32 (bf16 products
// are exact in f32: the narrow routes widen bf16 inputs, the general route
// accumulates its mma.sync products in f32), ds is rounded to bf16 before
// the dq and dk products and pd before the dv product, as the JAX kernel
// casts them to the operand dtype; outputs are stored in the input dtype.
// The float32 path runs true f32 FMAs (no TF32).
//
// Deterministic, no atomics.  Three routes (the wrapper picks one by shape,
// ops/attention_kernel.py):
//
// general (both sides > NARROW; MFMF config1's blocks 2 and 3, the bag
//   shape).  The streamed tiles pass through a two-slot ring of 16-byte
//   cp.async copies (tile j+1 copies while tile j computes).  Keys go in
//   runs of 16: where a case has a valid key, a run without one is skipped
//   (its p is 0 in float32), the kernels streaming or owning rows gathered
//   from the list of runs with work.
//   float32, one pass (where the short side's gradient fits OP_ACC bytes,
//   hd <= 64: config1's blocks, whose short side is 512 q rows or 512
//   keys): each (row, key) pair's s, dp, p, pd and ds are formed once and
//   feed all three gradients, 5 products where 5 are the least.  A block
//   owns keys and streams q rows: where Tk >= Tq a span of keys against
//   every q row (dk and dv complete in place, dq summed over the spans),
//   else every key against a span of q rows (dq complete in the block, dk
//   and dv summed over the spans).  The sum over spans goes through float32
//   partials that a second launch adds in span order (see OnePass).
//   float32 otherwise (the bag shape): two launches, dkdv (a block owns 64
//   keys, 32 at hd 128, and walks every q tile) and dq (a block owns 64 q
//   rows and walks the key tiles), each recomputing s and dp, 7 products in
//   all.  Each owned row's 16-dim slices of q and do (k and v) live in
//   registers (one row a thread at hd 16, two wider), and the thread's
//   outputs sum over its interleaved share of the streamed columns, 8
//   float4 shared loads per column and row pair for 64 FMAs a row; a fixed
//   butterfly adds the shares (see GenF32).  dq streams tiles gathered from
//   the list of runs with work; dkdv spreads its runs with work over all its
//   threads.
//   bf16: two launches as the float32 pair, mma.sync m16n8k16 for all five
//   products, fragments by ldmatrix / ldmatrix.trans as K3's bf16 route; ds
//   and pd are re-packed in registers as A operands after their bf16
//   rounding.  p comes from the saved m and
//   1/l through the SFU's exp2 (grad_fast).  hd is instantiated at 16, 32,
//   64 and 128 (hd 16 unpadded).
// narrow_k (Tk <= NARROW; MFMF config0's block 3, 4096 q rows against 5
//   keys): the keys' k and v sit whole in shared memory; each q row belongs
//   to HD/16 lanes (16 dims each, 16-byte loads) that compute s, dp, p, pd
//   and ds against every key, so its dq row is complete in place.  dk and dv
//   are sums over the long q axis: each block sums its 128/(HD/16) rows in a
//   fixed order through shared memory, and a second small launch adds the
//   blocks' float32 partials in chunk order.
// narrow_q (Tq <= NARROW; config0's blocks 1 and 2, 5 rows against 512 or
//   4096 keys): the mirror image.  q, do and the row statistics sit in
//   shared memory, each key belongs to HD/16 lanes, its dk and dv rows are
//   complete in place, and dq is the fixed-order sum.  A user-masked key
//   reads neither k nor v (its ds is 0 and its pd needs only m and l).
// The narrow routes instantiate hd 16, 32, 64 and 128 (no padding of hd 16).
//
// Bound on the H100: the work is 5 products of 2*Tq*Tk*hd per (batch,
// head), 10*B*H*Tq*Tk*hd FLOPs (counting the keys a case keeps), against q,
// k, v, do, dq, dk, dv bytes (m, l and dsum beside them).  At MFMF
// config0's shapes (hd = 16, Tq or Tk = 5) the bytes of the long side bound
// it: the narrow routes read each long-side row once.  At config1's general
// shapes ([512 x 4096] and [4096 x 512], hd 16) the float32 operations
// bound it (67 TFLOP/s without tensor cores); the one-pass route spends the
// 5 products and one exp and mask a pair, where the pair of launches spent 7
// and two.  Not yet done: wgmma and an error-compensated 3xTF32 float32
// path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace mmf_attn;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* mask;  // [B or 1, Tk], 1 = keep; null = no mask
  const int* seeds;     // [B] per-case dropout seeds; null = ``seed`` for all
  const float* m;       // [B, H, Tq] forward row max
  const float* l;       // [B, H, Tq] forward pre-dropout exp-sum
  const float* dsum;    // [B, H, Tq] rowsum(do * o)
  void* dq;             // [B, Tq, H, hd] contiguous
  void* dk;             // [B, Tk, H, hd] contiguous
  void* dv;             // [B, Tk, H, hd] contiguous
  float* part;          // narrow routes' per-block partials (workspace); null when one chunk
  int B, H, Tq, Tk, hd;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh, mask_sb;
  float scale, keep_scale;
  uint32_t threshold, seed;
  int dropout;
};

// p, pd and ds of one (row, key) pair: a masked key keeps pd (an all-masked
// row takes the uniform p) and gets ds = 0; keys past Tk and rows past Tq
// take no part.  Returns ds and pd rounded to T.
template <typename T>
__device__ __forceinline__ void grad_pair(const BwdParams& p, float s, float dp, float rm, float rr,
                                          float rd, bool valid, int8_t st, uint32_t seed, int h,
                                          int gq, int gk, float& ds, float& pd) {
  const float sv = st == kMasked ? kNegInf : s * p.scale;
  const float pr = expf(sv - rm) * rr;
  float pdv = pr, dpv = dp;
  if (p.dropout) {
    const bool kp = keep(seed, p.threshold, p.Tq, p.Tk, h, gq, gk);
    pdv = kp ? pr * p.keep_scale : 0.f;
    dpv = kp ? dpv * p.keep_scale : 0.f;
  }
  float dsv = pr * (dpv - rd) * p.scale;
  if (st != kValid || !valid) dsv = 0.f;
  if (st == kOutside || !valid) pdv = 0.f;
  ds = round_to<T>(dsv);
  pd = round_to<T>(pdv);
}

// a [rows, hd] output of one (batch, head): element (row, d) of a
// contiguous [B, rows, H, hd] tensor
template <typename T>
__device__ __forceinline__ T* out_row(void* out, const BwdParams& p, int b, int h, int rows, int row) {
  return static_cast<T*>(out) + ((static_cast<long long>(b) * rows + row) * p.H + h) * p.hd;
}

// ------------------------------------------------------- general route
//
// The pair of launches (bf16, and float32 where the short side is long
// too).  dkdv: a block owns GR keys (x1 = k, x2 = v) and walks every q tile
// (y1 = q, y2 = do), summing dk += ds y1 and dv += pd y2.  dq: a block owns
// GR q rows (x1 = q, x2 = do) and walks the key tiles (y1 = k, y2 = v),
// summing dq += ds y1.  s = x1 . y1 and dp = x2 . y2 either way: both
// launches recompute them.  The float32 one-pass route below forms them
// once.
//
// Skipping: for a case with at least one valid key, a user-masked key has
// p = exp(-1e9 - m) / l == 0 exactly in float32 (m is at least that valid
// key's score), so its pd and ds are 0: it adds nothing to dq and has dk =
// dv = 0.  Keys are taken in runs of SUB: a dq block streams only the runs
// holding a valid key (the key tiles are gathered from a list of them, so
// a tile is 4 such runs), and a dkdv block computes only its owned runs
// holding one (their rows spread over all its threads), writes zeros for
// the rest, and returns at once when it owns none.  An all-masked case is
// dq = 0 outright, and its dkdv takes every run (the uniform p carries dv).
// The listing (case_has_valid, list_runs, copy_run_tile) is
// attention_common.cuh's, shared with K3's float32 general route.

constexpr int STAGES = 2;    // streamed-tile ring depth: tile j+1 copies while tile j computes
constexpr int GC = 64;       // streamed rows per tile
constexpr int MAXR = 1024;   // key runs listed at a time by a dq block (16384 keys)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; 0 below 2^-126)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p, pd and ds of one (row, key) pair on the general route, from factors
// fixed per row or per key: m2 = m * log2(e) and r = 1/l of the q row (r =
// 0 for a row past Tq, which zeroes its p), cs = scale for a valid key (0
// for a masked one or one past Tk: ds = 0), pf = 1 where pd flows (a valid
// key, or any key below Tk of an all-masked case) and 0 elsewhere.  The
// exponent s*scale - m is clamped at 0: a valid key's recomputed score can
// pass the forward's m by a rounding, a masked key's can pass it by far
// (its p then goes unused through cs = pf = 0), and an all-masked case's m
// of -1e9 sends every key to 0, the uniform p = 1/l.  sl = scale * log2(e).
template <typename T>
__device__ __forceinline__ void grad_fast(const BwdParams& p, float sl, float s, float dp, float m2, float r,
                                          float dsum, float cs, float pf, uint32_t seed, int h, int gq,
                                          int gk, float& ds, float& pd) {
  const float pr = exp2_fast(fminf(fmaf(s, sl, -m2), 0.f)) * r;
  float pdv = pr * pf, dpv = dp;
  if (p.dropout) {
    const bool kp = keep(seed, p.threshold, p.Tq, p.Tk, h, gq, gk);
    pdv = kp ? pdv * p.keep_scale : 0.f;
    dpv = kp ? dpv * p.keep_scale : 0.f;
  }
  ds = round_to<T>((dpv - dsum) * (pr * cs));
  pd = round_to<T>(pdv);
}

// a key's ds factor (cs) and pd factor (pf) for grad_fast
__device__ __forceinline__ float key_cs(const BwdParams& p, int8_t st) { return st == kValid ? p.scale : 0.f; }
__device__ __forceinline__ float key_pf(int8_t st, bool has_valid) {
  return (st == kValid || (!has_valid && st == kMasked)) ? 1.f : 0.f;
}

// The streamed columns of tile t, read into registers of threads tid < GC
// before a tile's products and stored into the ring after them (read after
// the next barrier): a dq tile's key states (from the run list), a dkdv
// tile's q rows' m * log2(e), 1/l and dsum.
template <int C = GC>
struct KeyCols {
  int8_t st[STAGES][C];
};
template <int C = GC>
struct RowCols {
  float m2[STAGES][C], r[STAGES][C], d[STAGES][C];
};

// zero rows [r0, r0 + n) (clipped to ``rows``) of a [B, rows, H, hd] output
template <typename T>
__device__ __forceinline__ void zero_rows(void* out, const BwdParams& p, int b, int h, int rows, int r0,
                                          int n) {
  const int n_rows = min(n, rows - r0);
  for (int i = threadIdx.x; i < n_rows * p.hd; i += NT)
    store(out_row<T>(out, p, b, h, rows, r0 + i / p.hd) + i % p.hd, 0.f);
}

// A dkdv block's owned runs with work, as a bit mask over its GR / SUB runs
// (the owned keys' states into own_state).  Every thread must call it.
template <int GR>
__device__ __forceinline__ unsigned own_runs(const BwdParams& p, int b, int k0, bool has_valid,
                                             int8_t* own_state, unsigned* own_mask) {
  const int tid = threadIdx.x;
  if (tid < GR) {  // whole warps: GR is 32 or 64
    const int8_t st = key_state(p.mask, p.mask_sb, p.Tk, b, k0 + tid);
    own_state[tid] = st;
    const unsigned use = __ballot_sync(0xffffffffu, has_valid ? st == kValid : st != kOutside);
    if ((tid & 31) == 0)
      own_mask[tid >> 5] = ((use & 0xffffu) != 0u ? 1u : 0u) | ((use >> 16) != 0u ? 2u : 0u);
  }
  __syncthreads();
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < GR / 32; ++w) mask |= own_mask[w] << (2 * w);
  return mask;
}

// the index of the (k+1)-th set bit of a run mask (k < popc(mask))
__device__ __forceinline__ int nth_run(unsigned mask, int k) {
  for (int i = 0; i < k; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// ---------------------------------------------- general route, float32
//
// Each owned row belongs to L = HD/16 lanes; a lane keeps a 16-dim slice of
// the row's two operands (x1, x2) in registers for the whole launch, I rows
// a thread (GenF32), beside its slices of the row's outputs.  The threads
// that hold the same row slices (a column group each) take interleaved streamed
// columns: for each column a thread reads the column's y1 and y2 slices
// from shared memory (8 float4 loads, the lanes of a warp hitting distinct
// bank groups), forms s and dp for its rows (a butterfly over the L lanes
// when L > 1), p, pd and ds (grad_fast), and adds ds * y1 (and pd * y2)
// into its outputs: 4 * 16 FMAs (dkdv; 3 * 16 dq) per row and column
// against 8 shared loads a column.  At the end a fixed butterfly adds the
// column groups' partial sums, so every order is fixed: no atomics, bit-identical
// launches.  A lane's slice is the float4 groups g with g % L == its lane
// in the row, so the L lanes of a row read neighbouring 16-byte chunks.  A
// dkdv block spreads the rows of its runs with work over all 128 threads
// (fewer rows, more column groups).  True float32 FMAs, no TF32.

template <int HD>
struct GenF32 {
  static constexpr int L = HD / 16;               // lanes per owned row
  // hd 16 (MFMF's): one owned row a thread, 128 registers, 4 blocks an SM,
  // 128-row streamed tiles (on the H100 the occupancy outweighs the shared
  // loads each column's y1, y2 then serve one row); wider: two rows a
  // thread, 2 blocks, 64-row tiles
  static constexpr int I = HD == 16 ? 1 : 2;      // owned rows per thread
  static constexpr int MINB = HD == 16 ? 4 : 2;   // blocks per SM the registers allow
  static constexpr int C = HD == 16 ? 128 : 64;   // streamed rows per tile
  static constexpr int GR = HD == 128 ? 32 : 64;  // owned rows per block
  static constexpr int CG = NT * I / (GR * L);    // column groups with every row owned
  static constexpr int LD = HD == 32 ? 40 : HD + 4;  // tile row stride (floats): the rows
                                                  // one load reads sit on distinct bank groups
  static constexpr int TILE = C * LD;
  static constexpr size_t smem = sizeof(float) * 2 * STAGES * TILE;
  // every owned row slice has a thread: at least one column group
  static_assert(NT * I >= GR * L, "GenF32: fewer threads than owned row slices");
};

// the 16 dims of slice s (float4 groups s, s + L, s + 2L, s + 3L) of a
// global row, zero at and past hd; the row is 16-byte aligned
template <int L>
__device__ __forceinline__ void load_groups(float (&x)[16], const float* row, int s, int hd) {
#pragma unroll
  for (int dd = 0; dd < 4; ++dd) {
    const int d = 4 * (s + L * dd);
    if (d + 4 <= hd) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + d));
      x[4 * dd] = v.x;
      x[4 * dd + 1] = v.y;
      x[4 * dd + 2] = v.z;
      x[4 * dd + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * dd + e] = d + e < hd ? row[d + e] : 0.f;
    }
  }
}

// the same slice of a shared tile row (HD wide, zero-filled past hd)
template <int L>
__device__ __forceinline__ void smem_groups(float (&x)[16], const float* row, int s) {
#pragma unroll
  for (int dd = 0; dd < 4; ++dd) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * (s + L * dd));
    x[4 * dd] = v.x;
    x[4 * dd + 1] = v.y;
    x[4 * dd + 2] = v.z;
    x[4 * dd + 3] = v.w;
  }
}

// the slice's dot: two FMA chains (dims 0-7, 8-15) then their sum
__device__ __forceinline__ float dot_slice(const float (&a)[16], const float (&b)[16]) {
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    lo = fmaf(a[d], b[d], lo);
    hi = fmaf(a[d + 8], b[d + 8], hi);
  }
  return lo + hi;
}

// the float4 groups dd with dd % cgs == cg of a row slice, dims below hd
template <int L>
__device__ __forceinline__ void store_groups(float* row, const float (&x)[16], int s, int cg, int cgs, int hd) {
#pragma unroll
  for (int dd = 0; dd < 4; ++dd) {
    if (dd % cgs != cg) continue;
    const int d = 4 * (s + L * dd);
    if (hd % 4 == 0 && d + 4 <= hd) {
      *reinterpret_cast<float4*>(row + d) = make_float4(x[4 * dd], x[4 * dd + 1], x[4 * dd + 2], x[4 * dd + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < hd) row[d + e] = x[4 * dd + e];
    }
  }
}

// the partial sums of the cgs column groups (lanes L, 2L, ... apart), added
// by a fixed butterfly; every lane of the warp takes part
template <int L, int I>
__device__ __forceinline__ void sum_groups(float (&acc)[I][16], int cgs) {
  for (int off = L; off < L * cgs; off <<= 1)
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int d = 0; d < 16; ++d) acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], off);
}

template <int HD>
__global__ void __launch_bounds__(NT, GenF32<HD>::MINB) attn_bwd_dkdv_f32_kernel(const BwdParams p) {
  using G = GenF32<HD>;
  constexpr int L = G::L, I = G::I, GR = G::GR, LD = G::LD, TILE = G::TILE, C = G::C;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [STAGES][C][LD] q tiles
  float* Ds = Qs + STAGES * TILE;                 // do tiles
  __shared__ RowCols<C> cols;
  __shared__ int8_t own_state[GR];
  __shared__ unsigned own_mask[GR / 32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * GR;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  const float sl = p.scale * kLog2e;
  const bool has_valid = case_has_valid(p.mask, p.mask_sb, p.Tk, b);
  const unsigned on = own_runs<GR>(p, b, k0, has_valid, own_state, own_mask);
  for (int r = 0; r < GR / SUB; ++r) {
    if (on & (1u << r)) continue;
    zero_rows<float>(p.dk, p, b, h, p.Tk, k0 + r * SUB, SUB);
    zero_rows<float>(p.dv, p, b, h, p.Tk, k0 + r * SUB, SUB);
  }
  if (on == 0u) return;

  // the runs with work, padded to a power of two, spread over the block:
  // n_rows owned rows, cgs column groups (columns cg + cgs * j)
  const int n_on = __popc(on);
  const int n_rows = SUB * (n_on == 1 ? 1 : n_on == 2 ? 2 : 4);
  const int cgs = NT * I / (n_rows * L);
  const int s = tid % L;
  const int cg = (tid / L) % cgs;
  const int rg = tid / (L * cgs);

  auto fill = [&](int t) {  // tile t into its ring slot
    const int slot = t % STAGES;
    copy_tile<float, HD, LD, C>(Qs + slot * TILE, qg, p.q_st, t * C, p.Tq, p.hd);
    copy_tile<float, HD, LD, C>(Ds + slot * TILE, dg, p.do_st, t * C, p.Tq, p.hd);
  };
  float nm2 = 0.f, nr = 0.f, nd = 0.f;
  auto fetch = [&](int t) {
    const int c = t * C + tid;
    if (tid < C) {
      const bool in = c < p.Tq;
      nm2 = in ? p.m[stat0 + c] * kLog2e : 0.f;
      nr = in ? 1.f / p.l[stat0 + c] : 0.f;
      nd = in ? p.dsum[stat0 + c] : 0.f;
    }
  };
  auto put = [&](int t) {
    if (tid < C) {
      cols.m2[t % STAGES][tid] = nm2;
      cols.r[t % STAGES][tid] = nr;
      cols.d[t % STAGES][tid] = nd;
    }
  };
  const int n_tiles = (p.Tq + C - 1) / C;
  fill(0);
  cp_async_commit();
  fetch(0);
  put(0);

  // this thread's owned keys: k and v slices, their ds and pd factors
  // (padding rows past the runs with work stay zero and add nothing)
  float xa[I][16], xb[I][16], cs[I], pf[I];
  int krow[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int ci = rg + (n_rows / I) * i;  // compacted row
    const int run = ci / SUB < n_on ? nth_run(on, ci / SUB) : -1;
    krow[i] = run < 0 ? -1 : run * SUB + ci % SUB;
    const int gk = k0 + krow[i];
#pragma unroll
    for (int d = 0; d < 16; ++d) xa[i][d] = xb[i][d] = 0.f;
    cs[i] = pf[i] = 0.f;
    if (krow[i] >= 0 && gk < p.Tk) {
      load_groups<L>(xa[i], kg + gk * p.k_st, s, p.hd);
      load_groups<L>(xb[i], vg + gk * p.v_st, s, p.hd);
      cs[i] = key_cs(p, own_state[krow[i]]);
      pf[i] = key_pf(own_state[krow[i]], has_valid);
    }
  }
  float acc1[I][16], acc2[I][16];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int d = 0; d < 16; ++d) acc1[i][d] = acc2[i][d] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t landed for this thread
    __syncthreads();     // ... for every thread, with its rows' statistics; slot t+1 is free
    if (t + 1 < n_tiles) {
      fill(t + 1);
      fetch(t + 1);
    }
    cp_async_commit();
    const int slot = t % STAGES;
    const float* Qt = Qs + slot * TILE;
    const float* Dt = Ds + slot * TILE;
#pragma unroll 2
    for (int c = cg; c < C; c += cgs) {
      float ya[16], yb[16];
      smem_groups<L>(ya, Qt + c * LD, s);
      smem_groups<L>(yb, Dt + c * LD, s);
      const float m2 = cols.m2[slot][c], r = cols.r[slot][c], dsum = cols.d[slot][c];
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const float sv = lane_sum<L>(dot_slice(xa[i], ya));
        const float dpv = lane_sum<L>(dot_slice(xb[i], yb));
        float ds, pd;
        grad_fast<float>(p, sl, sv, dpv, m2, r, dsum, cs[i], pf[i], seed, h, t * C + c, k0 + krow[i], ds, pd);
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          acc1[i][d] = fmaf(ds, ya[d], acc1[i][d]);
          acc2[i][d] = fmaf(pd, yb[d], acc2[i][d]);
        }
      }
    }
    if (t + 1 < n_tiles) put(t + 1);
  }
  cp_async_wait<0>();  // no copy outlives the block

  sum_groups<L, I>(acc1, cgs);
  sum_groups<L, I>(acc2, cgs);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int gk = k0 + krow[i];
    if (krow[i] < 0 || gk >= p.Tk) continue;
    store_groups<L>(out_row<float>(p.dk, p, b, h, p.Tk, gk), acc1[i], s, cg, cgs, p.hd);
    store_groups<L>(out_row<float>(p.dv, p, b, h, p.Tk, gk), acc2[i], s, cg, cgs, p.hd);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, GenF32<HD>::MINB) attn_bwd_dq_f32_kernel(const BwdParams p) {
  using G = GenF32<HD>;
  constexpr int L = G::L, I = G::I, GR = G::GR, CG = G::CG, LD = G::LD, TILE = G::TILE, C = G::C;
  constexpr int RG = GR / I;  // row groups: rows rg + RG * i
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);  // [STAGES][C][LD] key tiles (4 listed runs)
  float* Vs = Ks + STAGES * TILE;                 // value tiles
  __shared__ KeyCols<C> cols;
  __shared__ int runs[MAXR];
  __shared__ int wsum[NT / 32];

  const int tid = threadIdx.x;
  const int s = tid % L;          // this lane's slice of its rows
  const int cg = (tid / L) % CG;  // its column group: columns cg + CG * j
  const int rg = tid / (L * CG);  // its row group
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * GR;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  const float sl = p.scale * kLog2e;
  if (!case_has_valid(p.mask, p.mask_sb, p.Tk, b)) {  // every ds is 0
    zero_rows<float>(p.dq, p, b, h, p.Tq, q0, GR);
    return;
  }

  // this thread's q rows: q and do slices and statistics (r = 0 past Tq)
  float xa[I][16], xb[I][16], m2[I], rr[I], rd[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + rg + RG * i;
#pragma unroll
    for (int d = 0; d < 16; ++d) xa[i][d] = xb[i][d] = 0.f;
    m2[i] = rr[i] = rd[i] = 0.f;
    if (row < p.Tq) {
      load_groups<L>(xa[i], qg + row * p.q_st, s, p.hd);
      load_groups<L>(xb[i], dg + row * p.do_st, s, p.hd);
      m2[i] = p.m[stat0 + row] * kLog2e;
      rr[i] = 1.f / p.l[stat0 + row];
      rd[i] = p.dsum[stat0 + row];
    }
  }
  float acc[I][16];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int d = 0; d < 16; ++d) acc[i][d] = 0.f;

  const int n_runs = (p.Tk + SUB - 1) / SUB;
  for (int r0 = 0; r0 < n_runs; r0 += MAXR) {
    const int n = list_runs(p.mask, p.mask_sb, p.Tk, b, r0, min(MAXR, n_runs - r0), true, runs, wsum);
    const int n_tiles = (n + C / SUB - 1) / (C / SUB);
    auto fill = [&](int t) {  // tile t into its ring slot
      const int slot = t % STAGES;
      copy_run_tile<float, HD, LD, C>(Ks + slot * TILE, kg, p.k_st, runs, t * (C / SUB), n, p.Tk, p.hd);
      copy_run_tile<float, HD, LD, C>(Vs + slot * TILE, vg, p.v_st, runs, t * (C / SUB), n, p.Tk, p.hd);
    };
    int8_t nst = kOutside;
    auto fetch = [&](int t) {
      if (tid < C) {
        const int e = t * (C / SUB) + tid / SUB;
        nst = key_state(p.mask, p.mask_sb, p.Tk, b, e < n ? runs[e] * SUB + tid % SUB : p.Tk);
      }
    };
    if (n_tiles > 0) {
      fill(0);
      fetch(0);
      if (tid < C) cols.st[0][tid] = nst;
    }
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<0>();
      __syncthreads();
      if (t + 1 < n_tiles) {
        fill(t + 1);
        fetch(t + 1);
      }
      cp_async_commit();
      const int slot = t % STAGES;
      const float* Kt = Ks + slot * TILE;
      const float* Vt = Vs + slot * TILE;
      const int n_in = min(C / SUB, n - t * (C / SUB));  // listed runs in this tile
#pragma unroll 1
      for (int run = 0; run < n_in; ++run) {
        const int gk0 = runs[t * (C / SUB) + run] * SUB;
#pragma unroll 2
        for (int jq = 0; jq < SUB / CG; ++jq) {
          const int c = run * SUB + cg + CG * jq;
          float ya[16], yb[16];
          smem_groups<L>(ya, Kt + c * LD, s);
          smem_groups<L>(yb, Vt + c * LD, s);
          const float cs = key_cs(p, cols.st[slot][c]);
#pragma unroll
          for (int i = 0; i < I; ++i) {
            const float sv = lane_sum<L>(dot_slice(xa[i], ya));
            const float dpv = lane_sum<L>(dot_slice(xb[i], yb));
            float ds, pd;
            grad_fast<float>(p, sl, sv, dpv, m2[i], rr[i], rd[i], cs, 0.f, seed, h, q0 + rg + RG * i,
                             gk0 + cg + CG * jq, ds, pd);
#pragma unroll
            for (int d = 0; d < 16; ++d) acc[i][d] = fmaf(ds, ya[d], acc[i][d]);
          }
        }
      }
      if (t + 1 < n_tiles && tid < C) cols.st[(t + 1) % STAGES][tid] = nst;
    }
    cp_async_wait<0>();
    __syncthreads();  // the next list and ring fill start after every read of these
  }

  sum_groups<L, I>(acc, CG);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + rg + RG * i;
    if (row < p.Tq) store_groups<L>(out_row<float>(p.dq, p, b, h, p.Tq, row), acc[i], s, cg, CG, p.hd);
  }
}

// ------------------------------------------ general route, float32, one pass
//
// A block owns keys (x1 = k, x2 = v in registers, as the pair's dkdv) and
// streams q rows (y1 = q, y2 = do), and every (row, key) pair's s, dp, p, pd
// and ds are formed once.  Where Tk >= Tq (MFMF config1's block 2) a block
// takes a span of SPAN keys against every q row: its keys' dk and dv are
// complete in place, and dq is summed over the spans.  Where Tq > Tk (block
// 3) a block takes every key against a span of QSPAN q rows: its rows' dq
// are complete in the block, and dk and dv are summed over the spans.  The
// block's keys are its span's runs with work (block 3: all the keys'),
// gathered into tiles of GR.  For each streamed tile of C q rows each
// thread forms its key's pairs with its interleaved share of the columns
// (grad_fast, as the pair does), adds dk += ds q and dv += pd do in
// registers and writes ds into a shared [GR][C] tile; after a barrier the
// block forms dq += ds^T k for the C rows from shared memory, a small
// product summed over the tile's GR keys in order, each thread owning R
// rows by 4 dims of the block's dq sums [rows][HD] in shared memory.  At the
// end of a key tile a fixed butterfly adds the column groups' shares of dk
// and dv.  The side summed over spans goes to the workspace as the span's
// partial (block 3: dk and dv of the listed keys, with a flag a run of keys
// written by the first span, so the other keys read 0), and
// attn_bwd_reduce_kernel adds the partials in span order.  Every sum has a
// fixed order: no atomics, bit-identical launches.  Two launches a call, the
// second even for one span.  The masks and the all-masked case work as in
// the pair: a masked key's cs = 0 gives ds = 0, an all-masked case lists
// every run below Tk and its uniform p carries dv.

constexpr int SPAN = 512;            // keys (Tk >= Tq) or at most q rows (Tq > Tk) a block
constexpr int OP_ACC = 64 * 1024;    // bytes: the short side's float32 gradient at most
constexpr int OP_RUNS = SPAN / SUB;  // key runs a block lists
static_assert(OP_ACC / (2 * 16 * 4) <= SPAN, "OnePass: the short side's runs outgrow the list");

// whether the shape takes the one-pass route: hd at most 64, both sides
// non-empty, and the short side's gradient (dq, or dk and dv) within OP_ACC
// bytes; else the pair
inline bool one_pass(int Tq, int Tk, int hd) {
  const int S = min(Tq, Tk), no = Tk >= Tq ? 1 : 2;
  return narrow_hd(hd) <= 64 && S > 0 &&
         static_cast<long long>(S) * narrow_hd(hd) * no * sizeof(float) <= OP_ACC;
}

// q rows a span where Tq > Tk: the block's dq sums hold OP_ACC / 2 bytes
constexpr int one_pass_qspan(int HD) {
  return SPAN < OP_ACC / 2 / (HD * 4) ? SPAN : OP_ACC / 2 / (HD * 4);
}

inline int one_pass_spans(int Tq, int Tk, int hd) {
  const int span = Tk >= Tq ? SPAN : one_pass_qspan(narrow_hd(hd));
  return (max(Tq, Tk) + span - 1) / span;
}

// the workspace: the spans' partials [B*H][spans][dq: Tq | dk, dv: 2][rows]
// [HD] float32, then where Tq > Tk a flag a run of keys [B*H][runs] (int)
inline long long one_pass_floats(int B, int H, int Tq, int Tk, int hd) {
  return static_cast<long long>(B) * H * one_pass_spans(Tq, Tk, hd) * (Tk >= Tq ? Tq : 2 * Tk) * narrow_hd(hd);
}
inline long long one_pass_bytes(int B, int H, int Tq, int Tk, int hd) {
  const long long flags = Tk >= Tq ? 0 : static_cast<long long>(B) * H * ((Tk + SUB - 1) / SUB);
  return sizeof(float) * one_pass_floats(B, H, Tq, Tk, hd) + sizeof(int) * flags;
}

template <int HD>
struct OnePass {
  static constexpr int L = HD / 16;               // lanes per key
  static constexpr int I = HD == 16 ? 1 : 2;      // keys per thread
  static constexpr int GR = 64;                   // keys per tile
  static constexpr int RG = GR / I;               // row groups: keys rg + RG * i
  static constexpr int CG = NT * I / (GR * L);    // column groups: q rows cg + CG * j
  static constexpr int C = HD == 16 ? 64 : 32;    // q rows per streamed tile
  static constexpr int LD = GenF32<HD>::LD;       // ring row stride (floats)
  static constexpr int LDW = C + 4;               // ds tile row stride: float4 rows
  static constexpr int QSPAN = one_pass_qspan(HD);
  // dq's product: a thread owns R q rows by 4 dims, CH times
  static constexpr int R = C * HD / (4 * NT) < 4 ? C * HD / (4 * NT) : 4;
  static constexpr int CH = C * HD / (4 * R * NT);
  // hd 16: 3 blocks an SM (the shared memory allows 3 at 512 q rows)
  static constexpr int MINB = HD == 16 ? 3 : 1;
  static constexpr size_t fixed = sizeof(float) * (2 * STAGES * C * LD + GR * (HD + LDW));
  static size_t smem(int rows) { return fixed + sizeof(float) * rows * HD; }
  static_assert(CG >= 1 && CG * GR * L == NT * I, "OnePass: threads do not tile the keys");
  static_assert(R >= 1 && CH * R * 4 * NT == C * HD, "OnePass: threads do not tile dq's product");
  static_assert(GR % SUB == 0 && SPAN % GR == 0, "OnePass: key tiles are whole runs");
};

// R (2 or 4) consecutive floats of a shared row, 8R-byte aligned
template <int R>
__device__ __forceinline__ void load_vec(float (&w)[R], const float* src) {
  static_assert(R == 2 || R == 4, "load_vec: two or four floats");
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    w[0] = v.x;
    w[1] = v.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, OnePass<HD>::MINB) attn_bwd_onepass_f32_kernel(const BwdParams p) {
  using O = OnePass<HD>;
  constexpr int L = O::L, I = O::I, GR = O::GR, RG = O::RG, CG = O::CG, C = O::C, LD = O::LD;
  constexpr int LDW = O::LDW, R = O::R, TILE = C * LD;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [STAGES][C][LD] q tiles
  float* Ds = Qs + STAGES * TILE;                 // do tiles
  float* Ks = Ds + STAGES * TILE;                 // [GR][HD] the key tile's k, for dq
  float* Ws = Ks + GR * HD;                       // [GR][LDW] the tile's ds
  float* dqs = Ws + GR * LDW;                     // [rows][HD] the block's dq sums
  __shared__ RowCols<C> cols;
  __shared__ int runs[OP_RUNS];
  __shared__ int wsum[NT / 32];

  const int tid = threadIdx.x;
  const int s = tid % L;          // this lane's slice of its keys
  const int cg = (tid / L) % CG;  // its column group
  const int rg = tid / (L * CG);  // its row group
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int span = blockIdx.y;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  const float sl = p.scale * kLog2e;
  const bool kl = p.Tk >= p.Tq;  // spans of keys (dq summed over them), else of q rows (dk, dv)
  const int k0 = kl ? span * SPAN : 0;
  const int kn = kl ? min(SPAN, p.Tk - k0) : p.Tk;
  const int q0 = kl ? 0 : span * O::QSPAN;
  const int qn = kl ? p.Tq : min(O::QSPAN, p.Tq - q0);
  const bool has_valid = case_has_valid(p.mask, p.mask_sb, p.Tk, b);
  float* part = p.part + static_cast<long long>(bh) * gridDim.y * (kl ? p.Tq : 2 * p.Tk) * HD;

  for (int i = tid; i < qn * HD; i += NT) dqs[i] = 0.f;
  const int run0 = k0 / SUB;
  const int n_runs = (kn + SUB - 1) / SUB;
  const int n = list_runs(p.mask, p.mask_sb, p.Tk, b, run0, n_runs, has_valid, runs, wsum);
  if (kl) {  // the span's keys in runs without work: dk = dv = 0
    for (int r = 0, e = 0; r < n_runs; ++r) {
      if (e < n && runs[e] == run0 + r) {
        ++e;
        continue;
      }
      zero_rows<float>(p.dk, p, b, h, p.Tk, (run0 + r) * SUB, SUB);
      zero_rows<float>(p.dv, p, b, h, p.Tk, (run0 + r) * SUB, SUB);
    }
  } else if (span == 0) {  // which runs the spans' partials hold
    int* flags = reinterpret_cast<int*>(p.part + static_cast<long long>(gridDim.x) * gridDim.y * 2 * p.Tk * HD);
    for (int r = tid; r < n_runs; r += NT) {
      bool on = false;
      for (int e = 0; e < n; ++e) on |= runs[e] == r;
      flags[static_cast<long long>(bh) * n_runs + r] = on;
    }
  }
  const int n_lt = (n * SUB + GR - 1) / GR;
  const int n_st = (qn + C - 1) / C;

  for (int lt = 0; lt < n_lt; ++lt) {
    copy_run_tile<float, HD, HD, GR>(Ks, kg, p.k_st, runs, lt * (GR / SUB), n, p.Tk, p.hd);
    auto fill = [&](int t) {  // q tile t into its ring slot
      const int slot = t % STAGES;
      copy_tile<float, HD, LD, C>(Qs + slot * TILE, qg, p.q_st, q0 + t * C, q0 + qn, p.hd);
      copy_tile<float, HD, LD, C>(Ds + slot * TILE, dg, p.do_st, q0 + t * C, q0 + qn, p.hd);
    };
    // the tile's rows' m * log2(e), 1/l and dsum, read into registers of
    // threads tid < C with the tile's copies and stored after its products
    float nm2 = 0.f, nr = 0.f, nd = 0.f;
    auto fetch = [&](int t) {
      const int c = q0 + t * C + tid;
      if (tid < C) {
        const bool in = c < q0 + qn;
        nm2 = in ? p.m[stat0 + c] * kLog2e : 0.f;
        nr = in ? 1.f / p.l[stat0 + c] : 0.f;
        nd = in ? p.dsum[stat0 + c] : 0.f;
      }
    };
    auto put = [&](int t) {
      if (tid < C) {
        cols.m2[t % STAGES][tid] = nm2;
        cols.r[t % STAGES][tid] = nr;
        cols.d[t % STAGES][tid] = nd;
      }
    };
    fill(0);
    cp_async_commit();
    fetch(0);
    put(0);

    // this thread's keys: k and v slices, their ds and pd factors (zero past the list)
    float xa[I][16], xb[I][16], cs[I], pf[I];
    int gk[I];
#pragma unroll
    for (int i = 0; i < I; ++i) {
      gk[i] = run_key(runs, lt * (GR / SUB), n, rg + RG * i, p.Tk);
#pragma unroll
      for (int d = 0; d < 16; ++d) xa[i][d] = xb[i][d] = 0.f;
      cs[i] = pf[i] = 0.f;
      if (gk[i] < p.Tk) {
        load_groups<L>(xa[i], kg + gk[i] * p.k_st, s, p.hd);
        load_groups<L>(xb[i], vg + gk[i] * p.v_st, s, p.hd);
        const int8_t st = key_state(p.mask, p.mask_sb, p.Tk, b, gk[i]);
        cs[i] = key_cs(p, st);
        pf[i] = key_pf(st, has_valid);
      }
    }
    float acc1[I][16], acc2[I][16];  // dk, dv
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int d = 0; d < 16; ++d) acc1[i][d] = acc2[i][d] = 0.f;

    for (int t = 0; t < n_st; ++t) {
      cp_async_wait<0>();  // q tile t (and the key tile) landed for this thread
      __syncthreads();     // ... for every thread; the ds tile and slot t+1 are free
      if (t + 1 < n_st) {
        fill(t + 1);
        fetch(t + 1);
      }
      cp_async_commit();
      const int slot = t % STAGES;
      const float* Qt = Qs + slot * TILE;
      const float* Dt = Ds + slot * TILE;
#pragma unroll 2
      for (int c = cg; c < C; c += CG) {
        float ya[16], yb[16];
        smem_groups<L>(ya, Qt + c * LD, s);
        smem_groups<L>(yb, Dt + c * LD, s);
        const float m2 = cols.m2[slot][c], r = cols.r[slot][c], dsum = cols.d[slot][c];
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const float sv = lane_sum<L>(dot_slice(xa[i], ya));
          const float dpv = lane_sum<L>(dot_slice(xb[i], yb));
          float ds, pd;
          grad_fast<float>(p, sl, sv, dpv, m2, r, dsum, cs[i], pf[i], seed, h, q0 + t * C + c, gk[i], ds, pd);
#pragma unroll
          for (int d = 0; d < 16; ++d) {
            acc1[i][d] = fmaf(ds, ya[d], acc1[i][d]);
            acc2[i][d] = fmaf(pd, yb[d], acc2[i][d]);
          }
          if (s == 0) Ws[(rg + RG * i) * LDW + c] = ds;
        }
      }
      if (t + 1 < n_st) put(t + 1);
      __syncthreads();  // the ds tile is whole

      // dq of the tile's rows c0 .. c0 + R - 1, dims d0 .. d0 + 3, summed
      // over the tile's keys in order
#pragma unroll
      for (int ch = 0; ch < O::CH; ++ch) {
        const int idx = tid + NT * ch;
        const int d0 = (idx % (HD / 4)) * 4;
        const int c0 = (idx / (HD / 4)) * R;
        const float* W = Ws + c0;
        const float* X = Ks + d0;
        float a[R][4];
#pragma unroll
        for (int j = 0; j < R; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < GR; ++kk) {
          float w[R];
          load_vec<R>(w, W + kk * LDW);
          const float4 x = *reinterpret_cast<const float4*>(X + kk * HD);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            a[j][0] = fmaf(w[j], x.x, a[j][0]);
            a[j][1] = fmaf(w[j], x.y, a[j][1]);
            a[j][2] = fmaf(w[j], x.z, a[j][2]);
            a[j][3] = fmaf(w[j], x.w, a[j][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int row = t * C + c0 + j;
          if (row >= qn) continue;
          float4* o = reinterpret_cast<float4*>(dqs + row * HD + d0);
          float4 v = *o;
          v.x += a[j][0];
          v.y += a[j][1];
          v.z += a[j][2];
          v.w += a[j][3];
          *o = v;
        }
      }
    }
    cp_async_wait<0>();  // no copy outlives the tile

    // the tile's dk and dv: over the block's q rows; where Tq > Tk the span's partial
    sum_groups<L, I>(acc1, CG);
    sum_groups<L, I>(acc2, CG);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      if (gk[i] >= p.Tk) continue;
      float* dk = kl ? out_row<float>(p.dk, p, b, h, p.Tk, gk[i])
                     : part + ((static_cast<long long>(span) * 2) * p.Tk + gk[i]) * HD;
      float* dv = kl ? out_row<float>(p.dv, p, b, h, p.Tk, gk[i]) : dk + static_cast<long long>(p.Tk) * HD;
      store_groups<L>(dk, acc1[i], s, cg, CG, p.hd);
      store_groups<L>(dv, acc2[i], s, cg, CG, p.hd);
    }
    __syncthreads();  // the key tile, the ring and the factors are free for the next tile
  }

  // the block's dq: over its keys; where Tk >= Tq the span's partial
  __syncthreads();
  if (kl) {
    float4* out = reinterpret_cast<float4*>(part + static_cast<long long>(span) * p.Tq * HD);
    for (int i = tid; i < qn * HD / 4; i += NT) out[i] = reinterpret_cast<const float4*>(dqs)[i];
  } else {
    for (int i = tid; i < qn * p.hd; i += NT)
      out_row<float>(p.dq, p, b, h, p.Tq, q0 + i / p.hd)[i % p.hd] = dqs[(i / p.hd) * HD + i % p.hd];
  }
}

// ------------------------------------------------- general route, bf16
//
// Tensor cores: each warp owns 16 rows and runs mma.sync m16n8k16 (bf16 in,
// f32 accumulate) for all five products, with K3's bf16 fragment layouts
// (attention.cu): the owned x1, x2 tiles and the streamed y1, y2 tiles sit
// row-major in shared memory (rows padded by 16 bytes), s = x1 y1^T and dp
// = x2 y2^T take A from ldmatrix.x4 of x and B from ldmatrix.x4 of y; ds
// (and pd) are rounded to bf16 and re-packed in registers as the A operand
// of ds y1 (pd y2), whose B comes from ldmatrix.x4.trans of row-major y.
// The dq launch streams the listed runs as the float32 one does.  A dkdv
// block spreads its runs with work over its 4 warps: with one such run all
// four take it, each a quarter of every tile's columns, and add their
// shares in warp order at the end (two runs: two warps each).

template <int HD>
constexpr size_t bf16_gen_smem() {
  return sizeof(__nv_bfloat16) * (2 * 64 + 2 * STAGES * GC) * (HD + 8);
}

// row r (0: g, 1: g + 8) of a warp's [16, HD] accumulators as bf16, the
// dims below hd; ``pairs``: rows 4-byte aligned, so bf16 pairs are stored
template <int NO>
__device__ __forceinline__ void store_acc_row(__nv_bfloat16* orow, const float (&acc)[NO][4], int r, int t4,
                                              int hd, bool pairs) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + 2 * t4;
    const float lo = acc[n][2 * r], hi = acc[n][2 * r + 1];
    if (pairs && d + 1 < hd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(lo, hi);
    } else {
      if (d < hd) orow[d] = __float2bfloat16_rn(lo);
      if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(hi);
    }
  }
}

// acc[n] += a (16 x 16 of the warp's rows, columns 16 kk..) times rows
// 16 kk.. of a row-major [GC][LDH] tile y: B fragments by ldmatrix.x4.trans
template <int NO, int LDH>
__device__ __forceinline__ void mma_rows(float (&acc)[NO][4], const uint32_t (&a)[4], const __nv_bfloat16* y,
                                         int kk, int lane) {
  const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NO / 2; ++np) {
    uint32_t yb[4];
    ldmatrix_x4_trans(yb, &y[off + np * 16]);
    mma_bf16(acc[2 * np], a, yb[0], yb[1]);
    mma_bf16(acc[2 * np + 1], a, yb[2], yb[3]);
  }
}

// the A fragment of columns 16 kk.. from score-shaped accumulators
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// hd 16 (MFMF's) keeps to 128 registers: 4 blocks an SM
template <int HD, bool DKDV>
__global__ void __launch_bounds__(NT, HD == 16 ? 4 : 1) attn_bwd_bf16_kernel(const BwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int GR = 64;       // owned rows per block, 16 a warp
  constexpr int LDH = HD + 8;  // row stride (bf16)
  constexpr int KS = HD / 16;  // k-steps of s and dp
  constexpr int NS = GC / 8;   // n-tiles of a score tile
  constexpr int NO = HD / 8;   // n-tiles of an output
  constexpr int TILE = GC * LDH;
  extern __shared__ float4 smem_f4[];
  bf16* X1s = reinterpret_cast<bf16*>(smem_f4);  // [GR][LDH] q (dq) or k (dkdv)
  bf16* X2s = X1s + GR * LDH;                    // do or v
  bf16* Y1s = X2s + GR * LDH;                    // [STAGES][GC][LDH] k or q
  bf16* Y2s = Y1s + STAGES * TILE;               // v or do
  __shared__ KeyCols<> kcols;
  __shared__ RowCols<> rcols;
  __shared__ int runs[DKDV ? 1 : MAXR];
  __shared__ int wsum[NT / 32];
  __shared__ int8_t own_state[GR];
  __shared__ unsigned own_mask[GR / 32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int o0 = blockIdx.y * GR;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dg = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int n_own = DKDV ? p.Tk : p.Tq;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  const float sl = p.scale * kLog2e;
  const bool has_valid = case_has_valid(p.mask, p.mask_sb, p.Tk, b);

  // the warp's 16 owned rows (x0) and its share of each tile's four
  // 16-column groups (those g with g % wpr == part; wpr is 1, 2 or 4): dq
  // one warp a 16 rows; dkdv the runs with work spread over the 4 warps,
  // wpr warps a run
  int x0 = warp * 16, wpr = 1, part = 0;
  bool warp_on = true;
  if constexpr (DKDV) {
    const unsigned on = own_runs<GR>(p, b, o0, has_valid, own_state, own_mask);
    for (int r = 0; r < GR / SUB; ++r) {
      if (on & (1u << r)) continue;
      zero_rows<bf16>(p.dk, p, b, h, p.Tk, o0 + r * SUB, SUB);
      zero_rows<bf16>(p.dv, p, b, h, p.Tk, o0 + r * SUB, SUB);
    }
    if (on == 0u) return;
    const int n_on = __popc(on);
    wpr = n_on == 1 ? 4 : n_on == 2 ? 2 : 1;
    part = warp % wpr;
    warp_on = warp / wpr < n_on;
    x0 = warp_on ? nth_run(on, warp / wpr) * SUB : 0;
  } else if (!has_valid) {
    zero_rows<bf16>(p.dq, p, b, h, p.Tq, o0, GR);
    return;
  }
  copy_tile<bf16, HD, LDH>(X1s, DKDV ? kg : qg, DKDV ? p.k_st : p.q_st, o0, n_own, p.hd);
  copy_tile<bf16, HD, LDH>(X2s, DKDV ? vg : dg, DKDV ? p.v_st : p.do_st, o0, n_own, p.hd);

  const int r0 = x0 + g;  // this thread's owned rows: r0 and r0 + 8
  // dq: a warp whose rows all lie past Tq only helps load (dkdv: a warp
  // beyond the runs with work)
  if constexpr (!DKDV) warp_on = o0 + warp * 16 < n_own;
  // per owned row: dq its statistics (r = 0 past Tq), dkdv its key's factors
  float m2[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f}, pf[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = o0 + r0 + 8 * r;
    if constexpr (DKDV) {
      cs[r] = key_cs(p, own_state[r0 + 8 * r]);
      pf[r] = key_pf(own_state[r0 + 8 * r], has_valid);
    } else if (row < n_own) {
      m2[r] = p.m[stat0 + row] * kLog2e;
      rr[r] = 1.f / p.l[stat0 + row];
      rd[r] = p.dsum[stat0 + row];
    }
  }
  float acc1[NO][4], acc2[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = acc2[n][e] = 0.f;

  // the streamed side: dkdv every q tile; dq the listed key runs, 4 a tile
  const int n_segs = DKDV ? 1 : ((p.Tk + SUB - 1) / SUB + MAXR - 1) / MAXR;
  for (int seg = 0; seg < n_segs; ++seg) {
    int n = 0, n_tiles = 0;
    if constexpr (DKDV) {
      n_tiles = (p.Tq + GC - 1) / GC;
    } else {
      const int n_runs = (p.Tk + SUB - 1) / SUB;
      n = list_runs(p.mask, p.mask_sb, p.Tk, b, seg * MAXR, min(MAXR, n_runs - seg * MAXR), true,
                    runs, wsum);
      n_tiles = (n + GC / SUB - 1) / (GC / SUB);
    }
    auto fill = [&](int t) {  // tile t into its ring slot
      const int slot = t % STAGES;
      if constexpr (DKDV) {
        copy_tile<bf16, HD, LDH>(Y1s + slot * TILE, qg, p.q_st, t * GC, p.Tq, p.hd);
        copy_tile<bf16, HD, LDH>(Y2s + slot * TILE, dg, p.do_st, t * GC, p.Tq, p.hd);
      } else {
        copy_run_tile<bf16, HD, LDH>(Y1s + slot * TILE, kg, p.k_st, runs, t * (GC / SUB), n, p.Tk, p.hd);
        copy_run_tile<bf16, HD, LDH>(Y2s + slot * TILE, vg, p.v_st, runs, t * (GC / SUB), n, p.Tk, p.hd);
      }
    };
    int8_t nst = kOutside;
    float nm2 = 0.f, nr = 0.f, nd = 0.f;
    auto fetch = [&](int t) {
      if (tid >= GC) return;
      if constexpr (DKDV) {
        const int c = t * GC + tid;
        const bool in = c < p.Tq;
        nm2 = in ? p.m[stat0 + c] * kLog2e : 0.f;
        nr = in ? 1.f / p.l[stat0 + c] : 0.f;
        nd = in ? p.dsum[stat0 + c] : 0.f;
      } else {
        const int e = t * (GC / SUB) + tid / SUB;
        nst = key_state(p.mask, p.mask_sb, p.Tk, b, e < n ? runs[e] * SUB + tid % SUB : p.Tk);
      }
    };
    auto put = [&](int t) {
      if (tid >= GC) return;
      if constexpr (DKDV) {
        rcols.m2[t % STAGES][tid] = nm2;
        rcols.r[t % STAGES][tid] = nr;
        rcols.d[t % STAGES][tid] = nd;
      } else {
        kcols.st[t % STAGES][tid] = nst;
      }
    };
    if (n_tiles > 0) {
      fill(0);
      fetch(0);
      put(0);
    }
    cp_async_commit();  // with the owned tiles at the first segment

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<0>();  // tile t (and the owned tiles) landed
      __syncthreads();
      if (t + 1 < n_tiles) {
        fill(t + 1);
        fetch(t + 1);
      }
      cp_async_commit();
      const int slot = t % STAGES;
      const bf16* Y1t = Y1s + slot * TILE;
      const bf16* Y2t = Y2s + slot * TILE;
      // 16-column groups of this tile with work (dq: its listed runs)
      const int n_in = DKDV ? GC / 16 : min(GC / SUB, n - t * (GC / SUB));
      // one tile's products for the warp's column share: a copy for warps
      // with every column group (WPR 1: dq, and dkdv blocks whose 4 runs all
      // hold work), whose loops keep no share test, and one (WPR 0) that
      // reads the share from wpr
      auto tile = [&](auto wpr_c) {
        constexpr int WPR = decltype(wpr_c)::value;
        const int w = WPR == 1 ? 1 : wpr;
        float sc[NS][4], dpc[NS][4];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = dpc[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t xa[4], xb[4];
          ldmatrix_x4(xa, &X1s[(x0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8]);
          ldmatrix_x4(xb, &X2s[(x0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8]);
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            if (np >= n_in || (w > 1 && (np & (w - 1)) != part)) continue;
            const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + ks * 16 + ((lane >> 3) & 1) * 8;
            uint32_t yb[4];
            ldmatrix_x4(yb, &Y1t[off]);
            mma_bf16(sc[2 * np], xa, yb[0], yb[1]);
            mma_bf16(sc[2 * np + 1], xa, yb[2], yb[3]);
            ldmatrix_x4(yb, &Y2t[off]);
            mma_bf16(dpc[2 * np], xb, yb[0], yb[1]);
            mma_bf16(dpc[2 * np + 1], xb, yb[2], yb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          if (nt / 2 >= n_in || (w > 1 && ((nt / 2) & (w - 1)) != part)) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int orow = o0 + r0 + 8 * (e >> 1);
            const int col = nt * 8 + 2 * t4 + (e & 1);
            float ds, pd;
            if constexpr (DKDV) {
              grad_fast<bf16>(p, sl, sc[nt][e], dpc[nt][e], rcols.m2[slot][col], rcols.r[slot][col],
                              rcols.d[slot][col], cs[e >> 1], pf[e >> 1], seed, h, t * GC + col, orow, ds, pd);
            } else {
              const int gk = runs[t * (GC / SUB) + col / SUB] * SUB + col % SUB;
              grad_fast<bf16>(p, sl, sc[nt][e], dpc[nt][e], m2[e >> 1], rr[e >> 1], rd[e >> 1],
                              key_cs(p, kcols.st[slot][col]), 0.f, seed, h, orow, gk, ds, pd);
            }
            sc[nt][e] = pd;
            dpc[nt][e] = ds;
          }
        }
        // ds (and pd) of columns 16kk.. as the A fragment, times y1 (y2)
#pragma unroll
        for (int kk = 0; kk < GC / 16; ++kk) {
          if (kk >= n_in || (w > 1 && (kk & (w - 1)) != part)) continue;
          uint32_t a[4];
          pack_a(a, dpc[2 * kk], dpc[2 * kk + 1]);
          mma_rows<NO, LDH>(acc1, a, Y1t, kk, lane);
          if constexpr (DKDV) {
            pack_a(a, sc[2 * kk], sc[2 * kk + 1]);
            mma_rows<NO, LDH>(acc2, a, Y2t, kk, lane);
          }
        }
      };
      if (warp_on) {
        if (DKDV && wpr > 1) {
          tile(std::integral_constant<int, 0>{});
        } else {
          tile(std::integral_constant<int, 1>{});
        }
      }
      if (t + 1 < n_tiles) put(t + 1);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next list and ring fill start after every read of these
  }

  if constexpr (DKDV) {
    if (wpr > 1) {  // add the run's wpr column shares in warp order, through the ring's memory
      float* red = reinterpret_cast<float*>(Y1s);  // [4 warps][2 NO 4][32 lanes]
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(warp * 2 * NO * 4 + n * 4 + e) * 32 + lane] = acc1[n][e];
          red[(warp * 2 * NO * 4 + (NO + n) * 4 + e) * 32 + lane] = acc2[n][e];
        }
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            for (int w = warp + 1; w < warp + wpr; ++w) {
              acc1[n][e] += red[(w * 2 * NO * 4 + n * 4 + e) * 32 + lane];
              acc2[n][e] += red[(w * 2 * NO * 4 + (NO + n) * 4 + e) * 32 + lane];
            }
      }
    }
    if (!warp_on || part != 0) return;
  }
  const bool pairs = (p.hd & 1) == 0;  // output rows 4-byte aligned: store bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = o0 + r0 + 8 * r;
    if (row >= n_own) continue;
    store_acc_row(out_row<bf16>(DKDV ? p.dk : p.dq, p, b, h, n_own, row), acc1, r, t4, p.hd, pairs);
    if constexpr (DKDV) store_acc_row(out_row<bf16>(p.dv, p, b, h, n_own, row), acc2, r, t4, p.hd, pairs);
  }
}

// --------------------------------------------------------- narrow routes

template <int HD>
struct Narrow {
  static constexpr int LANES = NarrowRows<HD>::LANES;  // lanes per long-side row
  static constexpr int ROWS = NarrowRows<HD>::ROWS;    // long-side rows per block
  static constexpr int LDR = HD + 4;         // staged row stride (floats)
  static constexpr int LDS = NARROW + 1;     // staged ds / pd row stride: conflict-free
  // narrow_k: K, V [NARROW][HD]; q, do rows [ROWS][LDR]; ds, pd [ROWS][LDS]
  static constexpr size_t k_smem = sizeof(float) * (2 * NARROW * HD + 2 * ROWS * LDR + 2 * ROWS * LDS);
  // narrow_q: q, do [NARROW][HD]; k rows [ROWS][LDR]; ds [ROWS][LDS]
  static constexpr size_t q_smem = sizeof(float) * (2 * NARROW * HD + ROWS * LDR + ROWS * LDS);
};

// Tk <= NARROW: one q row per HD/16 lanes; dq in place, dk and dv summed
// over the block's rows, then over the blocks (attn_bwd_reduce_kernel)
template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_bwd_narrow_k_kernel(const BwdParams p) {
  using G = Narrow<HD>;
  constexpr int LANES = G::LANES, ROWS = G::ROWS, LDR = G::LDR, LDS = G::LDS;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);  // [NARROW][HD]
  float* Vs = Ks + NARROW * HD;
  float* Qst = Vs + NARROW * HD;   // [ROWS][LDR] this block's q rows
  float* Dst = Qst + ROWS * LDR;   // do rows
  float* DSs = Dst + ROWS * LDR;   // [ROWS][LDS] ds
  float* PDs = DSs + ROWS * LDS;   // pd
  __shared__ int8_t colstate[NARROW];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * ROWS;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dg = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  // this thread's q and do rows first: their loads are in flight while K
  // and V are staged
  const int r = tid / LANES;
  const int d0 = (tid % LANES) * 16;
  const int gq = q0 + r;
  const bool valid = gq < p.Tq;
  float qx[16], dx[16], rm = 0.f, rr = 0.f, rd = 0.f;
#pragma unroll
  for (int d = 0; d < 16; ++d) qx[d] = dx[d] = 0.f;
  if (valid) {
    load_slice(qx, qg + gq * p.q_st, d0, p.hd);
    load_slice(dx, dg + gq * p.do_st, d0, p.hd);
    const long long stat = static_cast<long long>(bh) * p.Tq + gq;
    rm = p.m[stat];
    rr = p.l[stat];  // inverted below, once it has arrived
    rd = p.dsum[stat];
  }
  for (int i = tid; i < NARROW * HD; i += NT) {
    const int jk = i / HD, d = i % HD;
    const bool in = jk < p.Tk && d < p.hd;
    Ks[i] = in ? to_f(kg[jk * p.k_st + d]) : 0.f;
    Vs[i] = in ? to_f(vg[jk * p.v_st + d]) : 0.f;
  }
  if (tid < NARROW) colstate[tid] = key_state(p.mask, p.mask_sb, p.Tk, b, tid);
  if (valid) rr = 1.f / rr;
#pragma unroll
  for (int d = 0; d < 16; d += 4) {
    *reinterpret_cast<float4*>(&Qst[r * LDR + d0 + d]) = make_float4(qx[d], qx[d + 1], qx[d + 2], qx[d + 3]);
    *reinterpret_cast<float4*>(&Dst[r * LDR + d0 + d]) = make_float4(dx[d], dx[d + 1], dx[d + 2], dx[d + 3]);
  }
  __syncthreads();

  // one key at a time (no register array indexed by key: the loop needs no
  // unrolling, which keeps the registers, and so the blocks per SM, up)
  float dq[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) dq[d] = 0.f;
#pragma unroll 1
  for (int jk = 0; jk < p.Tk; ++jk) {
    const float* kr = &Ks[jk * HD + d0];
    const float s = lane_sum<LANES>(dot16(qx, kr));
    const float dp = lane_sum<LANES>(dot16(dx, &Vs[jk * HD + d0]));
    float ds, pd;
    grad_pair<T>(p, s, dp, rm, rr, rd, valid, colstate[jk], seed, h, gq, jk, ds, pd);
#pragma unroll
    for (int d = 0; d < 16; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
    if (d0 == 0) {
      DSs[r * LDS + jk] = ds;
      PDs[r * LDS + jk] = pd;
    }
  }
  if (valid) store_slice(out_row<T>(p.dq, p, b, h, p.Tq, gq), dq, d0, p.hd, (p.hd * sizeof(T)) % 16 == 0);
  __syncthreads();

  // dk[key] = sum_rows ds[row, key] q[row, :], dv[key] = sum_rows pd[row, key] do[row, :]
  const int n_rows = min(ROWS, p.Tq - q0);
  const bool direct = gridDim.y == 1;  // one chunk: no reduce launch
  const long long c = static_cast<long long>(bh) * gridDim.y + blockIdx.y;
  const int lane = tid & 31;
  for (int which = 0; which < 2; ++which) {
    staged_sum<HD>(which ? PDs : DSs, LDS, which ? Dst : Qst, LDR, n_rows, p.Tk,
                   [&](int jk, int d, float4 a) {
                     if (lane != 0) return;
                     const float vals[4] = {a.x, a.y, a.z, a.w};
                     if (direct) {
                       T* row = out_row<T>(which ? p.dv : p.dk, p, b, h, p.Tk, jk);
#pragma unroll
                       for (int e = 0; e < 4; ++e)
                         if (d + e < p.hd) store(row + d + e, vals[e]);
                     } else {
                       float* pc = p.part + ((c * 2 + which) * NARROW + jk) * HD + d;
#pragma unroll
                       for (int e = 0; e < 4; ++e) pc[e] = vals[e];
                     }
                   });
  }
}

// Tq <= NARROW: one key per HD/16 lanes; dk and dv in place, dq summed over
// the block's keys, then over the blocks (attn_bwd_reduce_kernel)
template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_bwd_narrow_q_kernel(const BwdParams p) {
  using G = Narrow<HD>;
  constexpr int LANES = G::LANES, ROWS = G::ROWS, LDR = G::LDR, LDS = G::LDS;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [NARROW][HD]
  float* Ds = Qs + NARROW * HD;                   // do
  float* Kst = Ds + NARROW * HD;                  // [ROWS][LDR] this block's k rows
  float* DSs = Kst + ROWS * LDR;                  // [ROWS][LDS] ds
  __shared__ float row_m[NARROW], row_r[NARROW], row_d[NARROW];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * ROWS;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dg = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  // this thread's key first: its loads are in flight while q, do and the
  // row statistics are staged
  const int r = tid / LANES;
  const int d0 = (tid % LANES) * 16;
  const int gk = k0 + r;
  const int8_t st = key_state(p.mask, p.mask_sb, p.Tk, b, gk);
  float kx[16], vx[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) kx[d] = vx[d] = 0.f;
  if (st == kValid) {  // a masked key needs neither: its ds is 0, its pd only m and l
    load_slice(kx, kg + gk * p.k_st, d0, p.hd);
    load_slice(vx, vg + gk * p.v_st, d0, p.hd);
  }
  for (int i = tid; i < NARROW * HD; i += NT) {
    const int qr = i / HD, d = i % HD;
    const bool in = qr < p.Tq && d < p.hd;
    Qs[i] = in ? to_f(qg[qr * p.q_st + d]) : 0.f;
    Ds[i] = in ? to_f(dg[qr * p.do_st + d]) : 0.f;
  }
  if (tid < NARROW) {
    const long long stat = static_cast<long long>(bh) * p.Tq + tid;
    const bool in = tid < p.Tq;
    row_m[tid] = in ? p.m[stat] : 0.f;
    row_r[tid] = in ? 1.f / p.l[stat] : 0.f;
    row_d[tid] = in ? p.dsum[stat] : 0.f;
  }
#pragma unroll
  for (int d = 0; d < 16; d += 4)
    *reinterpret_cast<float4*>(&Kst[r * LDR + d0 + d]) = make_float4(kx[d], kx[d + 1], kx[d + 2], kx[d + 3]);
  __syncthreads();

  float dk[16], dv[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) dk[d] = dv[d] = 0.f;
#pragma unroll 1
  for (int i = 0; i < p.Tq; ++i) {  // one row at a time: few registers, more blocks per SM
    const float s = lane_sum<LANES>(dot16(kx, &Qs[i * HD + d0]));
    const float dp = lane_sum<LANES>(dot16(vx, &Ds[i * HD + d0]));
    float ds, pd;
    grad_pair<T>(p, s, dp, row_m[i], row_r[i], row_d[i], true, st, seed, h, i, gk, ds, pd);
    const float* qr = &Qs[i * HD + d0];
    const float* dr = &Ds[i * HD + d0];
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      dk[d] = fmaf(ds, qr[d], dk[d]);
      dv[d] = fmaf(pd, dr[d], dv[d]);
    }
    if (d0 == 0) DSs[r * LDS + i] = ds;
  }
  if (st != kOutside) {
    const bool vec = (p.hd * sizeof(T)) % 16 == 0;
    store_slice(out_row<T>(p.dk, p, b, h, p.Tk, gk), dk, d0, p.hd, vec);
    store_slice(out_row<T>(p.dv, p, b, h, p.Tk, gk), dv, d0, p.hd, vec);
  }
  __syncthreads();

  // dq[row] = sum_keys ds[row, key] k[key, :]
  const bool direct = gridDim.y == 1;  // one chunk: no reduce launch
  const long long c = static_cast<long long>(bh) * gridDim.y + blockIdx.y;
  const int lane = tid & 31;
  staged_sum<HD>(DSs, LDS, Kst, LDR, min(ROWS, p.Tk - k0), p.Tq, [&](int i, int d, float4 a) {
    if (lane != 0) return;
    const float vals[4] = {a.x, a.y, a.z, a.w};
    if (direct) {
      T* row = out_row<T>(p.dq, p, b, h, p.Tq, i);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < p.hd) store(row + d + e, vals[e]);
    } else {
      float* pc = p.part + (c * NARROW + i) * HD + d;
#pragma unroll
      for (int e = 0; e < 4; ++e) pc[e] = vals[e];
    }
  });
}

// Per-block partials [B*H][n_chunks][n_out][cap][HD] summed over the chunks
// in order: outputs [rows, hd] of each (batch, head) into out[0] (and
// out[1] when n_out is 2).  The narrow routes' chunks (cap NARROW) and the
// one-pass route's spans (cap = rows; ``flags``, where given, one a run of
// SUB rows: a row of a run without a flag is 0 and has no partials).
template <typename T, int HD>
__global__ void attn_bwd_reduce_kernel(const BwdParams p, int n_chunks, int n_out, int rows, int cap,
                                     const int* flags, void* out0, void* out1) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(p.B) * p.H * n_out * rows * p.hd;
  if (idx >= total) return;
  const int d = idx % p.hd;
  long long rest = idx / p.hd;
  const int row = rest % rows;
  rest /= rows;
  const int which = rest % n_out;
  const int bh = static_cast<int>(rest / n_out);
  const bool on = flags == nullptr || flags[static_cast<long long>(bh) * ((rows + SUB - 1) / SUB) + row / SUB];
  float a = 0.f;
  for (int c = 0; c < (on ? n_chunks : 0); ++c)
    a += p.part[(((static_cast<long long>(bh) * n_chunks + c) * n_out + which) * cap + row) * HD + d];
  const int b = bh / p.H;
  store(out_row<T>(which ? out1 : out0, p, b, bh - b * p.H, rows, row) + d, a);
}

template <typename T, int HD>
int launch_narrow(int route, const BwdParams& p, cudaStream_t stream) {
  using G = Narrow<HD>;
  const bool narrow_k = route == kRouteNarrowK;
  const int n_chunks = max(1, narrow_chunks(narrow_k ? p.Tq : p.Tk, HD));
  if (n_chunks > 1 && p.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.B * p.H, n_chunks);
  if (narrow_k) {
    const cudaError_t err = allow_smem<attn_bwd_narrow_k_kernel<T, HD>>(G::k_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_narrow_k_kernel<T, HD><<<grid, NT, G::k_smem, stream>>>(p);
  } else {
    const cudaError_t err = allow_smem<attn_bwd_narrow_q_kernel<T, HD>>(G::q_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_narrow_q_kernel<T, HD><<<grid, NT, G::q_smem, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const int n_out = narrow_k ? 2 : 1;
  const int rows = narrow_k ? p.Tk : p.Tq;
  const long long total = static_cast<long long>(p.B) * p.H * n_out * rows * p.hd;
  if (total > 0) {
    attn_bwd_reduce_kernel<T, HD><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
        p, n_chunks, n_out, rows, NARROW, nullptr, narrow_k ? p.dk : p.dq, p.dv);
  }
  return static_cast<int>(cudaGetLastError());
}

// the float32 one-pass route's two launches: the spans, then their sum
template <int HD>
int launch_one_pass(const BwdParams& p, cudaStream_t stream) {
  using O = OnePass<HD>;
  if (p.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in once, for the most dq sums a block holds
  cudaError_t err = allow_smem<attn_bwd_onepass_f32_kernel<HD>>(O::fixed + OP_ACC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool kl = p.Tk >= p.Tq;
  const int n_spans = one_pass_spans(p.Tq, p.Tk, HD);
  attn_bwd_onepass_f32_kernel<HD>
      <<<dim3(p.B * p.H, n_spans), NT, O::smem(kl ? p.Tq : min(O::QSPAN, p.Tq)), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = kl ? 1 : 2, rows = kl ? p.Tq : p.Tk;
  const int* flags = kl ? nullptr : reinterpret_cast<const int*>(p.part + one_pass_floats(p.B, p.H, p.Tq, p.Tk, HD));
  const long long total = static_cast<long long>(p.B) * p.H * n_out * rows * p.hd;
  attn_bwd_reduce_kernel<float, HD><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      p, n_spans, n_out, rows, rows, flags, kl ? p.dq : p.dk, p.dv);
  return static_cast<int>(cudaGetLastError());
}

// the general route's two launches, dkdv then dq, ``rows`` owned rows a block
template <auto Dkdv, auto Dq>
int launch_pair(int rows, size_t smem, const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<Dkdv>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem<Dq>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.Tk > 0) {
    Dkdv<<<dim3(p.B * p.H, (p.Tk + rows - 1) / rows), NT, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.Tq > 0) Dq<<<dim3(p.B * p.H, (p.Tq + rows - 1) / rows), NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_general(const BwdParams& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (HD <= 64) {
      if (one_pass(p.Tq, p.Tk, p.hd)) return launch_one_pass<HD>(p, stream);
    }
    return launch_pair<attn_bwd_dkdv_f32_kernel<HD>, attn_bwd_dq_f32_kernel<HD>>(GenF32<HD>::GR,
                                                                                 GenF32<HD>::smem, p, stream);
  } else {
    return launch_pair<attn_bwd_bf16_kernel<HD, true>, attn_bwd_bf16_kernel<HD, false>>(
        64, bf16_gen_smem<HD>(), p, stream);
  }
}

template <typename T>
int launch_hd(int route, const BwdParams& p, cudaStream_t stream) {
  if (route != kRouteGeneral) {
    if (p.hd <= 16) return launch_narrow<T, 16>(route, p, stream);
    if (p.hd <= 32) return launch_narrow<T, 32>(route, p, stream);
    if (p.hd <= 64) return launch_narrow<T, 64>(route, p, stream);
    return launch_narrow<T, 128>(route, p, stream);
  }
  if (p.hd <= 16) return launch_general<T, 16>(p, stream);
  if (p.hd <= 32) return launch_general<T, 32>(p, stream);
  if (p.hd <= 64) return launch_general<T, 64>(p, stream);
  return launch_general<T, 128>(p, stream);
}

}  // namespace

// Bytes of workspace that mmf_attention_bwd needs on ``route`` (0 when
// none): the narrow routes' float32 per-block partials when the long side is
// more than one chunk; on the general route the float32 one-pass route's
// span partials and flags (its only workspace: 0 where the shape keeps the
// pair).
extern "C" long long mmf_attention_bwd_workspace(int is_bf16, int route, int B, int H, int Tq, int Tk,
                                                 int hd) {
  if (route == kRouteGeneral) return !is_bf16 && one_pass(Tq, Tk, hd) ? one_pass_bytes(B, H, Tq, Tk, hd) : 0;
  const bool narrow_k = route == kRouteNarrowK;
  const long long n_chunks = narrow_chunks(narrow_k ? Tq : Tk, hd);
  if (n_chunks <= 1) return 0;
  return static_cast<long long>(sizeof(float)) * B * H * n_chunks * (narrow_k ? 2 : 1) * NARROW *
         narrow_hd(hd);
}

// dq, dk, dv for q, do [B, Tq, H, hd] and k, v [B, Tk, H, hd] given by
// strides (in elements; the head dim contiguous, every row 16-byte
// aligned), m, l, dsum float32 [B, H, Tq], an optional uint8 mask
// [B or 1, Tk] and optional int32 per-case seeds [B].  dq, dk, dv are
// contiguous, in the input dtype (is_bf16: bf16, else float32).  route: 0
// general, 1 narrow_q (Tq <= 16), 2 narrow_k (Tk <= 16).  workspace:
// mmf_attention_bwd_workspace bytes (null when that is 0).  hd <= 128.
// Two launches on the general route and on a narrow route of more than one
// chunk, one on a narrow route of one chunk.
// Returns cudaGetLastError() after the launches (or the error of the
// shared-memory opt-in, or cudaErrorInvalidValue for a route the shape does
// not allow).
extern "C" int mmf_attention_bwd(int is_bf16, int route, const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask, const void* seeds,
                                 const void* m, const void* l, const void* dsum, void* dq,
                                 void* dk, void* dv, void* workspace, int B, int H, int Tq, int Tk,
                                 int hd, long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                 long long k_st, long long k_sh, long long v_sb, long long v_st,
                                 long long v_sh, long long do_sb, long long do_st,
                                 long long do_sh, long long mask_sb, float scale,
                                 float keep_scale, unsigned int threshold, unsigned int seed,
                                 int dropout, void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.seeds = static_cast<const int*>(seeds);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.dsum = static_cast<const float*>(dsum);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.part = static_cast<float*>(workspace);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.hd = hd;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.do_sb = do_sb;
  p.do_st = do_st;
  p.do_sh = do_sh;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.keep_scale = keep_scale;
  p.threshold = threshold;
  p.seed = seed;
  p.dropout = dropout;
  if ((route == kRouteNarrowQ && Tq > NARROW) || (route == kRouteNarrowK && Tk > NARROW) ||
      route < kRouteGeneral || route > kRouteNarrowK || hd > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(route, p, s) : launch_hd<float>(route, p, s);
}
