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
// score a constant.  Scores, p, ds and every sum are float32.  bf16 inputs
// are read into float32 tiles (bf16 products are exact in f32), ds is
// rounded to bf16 before the dq and dk products and pd before the dv
// product, as the JAX kernel casts them to the operand dtype; outputs are
// stored in the input dtype.  The float32 path runs true f32 FMAs (no TF32).
//
// Deterministic, no atomics.  Three routes (the wrapper picks one by shape,
// ops/attention_kernel.py):
//
// general (both sides > NARROW): two launches.
//   dkdv: one block per (batch*head, 64-key tile) holds its K and V tile in
//         shared memory and walks every 64-row q tile in order, summing dk
//         and dv in registers;
//   dq:   one block per (batch*head, 64-row q tile) holds its q and do tile
//         and walks every key tile in order, summing dq in registers.
//   Both recompute s and dp in 64 x 64 tiles with K3's thread layout: 128
//   threads, each owning 4 rows x 8 keys of a score tile; p and ds go
//   through shared memory for the second products.  hd pads to 32, 64, 128.
// narrow_k (Tk <= NARROW; MFMF's block 3, 4096 q rows against 5 keys): the
//   keys' k and v sit whole in shared memory; each q row belongs to HD/16
//   lanes (16 dims each, 16-byte loads) that compute s, dp, p, pd and ds
//   against every key, so its dq row is complete in place.  dk and dv are
//   sums over the long q axis: each block sums its 128/(HD/16) rows in a
//   fixed order through shared memory, and a second small launch adds the
//   blocks' float32 partials in chunk order.
// narrow_q (Tq <= NARROW; blocks 1 and 2, 5 rows against 512 or 4096 keys):
//   the mirror image.  q, do and the row statistics sit in shared memory,
//   each key belongs to HD/16 lanes, its dk and dv rows are complete in
//   place, and dq is the fixed-order sum.  A user-masked key reads neither
//   k nor v (its ds is 0 and its pd needs only m and l).
// The narrow routes instantiate hd 16, 32, 64 and 128 (no padding of hd 16).
//
// Bound on the H100: the work is 5 products of 2*Tq*Tk*hd per (batch,
// head), 10*B*H*Tq*Tk*hd FLOPs, against q, k, v, do, dq, dk, dv bytes (m, l
// and dsum beside them).  At MFMF's shapes (hd = 16, Tq or Tk = 5) the
// bytes of the long side bound it: the narrow routes read each long-side
// row once.  Not yet done: tensor cores (mma.sync / wgmma) for bf16 and a
// K/V ring on the general route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// rows [r0, r0 + 64) of a [T, hd] slice (token stride st) into a float tile
// of row stride LD, zero past T and hd
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long st, int r0, int n_rows,
                                          int hd) {
  constexpr int LD = HD + 4;
  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int g = r0 + r;
    dst[r * LD + d] = (g < n_rows && d < hd) ? to_f(src[g * st + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[rows ty + 16 i, d] * B[rows tx + 8 j, d] over float tiles
template <int HD>
__device__ __forceinline__ void tile_dots(float (&acc)[4][8], const float* A, const float* Bt, int ty,
                                          int tx) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float4*>(&Bt[(tx + 8 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = acc[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
}

// p, pd and ds of one score tile in place: s -> pd (rounded to T), dp -> ds
// (rounded to T).  Row stats of this thread's rows: rm (m), rr (1 / l), rd
// (dsum), valid (row < Tq).  colstate from the key tile.
template <typename T>
__device__ __forceinline__ void grad_tile(const BwdParams& p, float (&s)[4][8], float (&dp)[4][8],
                                          const float* rm, const float* rr, const float* rd,
                                          const bool* valid, const int8_t* colstate, uint32_t seed,
                                          int h, int q0, int k0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t st = colstate[tx + 8 * j];
      const float sv = st == kMasked ? kNegInf : s[i][j] * p.scale;
      const float pr = expf(sv - rm[i]) * rr[i];
      float pd = pr, dpv = dp[i][j];
      if (p.dropout) {
        const bool kp = keep(seed, p.threshold, p.Tq, p.Tk, h, q0 + ty + 16 * i, k0 + tx + 8 * j);
        pd = kp ? pr * p.keep_scale : 0.f;
        dpv = kp ? dpv * p.keep_scale : 0.f;
      }
      float ds = pr * (dpv - rd[i]) * p.scale;
      if (st != kValid || !valid[i]) ds = 0.f;
      if (st == kOutside || !valid[i]) pd = 0.f;
      s[i][j] = round_to<T>(pd);
      dp[i][j] = round_to<T>(ds);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * BKV * (HD + 4) + 2 * BQ * (BKV + 4));
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BKV * (HD + 4) + BQ * (BKV + 4));
}

// ------------------------------------------------------------- dk and dv

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LD = HD + 4;
  constexpr int LDP = BKV + 4;
  constexpr int NV = HD / 32;  // float4 groups of output dims per thread
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;
  float* Ds = Qs + BQ * LD;   // do tile
  float* Ps = Ds + BQ * LD;   // pd [q][key]
  float* Ss = Ps + BQ * LDP;  // ds [q][key]
  __shared__ int8_t colstate[BKV];
  __shared__ float row_m[BQ], row_r[BQ], row_d[BQ];

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * BKV;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dg = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;

  load_tile<T, HD>(Ks, kg, p.k_st, k0, p.Tk, p.hd);
  load_tile<T, HD>(Vs, vg, p.v_st, k0, p.Tk, p.hd);
  load_colstate(p.mask, p.mask_sb, p.Tk, b, k0, colstate);

  // dk, dv of keys ty + 16 i, dims e*32 + tx*4 + 0..3
  float4 dk[4][NV], dv[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      dk[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
    __syncthreads();  // the previous tile's second products are done
    load_tile<T, HD>(Qs, qg, p.q_st, q0, p.Tq, p.hd);
    load_tile<T, HD>(Ds, dg, p.do_st, q0, p.Tq, p.hd);
    if (tid < BQ) {
      const int gq = q0 + tid;
      const bool in = gq < p.Tq;
      row_m[tid] = in ? p.m[stat0 + gq] : 0.f;
      row_r[tid] = in ? 1.f / p.l[stat0 + gq] : 0.f;
      row_d[tid] = in ? p.dsum[stat0 + gq] : 0.f;
    }
    __syncthreads();

    float s[4][8], dp[4][8];
    tile_dots<HD>(s, Qs, Ks, ty, tx);
    tile_dots<HD>(dp, Ds, Vs, ty, tx);
    float rm[4], rr[4], rd[4];
    bool valid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      rm[i] = row_m[r];
      rr[i] = row_r[r];
      rd[i] = row_d[r];
      valid[i] = q0 + r < p.Tq;
    }
    grad_tile<T>(p, s, dp, rm, rr, rd, valid, colstate, seed, h, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Ps[(ty + 16 * i) * LDP + tx + 8 * j] = s[i][j];
        Ss[(ty + 16 * i) * LDP + tx + 8 * j] = dp[i][j];
      }
    __syncthreads();

    // dv[key] += sum_q pd[q, key] do[q, :];  dk[key] += sum_q ds[q, key] q[q, :]
    const int n_q = min(BQ, p.Tq - q0);
    for (int r = 0; r < n_q; ++r) {
      float4 dov[NV], qv[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        dov[e] = *reinterpret_cast<const float4*>(&Ds[r * LD + e * 32 + tx * 4]);
        qv[e] = *reinterpret_cast<const float4*>(&Qs[r * LD + e * 32 + tx * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = Ps[r * LDP + ty + 16 * i];
        const float sk = Ss[r * LDP + ty + 16 * i];
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          dv[i][e].x = fmaf(pk, dov[e].x, dv[i][e].x);
          dv[i][e].y = fmaf(pk, dov[e].y, dv[i][e].y);
          dv[i][e].z = fmaf(pk, dov[e].z, dv[i][e].z);
          dv[i][e].w = fmaf(pk, dov[e].w, dv[i][e].w);
          dk[i][e].x = fmaf(sk, qv[e].x, dk[i][e].x);
          dk[i][e].y = fmaf(sk, qv[e].y, dk[i][e].y);
          dk[i][e].z = fmaf(sk, qv[e].z, dk[i][e].z);
          dk[i][e].w = fmaf(sk, qv[e].w, dk[i][e].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + 16 * i;
    if (gk >= p.Tk) continue;
    const long long row = ((static_cast<long long>(b) * p.Tk + gk) * p.H + h) * p.hd;
    T* dkrow = static_cast<T*>(p.dk) + row;
    T* dvrow = static_cast<T*>(p.dv) + row;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float kvals[4] = {dk[i][e].x, dk[i][e].y, dk[i][e].z, dk[i][e].w};
      const float vvals[4] = {dv[i][e].x, dv[i][e].y, dv[i][e].z, dv[i][e].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = e * 32 + tx * 4 + x;
        if (d < p.hd) {
          store(dkrow + d, kvals[x]);
          store(dvrow + d, vvals[x]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- dq

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = HD + 4;
  constexpr int LDP = BKV + 4;
  constexpr int NV = HD / 32;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ds = Qs + BQ * LD;   // do tile
  float* Ks = Ds + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ss = Vs + BKV * LD;  // ds [q][key]
  __shared__ int8_t colstate[BKV];

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * BQ;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dg = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;

  load_tile<T, HD>(Qs, qg, p.q_st, q0, p.Tq, p.hd);
  load_tile<T, HD>(Ds, dg, p.do_st, q0, p.Tq, p.hd);
  float rm[4], rr[4], rd[4];
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + 16 * i;
    valid[i] = gq < p.Tq;
    rm[i] = valid[i] ? p.m[stat0 + gq] : 0.f;
    rr[i] = valid[i] ? 1.f / p.l[stat0 + gq] : 0.f;
    rd[i] = valid[i] ? p.dsum[stat0 + gq] : 0.f;
  }

  // dq of rows ty + 16 i, dims e*32 + tx*4 + 0..3
  float4 dq[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NV; ++e) dq[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < p.Tk; k0 += BKV) {
    __syncthreads();  // the previous tile's dq products are done
    load_tile<T, HD>(Ks, kg, p.k_st, k0, p.Tk, p.hd);
    load_tile<T, HD>(Vs, vg, p.v_st, k0, p.Tk, p.hd);
    load_colstate(p.mask, p.mask_sb, p.Tk, b, k0, colstate);
    __syncthreads();

    float s[4][8], dp[4][8];
    tile_dots<HD>(s, Qs, Ks, ty, tx);
    tile_dots<HD>(dp, Ds, Vs, ty, tx);
    grad_tile<T>(p, s, dp, rm, rr, rd, valid, colstate, seed, h, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Ss[(ty + 16 * i) * LDP + tx + 8 * j] = dp[i][j];
    __syncthreads();

    // dq[row] += sum_key ds[row, key] k[key, :]
    const int n_k = min(BKV, p.Tk - k0);
    for (int c = 0; c < n_k; ++c) {
      float4 kv[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) kv[e] = *reinterpret_cast<const float4*>(&Ks[c * LD + e * 32 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = Ss[(ty + 16 * i) * LDP + c];
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          dq[i][e].x = fmaf(sc, kv[e].x, dq[i][e].x);
          dq[i][e].y = fmaf(sc, kv[e].y, dq[i][e].y);
          dq[i][e].z = fmaf(sc, kv[e].z, dq[i][e].z);
          dq[i][e].w = fmaf(sc, kv[e].w, dq[i][e].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!valid[i]) continue;
    const int gq = q0 + ty + 16 * i;
    T* row = static_cast<T*>(p.dq) + ((static_cast<long long>(b) * p.Tq + gq) * p.H + h) * p.hd;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float vals[4] = {dq[i][e].x, dq[i][e].y, dq[i][e].z, dq[i][e].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = e * 32 + tx * 4 + x;
        if (d < p.hd) store(row + d, vals[x]);
      }
    }
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

// p, pd and ds of one (row, key) pair, as grad_tile: a masked key keeps pd
// (an all-masked row takes the uniform p) and gets ds = 0; keys past Tk and
// rows past Tq take no part.  Returns ds and pd rounded to T.
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

// The narrow routes' per-block partials [B*H][n_chunks][n_out][NARROW][HD]
// summed over the chunks in order: outputs [rows, hd] of each (batch, head)
// into out[0] (and out[1] when n_out is 2).
template <typename T, int HD>
__global__ void attn_bwd_reduce_kernel(const BwdParams p, int n_chunks, int n_out, int rows, void* out0,
                                     void* out1) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(p.B) * p.H * n_out * rows * p.hd;
  if (idx >= total) return;
  const int d = idx % p.hd;
  long long rest = idx / p.hd;
  const int row = rest % rows;
  rest /= rows;
  const int which = rest % n_out;
  const int bh = static_cast<int>(rest / n_out);
  float a = 0.f;
  for (int c = 0; c < n_chunks; ++c)
    a += p.part[(((static_cast<long long>(bh) * n_chunks + c) * n_out + which) * NARROW + row) * HD + d];
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
        p, n_chunks, n_out, rows, narrow_k ? p.dk : p.dq, p.dv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  auto dkdv = attn_bwd_dkdv_kernel<T, HD>;
  auto dq = attn_bwd_dq_kernel<T, HD>;
  cudaError_t err = allow_smem<attn_bwd_dkdv_kernel<T, HD>>(dkdv_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem<attn_bwd_dq_kernel<T, HD>>(dq_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.Tk > 0) {
    dkdv<<<dim3(p.B * p.H, (p.Tk + BKV - 1) / BKV), NT, dkdv_smem<HD>(), stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.Tq > 0) {
    dq<<<dim3(p.B * p.H, (p.Tq + BQ - 1) / BQ), NT, dq_smem<HD>(), stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int route, const BwdParams& p, cudaStream_t stream) {
  if (route != kRouteGeneral) {
    if (p.hd <= 16) return launch_narrow<T, 16>(route, p, stream);
    if (p.hd <= 32) return launch_narrow<T, 32>(route, p, stream);
    if (p.hd <= 64) return launch_narrow<T, 64>(route, p, stream);
    return launch_narrow<T, 128>(route, p, stream);
  }
  if (p.hd <= 32) return launch_bwd<T, 32>(p, stream);
  if (p.hd <= 64) return launch_bwd<T, 64>(p, stream);
  return launch_bwd<T, 128>(p, stream);
}

}  // namespace

// Bytes of float32 workspace that mmf_attention_bwd needs on ``route`` (0
// when none): the narrow routes' per-block partials when the long side is
// more than one chunk.
extern "C" long long mmf_attention_bwd_workspace(int route, int B, int H, int Tq, int Tk, int hd) {
  const bool narrow_k = route == kRouteNarrowK;
  const long long n_chunks = narrow_chunks(narrow_k ? Tq : Tk, hd);
  if (route == kRouteGeneral || n_chunks <= 1) return 0;
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
