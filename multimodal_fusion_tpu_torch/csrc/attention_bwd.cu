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
// Deterministic, no atomics: two launches behind one entry.
//   dkdv: one block per (batch*head, 64-key tile) holds its K and V tile in
//         shared memory and walks every 64-row q tile in order, summing dk
//         and dv in registers;
//   dq:   one block per (batch*head, 64-row q tile) holds its q and do tile
//         and walks every key tile in order, summing dq in registers.
// Both recompute s and dp in 64 x 64 tiles with K3's thread layout: 128
// threads, each owning 4 rows x 8 keys of a score tile; p and ds go through
// shared memory for the second products.
//
// Bound on the H100: the work is 5 products of 2*Tq*Tk*hd per (batch,
// head), 10*B*H*Tq*Tk*hd FLOPs (the two launches recompute s and dp: 14
// products are done), against q, k, v, do, dq, dk, dv bytes.  At MFMF's
// shapes (hd = 16, Tq or Tk = 5) the tiles are mostly padding: hd pads to
// 32 and a 5-row tile fills 5 of 64 rows, so the kernel does far more than
// the bound counts.  Not yet done: tensor cores (mma.sync / wgmma) for
// bf16, TMA loads and a K/V ring, tiles shaped for Tq or Tk = 5.

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
  int B, H, Tq, Tk, hd;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh, mask_sb;
  float scale, keep_scale;
  uint32_t threshold, seed;
  int dropout;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// round to the operand dtype T (a no-op for float32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* ptr, float x) { *ptr = x; }
__device__ __forceinline__ void store(__nv_bfloat16* ptr, float x) { *ptr = __float2bfloat16_rn(x); }

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

template <typename T, int HD>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  auto dkdv = attn_bwd_dkdv_kernel<T, HD>;
  auto dq = attn_bwd_dq_kernel<T, HD>;
  cudaError_t err = allow_smem(dkdv, dkdv_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dq, dq_smem<HD>());
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
int launch_hd(const BwdParams& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch_bwd<T, 32>(p, stream);
  if (p.hd <= 64) return launch_bwd<T, 64>(p, stream);
  return launch_bwd<T, 128>(p, stream);
}

}  // namespace

// dq, dk, dv for q, do [B, Tq, H, hd] and k, v [B, Tk, H, hd] given by
// strides (in elements; the head dim contiguous), m, l, dsum float32
// [B, H, Tq], an optional uint8 mask [B or 1, Tk] and optional int32
// per-case seeds [B].  dq, dk, dv are contiguous, in the input dtype
// (is_bf16: bf16, else float32).  hd <= 128.  Returns cudaGetLastError()
// after the launches (or the error of the shared-memory opt-in).
extern "C" int mmf_attention_bwd(int is_bf16, const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask, const void* seeds,
                                 const void* m, const void* l, const void* dsum, void* dq,
                                 void* dk, void* dv, int B, int H, int Tq, int Tk, int hd,
                                 long long q_sb, long long q_st, long long q_sh, long long k_sb,
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(p, s) : launch_hd<float>(p, s);
}
