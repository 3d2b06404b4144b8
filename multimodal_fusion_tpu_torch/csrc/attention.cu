// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_fusion_tpu/ops/pallas_attention.py:
// _attn_kernel (called from _fused_attention_hxd).  For every (batch, head)
// it computes o = softmax(q k^T * scale) v with an online softmax over key
// tiles, and returns the row max m and the pre-dropout exp-sum l beside o.
//
// Semantics held from the TPU kernel:
//   - scores and softmax in float32 whatever the input dtype; p is cast to
//     v's dtype before the P.V product; o is stored in the input dtype.  The
//     float32 path runs true f32 FMAs (no TF32);
//   - a masked key's score is REPLACED by NEG_INF = -1e9 (not added to), the
//     running max starts at -1e30, so an all-masked row gives the uniform
//     average of v; keys past Tk are excluded outright (-inf, exp -> 0);
//   - deferred normalisation: o = acc * (1 / l) once at the end; m and l are
//     stored separately as float32 [B, H, Tq], never as a log-sum-exp;
//   - dropout (rate > 0): keep iff fmix32((h*Tq + q)*Tk + k) * 0x9E3779B9 +
//     seed) >= threshold in uint32 arithmetic, at the absolute (head, q, k)
//     index, applied to the unnormalised p after l is updated.  The seed is
//     one per batch element (the JAX kernel under vmap with per-case keys)
//     or one shared by the batch (vmap with one unbatched key: every batch
//     element then draws the same mask);
//   - deterministic: every sum runs in a fixed order, no atomics.
//
// Layout: q, k, v are read in the caller's [B, T, H, hd] layout through
// their batch, token and head strides (the head dim is contiguous), so the
// ViT's fused qkv output [B, T, 3, H, hd] needs no transpose copy.  o is a
// contiguous [B, Tq, H, hd].
//
// Bound on the H100: at the ViT-L shape (B*H = 512, T = 257, hd = 64) the
// work is 4*B*H*T^2*hd = 8.7 GFLOP per call against 135 MB of q, k, v and o
// in f32: operations bound (0.13 ms at the 67 TFLOP/s non-tensor f32 peak,
// 0.04 ms for the bytes at 3.35 TB/s).  In bf16 the tensor cores' 989
// TFLOP/s leave the 67 MB as the bound (0.02 ms).  Design (simple
// first): one 128-thread block per (batch*head, 64-row q tile); K and V walk
// through shared memory in 64-key tiles, synchronously.
//   f32: each thread owns a 4 x 8 block of scores (rows ty + 16i, keys
//        tx + 8j) and 4 rows x hd/8 output dims; 128-bit shared loads along
//        hd, P goes through shared memory for the P.V product.
//   bf16: each warp owns 16 q rows and runs mma.sync m16n8k16 (bf16 in,
//        f32 accumulate) for q k^T and P.V; the score accumulators are
//        re-packed in registers as the A operand of P.V; V is stored
//        transposed in shared memory so every B fragment is a 32-bit load.
// The head dim is padded with zeros to 32, 64 or 128 (hd <= 128).  Not yet
// done: the 257-token edge wastes most of a fifth q and k tile; TMA, wgmma
// and a pipelined K/V ring are for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace mmf_attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B or 1, Tk], 1 = keep; null = no mask
  const int* seeds;     // [B] per-case dropout seeds; null = ``seed`` for all
  void* o;
  float* m;
  float* l;
  int B, H, Tq, Tk, hd;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask_sb;
  float scale, keep_scale;
  uint32_t threshold, seed;
  int dropout;
};

__device__ __forceinline__ float apply_colstate(float s, int8_t st) {
  return st == kOutside ? -INFINITY : (st == kMasked ? kNegInf : s);
}

// ---------------------------------------------------------------- float32

template <int HD>
__global__ void __launch_bounds__(NT) attn_f32_kernel(const Params p) {
  constexpr int LD = HD + 4;    // Q/K/V row stride (floats): conflict-free float4 reads
  constexpr int LDP = BKV + 4;  // P row stride
  constexpr int NV = HD / 32;   // float4 groups of output dims per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ps = Vs + BKV * LD;
  __shared__ int8_t colstate[BKV];

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // key / output-dim group
  const int ty = tid >> 3;  // row group: rows ty + 16 i
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * BQ;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int gq = q0 + r;
    Qs[r * LD + d] = (gq < p.Tq && d < p.hd) ? qg[gq * p.q_st + d] : 0.f;
  }

  float m_i[4], l_i[4];
  float4 acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kInitMax;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < p.Tk; k0 += BKV) {
    __syncthreads();  // the previous tile's P.V reads are done
    for (int i = tid; i < BKV * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int gk = k0 + r;
      const bool in = gk < p.Tk && d < p.hd;
      Ks[r * LD + d] = in ? kg[gk * p.k_st + d] : 0.f;
      Vs[r * LD + d] = in ? vg[gk * p.v_st + d] : 0.f;
    }
    load_colstate(p.mask, p.mask_sb, p.Tk, b, k0, colstate);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax; the 8 threads of a row group are 8 consecutive lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = apply_colstate(s[i][j] * p.scale, colstate[tx + 8 * j]);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
      if (p.dropout) {
        const uint32_t gq = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t gk = k0 + tx + 8 * j;
          s[i][j] = keep(seed, p.threshold, p.Tq, p.Tk, h, gq, gk) ? s[i][j] * p.keep_scale : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty + 16 * i) * LDP + tx + 8 * j] = s[i][j];
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        acc[i][e].x *= alpha;
        acc[i][e].y *= alpha;
        acc[i][e].z *= alpha;
        acc[i][e].w *= alpha;
      }
    }
    __syncthreads();

    // acc[i] += P[row i, :] . V[:, dims]; dims of group e: e*32 + tx*4 + 0..3
#pragma unroll 4
    for (int c = 0; c < BKV; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e)
          vv[e] = *reinterpret_cast<const float4*>(&Vs[(c + cc) * LD + e * 32 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            acc[i][e].x = fmaf(pc, vv[e].x, acc[i][e].x);
            acc[i][e].y = fmaf(pc, vv[e].y, acc[i][e].y);
            acc[i][e].z = fmaf(pc, vv[e].z, acc[i][e].z);
            acc[i][e].w = fmaf(pc, vv[e].w, acc[i][e].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= p.Tq) continue;
    const float inv = 1.f / l_i[i];
    float* orow = static_cast<float*>(p.o) + ((static_cast<long long>(b) * p.Tq + gq) * p.H + h) * p.hd;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float vals[4] = {acc[i][e].x, acc[i][e].y, acc[i][e].z, acc[i][e].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = e * 32 + tx * 4 + x;
        if (d < p.hd) orow[d] = vals[x] * inv;
      }
    }
    if (tx == 0) {
      p.m[static_cast<long long>(bh) * p.Tq + gq] = m_i[i];
      p.l[static_cast<long long>(bh) * p.Tq + gq] = l_i[i];
    }
  }
}

// ---------------------------------------------------------------- bfloat16

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A regs: (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k rows 2t..2t+1, col g), (k rows 2t+8..2t+9, col g)
//   C:      c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at (row g+8, same cols)
template <int HD>
__global__ void __launch_bounds__(NT) attn_bf16_kernel(const Params p) {
  constexpr int LDH = HD + 8;    // Q and K row stride (bf16): conflict-free fragment loads
  constexpr int LDV = BKV + 8;   // V^T row stride
  constexpr int KS = HD / 16;    // k-steps of q k^T
  constexpr int NS = BKV / 8;    // n-tiles of a score tile
  constexpr int NO = HD / 8;     // n-tiles of the output
  extern __shared__ float4 smem_f4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_f4);
  __nv_bfloat16* Ks = Qs + BQ * LDH;
  __nv_bfloat16* Vt = Ks + BKV * LDH;  // [HD][LDV]: V transposed
  __shared__ int8_t colstate[BKV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * BQ;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int gq = q0 + r;
    Qs[r * LDH + d] = (gq < p.Tq && d < p.hd) ? qg[gq * p.q_st + d] : zero;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = ld_b32(&Qs[r0 * LDH + ks * 16 + 2 * t]);
    qa[ks][1] = ld_b32(&Qs[(r0 + 8) * LDH + ks * 16 + 2 * t]);
    qa[ks][2] = ld_b32(&Qs[r0 * LDH + ks * 16 + 2 * t + 8]);
    qa[ks][3] = ld_b32(&Qs[(r0 + 8) * LDH + ks * 16 + 2 * t + 8]);
  }

  float m_i[2] = {kInitMax, kInitMax};
  float l_i[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BKV) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    for (int i = tid; i < BKV * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int gk = k0 + r;
      const bool in = gk < p.Tk && d < p.hd;
      Ks[r * LDH + d] = in ? kg[gk * p.k_st + d] : zero;
      Vt[d * LDV + r] = in ? vg[gk * p.v_st + d] : zero;
    }
    load_colstate(p.mask, p.mask_sb, p.Tk, b, k0, colstate);
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kr = &Ks[(n * 8 + g) * LDH + ks * 16 + 2 * t];
        mma_bf16(sc[n], qa[ks], ld_b32(kr), ld_b32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = apply_colstate(sc[n][e] * p.scale, colstate[n * 8 + 2 * t + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m_i[e >> 1]);
        sum[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + sum[r];
    }
    if (p.dropout) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t gq = q0 + r0 + 8 * (e >> 1);
          const uint32_t gk = k0 + n * 8 + 2 * t + (e & 1);
          sc[n][e] = keep(seed, p.threshold, p.Tq, p.Tk, h, gq, gk) ? sc[n][e] * p.keep_scale : 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];

    // P (score accumulators of n-tiles 2kk, 2kk+1 = A fragment of keys
    // 16kk..16kk+15, cast to bf16) times V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]), pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = &Vt[(n * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_bf16(oacc[n], pa, ld_b32(vr), ld_b32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gq = q0 + r0 + 8 * r;
    if (gq >= p.Tq) continue;
    const float inv = 1.f / l_i[r];
    __nv_bfloat16* orow =
        static_cast<__nv_bfloat16*>(p.o) + ((static_cast<long long>(b) * p.Tq + gq) * p.H + h) * p.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = n * 8 + 2 * t + x;
        if (d < p.hd) orow[d] = __float2bfloat16_rn(oacc[n][2 * r + x] * inv);
      }
    if (t == 0) {
      p.m[static_cast<long long>(bh) * p.Tq + gq] = m_i[r];
      p.l[static_cast<long long>(bh) * p.Tq + gq] = l_i[r];
    }
  }
}

template <int HD>
constexpr size_t f32_smem() {
  return sizeof(float) * (BQ * (HD + 4) + 2 * BKV * (HD + 4) + BQ * (BKV + 4));
}

template <int HD>
constexpr size_t bf16_smem() {
  return sizeof(__nv_bfloat16) * (BQ * (HD + 8) + BKV * (HD + 8) + HD * (BKV + 8));
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Params& p, void* stream) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.Tq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o, m, l for q [B, Tq, H, hd] and k, v [B, Tk, H, hd] given by strides (in
// elements; the head dim contiguous).  seeds: int32 [B] per-case dropout
// seeds, or null to use ``seed`` for every batch element.  is_bf16 selects bf16 inputs and
// output (else float32).  hd <= 128.  Returns cudaGetLastError() after the
// launch (or the error of the shared-memory opt-in).
extern "C" int mmf_attention_fwd(int is_bf16, const void* q, const void* k, const void* v,
                                 const void* mask, const void* seeds, void* o, void* m, void* l, int B, int H,
                                 int Tq, int Tk, int hd, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long mask_sb,
                                 float scale, float keep_scale, unsigned int threshold,
                                 unsigned int seed, int dropout, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.seeds = static_cast<const int*>(seeds);
  p.o = o;
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
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
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.keep_scale = keep_scale;
  p.threshold = threshold;
  p.seed = seed;
  p.dropout = dropout;
  if (hd <= 32) {
    return is_bf16 ? launch(attn_bf16_kernel<32>, bf16_smem<32>(), p, stream)
                   : launch(attn_f32_kernel<32>, f32_smem<32>(), p, stream);
  }
  if (hd <= 64) {
    return is_bf16 ? launch(attn_bf16_kernel<64>, bf16_smem<64>(), p, stream)
                   : launch(attn_f32_kernel<64>, f32_smem<64>(), p, stream);
  }
  return is_bf16 ? launch(attn_bf16_kernel<128>, bf16_smem<128>(), p, stream)
                 : launch(attn_f32_kernel<128>, f32_smem<128>(), p, stream);
}
