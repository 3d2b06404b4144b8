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
// their batch, token and head strides (the head dim is contiguous, every
// row 16-byte aligned: the wrapper checks it), so the ViT's fused qkv output
// [B, T, 3, H, hd] needs no transpose copy.  o is a contiguous [B, Tq, H, hd].
//
// Three routes (the wrapper picks one by shape, ops/attention_kernel.py):
//
// general (both sides > NARROW; the ViT, T = 257): one 128-thread block per
//   (batch*head, 64-row q tile); K and V tiles stream through a ring of
//   STAGES shared-memory slots filled by 16-byte cp.async copies (zero-fill
//   past T and hd), so tile j+1's copy overlaps tile j's products.  Bound
//   on the H100 at the ViT-L shape (B*H = 512, T = 257, hd = 64): 8.7 GFLOP
//   against 135 MB in f32, operations bound (0.13 ms at the 67 TFLOP/s
//   non-tensor peak); in bf16 the 67 MB are the bound (0.02 ms).
//     f32: each thread owns a 4 x 8 block of scores (rows ty + 16i, keys
//          tx + 8j) and 4 rows x hd/8 output dims; 128-bit shared loads
//          along hd, P goes through shared memory for the P.V product.
//          Under a key mask a block first lists its case's runs of 16 keys
//          that hold a valid key (K4's listing, attention_common.cuh) and
//          streams K/V tiles gathered from the list, so a run without one
//          is never read or computed (its p is exactly 0); a case with no
//          valid key keeps every run.  MFMF config1's masks keep about a
//          quarter of block 3's runs (8 markers of 9-16 in buckets of 64)
//          and ceil(n/16) of block 2's 256 (a WSI prefix of 2048-4096).
//          Without a mask (the ViT) every tile streams as before.
//     bf16: each warp owns 16 q rows and runs mma.sync m16n8k16 (bf16 in,
//          f32 accumulate); Q and K fragments come from ldmatrix.x4, V's
//          straight from row-major V by ldmatrix.x4.trans; rows are padded
//          by 16 bytes so the eight rows of an 8x8 matrix hit eight bank
//          groups; the score accumulators are re-packed in registers as the
//          A operand of P.V.  8-key n-tiles past Tk are skipped, and warps
//          whose 16 rows all lie past Tq only help load.  It streams every
//          tile, masked or not.
// narrow_k (Tk <= NARROW; MFMF's reconstructed bag against 5 result
//   tokens): every key of a (batch, head) sits in shared memory; each q row
//   belongs to HD/16 lanes (16 dims each) that compute its scores against
//   every key, a one-pass softmax m = max(-1e30, max s), and o.  The bytes
//   of q and o bound it.
// narrow_q (Tq <= NARROW; 5 tokens against a bag): all q rows sit in shared
//   memory; each block takes 128/(HD/16) keys, one per lane group, and
//   keeps its own (m, l, acc) for the rows; a second launch combines the
//   blocks' partials in chunk order (m is a max, so it stays exact).  The
//   bytes of k and v bound it; a user-masked key's k is never read.
// hd is padded with zeros to 16, 32, 64 or 128 on every route (hd <= 128);
// at hd 16 each f32 general-route thread owns a pair of output dims.  The
// async copies, ldmatrix and mma.sync helpers are attention_common.cuh's,
// shared with K4.  wgmma and TMA are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace mmf_attn;
using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B or 1, Tk], 1 = keep; null = no mask
  const int* seeds;     // [B] per-case dropout seeds; null = ``seed`` for all
  void* o;
  float* m;
  float* l;
  float* part;          // narrow_q partials (workspace); null when one chunk
  int B, H, Tq, Tk, hd;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask_sb;
  float scale, keep_scale;
  uint32_t threshold, seed;
  int dropout;
};

// K/V ring depth of the general routes: double buffering (a third slot
// adds 18 KB a block in bf16 at hd 64: 3 blocks per SM instead of 4)
constexpr int STAGES = 2;

__device__ __forceinline__ float apply_colstate(float s, int8_t st) {
  return st == kOutside ? -INFINITY : (st == kMasked ? kNegInf : s);
}

// ---------------------------------------------------------------- float32

// K/V tiles of the listing path gathered from at most this many listed runs
// at a time (4096 keys): a longer key side is listed in segments
constexpr int FWD_RUNS = 256;

// LISTED (the host entry takes it for a call with a key mask): a block lists
// its case's runs of SUB keys with work (attention_common.cuh) and streams
// K/V tiles gathered from the list, 4 runs a tile; tile row rr is key
// run_key(...), whose column state and dropout draw come from that absolute
// index, and rows past the list are outside (-inf, p 0).  A case with a
// valid key then skips every run without one (their p is exactly 0); a
// case without keeps every run, so its tiles are the unlisted path's.
template <int HD, bool LISTED>
__device__ __forceinline__ void attn_f32_tiles(const Params& p) {
  constexpr int LD = HD + 4;    // Q/K/V row stride (floats): conflict-free float4 reads
  constexpr int LDP = BKV + 4;  // P row stride
  constexpr int RPT = BKV / SUB;  // listed runs per tile
  // output dims per thread: NV float4 groups, dims e*32 + tx*4 + 0..3; at
  // hd 16 one pair, dims tx*2 + 0..1 (the group's z and w stay unused)
  constexpr int NV = HD >= 32 ? HD / 32 : 1;
  constexpr int XN = HD >= 32 ? 4 : 2;
  constexpr int TILE = BKV * LD;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * LD;          // [STAGES][BKV][LD]
  float* Vs = Ks + STAGES * TILE;    // [STAGES][BKV][LD]
  float* Ps = Vs + STAGES * TILE;
  __shared__ int8_t colstate[STAGES][BKV];
  __shared__ int runs[LISTED ? FWD_RUNS : 1];
  __shared__ int wsum[LISTED ? NT / 32 : 1];

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

  copy_tile<float, HD, LD>(Qs, qg, p.q_st, q0, p.Tq, p.hd);
  cp_async_commit();

  float m_i[4], l_i[4];
  float4 acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kInitMax;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_runs = (p.Tk + SUB - 1) / SUB;
  const bool has_valid = LISTED ? case_has_valid(p.mask, p.mask_sb, p.Tk, b) : true;
  const int n_segs = LISTED ? (n_runs + FWD_RUNS - 1) / FWD_RUNS : 1;
  for (int seg = 0; seg < n_segs; ++seg) {
    int n = 0, n_tiles = (p.Tk + BKV - 1) / BKV;  // listed runs, key tiles
    if constexpr (LISTED) {
      n = list_runs(p.mask, p.mask_sb, p.Tk, b, seg * FWD_RUNS, min(FWD_RUNS, n_runs - seg * FWD_RUNS),
                    has_valid, runs, wsum);
      n_tiles = (n + RPT - 1) / RPT;
    }
    auto load_kv = [&](int tile) {
      const int slot = tile % STAGES;
      if constexpr (LISTED) {
        copy_run_tile<float, HD, LD>(Ks + slot * TILE, kg, p.k_st, runs, tile * RPT, n, p.Tk, p.hd);
        copy_run_tile<float, HD, LD>(Vs + slot * TILE, vg, p.v_st, runs, tile * RPT, n, p.Tk, p.hd);
        if (tid < BKV)
          colstate[slot][tid] = key_state(p.mask, p.mask_sb, p.Tk, b, run_key(runs, tile * RPT, n, tid, p.Tk));
      } else {
        copy_tile<float, HD, LD>(Ks + slot * TILE, kg, p.k_st, tile * BKV, p.Tk, p.hd);
        copy_tile<float, HD, LD>(Vs + slot * TILE, vg, p.v_st, tile * BKV, p.Tk, p.hd);
        load_colstate(p.mask, p.mask_sb, p.Tk, b, tile * BKV, colstate[slot]);
      }
    };

#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) load_kv(t);
      cp_async_commit();
    }

    for (int j = 0; j < n_tiles; ++j) {
      cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread
      __syncthreads();              // ... for every thread; slot (j-1) is free
      if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
      cp_async_commit();
      const int slot = j % STAGES;
      const int k0 = j * BKV;
      const float* Kt = Ks + slot * TILE;
      const float* Vt = Vs + slot * TILE;
      const int8_t* cs = colstate[slot];

      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4], kv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) kv[jj] = *reinterpret_cast<const float4*>(&Kt[(tx + 8 * jj) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            float a = s[i][jj];
            a = fmaf(qv[i].x, kv[jj].x, a);
            a = fmaf(qv[i].y, kv[jj].y, a);
            a = fmaf(qv[i].z, kv[jj].z, a);
            a = fmaf(qv[i].w, kv[jj].w, a);
            s[i][jj] = a;
          }
      }

      // online softmax; the 8 threads of a row group are 8 consecutive lanes
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[i][jj] = apply_colstate(s[i][jj] * p.scale, cs[tx + 8 * jj]);
          mx = fmaxf(mx, s[i][jj]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m_i[i], mx);
        const float alpha = expf(m_i[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[i][jj] = expf(s[i][jj] - m_new);
          sum += s[i][jj];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        l_i[i] = l_i[i] * alpha + sum;
        m_i[i] = m_new;
        if (p.dropout) {
          const uint32_t gq = q0 + ty + 16 * i;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = tx + 8 * jj;
            const uint32_t gk = LISTED ? run_key(runs, j * RPT, n, c, p.Tk) : k0 + c;
            s[i][jj] = keep(seed, p.threshold, p.Tq, p.Tk, h, gq, gk) ? s[i][jj] * p.keep_scale : 0.f;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) Ps[(ty + 16 * i) * LDP + tx + 8 * jj] = s[i][jj];
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
          for (int e = 0; e < NV; ++e) {
            if constexpr (HD >= 32) {
              vv[e] = *reinterpret_cast<const float4*>(&Vt[(c + cc) * LD + e * 32 + tx * 4]);
            } else {
              const float2 v2 = *reinterpret_cast<const float2*>(&Vt[(c + cc) * LD + tx * 2]);
              vv[e] = make_float4(v2.x, v2.y, 0.f, 0.f);
            }
          }
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
    if constexpr (LISTED) {  // the next segment's list rewrites runs[] and refills the ring
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

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
      for (int x = 0; x < XN; ++x) {
        const int d = HD >= 32 ? e * 32 + tx * 4 + x : tx * 2 + x;
        if (d < p.hd) orow[d] = vals[x] * inv;
      }
    }
    if (tx == 0) {
      p.m[static_cast<long long>(bh) * p.Tq + gq] = m_i[i];
      p.l[static_cast<long long>(bh) * p.Tq + gq] = l_i[i];
    }
  }
}

template <int HD, bool LISTED>
__global__ void __launch_bounds__(NT) attn_f32_kernel(const Params p) {
  attn_f32_tiles<HD, LISTED>(p);
}

// The listing path's bookkeeping takes hd 16 from the unlisted path's 128
// registers (4 blocks an SM) to 160 (3 blocks); held to 4 blocks it spills
// 40 bytes and runs MFMF config1's two blocks 3-6% faster on the H100.
template <>
__global__ void __launch_bounds__(NT, 4) attn_f32_kernel<16, true>(const Params p) {
  attn_f32_tiles<16, true>(p);
}

// ---------------------------------------------------------------- bfloat16

// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A regs: (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k rows 2t..2t+1, col g), (k rows 2t+8..2t+9, col g)
//   C:      c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at (row g+8, same cols)
// ldmatrix.x4 hands lane l element (row l/4, cols 2(l%4)..+1) of each 8x8
// matrix (.trans: rows 2(l%4)..+1, col l/4).  So, with lane l addressing:
//   Q (A of q k^T): row 16w + l%16, col 16ks + 8(l/16)  -> a0..a3;
//   K (B of q k^T, K row-major = B col-major): key 16np + l%8 + 8(l/16),
//     dim 16ks + 8((l/8)%2) -> b0, b1 of n-tile 2np, b0, b1 of 2np+1;
//   V (B of P.V, .trans from row-major V): key 16kk + l%8 + 8((l/8)%2),
//     dim 16np + 8(l/16) -> b0, b1 of dims 16np.., b0, b1 of dims 16np+8..
template <int HD>
__global__ void __launch_bounds__(NT) attn_bf16_kernel(const Params p) {
  constexpr int LDH = HD + 8;    // row stride (bf16): 16 bytes of padding
  constexpr int KS = HD / 16;    // k-steps of q k^T
  constexpr int NS = BKV / 8;    // n-tiles of a score tile
  constexpr int NO = HD / 8;     // n-tiles of the output
  constexpr int TILE = BKV * LDH;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);
  bf16* Ks = Qs + BQ * LDH;        // [STAGES][BKV][LDH]
  bf16* Vs = Ks + STAGES * TILE;   // [STAGES][BKV][LDH], row-major
  __shared__ int8_t colstate[STAGES][BKV];

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
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.Tk + BKV - 1) / BKV;
  const bool active = q0 + warp * 16 < p.Tq;  // some of this warp's rows exist

  auto load_kv = [&](int tile) {
    const int slot = tile % STAGES;
    copy_tile<bf16, HD, LDH>(Ks + slot * TILE, kg, p.k_st, tile * BKV, p.Tk, p.hd);
    copy_tile<bf16, HD, LDH>(Vs + slot * TILE, vg, p.v_st, tile * BKV, p.Tk, p.hd);
    load_colstate(p.mask, p.mask_sb, p.Tk, b, tile * BKV, colstate[slot]);
  };

  copy_tile<bf16, HD, LDH>(Qs, qg, p.q_st, q0, p.Tq, p.hd);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KS][4];
  float m_i[2] = {kInitMax, kInitMax};
  float l_i[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread
    __syncthreads();              // ... for every thread; slot (j-1) is free
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    cp_async_commit();
    if (!active) continue;  // rows all past Tq: this warp only loads
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qa[ks], &Qs[(warp * 16 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8]);
    }
    const int slot = j % STAGES;
    const int k0 = j * BKV;
    const int n_valid = min(BKV, p.Tk - k0);
    const bf16* Kt = Ks + slot * TILE;
    const bf16* Vt = Vs + slot * TILE;
    const int8_t* cs = colstate[slot];

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      if (np * 16 >= n_valid) continue;  // 16 keys all past Tk
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &Kt[(np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + ks * 16 +
                            ((lane >> 3) & 1) * 8]);
        mma_bf16(sc[2 * np], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa[ks], kb[2], kb[3]);
      }
    }

    // a tile of valid keys only (no mask, none past Tk) skips the column states
    const bool full = p.mask == nullptr && k0 + BKV <= p.Tk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = sc[n][e] * p.scale;
        sc[n][e] = full ? sv : apply_colstate(sv, cs[n * 8 + 2 * t + (e & 1)]);
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
        // the hardware exp (ex2.approx): within a few units of 2^-23 of expf
        // where p matters (scores near the max), exact at 0 and 0 at -inf;
        // p rounds to bf16 before P.V anyway
        sc[n][e] = __expf(sc[n][e] - m_i[e >> 1]);
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
      if (kk * 16 >= n_valid) continue;
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]), pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vt[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + np * 16 +
                                  (lane >> 4) * 8]);
        mma_bf16(oacc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(oacc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  const bool pairs = (p.hd & 1) == 0;  // o rows 4-byte aligned: store bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gq = q0 + r0 + 8 * r;
    if (gq >= p.Tq) continue;
    const float inv = 1.f / l_i[r];
    bf16* orow = static_cast<bf16*>(p.o) + ((static_cast<long long>(b) * p.Tq + gq) * p.H + h) * p.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t;
      const float lo = oacc[n][2 * r] * inv, hi = oacc[n][2 * r + 1] * inv;
      if (pairs && d + 1 < p.hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (d < p.hd) orow[d] = __float2bfloat16_rn(lo);
        if (d + 1 < p.hd) orow[d + 1] = __float2bfloat16_rn(hi);
      }
    }
    if (t == 0) {
      p.m[static_cast<long long>(bh) * p.Tq + gq] = m_i[r];
      p.l[static_cast<long long>(bh) * p.Tq + gq] = l_i[r];
    }
  }
}

template <int HD>
constexpr size_t f32_smem() {
  return sizeof(float) * (BQ * (HD + 4) + 2 * STAGES * BKV * (HD + 4) + BQ * (BKV + 4));
}

template <int HD>
constexpr size_t bf16_smem() {
  return sizeof(bf16) * (BQ * (HD + 8) + 2 * STAGES * BKV * (HD + 8));
}

// --------------------------------------------------------- narrow routes

// Tk <= NARROW: every key in shared memory, HD/16 lanes per q row
template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_narrow_k_kernel(const Params p) {
  constexpr int LANES = NarrowRows<HD>::LANES, ROWS = NarrowRows<HD>::ROWS;
  __shared__ __align__(16) float Ks[NARROW * HD];
  __shared__ __align__(16) float Vs[NARROW * HD];
  __shared__ int8_t colstate[NARROW];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  // this thread's q row first: its loads are in flight while K and V are staged
  const int d0 = (tid % LANES) * 16;
  const int gq = blockIdx.y * ROWS + tid / LANES;
  const bool valid = gq < p.Tq;
  float x[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) x[d] = 0.f;
  if (valid) load_slice(x, qg + gq * p.q_st, d0, p.hd);
  for (int i = tid; i < NARROW * HD; i += NT) {
    const int jk = i / HD, d = i % HD;
    const bool in = jk < p.Tk && d < p.hd;
    Ks[i] = in ? to_f(kg[jk * p.k_st + d]) : 0.f;
    Vs[i] = in ? to_f(vg[jk * p.v_st + d]) : 0.f;
  }
  if (tid < NARROW) colstate[tid] = key_state(p.mask, p.mask_sb, p.Tk, b, tid);
  __syncthreads();

  // two passes over the keys in shared memory: the max, then p, l and P.V
  // with each score recomputed by the same instructions (so bit-equal), no
  // register array indexed by key
  float mx = kInitMax;
#pragma unroll 1
  for (int jk = 0; jk < p.Tk; ++jk) {
    const float dot = lane_sum<LANES>(dot16(x, &Ks[jk * HD + d0]));
    mx = fmaxf(mx, colstate[jk] == kMasked ? kNegInf : __fmul_rn(dot, p.scale));
  }
  float l = 0.f;
  float acc[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) acc[d] = 0.f;
#pragma unroll 1
  for (int jk = 0; jk < p.Tk; ++jk) {
    const float dot = lane_sum<LANES>(dot16(x, &Ks[jk * HD + d0]));
    float pj = expf((colstate[jk] == kMasked ? kNegInf : __fmul_rn(dot, p.scale)) - mx);
    l += pj;
    if (p.dropout) pj = keep(seed, p.threshold, p.Tq, p.Tk, h, gq, jk) ? pj * p.keep_scale : 0.f;
    pj = round_to<T>(pj);  // p in v's dtype before P.V
    const float* vr = &Vs[jk * HD + d0];
#pragma unroll
    for (int d = 0; d < 16; ++d) acc[d] = fmaf(pj, vr[d], acc[d]);
  }
  if (!valid) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < 16; ++d) acc[d] *= inv;
  T* orow = static_cast<T*>(p.o) + ((static_cast<long long>(b) * p.Tq + gq) * p.H + h) * p.hd;
  store_slice(orow, acc, d0, p.hd, (p.hd * sizeof(T)) % 16 == 0);
  if (d0 == 0) {
    p.m[static_cast<long long>(bh) * p.Tq + gq] = mx;
    p.l[static_cast<long long>(bh) * p.Tq + gq] = l;
  }
}

template <int HD>
struct NarrowQ {
  static constexpr int LANES = NarrowRows<HD>::LANES;
  static constexpr int ROWS = NarrowRows<HD>::ROWS;  // keys per block
  static constexpr int LDS = NARROW + 1;   // score row stride: conflict-free
  static constexpr int LDV = HD + 4;
  static constexpr size_t smem = sizeof(float) * (NARROW * HD + ROWS * LDS + ROWS * LDV);
};

// Tq <= NARROW: every q row in shared memory, HD/16 lanes per key; each
// block keeps (m, l, acc) of its ROWS keys for every row
template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_narrow_q_kernel(const Params p) {
  using G = NarrowQ<HD>;
  constexpr int LANES = G::LANES, ROWS = G::ROWS, LDS = G::LDS, LDV = G::LDV;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [NARROW][HD]
  float* S = Qs + NARROW * HD;                    // [ROWS][LDS] scores, then p
  float* Vst = S + ROWS * LDS;                    // [ROWS][LDV] this block's v rows
  __shared__ float row_m[NARROW], row_l[NARROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * ROWS;
  const uint32_t seed = case_seed(p.seeds, p.seed, b);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  // this thread's key first: its loads are in flight while q is staged
  const int r = tid / LANES;
  const int d0 = (tid % LANES) * 16;
  const int gk = k0 + r;
  const int8_t st = key_state(p.mask, p.mask_sb, p.Tk, b, gk);
  float kx[16], vx[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) kx[d] = vx[d] = 0.f;
  if (st == kValid) load_slice(kx, kg + gk * p.k_st, d0, p.hd);  // a masked key's score is replaced
  if (st != kOutside) load_slice(vx, vg + gk * p.v_st, d0, p.hd);
  for (int i = tid; i < NARROW * HD; i += NT) {
    const int qr = i / HD, d = i % HD;
    Qs[i] = (qr < p.Tq && d < p.hd) ? to_f(qg[qr * p.q_st + d]) : 0.f;
  }
#pragma unroll
  for (int d = 0; d < 16; d += 4)
    *reinterpret_cast<float4*>(&Vst[r * LDV + d0 + d]) = make_float4(vx[d], vx[d + 1], vx[d + 2], vx[d + 3]);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NARROW; ++i) {
    if (i >= p.Tq) break;
    const float dot = lane_sum<LANES>(dot16(kx, &Qs[i * HD + d0]));
    if (d0 == 0) S[r * LDS + i] = apply_colstate(dot * p.scale, st);
  }
  __syncthreads();

  // per row: the block's max and exp-sum over its keys (each warp takes
  // rows warp, warp + 4, ...; lanes stride the keys, then a fixed tree)
  for (int i = warp; i < p.Tq; i += NT / 32) {
    float mx = kInitMax;
    for (int kr = lane; kr < ROWS; kr += 32) mx = fmaxf(mx, S[kr * LDS + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int kr = lane; kr < ROWS; kr += 32) {
      float e = expf(S[kr * LDS + i] - mx);
      sum += e;
      if (p.dropout) e = keep(seed, p.threshold, p.Tq, p.Tk, h, i, k0 + kr) ? e * p.keep_scale : 0.f;
      S[kr * LDS + i] = round_to<T>(e);  // p in v's dtype before P.V
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      row_m[i] = mx;
      row_l[i] = sum;
    }
  }
  __syncthreads();

  // acc[i][:] = sum over this block's keys of p[key, i] v[key, :]
  const bool direct = gridDim.y == 1;  // one chunk: no combine launch
  const long long c = static_cast<long long>(bh) * gridDim.y + blockIdx.y;
  staged_sum<HD>(S, LDS, Vst, LDV, min(ROWS, p.Tk - k0), p.Tq, [&](int i, int d, float4 a) {
    if (lane != 0) return;
    const float vals[4] = {a.x, a.y, a.z, a.w};
    if (direct) {
      T* orow = static_cast<T*>(p.o) + ((static_cast<long long>(b) * p.Tq + i) * p.H + h) * p.hd;
      const float inv = 1.f / row_l[i];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < p.hd) store(orow + d + e, vals[e] * inv);
      if (d == 0) {
        p.m[static_cast<long long>(bh) * p.Tq + i] = row_m[i];
        p.l[static_cast<long long>(bh) * p.Tq + i] = row_l[i];
      }
    } else {
      float* pc = p.part + (c * NARROW + i) * (HD + 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) pc[d + e] = vals[e];
      if (d == 0) {
        pc[HD] = row_m[i];
        pc[HD + 1] = row_l[i];
      }
    }
  });
}

// the narrow_q blocks' partials of one (batch*head) combined in chunk order:
// m = max(-1e30, max m_c), l = sum l_c e^(m_c - m), o = sum acc_c e^(m_c - m) / l
template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_combine_kernel(const Params p, int n_chunks) {
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const float* part = p.part + static_cast<long long>(bh) * n_chunks * NARROW * (HD + 2);
  for (int o = threadIdx.x; o < p.Tq * HD; o += NT) {
    const int i = o / HD, d = o % HD;
    float m = kInitMax;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, part[(c * NARROW + i) * (HD + 2) + HD]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* pc = part + (c * NARROW + i) * (HD + 2);
      const float w = expf(pc[HD] - m);
      l = fmaf(pc[HD + 1], w, l);
      a = fmaf(pc[d], w, a);
    }
    if (d < p.hd) {
      T* orow = static_cast<T*>(p.o) + ((static_cast<long long>(b) * p.Tq + i) * p.H + h) * p.hd;
      store(orow + d, a * (1.f / l));
    }
    if (d == 0) {
      p.m[static_cast<long long>(bh) * p.Tq + i] = m;
      p.l[static_cast<long long>(bh) * p.Tq + i] = l;
    }
  }
}

template <auto Kernel>
int launch(size_t smem, const Params& p, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Kernel<<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the general route at head-dim instantiation HD: bf16, or float32 with
// the listing path under a key mask
template <int HD>
int launch_general(int is_bf16, const Params& p, dim3 grid, cudaStream_t stream) {
  if (is_bf16) return launch<attn_bf16_kernel<HD>>(bf16_smem<HD>(), p, grid, stream);
  if (p.mask != nullptr) return launch<attn_f32_kernel<HD, true>>(f32_smem<HD>(), p, grid, stream);
  return launch<attn_f32_kernel<HD, false>>(f32_smem<HD>(), p, grid, stream);
}

template <typename T, int HD>
int launch_narrow(int route, const Params& p, cudaStream_t stream) {
  if (route == kRouteNarrowK) {
    const dim3 grid(p.B * p.H, narrow_chunks(p.Tq, HD));
    return launch<attn_narrow_k_kernel<T, HD>>(0, p, grid, stream);
  }
  const int n_chunks = max(1, narrow_chunks(p.Tk, HD));
  if (n_chunks > 1 && p.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch<attn_narrow_q_kernel<T, HD>>(NarrowQ<HD>::smem, p, dim3(p.B * p.H, n_chunks), stream);
  if (err != 0 || n_chunks == 1) return err;
  attn_combine_kernel<T, HD><<<p.B * p.H, NT, 0, stream>>>(p, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_narrow_hd(int route, const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch_narrow<T, 16>(route, p, stream);
  if (p.hd <= 32) return launch_narrow<T, 32>(route, p, stream);
  if (p.hd <= 64) return launch_narrow<T, 64>(route, p, stream);
  return launch_narrow<T, 128>(route, p, stream);
}

}  // namespace

// Bytes of float32 workspace that mmf_attention_fwd needs on ``route``
// (0 when none): the narrow_q blocks' partials when they are more than one
// chunk of keys.
extern "C" long long mmf_attention_fwd_workspace(int route, int B, int H, int Tq, int Tk, int hd) {
  (void)Tq;
  const long long n_chunks = narrow_chunks(Tk, hd);
  if (route != kRouteNarrowQ || n_chunks <= 1) return 0;
  return static_cast<long long>(sizeof(float)) * B * H * n_chunks * NARROW * (narrow_hd(hd) + 2);
}

// o, m, l for q [B, Tq, H, hd] and k, v [B, Tk, H, hd] given by strides (in
// elements; the head dim contiguous, every row 16-byte aligned).  seeds:
// int32 [B] per-case dropout seeds, or null to use ``seed`` for every batch
// element.  is_bf16 selects bf16 inputs and output (else float32).  route:
// 0 general, 1 narrow_q (Tq <= 16), 2 narrow_k (Tk <= 16).  workspace:
// mmf_attention_fwd_workspace bytes (null when that is 0).  hd <= 128.
// Returns cudaGetLastError() after the launches (or the error of the
// shared-memory opt-in, or cudaErrorInvalidValue for a route the shape does
// not allow).
extern "C" int mmf_attention_fwd(int is_bf16, int route, const void* q, const void* k, const void* v,
                                 const void* mask, const void* seeds, void* o, void* m, void* l,
                                 void* workspace, int B, int H, int Tq, int Tk, int hd,
                                 long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                 long long k_st, long long k_sh, long long v_sb, long long v_st,
                                 long long v_sh, long long mask_sb, float scale, float keep_scale,
                                 unsigned int threshold, unsigned int seed, int dropout, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.seeds = static_cast<const int*>(seeds);
  p.o = o;
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
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
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.keep_scale = keep_scale;
  p.threshold = threshold;
  p.seed = seed;
  p.dropout = dropout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((route == kRouteNarrowQ && Tq > NARROW) || (route == kRouteNarrowK && Tk > NARROW) ||
      route < kRouteGeneral || route > kRouteNarrowK || hd > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteGeneral) {
    return is_bf16 ? launch_narrow_hd<bf16>(route, p, s) : launch_narrow_hd<float>(route, p, s);
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  if (hd <= 16) return launch_general<16>(is_bf16, p, grid, s);
  if (hd <= 32) return launch_general<32>(is_bf16, p, grid, s);
  if (hd <= 64) return launch_general<64>(is_bf16, p, grid, s);
  return launch_general<128>(is_bf16, p, grid, s);
}
