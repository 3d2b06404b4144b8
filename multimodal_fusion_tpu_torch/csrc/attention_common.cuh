// Pieces shared by the fused-attention forward (attention.cu, K3) and
// backward (attention_bwd.cu, K4): tile sizes, the routes, the mask
// constants, the per-column key state, the hash dropout mask, the listing of
// the runs of 16 keys that hold work under a key mask, the 16-dim row-slice
// loads of the narrow routes, and the general routes' 16-byte cp.async tile
// copies (whole tiles, or tiles gathered from listed runs) and bf16
// ldmatrix / mma.sync helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace mmf_attn {

constexpr int BQ = 64;    // query rows per tile (general routes)
constexpr int BKV = 64;   // keys per shared-memory tile (general routes)
constexpr int NT = 128;   // threads per block (4 warps)
constexpr float kNegInf = -1e9f;     // ops.masked.NEG_INF
constexpr float kInitMax = -1e30f;   // running-max start
constexpr int8_t kValid = 0, kMasked = 1, kOutside = 2;

// Routes, chosen by the wrapper (ops/attention_kernel.py:_route, which
// mirrors NARROW).  A narrow route keeps the narrow side (<= NARROW rows of
// q or keys) whole in shared memory and spreads the long side over the
// threads, HD / 16 lanes per long-side row, 16 dims per lane.
constexpr int kRouteGeneral = 0, kRouteNarrowQ = 1, kRouteNarrowK = 2;
constexpr int NARROW = 16;

// the narrow routes' head-dim instantiations: hd padded to 16, 32, 64 or 128
inline int narrow_hd(int hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

template <int HD>
struct NarrowRows {
  static constexpr int LANES = HD / 16;    // lanes per long-side row
  static constexpr int ROWS = NT / LANES;  // long-side rows per block
};

// long-side chunks (blocks) of a narrow route
inline int narrow_chunks(int long_len, int hd) {
  const int rows = NT / (narrow_hd(hd) / 16);
  return (long_len + rows - 1) / rows;
}

// pallas_attention._keep_mask at one absolute (head, q, k) index: keep iff
// fmix32((h*Tq + q)*Tk + k) * 0x9E3779B9 + seed) >= threshold, in uint32
// arithmetic.  The seed is the case's own (one per batch element) or one
// shared by the batch.
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t threshold, int Tq, int Tk,
                                     uint32_t h, uint32_t q, uint32_t k) {
  uint32_t lin = (h * static_cast<uint32_t>(Tq) + q) * static_cast<uint32_t>(Tk) + k;
  uint32_t z = lin * 0x9E3779B9u + seed;
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z >= threshold;
}

// the dropout seed of batch element b: seeds[b] when given, else the shared one
__device__ __forceinline__ uint32_t case_seed(const int* seeds, uint32_t seed, int b) {
  return seeds != nullptr ? static_cast<uint32_t>(seeds[b]) : seed;
}

// the state of key gk of batch element b: valid, user-masked, or past Tk
__device__ __forceinline__ int8_t key_state(const uint8_t* mask, long long mask_sb, int Tk, int b,
                                            int gk) {
  if (gk >= Tk) return kOutside;
  return (mask != nullptr && mask[b * mask_sb + gk] == 0) ? kMasked : kValid;
}

// column states of one key tile: valid, user-masked, or past Tk
__device__ __forceinline__ void load_colstate(const uint8_t* mask, long long mask_sb, int Tk, int b,
                                              int k0, int8_t* colstate) {
  const int tid = threadIdx.x;
  if (tid < BKV) colstate[tid] = key_state(mask, mask_sb, Tk, b, k0 + tid);
}

// ------------------------------------------------- runs of keys with work
//
// The general routes under a key mask take keys in runs of SUB: for a case
// with at least one valid key, a user-masked key has p = exp(-1e9 - m) == 0
// exactly in float32 (m is at least that valid key's score), so a run
// without a valid key adds nothing and is skipped; a case with no valid key
// keeps every run below Tk (its rows average uniformly).  A block lists the
// runs with work and streams key tiles gathered from the list.

constexpr int SUB = 16;  // keys per run

// Whether batch element b keeps at least one key: a block-wide scan of its
// mask row, 128 keys a step, that stops at the first step holding a valid
// key (the first, for the prefix masks of a padded bag).  Every thread of
// the block must call it.
__device__ __forceinline__ bool case_has_valid(const uint8_t* mask, long long mask_sb, int Tk, int b) {
  if (mask == nullptr) return Tk > 0;
  for (int k0 = 0; k0 < Tk; k0 += NT) {
    const int k = k0 + threadIdx.x;
    if (__syncthreads_or(k < Tk && mask[b * mask_sb + k] != 0)) return true;
  }
  return false;
}

// whether run r (keys 16r..16r+15) of batch element b holds work: a valid
// key, or (all-masked case) any key below Tk
__device__ __forceinline__ bool run_has_work(const uint8_t* mask, long long mask_sb, int Tk, int b, int r,
                                             bool has_valid) {
  bool on = false;
#pragma unroll
  for (int e = 0; e < SUB; ++e) {
    const int8_t st = key_state(mask, mask_sb, Tk, b, r * SUB + e);
    on |= has_valid ? st == kValid : st != kOutside;
  }
  return on;
}

// The runs r0 .. r0 + n - 1 of batch element b that hold work, in order,
// into runs[]; returns their count.  wsum: NT / 32 ints of shared scratch.
// Every thread must call it; runs[] is complete for every thread on return.
__device__ __forceinline__ int list_runs(const uint8_t* mask, long long mask_sb, int Tk, int b, int r0, int n,
                                         bool has_valid, int* runs, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < n; base += NT) {
    const int i = base + threadIdx.x;
    const bool on = i < n && run_has_work(mask, mask_sb, Tk, b, r0 + i, has_valid);
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int off = total, add = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      off += w < warp ? wsum[w] : 0;
      add += wsum[w];
    }
    if (on) runs[off + __popc(bal & ((1u << lane) - 1u))] = r0 + i;
    total += add;
    __syncthreads();  // wsum is rewritten next round; runs[] is complete
  }
  return total;
}

// the key of row rr of a tile gathered from listed runs, the tile's first
// run being entry e0 of the list's n: runs[e0 + rr / SUB] * SUB + rr % SUB,
// or Tk (no key) past the list
__device__ __forceinline__ int run_key(const int* runs, int e0, int n, int rr, int Tk) {
  const int e = e0 + rr / SUB;
  return e < n ? runs[e] * SUB + rr % SUB : Tk;
}

// Dynamic shared memory above 48 KB needs the opt-in, once per kernel and
// device (the attribute stays set), not at every launch.
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<uint64_t> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

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

// Dims [d0, d0 + 16) of one row as float32, zero at and past hd.  The row
// is 16-byte aligned (the wrapper guarantees it for every input row), so a
// 16-byte chunk that lies inside hd is one vector load.
__device__ __forceinline__ void load_slice(float (&x)[16], const float* row, int d0, int hd) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d = d0 + 4 * c;
    if (d + 4 <= hd) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + d));
      x[4 * c] = v.x;
      x[4 * c + 1] = v.y;
      x[4 * c + 2] = v.z;
      x[4 * c + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * c + e] = d + e < hd ? row[d + e] : 0.f;
    }
  }
}

__device__ __forceinline__ void load_slice(float (&x)[16], const __nv_bfloat16* row, int d0, int hd) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = d0 + 8 * c;
    if (d + 8 <= hd) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + d));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        x[8 * c + 2 * e] = __low2float(pair);
        x[8 * c + 2 * e + 1] = __high2float(pair);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[8 * c + e] = d + e < hd ? __bfloat162float(row[d + e]) : 0.f;
    }
  }
}

// Dims [d0, d0 + 16) of an output row (contiguous [.., hd]), those below hd.
// ``vec``: rows are 16-byte aligned (hd * sizeof(T) is a multiple of 16).
__device__ __forceinline__ void store_slice(float* row, const float (&x)[16], int d0, int hd, bool vec) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d = d0 + 4 * c;
    if (vec && d + 4 <= hd) {
      *reinterpret_cast<float4*>(row + d) = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < hd) row[d + e] = x[4 * c + e];
    }
  }
}

__device__ __forceinline__ void store_slice(__nv_bfloat16* row, const float (&x)[16], int d0, int hd,
                                            bool vec) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = d0 + 8 * c;
    if (vec && d + 8 <= hd) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 pair = __floats2bfloat162_rn(x[8 * c + 2 * e], x[8 * c + 2 * e + 1]);
        w[e] = *reinterpret_cast<uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(row + d) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (d + e < hd) row[d + e] = __float2bfloat16_rn(x[8 * c + e]);
    }
  }
}

// ------------------------------------------------------- async copies

// 16-byte global -> shared copy of which the first ``bytes`` (0..16) are
// read and the rest zero-filled; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of a [T, hd] slice (token stride st, elements of T)
// into a shared tile of row stride LD elements, HD columns, zero past T and
// hd, as 16-byte cp.async copies
template <typename E, int HD, int LD, int ROWS = 64>
__device__ __forceinline__ void copy_tile(E* dst, const E* src, long long st, int r0, int n_rows,
                                          int hd) {
  constexpr int PER = 16 / sizeof(E);  // elements per 16-byte chunk
  constexpr int CH = HD / PER;         // chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const int g = r0 + r;
    const int left = (hd - c * PER) * static_cast<int>(sizeof(E));
    const int bytes = g < n_rows ? max(0, min(16, left)) : 0;
    const E* from = bytes > 0 ? src + g * st + c * PER : src;
    cp_async16(dst + r * LD + c * PER, from, bytes);
  }
}

// rows of a streamed key tile gathered from listed runs: tile row rr is key
// run_key(runs, e0, n, rr, Tk), or nothing (zero-filled) past the list's n
// entries or Tk; 16-byte cp.async copies as copy_tile
template <typename E, int HD, int LD, int C = BKV>
__device__ __forceinline__ void copy_run_tile(E* dst, const E* src, long long st, const int* runs, int e0,
                                              int n, int Tk, int hd) {
  constexpr int PER = 16 / sizeof(E);
  constexpr int CH = HD / PER;
  for (int i = threadIdx.x; i < C * CH; i += NT) {
    const int rr = i / CH, c = i - (i / CH) * CH;
    const int g = run_key(runs, e0, n, rr, Tk);
    const int left = (hd - c * PER) * static_cast<int>(sizeof(E));
    const int bytes = g < Tk ? max(0, min(16, left)) : 0;
    const E* from = bytes > 0 ? src + g * st + c * PER : src;
    cp_async16(dst + rr * LD + c * PER, from, bytes);
  }
}

// ------------------------------------------------ bf16 tensor-core pieces

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum over the LANES lanes of one long-side row (consecutive lanes of a
// warp), in a fixed butterfly order; every lane gets the sum.  Every lane
// of the warp must call it.
template <int LANES>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dot of two 16-dim slices, summed in dim order
__device__ __forceinline__ float dot16(const float (&a)[16], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 16; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], v.x, s);
    s = fmaf(a[d + 1], v.y, s);
    s = fmaf(a[d + 2], v.z, s);
    s = fmaf(a[d + 3], v.w, s);
  }
  return s;
}

// The narrow routes' sum over the long side of a block, staged in shared
// memory: out[j][d] = sum_r W[r * ldw + j] * X[r * ldx + d] for j < nj,
// d < HD, r < n_rows.  Each warp takes groups of (j, 4 dims) in turn; lane
// l sums rows l, l + 32, ... in order, then a butterfly over the warp adds
// the lanes, so the order is fixed.  ldx / 4 is odd: the float4 reads of
// eight lanes hit eight bank groups.  emit(j, d, sum) runs on every lane.
template <int HD, typename Emit>
__device__ __forceinline__ void staged_sum(const float* W, int ldw, const float* X, int ldx, int n_rows,
                                           int nj, Emit emit) {
  const int lane = threadIdx.x & 31;
  for (int grp = threadIdx.x >> 5; grp < nj * (HD / 4); grp += NT / 32) {
    const int j = grp / (HD / 4), d = (grp % (HD / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = lane; r < n_rows; r += 32) {
      const float w = W[r * ldw + j];
      const float4 x = *reinterpret_cast<const float4*>(&X[r * ldx + d]);
      a.x = fmaf(w, x.x, a.x);
      a.y = fmaf(w, x.y, a.y);
      a.z = fmaf(w, x.z, a.z);
      a.w = fmaf(w, x.w, a.w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
    }
    emit(j, d, a);
  }
}

}  // namespace mmf_attn
