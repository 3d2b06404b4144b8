// Pieces shared by the fused-attention forward (attention.cu, K3) and
// backward (attention_bwd.cu, K4): tile sizes, the mask constants, the
// per-column key state and the hash dropout mask.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmf_attn {

constexpr int BQ = 64;    // query rows per tile
constexpr int BKV = 64;   // keys per shared-memory tile
constexpr int NT = 128;   // threads per block (4 warps)
constexpr float kNegInf = -1e9f;     // ops.masked.NEG_INF
constexpr float kInitMax = -1e30f;   // running-max start
constexpr int8_t kValid = 0, kMasked = 1, kOutside = 2;

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

// column states of one key tile: valid, user-masked, or past Tk
__device__ __forceinline__ void load_colstate(const uint8_t* mask, long long mask_sb, int Tk, int b,
                                              int k0, int8_t* colstate) {
  const int tid = threadIdx.x;
  if (tid < BKV) {
    const int gk = k0 + tid;
    int8_t st = kValid;
    if (gk >= Tk) {
      st = kOutside;
    } else if (mask != nullptr && mask[b * mask_sb + gk] == 0) {
      st = kMasked;
    }
    colstate[tid] = st;
  }
}

// dynamic shared memory above 48 KB needs the opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace mmf_attn
