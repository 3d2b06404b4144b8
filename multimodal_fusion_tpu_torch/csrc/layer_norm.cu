// LayerNorm forward and backward for Hopper (sm_90a), flax's one-pass form.
//
// Replaces no Pallas TPU kernel: on the TPU, XLA fuses the norm's
// elementwise ops and row reductions into its neighbours.  On the card the
// same norm written as composite PyTorch ops (models/common.py:LayerNorm)
// costs about a dozen launches forward and two dozen backward, each a pass
// over the [rows, D] tensor.  For x [rows, D] with weight w and bias b [D]:
//
//   mu   = E[x],  var_raw = E[x*x] - mu*mu  (one pass of f32 sums)
//   rstd = rsqrt(max(var_raw, 0) + eps)
//   y    = (x - mu) * (rstd * w) + b
//
// each product and sum rounded as the composite rounds it (no contraction
// into FMAs).  Backward, with xhat = (x - mu) * rstd and g = dy * w:
//
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//        the last term dropped on rows where var_raw < 0 (clamp_min's
//        backward passes nothing there)
//   dw = sum over rows of dy * xhat,  db = sum over rows of dy.
//
// Bound on the H100: bytes.  The forward reads x and writes y, the
// backward reads x and dy and writes dx: 5 passes over rows * D values,
// plus 8 bytes a row of statistics.  mfmf_config1's 9 norms a window (3 of
// 262144 rows, 5 of 32768, 1 of 320, D = 128) move 2.4 GB, 0.73 ms at
// 3.35 TB/s.
//
// Design.  One warp per row: a lane holds its share of the row in
// registers, NC chunks of VEC values (16-byte loads of float32, 8-byte of
// bf16, where D % 4 == 0 and every row pointer is aligned; scalar loads
// otherwise), chunk c of lane l at columns (c * 32 + l) * VEC.  Row sums
// are a butterfly of warp shuffles (every lane ends with the same bits:
// IEEE addition commutes), with no shared memory and no second read of x.
// Where a lane holds at most 8 values a row, a warp takes 2 rows at once,
// so twice the loads are in flight.  The forward saves mu and rstd per row
// in float32; rstd carries var_raw < 0 as its sign bit (rstd itself is
// positive), for the backward's clamp.
//
// The backward is a persistent grid: as many blocks as fit the card at
// once (mmf_layer_norm_bwd_capacity gives that count, which sizes their
// workspace), each walking a fixed range of rows, its warps interleaved
// over them.  Each lane sums dy * xhat and dy for its columns over its
// rows in registers; the block's warps add theirs into shared memory in
// warp order and write one [D] partial per block and output; a second
// launch adds the partials in block order.  No atomics: two launches are
// bit-identical.
//
// Types: float32 forward and backward; bf16 forward (x, w, b and y bf16,
// statistics and arithmetic float32, y rounded once).  D from 1 to MAX_D;
// the C entries refuse (cudaErrorInvalidValue) anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int MAX_D = 1024;
constexpr int WARPS = 8;  // warps a block, both kernels
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC values at p (aligned to VEC elements where VEC == 4) as float32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same<T, float>::value) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&lo);
    q.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (std::is_same<T, float>::value) p[i] = v[i];
      else p[i] = __float2bfloat16_rn(v[i]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// a lane's first column of chunk c
template <int VEC>
__device__ __forceinline__ int column(int c, int lane) { return (c * 32 + lane) * VEC; }

// rows a warp takes at once: 2 where a lane holds at most 8 values a row
template <int VEC, int NC>
__host__ __device__ constexpr int rows_at_once() { return NC * VEC <= 8 ? 2 : 1; }

template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                      T* __restrict__ y, float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      int rows, int D, float inv_d, float eps) {
  constexpr int R = rows_at_once<VEC, NC>();
  const int lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * R;
  float v[R][NC][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = column<VEC>(c, lane);
      if (row0 + r < rows && col < D) {
        load_vec<T, VEC>(x + (row0 + r) * D + col, v[r][c]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[r][c][i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + r;
    if (row >= rows) break;  // uniform over the warp
    float s1 = 0.f, s2 = 0.f;  // zeros past D add nothing
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1 = __fadd_rn(s1, v[r][c][i]);
        s2 = __fadd_rn(s2, __fmul_rn(v[r][c][i], v[r][c][i]));
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mu = __fmul_rn(s1, inv_d);
    const float var_raw = __fsub_rn(__fmul_rn(s2, inv_d), __fmul_rn(mu, mu));
    const float rstd = rsqrtf(__fadd_rn(fmaxf(var_raw, 0.f), eps));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = column<VEC>(c, lane);
      if (col >= D) continue;
      float wv[VEC], bv[VEC], out[VEC];
      load_vec<T, VEC>(w + col, wv);
      load_vec<T, VEC>(b + col, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[r][c][i], mu), __fmul_rn(rstd, wv[i])), bv[i]);
      store_vec<T, VEC>(y + row * D + col, out);
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = var_raw < 0.f ? -rstd : rstd;
    }
  }
}

template <int VEC, int NC>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                      const float* __restrict__ w, const float* __restrict__ mu_in,
                      const float* __restrict__ rstd_in, float* __restrict__ dx,
                      float* __restrict__ part, int rows, int D, int rows_per_block, float inv_d) {
  constexpr int R = rows_at_once<VEC, NC>();
  __shared__ float acc[2 * MAX_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, static_cast<long long>(rows));
  float wv[NC][VEC], dw[NC][VEC], db[NC][VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = column<VEC>(c, lane);
#pragma unroll
    for (int i = 0; i < VEC; ++i) wv[c][i] = dw[c][i] = db[c][i] = 0.f;
    if (col < D) load_vec<float, VEC>(w + col, wv[c]);
  }
  for (long long base = r0 + warp * R; base < r1; base += WARPS * R) {
    float xv[R][NC][VEC], gv[R][NC][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = column<VEC>(c, lane);
        if (base + r < r1 && col < D) {
          load_vec<float, VEC>(x + (base + r) * D + col, xv[r][c]);
          load_vec<float, VEC>(dy + (base + r) * D + col, gv[r][c]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) xv[r][c][i] = gv[r][c][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r;
      if (row >= r1) break;  // uniform over the warp
      const float mu = mu_in[row];
      const float signed_rstd = rstd_in[row];
      const float rstd = fabsf(signed_rstd);
      float sg = 0.f, sgx = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // past D, dy and w are 0: those columns add nothing
          const float xhat = (xv[r][c][i] - mu) * rstd;
          const float d = gv[r][c][i];
          dw[c][i] += d * xhat;
          db[c][i] += d;
          xv[r][c][i] = xhat;
          gv[r][c][i] = d * wv[c][i];
          sg += gv[r][c][i];
          sgx += gv[r][c][i] * xhat;
        }
      }
      const float mg = warp_sum(sg) * inv_d;
      const float sum_gx = warp_sum(sgx);
      const float mgx = signed_rstd < 0.f ? 0.f : sum_gx * inv_d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = column<VEC>(c, lane);
        if (col >= D) continue;
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[i] = rstd * (gv[r][c][i] - mg - xv[r][c][i] * mgx);
        store_vec<float, VEC>(dx + row * D + col, out);
      }
    }
  }
  // the block's warps add their sums in warp order
  for (int k = 0; k < WARPS; ++k) {
    if (warp == k) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = column<VEC>(c, lane);
        if (col >= D) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[col + i] = (k == 0 ? 0.f : acc[col + i]) + dw[c][i];
          acc[MAX_D + col + i] = (k == 0 ? 0.f : acc[MAX_D + col + i]) + db[c][i];
        }
      }
    }
    __syncthreads();
  }
  const long long blocks = gridDim.x;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    part[blockIdx.x * static_cast<long long>(D) + i] = acc[i];
    part[(blocks + blockIdx.x) * D + i] = acc[MAX_D + i];
  }
}

// dw and db: column i of [2D] sums the P block partials in block order
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                             float* __restrict__ db, int P, int D) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= 2 * D) return;
  const float* p = part + (i < D ? i : static_cast<long long>(P) * D + (i - D));
  float s = 0.f;
#pragma unroll 16
  for (int k = 0; k < P; ++k) s += p[static_cast<long long>(k) * D];
  if (i < D) dw[i] = s;
  else db[i - D] = s;
}

// f(std::integral_constant<int, NC>) for NC, a power of 2 up to 32
template <typename F>
void with_nc(int nc, F&& f) {
  switch (nc) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    default: f(std::integral_constant<int, 32>{}); break;
  }
}

// chunks a lane holds: the power of 2 at or above D / (32 * VEC)
int chunks(int D, int vec) {
  int nc = 1;
  while (nc * 32 * vec < D) nc *= 2;
  return nc;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T>
int fwd(const void* x, const void* w, const void* b, void* y, void* mu, void* rstd, int rows, int D,
        float eps, cudaStream_t st) {
  const int vb = 4 * static_cast<int>(sizeof(T));
  const bool vec = D % 4 == 0 && aligned(x, vb) && aligned(w, vb) && aligned(b, vb) && aligned(y, vb);
  const float inv_d = 1.f / static_cast<float>(D);
  auto launch = [&](auto vec_c, auto nc_c) {
    constexpr int VEC = decltype(vec_c)::value, NC = decltype(nc_c)::value;
    if constexpr (VEC * NC * 32 <= MAX_D) {
      constexpr int per_block = WARPS * rows_at_once<VEC, NC>();
      const long long grid = (static_cast<long long>(rows) + per_block - 1) / per_block;
      layer_norm_fwd_kernel<T, VEC, NC><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
          static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), rows, D, inv_d, eps);
    }
  };
  if (vec) with_nc(chunks(D, 4), [&](auto nc_c) { launch(std::integral_constant<int, 4>{}, nc_c); });
  else with_nc(chunks(D, 1), [&](auto nc_c) { launch(std::integral_constant<int, 1>{}, nc_c); });
  return static_cast<int>(cudaGetLastError());
}

// The backward's grid policy, in one place: for rows of width D, as many
// blocks as are resident on the current device at once, and at most one
// for every WARPS rows.
template <typename F>
void with_bwd_kernel(int D, bool vec, F&& f) {
  auto pick = [&](auto vec_c, auto nc_c) {
    constexpr int VEC = decltype(vec_c)::value, NC = decltype(nc_c)::value;
    if constexpr (VEC * NC * 32 <= MAX_D) f(layer_norm_bwd_kernel<VEC, NC>);
  };
  if (vec) with_nc(chunks(D, 4), [&](auto nc_c) { pick(std::integral_constant<int, 4>{}, nc_c); });
  else with_nc(chunks(D, 1), [&](auto nc_c) { pick(std::integral_constant<int, 1>{}, nc_c); });
}

// *blocks: the backward's resident blocks at width D on the current device
// for the vector (vec) or scalar kernel, the rows of its workspace.
cudaError_t bwd_capacity(int D, bool vec, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  with_bwd_kernel(D, vec, [&](auto kernel) {
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  });
  *blocks = std::max(per_sm, 1) * sms;
  return err;
}

}  // namespace

// y, mu and rstd of x [rows, D] (float32, or bf16 with is_bf16), w and b
// [D] of x's type; mu and rstd float32 [rows], rstd negative where
// var_raw < 0.
extern "C" int mmf_layer_norm_fwd(int is_bf16, const void* x, const void* w, const void* b, void* y,
                                  void* mu, void* rstd, int rows, int D, float eps, void* stream) {
  if (rows < 1 || D < 1 || D > MAX_D || !x || !w || !b || !y || !mu || !rstd)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(x, w, b, y, mu, rstd, rows, D, eps, st)
                 : fwd<float>(x, w, b, y, mu, rstd, rows, D, eps, st);
}

// *blocks: the most blocks mmf_layer_norm_bwd launches at width D on the
// current device (the larger of its vector and scalar kernels'); its
// workspace holds 2 * *blocks * D floats.
extern "C" int mmf_layer_norm_bwd_capacity(int D, int* blocks) {
  if (D < 1 || D > MAX_D || !blocks) return static_cast<int>(cudaErrorInvalidValue);
  int scalar = 0, vector = 0;
  cudaError_t err = bwd_capacity(D, false, &scalar);
  if (err == cudaSuccess && D % 4 == 0) err = bwd_capacity(D, true, &vector);
  *blocks = std::max(scalar, vector);
  return static_cast<int>(err);
}

// dx [rows, D], dw and db [D] of float32 dy, x [rows, D], w [D] and the
// forward's mu and rstd [rows].  part holds 2 * capacity * D floats, with
// capacity from mmf_layer_norm_bwd_capacity.
extern "C" int mmf_layer_norm_bwd(const void* dy, const void* x, const void* w, const void* mu,
                                  const void* rstd, void* dx, void* dw, void* db, void* part,
                                  int rows, int D, int capacity, void* stream) {
  if (rows < 1 || D < 1 || D > MAX_D || capacity < 1 || !dy || !x || !w || !mu || !rstd || !dx ||
      !dw || !db || !part)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && aligned(dy, 16) && aligned(x, 16) && aligned(w, 16) && aligned(dx, 16);
  const float inv_d = 1.f / static_cast<float>(D);
  int resident = 0;
  cudaError_t err = bwd_capacity(D, vec, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (static_cast<long long>(rows) + WARPS - 1) / WARPS;
  const int P = static_cast<int>(std::min<long long>(want, std::min(resident, capacity)));
  const int rows_per_block = static_cast<int>((static_cast<long long>(rows) + P - 1) / P);
  with_bwd_kernel(D, vec, [&](auto kernel) {
    kernel<<<P, THREADS, 0, st>>>(static_cast<const float*>(dy), static_cast<const float*>(x),
                                  static_cast<const float*>(w), static_cast<const float*>(mu),
                                  static_cast<const float*>(rstd), static_cast<float*>(dx),
                                  static_cast<float*>(part), rows, D, rows_per_block, inv_d);
  });
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_bwd_reduce_kernel<<<(2 * D + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), static_cast<float*>(db), P, D);
  return static_cast<int>(cudaGetLastError());
}
