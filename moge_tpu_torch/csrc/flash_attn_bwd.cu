// K2b: flash attention backward, non-causal multi-head, head dim 64.
//
// Replaces moge_tpu/ops/attention.py::_flash_dq_kernel (K2b-dq) and
// ::_flash_dkv_kernel (K2b-dkv), reached through _flash_core_bwd. With
// logits s_ij = scale * q_i . k_j over the keys j < kv_valid, the forward's
// per-row logsumexp lse_i and delta_i = sum_d dO_id O_id (computed by the
// caller in plain PyTorch, as the JAX package does in XLA):
//   P_ij  = exp(s_ij - lse_i)                 (recomputed, never stored)
//   dS_ij = P_ij * (dO_i . v_j - delta_i)
//   dQ_i  = scale * sum_j dS_ij k_j
//   dK_j  = scale * sum_i dS_ij q_i,    dV_j = sum_i P_ij dO_i
// P and dS are rounded to the input dtype before their products, with fp32
// accumulation, as in the TPU kernels.
//
// What bounds it on an H100: like the forward, 4 (N, N, 64) products per
// head against O(N * 64) traffic, so the tensor cores and the exp, never
// device memory, as long as P stays on the chip. Design: two kernels, so
// that neither needs atomics and both are deterministic.
//   dq:  one block of 4 warps per (64 query rows, head, batch); each warp
//        owns 16 rows and walks the key tiles, accumulating dQ in shared
//        memory.
//   dkv: one block per (64 keys, head, batch); each warp owns 16 keys and
//        walks the query tiles, accumulating dK and dV in shared memory.
// Both recompute S and dP = dO V^T per tile from q/k/v/dO staged in shared
// memory, read through their strides (the (B, N, 3, H, 64) qkv projection and
// its gradient need no transposed copies). Keys at or past kv_valid are
// masked by index; a key tile entirely past kv_valid writes zeros. For bf16
// the products run on the tensor cores through WMMA 16x16x16 tiles with fp32
// accumulation; the fp32 variant uses plain fp32 FMAs. Deliberately simple:
// no cp.async/TMA pipelining, no wgmma, S/dP pass through shared memory.

#include "common.cuh"

#include <mma.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kB = 64;         // rows per tile, queries and keys alike
constexpr int kWarps = 4;      // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr int kLdF = kB + 4;   // fp32 tile row stride

template <typename T> struct Tile {
  static constexpr int ld = kD + kPad<T>;  // row stride of a (64, 64) T tile
  static constexpr size_t bytes = sizeof(T) * kB * ld;
};
constexpr size_t kFBytes = sizeof(float) * kB * kLdF;

struct Strides { int64_t b, n, h; };

// rows [row0, row0 + kB) of one (b, h) slice into shared memory, zero at or past n.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int64_t row_stride,
                                          int row0, int n) {
  constexpr int kEpv = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kVpr = kD / kEpv;       // vectors per row
  for (int i = threadIdx.x; i < kB * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i % kVpr) * kEpv;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const int4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<int4*>(dst + r * Tile<T>::ld + c) = val;
  }
}

// S_w (16 x 64, fp32) = A_w (16 x 64) . B^T, B a (64, 64) tile.
__device__ __forceinline__ void abt(const float* a, const float* b, float* s, int lane) {
  constexpr int ld = Tile<float>::ld;
  for (int idx = lane; idx < 16 * kB; idx += 32) {
    const int r = idx / kB, c = idx % kB;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) acc = fmaf(a[r * ld + d], b[c * ld + d], acc);
    s[r * kLdF + c] = acc;
  }
}

__device__ __forceinline__ void abt(const __nv_bfloat16* a, const __nv_bfloat16* b, float* s, int) {
  using namespace nvcuda;
  constexpr int ld = Tile<__nv_bfloat16>::ld;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wmma::load_matrix_sync(fa[kk], a + kk * 16, ld);
#pragma unroll
  for (int nt = 0; nt < kB / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      // B^T as a col-major (64 x 64) operand is B's row-major storage.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + nt * 16 * ld + kk * 16, ld);
      wmma::mma_sync(acc, fa[kk], fb, acc);
    }
    wmma::store_matrix_sync(s + nt * 16, acc, kLdF, wmma::mem_row_major);
  }
}

// O_w (16 x 64, fp32) += P_w (16 x 64) . B, B a (64, 64) tile.
__device__ __forceinline__ void acc_ab(const float* p, const float* b, float* o, int lane) {
  constexpr int ld = Tile<float>::ld;
  for (int idx = lane; idx < 16 * kD; idx += 32) {
    const int r = idx / kD, c = idx % kD;
    float acc = 0.f;
#pragma unroll 16
    for (int j = 0; j < kB; ++j) acc = fmaf(p[r * ld + j], b[j * ld + c], acc);
    o[r * kLdF + c] += acc;
  }
}

__device__ __forceinline__ void acc_ab(const __nv_bfloat16* p, const __nv_bfloat16* b, float* o,
                                       int) {
  using namespace nvcuda;
  constexpr int ld = Tile<__nv_bfloat16>::ld;
#pragma unroll
  for (int nt = 0; nt < kD / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o + nt * 16, kLdF, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p + kk * 16, ld);
      wmma::load_matrix_sync(fb, b + kk * 16 * ld + nt * 16, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(o + nt * 16, acc, kLdF, wmma::mem_row_major);
  }
}

// row r of this warp's 16 fp32 rows, times mul, rounded into a strided output row.
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const float* src, float mul, int lane) {
  dst[lane] = from_f<T>(src[lane] * mul);
  dst[lane + 32] = from_f<T>(src[lane + 32] * mul);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;  // (B, H, Nq) fp32
  void *dq, *dk, *dv;
  int H, Nq, Nkv, kv_valid;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr size_t tb = Tile<T>::bytes;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + tb);
  T* ks = reinterpret_cast<T*>(smem + 2 * tb);
  T* vs = reinterpret_cast<T*>(smem + 3 * tb);
  T* dss = reinterpret_cast<T*>(smem + 4 * tb);
  float* ss = reinterpret_cast<float*>(smem + 5 * tb);
  float* dps = reinterpret_cast<float*>(smem + 5 * tb + kFBytes);
  float* dqs = reinterpret_cast<float*>(smem + 5 * tb + 2 * kFBytes);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;

  load_rows(qs, static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, q0, a.Nq);
  load_rows(dos, static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h, a.sdo.n, q0, a.Nq);
  for (int i = threadIdx.x; i < kB * kLdF; i += kThreads) dqs[i] = 0.f;

  const int row0 = warp * 16;
  const T* qw = qs + row0 * Tile<T>::ld;
  const T* dow = dos + row0 * Tile<T>::ld;
  T* dsw = dss + row0 * Tile<T>::ld;
  float* sw = ss + row0 * kLdF;
  float* dpw = dps + row0 * kLdF;
  float* dqw = dqs + row0 * kLdF;

  // per-row lse and delta (uniform across the warp). Rows past Nq have zero
  // q and dO, so with lse = delta = 0 their dS is p * (0 - 0) = 0.
  const int64_t stat0 = (static_cast<int64_t>(b) * a.H + h) * a.Nq;
  float lse[16], delta[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + row0 + r;
    lse[r] = qi < a.Nq ? a.lse[stat0 + qi] : 0.f;
    delta[r] = qi < a.Nq ? a.delta[stat0 + qi] : 0.f;
  }

  const int n_tiles = (a.kv_valid + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(ks, k, a.sk.n, k0, a.kv_valid);
    load_rows(vs, v, a.sv.n, k0, a.kv_valid);
    __syncthreads();

    abt(qw, ks, sw, lane);    // S  = Q K^T
    abt(dow, vs, dpw, lane);  // dP = dO V^T
    __syncwarp();

    const bool ok0 = k0 + lane < a.kv_valid, ok1 = k0 + lane + 32 < a.kv_valid;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p0 = ok0 ? expf(sw[r * kLdF + lane] * a.scale - lse[r]) : 0.f;
      const float p1 = ok1 ? expf(sw[r * kLdF + lane + 32] * a.scale - lse[r]) : 0.f;
      dsw[r * Tile<T>::ld + lane] = from_f<T>(p0 * (dpw[r * kLdF + lane] - delta[r]));
      dsw[r * Tile<T>::ld + lane + 32] = from_f<T>(p1 * (dpw[r * kLdF + lane + 32] - delta[r]));
    }
    __syncwarp();

    acc_ab(dsw, ks, dqw, lane);  // dQ += dS K
    __syncwarp();
  }

  T* dq = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + row0 + r;
    if (qi < a.Nq) store_row(dq + qi * a.sdq.n, dqw + r * kLdF, a.scale, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  T* dk = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dv = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  if (k0 >= a.kv_valid) {  // every key of the tile is masked: zero gradients
    for (int r = 0; r < 16; ++r) {
      const int kj = k0 + row0 + r;
      if (kj >= a.Nkv) break;
      dk[kj * a.sdk.n + lane] = dk[kj * a.sdk.n + lane + 32] = from_f<T>(0.f);
      dv[kj * a.sdv.n + lane] = dv[kj * a.sdv.n + lane + 32] = from_f<T>(0.f);
    }
    return;
  }

  constexpr size_t tb = Tile<T>::bytes;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tb);
  T* qs = reinterpret_cast<T*>(smem + 2 * tb);
  T* dos = reinterpret_cast<T*>(smem + 3 * tb);
  T* ps = reinterpret_cast<T*>(smem + 4 * tb);
  T* dss = reinterpret_cast<T*>(smem + 5 * tb);
  float* ss = reinterpret_cast<float*>(smem + 6 * tb);
  float* dps = reinterpret_cast<float*>(smem + 6 * tb + kFBytes);
  float* dks = reinterpret_cast<float*>(smem + 6 * tb + 2 * kFBytes);
  float* dvs = reinterpret_cast<float*>(smem + 6 * tb + 3 * kFBytes);
  float* lse_s = reinterpret_cast<float*>(smem + 6 * tb + 4 * kFBytes);
  float* delta_s = lse_s + kB;

  load_rows(ks, static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n, k0, a.kv_valid);
  load_rows(vs, static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n, k0, a.kv_valid);
  for (int i = threadIdx.x; i < kB * kLdF; i += kThreads) dks[i] = dvs[i] = 0.f;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const int64_t stat0 = (static_cast<int64_t>(b) * a.H + h) * a.Nq;

  const T* kw = ks + row0 * Tile<T>::ld;
  const T* vw = vs + row0 * Tile<T>::ld;
  T* pw = ps + row0 * Tile<T>::ld;
  T* dsw = dss + row0 * Tile<T>::ld;
  float* sw = ss + row0 * kLdF;  // S^T and dP^T: this warp's keys x the tile's queries
  float* dpw = dps + row0 * kLdF;
  float* dkw = dks + row0 * kLdF;
  float* dvw = dvs + row0 * kLdF;

  bool keep[16];  // keys below kv_valid (masked keys get P = 0, never exp of their logit)
#pragma unroll
  for (int r = 0; r < 16; ++r) keep[r] = k0 + row0 + r < a.kv_valid;

  const int n_tiles = (a.Nq + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kB;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_rows(qs, q, a.sq.n, q0, a.Nq);
    load_rows(dos, dout, a.sdo.n, q0, a.Nq);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool ok = q0 + i < a.Nq;
      lse_s[i] = ok ? a.lse[stat0 + q0 + i] : INFINITY;  // padded queries: P = 0
      delta_s[i] = ok ? a.delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

    abt(kw, qs, sw, lane);    // S^T  = K Q^T
    abt(vw, dos, dpw, lane);  // dP^T = V dO^T
    __syncwarp();

    const float lse0 = lse_s[lane], lse1 = lse_s[lane + 32];
    const float dl0 = delta_s[lane], dl1 = delta_s[lane + 32];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p0 = keep[r] ? expf(sw[r * kLdF + lane] * a.scale - lse0) : 0.f;
      const float p1 = keep[r] ? expf(sw[r * kLdF + lane + 32] * a.scale - lse1) : 0.f;
      pw[r * Tile<T>::ld + lane] = from_f<T>(p0);
      pw[r * Tile<T>::ld + lane + 32] = from_f<T>(p1);
      dsw[r * Tile<T>::ld + lane] = from_f<T>(p0 * (dpw[r * kLdF + lane] - dl0));
      dsw[r * Tile<T>::ld + lane + 32] = from_f<T>(p1 * (dpw[r * kLdF + lane + 32] - dl1));
    }
    __syncwarp();

    acc_ab(pw, dos, dvw, lane);  // dV += P^T dO
    acc_ab(dsw, qs, dkw, lane);  // dK += dS^T Q
    __syncwarp();
  }

#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int kj = k0 + row0 + r;
    if (kj >= a.Nkv) break;
    store_row(dk + kj * a.sdk.n, dkw + r * kLdF, a.scale, lane);
    store_row(dv + kj * a.sdv.n, dvw + r * kLdF, 1.f, lane);
  }
}

template <typename T>
int launch_dq(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = 5 * Tile<T>::bytes + 3 * kFBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dq_kernel<T><<<dim3((a.Nq + kB - 1) / kB, a.H, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = 6 * Tile<T>::bytes + 4 * kFBytes + 2 * kB * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dkv_kernel<T><<<dim3((a.Nkv + kB - 1) / kB, a.H, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int Nq, int Nkv, int kv_valid) {
  return B <= 0 || H <= 0 || Nq <= 0 || Nkv <= 0 || kv_valid <= 0 || kv_valid > Nkv;
}

}  // namespace

// q: (B, Nq, H, 64), k/v: (B, Nkv, H, 64), dout and dq like q; each with unit
// stride on the last axis, the given element strides for (b, n, h) and
// 16-byte aligned rows (the outputs only need unit stride). lse/delta:
// (B, H, Nq) fp32 contiguous. Keys >= kv_valid are masked. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int moge_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, int B, int H, int Nq, int Nkv, int kv_valid,
                                           const int64_t* strides, float scale, int dtype,
                                           void* stream) {
  if (bad_shape(B, H, Nq, Nkv, kv_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = strides;  // (b, n, h) of q, k, v, dout, dq
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, H, Nq, Nkv, kv_valid,
         {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
         {s[12], s[13], s[14]}, {}, {}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_dq<__nv_bfloat16>(a, B, st);
  if (dtype == kFloat32) return launch_dq<float>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above; dk/dv like k (rows >= kv_valid get zeros). strides: (b, n, h) of
// q, k, v, dout, dk, dv.
extern "C" int moge_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int B, int H, int Nq, int Nkv,
                                            int kv_valid, const int64_t* strides, float scale,
                                            int dtype, void* stream) {
  if (bad_shape(B, H, Nq, Nkv, kv_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = strides;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, H, Nq, Nkv, kv_valid,
         {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
         {}, {s[12], s[13], s[14]}, {s[15], s[16], s[17]}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_dkv<__nv_bfloat16>(a, B, st);
  if (dtype == kFloat32) return launch_dkv<float>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
