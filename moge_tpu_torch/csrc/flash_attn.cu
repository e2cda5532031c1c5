// K2: flash attention forward, non-causal multi-head, head dim 64.
//
// Replaces moge_tpu/ops/attention.py::_flash_fwd_kernel (reached through
// flash_attention -> _flash_core_fwd_impl). Computes, for every (b, h) and
// query row i,
//   o_i = sum_j softmax_j(scale * q_i . k_j) v_j,   lse_i = logsumexp_j(scale * q_i . k_j)
// over the keys j < kv_valid, with the softmax in fp32 and the output
// rounded once to the input dtype. The LSE (natural log) is emitted for the
// backward (K2b-dq, K2b-dkv read it).
//
// What bounds it on an H100: at the ViT token counts (N = 1201..3601, 16
// heads) the work is 4*N^2*64 tensor-core flops and N^2 exps per head
// against 4*N*64 elements of traffic: bound by the tensor cores (989
// TFLOP/s bf16) with the exps on the MUFU units close behind, never by
// device memory, as long as the (N, N) logits never leave the chip.
//
// bf16, the main path: the Hopper kernel of flash_fwd.cuh (its note: TMA
// rings of 128-key K/V tiles, both products on wgmma, the softmax in
// registers), with the chain of K2: the
// scale folded into the exp, keys at or past kv_valid masked by index (TMA
// maps K and V over kv_valid rows, so the keys past it arrive as zeros), a
// row with no live key yet at m = 0 (the port's rule, not the TPU kernel's
// m >= 0 assumption), and the natural-log lse. At 16 heads and B = 1 that is
// 352 blocks at 1370 tokens (0.9 of one wave of 3 blocks per SM on 132
// SMs) and 912 at 3601 (2.3 waves); B = 8 at 1370 tokens 2816 (7.1 waves).
//
// fp32 (parity and gradient checks, not the main path): the plain-FMA kernel
// below. Its numbers hold the train-step parity within 1e-4; a TF32 wgmma
// would change them.

#include "flash_fwd.cuh"

namespace {

// ----------------------------------------------------------------- fp32 path

constexpr int kD = 64;         // head dim
constexpr int kBr = 64;        // query rows per block
constexpr int kBc = 64;        // keys per tile
constexpr int kWarps = 4;      // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kLdS = kBc + 4;  // fp32 row stride of S and O tiles
constexpr int kLdO = kD + 4;

template <typename T> struct Smem {
  static constexpr int kLdT = kD + kPad<T>;   // q/k/v rows
  static constexpr int kLdP = kBc + kPad<T>;  // probability rows
  static constexpr size_t q = sizeof(T) * kBr * kLdT;
  static constexpr size_t k = sizeof(T) * kBc * kLdT;
  static constexpr size_t s = sizeof(float) * kBr * kLdS;
  static constexpr size_t p = sizeof(T) * kBr * kLdP;
  static constexpr size_t o = sizeof(float) * kBr * kLdO;
  static constexpr size_t total = q + 2 * k + s + p + o;
};

// rows [row0, row0 + rows) of one (b, h) slice into shared memory, zero past n.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int64_t row_stride,
                                          int row0, int rows, int n) {
  constexpr int kEpv = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kVpr = kD / kEpv;       // vectors per row
  for (int i = threadIdx.x; i < rows * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i % kVpr) * kEpv;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const int4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<int4*>(dst + r * Smem<T>::kLdT + c) = val;
  }
}

// S_w (16 x kBc, fp32) = Q_w (16 x kD) . K^T for this warp's 16 rows.
__device__ __forceinline__ void qk_tile(const float* q, const float* k, float* s, int lane) {
  constexpr int ld = Smem<float>::kLdT;
  for (int idx = lane; idx < 16 * kBc; idx += 32) {
    const int r = idx / kBc, c = idx % kBc;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) acc = fmaf(q[r * ld + d], k[c * ld + d], acc);
    s[r * kLdS + c] = acc;
  }
}

// O_w (16 x kD, fp32, already rescaled) += P_w (16 x kBc) . V (kBc x kD).
__device__ __forceinline__ void pv_tile(const float* p, const float* v, float* o, int lane) {
  constexpr int ldp = Smem<float>::kLdP, ldv = Smem<float>::kLdT;
  for (int idx = lane; idx < 16 * kD; idx += 32) {
    const int r = idx / kD, c = idx % kD;
    float acc = 0.f;
#pragma unroll 16
    for (int j = 0; j < kBc; ++j) acc = fmaf(p[r * ldp + j], v[j * ldv + c], acc);
    o[r * kLdO + c] += acc;
  }
}


template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, int H, int Nq, int kv_valid,
              Strides sq, Strides sk, Strides sv, float scale) {
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + S::q);
  T* vs = reinterpret_cast<T*>(smem + S::q + S::k);
  float* ss = reinterpret_cast<float*>(smem + S::q + 2 * S::k);
  T* ps = reinterpret_cast<T*>(smem + S::q + 2 * S::k + S::s);
  float* os = reinterpret_cast<float*>(smem + S::q + 2 * S::k + S::s + S::p);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qbh = q + b * sq.b + h * sq.h;
  const T* kbh = k + b * sk.b + h * sk.h;
  const T* vbh = v + b * sv.b + h * sv.h;

  load_rows(qs, qbh, sq.n, q0, kBr, Nq);
  for (int i = threadIdx.x; i < kBr * kLdO; i += kThreads) os[i] = 0.f;

  // this warp's 16-row slices
  const T* qw = qs + warp * 16 * S::kLdT;
  float* sw = ss + warp * 16 * kLdS;
  T* pw = ps + warp * 16 * S::kLdP;
  float* ow = os + warp * 16 * kLdO;

  float m[16], l[16];  // running max / sum per row (uniform across the warp)
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = -INFINITY; l[r] = 0.f; }

  const int n_tiles = (kv_valid + kBc - 1) / kBc;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBc;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(ks, kbh, sk.n, k0, kBc, kv_valid);
    load_rows(vs, vbh, sv.n, k0, kBc, kv_valid);
    __syncthreads();

    qk_tile(qw, ks, sw, lane);
    __syncwarp();

    const bool ok0 = k0 + lane < kv_valid, ok1 = k0 + lane + 32 < kv_valid;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float s0 = ok0 ? sw[r * kLdS + lane] * scale : -INFINITY;
      const float s1 = ok1 ? sw[r * kLdS + lane + 32] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet stays 0
      const float p0 = expf(s0 - m_use);
      const float p1 = expf(s1 - m_use);
      const float alpha = expf(m[r] - m_use);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * S::kLdP + lane] = from_f<T>(p0);
      pw[r * S::kLdP + lane + 32] = from_f<T>(p1);
      ow[r * kLdO + lane] *= alpha;
      ow[r * kLdO + lane + 32] *= alpha;
    }
    __syncwarp();

    pv_tile(pw, vs, ow, lane);
    __syncwarp();
  }

  // epilogue: normalise, one rounding, store (B, Nq, H, kD) contiguous
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
    if (qi >= Nq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = out + ((static_cast<int64_t>(b) * Nq + qi) * H + h) * kD;
    orow[lane] = from_f<T>(ow[r * kLdO + lane] * inv);
    orow[lane + 32] = from_f<T>(ow[r * kLdO + lane + 32] * inv);
    if (lane == 0) lse[(static_cast<int64_t>(b) * H + h) * Nq + qi] = m[r] + logf(l[r]);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H, int Nq,
               int kv_valid, Strides sq, Strides sk, Strides sv, float scale, cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};
  const cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(flash_fwd_f32<float>),
                                    static_cast<int>(Smem<float>::total), opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Nq + kBr - 1) / kBr, H, B);
  flash_fwd_f32<float><<<grid, kThreads, Smem<float>::total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, H, Nq, kv_valid, sq, sk, sv, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ bf16 path (wgmma)

struct K2Chain {
  static constexpr bool bias = false, clamp60 = false, round_bf16 = false, no_exp = false, use_max = true,
                        floor0 = false, rescale = true, ext = false, pad_fix = false, lse = true;
};

int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H, int Nq,
                int kv_valid, Strides sq, Strides sk, Strides sv, float scale, int bc, int stages,
                cudaStream_t st) {
  if (bc != fwd::kBc || stages != fwd::kStages) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.out_sb = static_cast<int64_t>(Nq) * H * kD;
  prm.out_sn = static_cast<int64_t>(H) * kD;
  prm.out_sh = kD;
  prm.lse = lse;
  prm.Nq = Nq;
  prm.n_keys = kv_valid;
  prm.c = scale * 1.4426950408889634f;
  prm.scale = scale;
  return launch_flash_fwd<K2Chain>(prm, q, k, v, B, H, sq, sk, sv, st);
}

}  // namespace

// q: (B, Nq, H, 64), k/v: (B, Nkv, H, 64), each with unit stride on the last
// axis and the given element strides for (b, n, h); 16-byte aligned rows and
// strides. out: (B, Nq, H, 64) contiguous; lse: (B, H, Nq) fp32. Keys >=
// kv_valid are masked. bc, stages: the bf16 kernel's key tile and ring depth
// as ops/attention.py::flash_plan has them (they must be flash_fwd.cuh's),
// ignored for fp32. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int moge_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int B, int H, int Nq, int kv_valid,
                                        int64_t sqb, int64_t sqn, int64_t sqh,
                                        int64_t skb, int64_t skn, int64_t skh,
                                        int64_t svb, int64_t svn, int64_t svh,
                                        float scale, int dtype, int bc, int stages, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || kv_valid <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqn, sqh}, sk{skb, skn, skh}, sv{svb, svn, svh};
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_bf16(q, k, v, out, l, B, H, Nq, kv_valid, sq, sk, sv, scale, bc, stages, st);
  if (dtype == kFloat32) return launch_f32(q, k, v, out, l, B, H, Nq, kv_valid, sq, sk, sv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
