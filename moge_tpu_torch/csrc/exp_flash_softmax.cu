// T1: seven softmax chains inside one flash-attention forward.
//
// Replaces tools/exp_flash_softmax.py::build -> make_kernel(variant), the TPU
// probe of what the softmax's elementwise chain costs beside the matrix
// work. For each of bh heads, unscaled logits s = q . k (fp32 sums of bf16
// products) over n_pad keys, then per variant:
//   0 base:         s + bias (0 or -inf), running max, p = exp(s - m), sum
//   1 nobias:       no bias over zero-padded keys, running max from 0, and
//                   (n_pad - n) * exp(-m) taken off the sum at the end
//   2 bf16sm:       s + bias, max, s - m and exp rounded to bf16, fp32 sum
//   3 noexp:        p = relu(s - m) with m the running max including the
//                   current tile: every p is 0, the output is exactly 0
//   4 nomax:        p = exp(min(s + bias, 60)), no max, no rescale
//   5 mxusum:       V carries a 65th column, the key's validity; the sum is
//                   P . V's last column on the tensor cores, running max from 0
//   6 mxusum_nomax: as 5 with p = exp(min(s, 60)), no max
// and out = (P V) / max(l, 1e-30), rounded once to bf16. The TPU kernel sees
// the whole key row; here every variant works online over key tiles (the
// running max and the rescale of the accumulator), as a flash forward must.
//
// What bounds it on an H100: 4 * bh * n_pad * n * 64 flops on the tensor
// cores (~0.054 ms at bh = 16, n = 3601) and bh * n_pad * n exps on the MUFU
// units (16 per clock per SM, ~0.05 ms at 1.98 GHz): the two are the same
// size, so the question of the TPU probe (does exp cost time?) is open here.
// Design: K2's structure (csrc/flash_attn.cu), one block of 4 warps per 64
// query rows and head; Q K^T and P V through WMMA 16x16x16 bf16 tiles with
// fp32 accumulation, S and O in shared memory; each warp owns 16 rows and
// keeps their running max and sum. The variant is a template parameter, so
// each chain compiles to only its own instructions. The 65-wide V of the
// mxusum variants is padded to 80 columns (5 WMMA tiles): P V then costs
// 80/64 of the base's, 1.125x the tensor-core work of the whole kernel, and
// V's 130-byte rows are loaded element by element.

#include "common.cuh"

#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim of q and k
constexpr int kBr = 64;        // query rows per block
constexpr int kBc = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int kLdT = kD + 8;   // bf16 q/k rows in shared memory
constexpr int kLdS = kBc + 4;  // fp32 logit rows
constexpr int kLdP = kBc + 8;  // bf16 probability rows

enum Variant { kBase = 0, kNoBias, kBf16Sm, kNoExp, kNoMax, kMxuSum, kMxuSumNoMax, kVariants };

template <int V> struct Tr {
  static constexpr bool use_bias = V == kBase || V == kBf16Sm || V == kNoExp || V == kNoMax;
  static constexpr bool ext = V == kMxuSum || V == kMxuSumNoMax;  // denominator from V's validity column
  static constexpr bool use_max = !(V == kNoMax || V == kMxuSumNoMax);
  static constexpr bool floor0 = V == kNoBias || V == kMxuSum;    // running max starts at 0
  static constexpr bool rescale = V == kBase || V == kNoBias || V == kBf16Sm || V == kMxuSum;
  static constexpr bool clamp60 = V == kNoMax || V == kMxuSumNoMax;
  static constexpr int dv = ext ? 80 : kD;  // V / O columns, 65 padded to a multiple of 16
  static constexpr int ldv = dv + 8;
  static constexpr int ldo = dv + 4;
  static constexpr size_t q = sizeof(bf16) * kBr * kLdT;
  static constexpr size_t k = sizeof(bf16) * kBc * kLdT;
  static constexpr size_t v = sizeof(bf16) * kBc * ldv;
  static constexpr size_t s = sizeof(float) * kBr * kLdS;
  static constexpr size_t p = sizeof(bf16) * kBr * kLdP;
  static constexpr size_t o = sizeof(float) * kBr * ldo;
  static constexpr size_t total = q + k + v + s + p + o;
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// rows [row0, row0 + 64) of a (n, 64) bf16 slice into shared memory (row stride kLdT)
__device__ __forceinline__ void load_rows64(bf16* dst, const bf16* __restrict__ src, int row0) {
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<int4*>(dst + r * kLdT + c) = *reinterpret_cast<const int4*>(src + (row0 + r) * kD + c);
  }
}

// S_w (16 x kBc, fp32) = Q_w (16 x kD) . K^T for one warp's 16 rows
__device__ __forceinline__ void qk_tile(const bf16* q, const bf16* k, float* s) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wmma::load_matrix_sync(a[kk], q + kk * 16, kLdT);
#pragma unroll
  for (int nt = 0; nt < kBc / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;  // K^T: K's rows
      wmma::load_matrix_sync(b, k + nt * 16 * kLdT + kk * 16, kLdT);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(s + nt * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// O_w (16 x DV, fp32, already rescaled) += P_w (16 x kBc) . V (kBc x DV)
template <int DV, int LDV, int LDO>
__device__ __forceinline__ void pv_tile(const bf16* p, const bf16* v, float* o) {
  using namespace nvcuda;
#pragma unroll
  for (int nt = 0; nt < DV / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o + nt * 16, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p + kk * 16, kLdP);
      wmma::load_matrix_sync(b, v + kk * 16 * LDV + nt * 16, LDV);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o + nt * 16, acc, LDO, wmma::mem_row_major);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
flash_softmax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ out, int n_pad, int dv_in,
                     float pad_cols) {
  using S = Tr<V>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::q);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::q + S::k);
  float* ss = reinterpret_cast<float*>(smem + S::q + S::k + S::v);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::q + S::k + S::v + S::s);
  float* os = reinterpret_cast<float*>(smem + S::q + S::k + S::v + S::s + S::p);

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k + bh * n_pad * kD;
  const bf16* vb = v + bh * n_pad * dv_in;

  load_rows64(qs, q + bh * n_pad * kD, q0);
  for (int i = threadIdx.x; i < kBr * S::ldo; i += kThreads) os[i] = 0.f;

  const bf16* qw = qs + warp * 16 * kLdT;
  float* sw = ss + warp * 16 * kLdS;
  bf16* pw = ps + warp * 16 * kLdP;
  float* ow = os + warp * 16 * S::ldo;

  float m[16], l[16];  // per row, uniform across the warp
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = S::floor0 ? 0.f : -INFINITY; l[r] = 0.f; }

  for (int k0 = 0; k0 < n_pad; k0 += kBc) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows64(ks, kb, k0);
    if (S::ext) {  // 65-wide rows: element loads, zero past column dv_in
      for (int i = threadIdx.x; i < kBc * S::dv; i += kThreads) {
        const int r = i / S::dv, c = i % S::dv;
        vs[r * S::ldv + c] = c < dv_in ? vb[static_cast<int64_t>(k0 + r) * dv_in + c] : __float2bfloat16(0.f);
      }
    } else {
      for (int i = threadIdx.x; i < kBc * 8; i += kThreads) {
        const int r = i >> 3, c = (i & 7) * 8;
        *reinterpret_cast<int4*>(vs + r * S::ldv + c) = *reinterpret_cast<const int4*>(vb + (k0 + r) * kD + c);
      }
    }
    __syncthreads();

    qk_tile(qw, ks, sw);
    __syncwarp();

    const float b0 = S::use_bias ? bias[k0 + lane] : 0.f, b1 = S::use_bias ? bias[k0 + lane + 32] : 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s0 = sw[r * kLdS + lane] + b0, s1 = sw[r * kLdS + lane + 32] + b1;
      if (S::clamp60) { s0 = fminf(s0, 60.f); s1 = fminf(s1, 60.f); }
      if (V == kBf16Sm) { s0 = round_bf16(s0); s1 = round_bf16(s1); }
      float m_new = m[r], m_use = 0.f;
      if (S::use_max) {
        m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
        m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet stays 0
      }
      float p0, p1;
      if (V == kNoExp) {
        p0 = fmaxf(s0 - m_use, 0.f);
        p1 = fmaxf(s1 - m_use, 0.f);
      } else if (V == kBf16Sm) {
        p0 = round_bf16(__expf(round_bf16(s0 - m_use)));
        p1 = round_bf16(__expf(round_bf16(s1 - m_use)));
      } else {
        p0 = __expf(s0 - m_use);
        p1 = __expf(s1 - m_use);
      }
      const float alpha = S::rescale ? __expf(m[r] - m_use) : 1.f;
      m[r] = m_new;
      if (!S::ext) l[r] = l[r] * alpha + warp_sum(p0 + p1);
      pw[r * kLdP + lane] = __float2bfloat16(p0);
      pw[r * kLdP + lane + 32] = __float2bfloat16(p1);
      if (S::rescale) {
#pragma unroll
        for (int c = lane; c < S::dv; c += 32) ow[r * S::ldo + c] *= alpha;
      }
    }
    __syncwarp();

    pv_tile<S::dv, S::ldv, S::ldo>(pw, vs, ow);
    __syncwarp();
  }

  // epilogue: out = O / max(l, 1e-30), one rounding to bf16, (bh, n_pad, 64) contiguous
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
    float den = S::ext ? ow[r * S::ldo + kD] : l[r];
    if (V == kNoBias) den -= pad_cols * __expf(-m[r]);  // the zero-padded keys' exp(0 - m) each
    den = fmaxf(den, 1e-30f);
    bf16* orow = out + (bh * n_pad + qi) * kD;
    orow[lane] = __float2bfloat16(ow[r * S::ldo + lane] / den);
    orow[lane + 32] = __float2bfloat16(ow[r * S::ldo + lane + 32] / den);
  }
}

template <int V>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out, int bh, int n_pad,
           int dv_in, float pad_cols, cudaStream_t stream) {
  const size_t smem = Tr<V>::total;
  cudaError_t e = cudaFuncSetAttribute(flash_softmax_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_pad / kBr, bh);
  flash_softmax_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(out), n_pad, dv_in, pad_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: (bh, n_pad, 64) bf16 contiguous; v: (bh, n_pad, 64) bf16, or (bh,
// n_pad, 65) for variants 5 and 6 (last column: 1 for a real key, 0 for a
// pad); bias: n_pad fp32 (0 or -inf), read by variants 0, 2, 3, 4; out: (bh,
// n_pad, 64) bf16. n_pad a multiple of 64; n_real the real keys (variant 1's
// correction). Returns cudaGetLastError() after the launch.
extern "C" int moge_flash_softmax_variant(const void* q, const void* k, const void* v, const void* bias, void* out,
                                          int bh, int n_pad, int n_real, int variant, void* stream) {
  if (bh <= 0 || n_pad <= 0 || n_pad % kBr != 0 || n_real <= 0 || n_real > n_pad || variant < 0 ||
      variant >= kVariants)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float pad = static_cast<float>(n_pad - n_real);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: return launch<kBase>(q, k, v, b, out, bh, n_pad, kD, pad, st);
    case kNoBias: return launch<kNoBias>(q, k, v, b, out, bh, n_pad, kD, pad, st);
    case kBf16Sm: return launch<kBf16Sm>(q, k, v, b, out, bh, n_pad, kD, pad, st);
    case kNoExp: return launch<kNoExp>(q, k, v, b, out, bh, n_pad, kD, pad, st);
    case kNoMax: return launch<kNoMax>(q, k, v, b, out, bh, n_pad, kD, pad, st);
    case kMxuSum: return launch<kMxuSum>(q, k, v, b, out, bh, n_pad, kD + 1, pad, st);
    default: return launch<kMxuSumNoMax>(q, k, v, b, out, bh, n_pad, kD + 1, pad, st);
  }
}
