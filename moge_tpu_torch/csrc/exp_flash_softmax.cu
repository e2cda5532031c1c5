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
// Design: K2's Hopper kernel (flash_fwd.cuh) with the variant as its chain
// policy, so each chain compiles to only its own instructions: the (bh,
// n_pad, 64) operands are mapped as bh batch entries of one head, the logits are
// unscaled (c = log2 e), and keys past n_pad (n_pad need not be a multiple
// of the 128-key tile) are masked as K2 masks keys past kv_valid.
// The mxusum variants: V's rows of 65 bf16 are 130 bytes, not a stride TMA
// can take, so the threads stage each V tile with 2-byte loads into two
// 64-column swizzle atoms (the layout TMA would write; columns 65-79 zero)
// behind a proxy fence and a barrier, and P V runs at N = 80 (the validity
// column rides in the product, as on the TPU): 80/64 of the base's P V
// work, 1.125x the tensor-core work of the whole kernel, plus a synchronous
// copy of 80 elements per thread per tile and a barrier that the TMA ring of
// the other variants does not pay.

#include "flash_fwd.cuh"

namespace {

enum Variant { kBase = 0, kNoBias, kBf16Sm, kNoExp, kNoMax, kMxuSum, kMxuSumNoMax, kVariants };

template <int V> struct Chain {
  static constexpr bool bias = V == kBase || V == kBf16Sm || V == kNoExp || V == kNoMax;
  static constexpr bool clamp60 = V == kNoMax || V == kMxuSumNoMax;
  static constexpr bool round_bf16 = V == kBf16Sm;
  static constexpr bool no_exp = V == kNoExp;
  static constexpr bool use_max = !(V == kNoMax || V == kMxuSumNoMax);
  static constexpr bool floor0 = V == kNoBias || V == kMxuSum;  // running max starts at 0
  static constexpr bool rescale = V == kBase || V == kNoBias || V == kBf16Sm || V == kMxuSum;
  static constexpr bool ext = V == kMxuSum || V == kMxuSumNoMax;  // denominator from V's validity column
  static constexpr bool pad_fix = V == kNoBias;
  static constexpr bool lse = false;
};

template <int V>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out, int bh, int n_pad,
           float pad_cols, cudaStream_t stream) {
  constexpr int kD = fwd::kD;
  FwdParams prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.out_sb = static_cast<int64_t>(n_pad) * kD;
  prm.out_sn = kD;
  prm.bias = bias;
  prm.v_ext = static_cast<const __nv_bfloat16*>(v);
  prm.Nq = prm.n_keys = n_pad;
  prm.c = 1.4426950408889634f;
  prm.scale = 1.f;
  prm.pad_cols = pad_cols;
  const Strides st{static_cast<int64_t>(n_pad) * kD, kD, kD};  // (b, n, h): bh batch entries of one head
  return launch_flash_fwd<Chain<V>>(prm, q, k, v, bh, 1, st, st, st, stream);
}

}  // namespace

// q, k: (bh, n_pad, 64) bf16 contiguous; v: (bh, n_pad, 64) bf16, or (bh,
// n_pad, 65) for variants 5 and 6 (last column: 1 for a real key, 0 for a
// pad); bias: n_pad fp32 (0 or -inf), read by variants 0, 2, 3, 4; out: (bh,
// n_pad, 64) bf16. n_pad a multiple of 64; n_real the real keys (variant 1's
// correction). Returns cudaGetLastError() after the launch.
extern "C" int moge_flash_softmax_variant(const void* q, const void* k, const void* v, const void* bias, void* out,
                                          int bh, int n_pad, int n_real, int variant, void* stream) {
  if (bh <= 0 || bh > 65535 || n_pad <= 0 || n_pad % fwd::kBr != 0 || n_real <= 0 || n_real > n_pad || variant < 0 ||
      variant >= kVariants)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float pad = static_cast<float>(n_pad - n_real);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: return launch<kBase>(q, k, v, b, out, bh, n_pad, pad, st);
    case kNoBias: return launch<kNoBias>(q, k, v, b, out, bh, n_pad, pad, st);
    case kBf16Sm: return launch<kBf16Sm>(q, k, v, b, out, bh, n_pad, pad, st);
    case kNoExp: return launch<kNoExp>(q, k, v, b, out, bh, n_pad, pad, st);
    case kNoMax: return launch<kNoMax>(q, k, v, b, out, bh, n_pad, pad, st);
    case kMxuSum: return launch<kMxuSum>(q, k, v, b, out, bh, n_pad, pad, st);
    default: return launch<kMxuSumNoMax>(q, k, v, b, out, bh, n_pad, pad, st);
  }
}
