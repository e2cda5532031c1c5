// The Hopper flash-attention forward shared by K2 (flash_attn.cu) and the
// T1 probe (exp_flash_softmax.cu): one kernel template whose softmax chain
// is a policy (the Chain flags below), so each chain compiles to only its
// own instructions.
//
// - One block of one warpgroup (128 threads) per 64 query rows, head and
//   batch entry; grid (ceil(Nq / 64), H, B). Thread 0 issues the copies (no
//   producer warp).
// - Loads by TMA from 4-d tensor maps {64, H, N, B} over the operands' own
//   byte strides (a per-head view of a (B, N, 3, H, 64) qkv projection is
//   read in place), 128-byte swizzle (a 64-wide bf16 row is 128 bytes), zero
//   fill past N. Q once; K and V tiles of kBc keys into rings of kStages
//   slots, one full-barrier per slot and operand.
// - S = Q K^T by wgmma m64n{kBc}k16, both operands from shared memory, K-major
//   (K read as stored); P V by wgmma m64nDVk16 with A = P in registers (the
//   accumulator layout is the A fragment's) and B = V, N-major.
// - Per key tile: S by wgmma, then the softmax chain on its accumulator
//   registers, then P V by wgmma; the K and V slots of tile t are refilled
//   with tile t + kStages once every warp is done with them, so those copies
//   overlap the following tiles' math, and several resident blocks per SM
//   overlap one block's softmax with another's products. (Overlapping the
//   products with the softmax inside one warpgroup, FlashAttention-3's
//   order, measured slower here: ptxas serialises every wgmma of the kernel
//   once accumulator registers are read while a product is in flight.)
// - Softmax on the accumulator registers: a row's values sit in the 4
//   threads of a quad, so the row max is the thread's own and 2 shuffles per
//   tile; p = 2^(s c - m c) (c = scale log2 e) is one FFMA and one MUFU ex2;
//   the row sum stays a per-thread partial, reduced once in the epilogue;
//   O is rescaled in registers. Only the last key tile pays for masking the
//   keys at or past n_keys (-inf).
// - Epilogue: O / max(l, 1e-30), one rounding to bf16, stored from the
//   registers through the output's strides, rows past Nq masked; lse (K2).
// Tile: 128 keys, 2 slots per ring. Shared memory: 8 KB of Q, 2 + 2 slots
// of 16 KB, 1 KB of alignment slack: 73 KB, so 3 blocks share an SM
// (registers, up to 168 a thread, allow the same). In development runs on
// the H100 (K2 at 16 heads, N = 1370 and 3601, B = 1 and 8) 64-key tiles,
// with 4 slots (3 blocks per SM) or 2 (up to 5), and FlashAttention-3's
// order were each slower than this.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace fwd {
constexpr int kD = 64;          // head dim
constexpr int kBr = 64;         // query rows per block: one warpgroup
constexpr int kBc = 128;        // keys per K/V tile
constexpr int kStages = 2;      // slots in the K ring and in the V ring
constexpr int kThreads = 128;
constexpr int kRowBytes = kD * 2;
constexpr int kQBytes = kBr * kRowBytes;
constexpr int kTileBytes = kBc * kRowBytes;
constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;  // + slack to align to 1 KB
constexpr uint32_t kAtomBytes = kBc / 8 * 1024;                   // one 64-column swizzle atom of a V tile
constexpr int kExtCols = 80;  // T1's mxusum V: 65 columns padded to a wgmma width
static_assert(2 * kAtomBytes <= kStages * kTileBytes, "a staged 80-column V tile fits the V ring");
}  // namespace fwd

// The softmax chain, as a policy with these members (all static constexpr bool):
//   bias       s += bias[key] (fp32, one per key)
//   clamp60    s = min(s, 60)
//   round_bf16 s and s - m rounded to bf16, and p
//   no_exp     p = relu(s - m) instead of exp
//   use_max    running row max (else m stays at its start, m_use = 0)
//   floor0     the running max starts at 0 (else -inf)
//   rescale    O and l rescaled by exp(m_old - m_new)
//   ext        V has a 65th column (validity), staged by the threads; the
//              denominator is P V's column 64, not the row sum
//   pad_fix    the denominator loses pad_cols * exp(-m) (zero-padded keys)
//   lse        write the natural-log logsumexp (B, H, Nq)
// A row with no live key yet uses m = 0.

struct Strides { int64_t b, n, h; };  // element strides of a (B, N, H, 64) operand

struct FwdParams {
  __nv_bfloat16* out;
  int64_t out_sb, out_sn, out_sh;  // element strides of the output (B, Nq, H, 64)
  float* lse;                      // (B, H, Nq), when the chain writes it
  const float* bias;               // (n_keys,), when the chain adds it
  const __nv_bfloat16* v_ext;      // (B, H, n_keys, 65) contiguous, for an ext chain
  int Nq, n_keys;
  float c;         // scale * log2(e): logits to log2 units
  float scale;     // for the natural-log lse
  float pad_cols;  // the pad_fix chain's zero-padded keys
};

template <class P>
__global__ void __launch_bounds__(fwd::kThreads)
flash_fwd_wgmma(const FwdParams prm, const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map) {
  using namespace fwd;
  using bf16 = __nv_bfloat16;
  constexpr int DV = P::ext ? kExtCols : kD;
  constexpr int S = kStages;
  __shared__ __align__(8) uint64_t q_full, k_full[S], v_full[S];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle atoms need 1 KB alignment
  const uint32_t k_s = q_s + kQBytes, v_s = k_s + S * kTileBytes;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (prm.n_keys + kBc - 1) / kBc;

  // thread 0: K or V of key tile t into slot t % S
  auto load_k = [&](int t) {
    const uint32_t bar = smem_u32(&k_full[t % S]);
    mbar_expect_tx(bar, kTileBytes);
    tma_load_4d(k_s + (t % S) * kTileBytes, &k_map, 0, h, t * kBc, b, bar);
  };
  auto load_v = [&](int t) {
    if constexpr (!P::ext) {
      const uint32_t bar = smem_u32(&v_full[t % S]);
      mbar_expect_tx(bar, kTileBytes);
      tma_load_4d(v_s + (t % S) * kTileBytes, &v_map, 0, h, t * kBc, b, bar);
    }
  };
  if (threadIdx.x == 0) {
    prefetch_tensormap(&q_map);
    prefetch_tensormap(&k_map);
    if (!P::ext) prefetch_tensormap(&v_map);
    mbar_init(smem_u32(&q_full), 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(smem_u32(&k_full[i]), 1);
      mbar_init(smem_u32(&v_full[i]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(smem_u32(&q_full), kQBytes);
    tma_load_4d(q_s, &q_map, 0, h, q0, b, smem_u32(&q_full));
    for (int t = 0; t < S && t < n_tiles; ++t) {
      load_k(t);
      load_v(t);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  // this thread's rows warp * 16 + lane / 4 (+ 8): running max (unscaled logits), partial row sum
  float m[2], l[2] = {0.f, 0.f};
  m[0] = m[1] = P::floor0 ? 0.f : -INFINITY;
  const uint64_t q_desc = wgmma_desc(q_s, 16, 1024, 1);
  float sacc[kBc / 2];

  // S(t) = Q K(t)^T into `sacc`, one commit group; the descriptors step 32 bytes (16 dims) per k16
  auto issue_s = [&](int t, float (&sacc)[kBc / 2]) {
    mbar_wait(smem_u32(&k_full[t % S]), (t / S) & 1);
    wgmma_fence();
    const uint64_t k_desc = wgmma_desc(k_s + (t % S) * kTileBytes, 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<kBc>::mma(sacc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
  };

  // The chain on tile t's logits (accumulator element i * 4 + half * 2 + j: row + 8 half, key
  // t kBc + 8 i + 2 (lane % 4) + j): P(t) into `pa` as the A fragments of P V (keys 16 kk ..
  // 16 kk + 15 are accumulator columns i = 2 kk, 2 kk + 1), the rows' rescale factors into alpha.
  auto chain = [&](int t, float (&sacc)[kBc / 2], const float2 (&bb)[kBc / 8], uint32_t (&pa)[kBc / 16][4],
                   float (&alpha)[2]) {
    const int k0 = t * kBc;
    if constexpr (P::bias || P::clamp60 || P::round_bf16) {
#pragma unroll
      for (int i = 0; i < kBc / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[i * 4 + e];
          if (P::bias) x += (e & 1) ? bb[i].y : bb[i].x;
          if (P::clamp60) x = fminf(x, 60.f);
          if (P::round_bf16) x = __bfloat162float(__float2bfloat16(x));
          sacc[i * 4 + e] = x;
        }
      }
    }
    if (k0 + kBc > prm.n_keys) {  // the last tile: keys at or past n_keys get -inf
#pragma unroll
      for (int i = 0; i < kBc / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + i * 8 + (lane & 3) * 2 + (e & 1) >= prm.n_keys) sacc[i * 4 + e] = -INFINITY;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float m_new = m[half], m_use = 0.f;
      if constexpr (P::use_max) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kBc / 8; ++i) mx = fmaxf(mx, fmaxf(sacc[i * 4 + half * 2], sacc[i * 4 + half * 2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new = fmaxf(m[half], mx);
        m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet stays 0
      }
      const float mc = m_use * prm.c;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBc / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = sacc[i * 4 + half * 2 + j];
          float p;
          if constexpr (P::no_exp) {
            p = fmaxf(x - m_use, 0.f);
          } else if constexpr (P::round_bf16) {
            p = __bfloat162float(__float2bfloat16(
                ex2(__bfloat162float(__float2bfloat16(x - m_use)) * prm.c)));
          } else {
            p = ex2(fmaf(x, prm.c, -mc));
          }
          sacc[i * 4 + half * 2 + j] = p;
          sum += p;
        }
      alpha[half] = P::rescale ? ex2(fmaf(m[half], prm.c, -mc)) : 1.f;
      m[half] = m_new;
      if (!P::ext) l[half] = l[half] * alpha[half] + sum;
    }
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(sacc[kk * 8 + r * 2], sacc[kk * 8 + r * 2 + 1]);
  };

  // this thread's bias pairs of tile t (n_keys is even for a bias chain: a pair is whole)
  auto load_bias = [&](int t, float2 (&bb)[kBc / 8]) {
#pragma unroll
    for (int i = 0; i < kBc / 8; ++i) {
      const int key = t * kBc + i * 8 + (lane & 3) * 2;
      bb[i] = key < prm.n_keys ? __ldg(reinterpret_cast<const float2*>(prm.bias + key)) : make_float2(0.f, 0.f);
    }
  };

  uint32_t pa[kBc / 16][4];
  mbar_wait(smem_u32(&q_full), 0);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    issue_s(t, sacc);
    float2 bb[kBc / 8];
    if constexpr (P::bias) load_bias(t, bb);  // while the product runs
    wgmma_wait<0>();
    fence_acc(sacc);
    float alpha[2];
    chain(t, sacc, bb, pa, alpha);
    if constexpr (P::rescale) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    uint32_t v_tile;
    if constexpr (P::ext) {  // stage V(t)'s 65 columns (zeros past column 64 and past n_keys) as two atoms
      const bf16* vb = prm.v_ext + ((static_cast<int64_t>(b) * gridDim.y + h) * prm.n_keys + t * kBc) * (kD + 1);
      for (int idx = threadIdx.x; idx < kBc * kExtCols; idx += kThreads) {
        const int r = idx / kExtCols, n = idx - r * kExtCols;
        const unsigned short val = n <= kD && t * kBc + r < prm.n_keys
                                       ? __ldg(reinterpret_cast<const unsigned short*>(vb + r * (kD + 1) + n))
                                       : 0;
        const uint32_t off = (n / 64) * kAtomBytes + (r / 8) * 1024 + (r % 8) * 128 + (n % 64) * 2;
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(v_s + (off ^ (((off >> 7) & 7) << 4))), "h"(val)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      __syncthreads();
      v_tile = v_s;
    } else {
      mbar_wait(smem_u32(&v_full[t % S]), (t / S) & 1);
      v_tile = v_s + (t % S) * kTileBytes;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) Wgmma<DV>::mma(o, pa[kk], wgmma_desc(v_tile + kk * 2048, kAtomBytes, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(pa);
    fence_acc(o);
    __syncthreads();  // every warp is done with slot t % S
    if (threadIdx.x == 0 && t + S < n_tiles) {
      load_k(t + S);
      load_v(t + S);
    }
  }

  // epilogue: the denominator, O / den rounded once, the lse
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float den;
    if constexpr (P::ext) {  // column 64: element 8 * 4 + half * 2 of the quad's first thread
      den = __shfl_sync(0xffffffffu, o[32 + half * 2], lane & ~3);
    } else {
      den = l[half];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
    }
    if (P::pad_fix) den -= prm.pad_cols * ex2(-m[half] * prm.c);  // the zero-padded keys' exp(0 - m) each
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= prm.Nq) continue;
    const float inv = 1.f / fmaxf(den, 1e-30f);
    bf16* orow = prm.out + b * prm.out_sb + row * prm.out_sn + h * prm.out_sh + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) = pack_bf16x2(o[i * 4 + half * 2] * inv, o[i * 4 + half * 2 + 1] * inv);
    if (P::lse && (lane & 3) == 0)
      prm.lse[(static_cast<int64_t>(b) * gridDim.y + h) * prm.Nq + row] =
          (m[half] == -INFINITY ? 0.f : m[half]) * prm.scale + logf(den);
  }
}

// rows of one (B, N, H, 64) bf16 operand as a 4-d tensor map {64, H, N, B}
// with its byte strides {2 sh, 2 sn, 2 sb} (each a multiple of 16), boxes of
// `rows` rows of one head, 128-byte swizzle, zeros past N
int rows_map(CUtensorMap* map, const void* base, int N, int H, int B, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(fwd::kD), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2, static_cast<cuuint64_t>(st.n) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(fwd::kD), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One launch of the chain P over B x H heads: q (B, Nq, H, 64) and k, v (B,
// n_keys, H, 64) through their strides (v unread by an ext chain).
template <class P>
int launch_flash_fwd(const FwdParams& prm, const void* q, const void* k, const void* v, int B, int H, Strides sq,
                     Strides sk, Strides sv, cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};  // per card: the >48 KB opt-in of this chain
  const cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(flash_fwd_wgmma<P>), fwd::kSmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qm, km, vm = {};  // encoded per call: the pointers change with every layer
  int rc = rows_map(&qm, q, prm.Nq, H, B, sq, fwd::kBr);
  if (rc == 0) rc = rows_map(&km, k, prm.n_keys, H, B, sk, fwd::kBc);
  if (rc == 0 && !P::ext) rc = rows_map(&vm, v, prm.n_keys, H, B, sv, fwd::kBc);
  if (rc != 0) return rc;
  const dim3 grid((prm.Nq + fwd::kBr - 1) / fwd::kBr, H, B);
  flash_fwd_wgmma<P><<<grid, fwd::kThreads, fwd::kSmem, stream>>>(prm, qm, km, vm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
