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
// What bounds bf16 on an H100: at the ViT token counts (N = 1201..3601, 16
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
// fp32: the register-blocked FFMA kernel below, the main path of every fp32
// forward (MoGe-1's and MoGe-2's fp32 `infer`, the panorama and eval in
// fp32, the fp32 exports, sequence-parallel fp32 chunks, the fp32 training
// steps whose K2b reads its lse). Every product and sum is an IEEE fp32 FFMA
// (no TF32 in any form: the fp32 configurations hold TF32 off). What bounds
// it: the FP32 pipes, 4*N^2*64 flops a head at 66.9 TFLOP/s (128 FFMA lanes
// on each of 132 SMs at 1.98 GHz); at B = 1, H = 16, N = 2501 that is 0.383
// ms against 41 MB of q, k, v and o (12 us). Bytes never bound it.
//
// Design (each value read from shared memory feeds 4 to 8 FFMAs; a plain
// one-dot-product-per-lane kernel feeds 0.5 and stops near 1/8 of the rate,
// since an SM issues one warp-wide shared load a clock against four FFMAs):
// - A block of 4 warps owns 128 query rows of one (b, h); a warp owns 32
//   rows as 4 row groups of 8 lanes. Lane (g, c) holds the 8 rows
//   {4g..4g+3, 16+4g..16+4g+3} of its warp, the S tile's 4 keys {4c..4c+3}
//   and O's 8 columns {4c..4c+3, 32+4c..32+4c+3}: an 8x4 block of S and an
//   8x8 block of O in registers.
// - Shared memory: Q^T (d-major, scaled by `scale` on the way in: the scale
//   of a 64-wide head, 1/8, is a power of two, so that is exact), resident
//   for the whole key loop; K^T of a 32-key tile (d-major, keys contiguous;
//   one or two slots); two 32-key V tiles (row-major); P^T per warp (keys
//   major). Each step of S = Q K^T reads two float4 of Q^T and one of K^T
//   for 32 FFMAs, each step of O += P V two float4 of P^T and two of V for
//   64, the next step's operands loaded before this step's FFMAs. A warp's
//   float4 read touches one 128-byte line (broadcast within a row group).
// - Overlap: V tiles arrive by cp.async, one tile ahead, into two slots; the
//   next K tile is loaded into registers while this tile's P V runs and
//   stored transposed into K^T (into the free slot before the tile's one
//   barrier when there are two, after the first of two barriers when one).
// - Softmax in registers: the row max reduces over the row's 8 lanes by 3
//   shuffles, the row sum stays a per-lane partial (reduced once in the
//   epilogue), O is rescaled in registers; expf, a row with no live key yet
//   at m = 0, keys at or past kv_valid at -inf (only the last tile has any),
//   the natural-log lse. The order of the sums is the only change from the
//   plain version's arithmetic.
// - Two builds, one launched per call: at most 168 registers a thread, so 3
//   blocks share an SM (one K^T slot), or 255, so 2 do (two slots, no
//   spills, faster per block). ops/attention.py::f32_plan picks the one whose
//   busiest SM finishes first at the call's B, H and Nq: at B = 1, H = 16,
//   Nq = 2501 that is 320 blocks in one round of 3 a SM, at Nq = 3589 or
//   1801 the 2-a-SM build. Grid (ceil(Nq / 128), H, B).

#include "flash_fwd.cuh"

namespace {

constexpr int kD = 64;  // head dim

// ----------------------------------------------------------------- fp32 path

namespace f32 {
constexpr int kBc = 32;                  // keys per K/V tile
constexpr int kWarpRows = 32;            // query rows per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBr = kWarpRows * kWarps;  // query rows per block
constexpr int kTileVecs = kBc * kD / 4;  // float4 of one K or V tile
constexpr int kVecs = kTileVecs / kThreads;  // a K or V tile's float4 per thread
constexpr int kQt = kD * kBr;            // floats of Q^T
constexpr int kKt = kD * kBc;            // floats of one K^T slot
constexpr int kV = kBc * kD;             // floats of one V slot
constexpr int kPt = kBc * kWarpRows;     // floats of one warp's P^T
static_assert(kTileVecs % kThreads == 0, "a K or V tile splits evenly over the threads");

// The kernel at most R registers a thread. R = 168 lets 3 blocks share an SM
// (72 KB of shared memory each); R = 255 lets 2 (no spills), and K^T gets a
// second slot, so a tile needs one block barrier instead of two.
template <int R> struct Cfg {
  static constexpr bool kTwoK = R > 168;  // 2 blocks an SM, two K^T slots
  static constexpr size_t kSmem = sizeof(float) * (kQt + (kTwoK ? 2 : 1) * kKt + 2 * kV + kWarps * kPt);
};
}  // namespace f32

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

template <int R>
__global__ void __maxnreg__(R)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, float* __restrict__ lse, int H, int Nq, int kv_valid,
              Strides sq, Strides sk, Strides sv, float scale) {
  using namespace f32;
  using C = Cfg<R>;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [kD][kBr]
  float* kt = qt + kQt;          // [1 or 2][kD][kBc]
  float* vs = kt + (C::kTwoK ? 2 : 1) * kKt;  // [2][kBc][kD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3, c = lane & 7;  // row group, column group
  float* pt = vs + 2 * kV + warp * kPt;  // this warp's [kBc][kWarpRows]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBr;
  const float* kbh = k + b * sk.b + h * sk.h;
  const float* vbh = v + b * sv.b + h * sv.h;
  const int n_tiles = (kv_valid + kBc - 1) / kBc;

  // Q^T, scaled: thread t transposes query row q0 + t (zeros past Nq)
  {
    const int r = threadIdx.x;
    const bool ok = q0 + r < Nq;
    const float* src = q + b * sq.b + h * sq.h + static_cast<int64_t>(ok ? q0 + r : 0) * sq.n;
#pragma unroll 4
    for (int d4 = 0; d4 < kD / 4; ++d4) {
      const float4 x = ok ? ld4(src + 4 * d4) : make_float4(0.f, 0.f, 0.f, 0.f);
      qt[(4 * d4 + 0) * kBr + r] = x.x * scale;
      qt[(4 * d4 + 1) * kBr + r] = x.y * scale;
      qt[(4 * d4 + 2) * kBr + r] = x.z * scale;
      qt[(4 * d4 + 3) * kBr + r] = x.w * scale;
    }
  }

  // K tile t into registers (float4 f = tid + i * threads: key f % kBc, d4 f / kBc), then
  // transposed into K^T: a warp writes 32 consecutive keys of one row of K^T
  float4 kreg[kVecs];
  auto load_k = [&](int t) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int f = threadIdx.x + i * kThreads, key = t * kBc + f % kBc;
      kreg[i] = key < kv_valid ? __ldg(reinterpret_cast<const float4*>(kbh + static_cast<int64_t>(key) * sk.n +
                                                                       4 * (f / kBc)))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_k = [&](int slot) {
    float* dst = kt + slot * kKt;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int f = threadIdx.x + i * kThreads, key = f % kBc, d = 4 * (f / kBc);
      dst[(d + 0) * kBc + key] = kreg[i].x;
      dst[(d + 1) * kBc + key] = kreg[i].y;
      dst[(d + 2) * kBc + key] = kreg[i].z;
      dst[(d + 3) * kBc + key] = kreg[i].w;
    }
  };
  // V tile t into slot s by cp.async (16 lanes a row; keys past kv_valid zero-filled)
  auto copy_v = [&](int t, int s) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int f = threadIdx.x + i * kThreads, row = f / (kD / 4), col = 4 * (f % (kD / 4));
      const int key = t * kBc + row;
      const bool ok = key < kv_valid;
      cp_async16(vs + s * kV + row * kD + col, vbh + static_cast<int64_t>(ok ? key : 0) * sv.n + col, ok);
    }
  };

  load_k(0);
  copy_v(0, 0);
  cp_async_commit();
  if (n_tiles > 1) copy_v(1, 1);
  cp_async_commit();
  store_k(0);
  cp_async_wait<1>();
  __syncthreads();

  float o[8][8], m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[r][j] = 0.f;
  }
  const float* qa = qt + warp * kWarpRows + 4 * g;  // rows 4g.., 16+4g.. of this warp
  const float* kc = kt + 4 * c;                     // keys 4c..4c+3
  const float* pa = pt + 4 * g;

  for (int t = 0; t < n_tiles; ++t) {
    // S (8 rows x 4 keys) = (scale Q) K^T
    const float* ka = kc + (C::kTwoK ? (t & 1) * kKt : 0);
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    // the next step's operands are loaded before this step's FFMAs (the last step's load
    // wraps to step 0 and goes unused), so no FFMA waits on its shared load
    float4 a0 = ld4(qa), a1 = ld4(qa + 16), kk = ld4(ka);
#pragma unroll 16
    for (int d = 0; d < kD; ++d) {
      const int dn = (d + 1) & (kD - 1);
      const float4 n0 = ld4(qa + dn * kBr), n1 = ld4(qa + dn * kBr + 16), nk = ld4(ka + dn * kBc);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w}, bk[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a[r], bk[j], s[r][j]);
      a0 = n0;
      a1 = n1;
      kk = nk;
    }
    if ((t + 1) * kBc > kv_valid) {  // the last tile: keys at or past kv_valid
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t * kBc + 4 * c + j >= kv_valid)
#pragma unroll
          for (int r = 0; r < 8; ++r) s[r][j] = -INFINITY;
    }

    // online softmax: the row max over the row's 8 lanes; P^T to this warp's slice
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet stays at 0
      const float alpha = expf(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = expf(s[r][j] - m_use);
        sum += s[r][j];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[r][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = pt + (4 * c + j) * kWarpRows + 4 * g;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 16) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncwarp();
    if (t + 1 < n_tiles) load_k(t + 1);  // lands while P V runs

    // O (8 rows x 8 columns) += P V
    const float* va = vs + (t & 1) * kV + 4 * c;
    float4 p0 = ld4(pa), p1 = ld4(pa + 16), v0 = ld4(va), v1 = ld4(va + 32);
#pragma unroll 16
    for (int j = 0; j < kBc; ++j) {
      const int jn = (j + 1) & (kBc - 1);
      const float4 np0 = ld4(pa + jn * kWarpRows), np1 = ld4(pa + jn * kWarpRows + 16);
      const float4 nv0 = ld4(va + jn * kD), nv1 = ld4(va + jn * kD + 32);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int x = 0; x < 8; ++x) o[r][x] = fmaf(p[r], vv[x], o[r][x]);
      p0 = np0;
      p1 = np1;
      v0 = nv0;
      v1 = nv1;
    }

    if constexpr (C::kTwoK) {
      // the other K^T slot was last read in tile t - 1, before the barrier that ended it
      if (t + 1 < n_tiles) store_k((t + 1) & 1);
      cp_async_wait<0>();  // this thread's copies of V tile t + 1 landed
      __syncthreads();     // K^T and V of tile t + 1 in place; every warp is done with tile t's
      if (t + 2 < n_tiles) copy_v(t + 2, t & 1);
      cp_async_commit();
    } else {
      __syncthreads();  // every warp is done with K^T, this V slot and its P^T
      if (t + 1 < n_tiles) store_k(0);
      if (t + 2 < n_tiles) copy_v(t + 2, t & 1);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of V tile t + 1 landed
      __syncthreads();
    }
  }

  // epilogue: the row sums over the row's 8 lanes; normalise, store (B, Nq, H, kD); lse
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const int qi = q0 + warp * kWarpRows + (r >> 2) * 16 + 4 * g + (r & 3);
    if (qi >= Nq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    float* orow = out + ((static_cast<int64_t>(b) * Nq + qi) * H + h) * kD;
    *reinterpret_cast<float4*>(orow + 4 * c) =
        make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv);
    *reinterpret_cast<float4*>(orow + 32 + 4 * c) =
        make_float4(o[r][4] * inv, o[r][5] * inv, o[r][6] * inv, o[r][7] * inv);
    if (c == 0) lse[(static_cast<int64_t>(b) * H + h) * Nq + qi] = m[r] + logf(sum);
  }
}

template <int R>
int launch_f32_regs(const float* q, const float* k, const float* v, float* out, float* lse, int B, int H, int Nq,
                    int kv_valid, Strides sq, Strides sk, Strides sv, float scale, cudaStream_t stream) {
  using C = f32::Cfg<R>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(flash_fwd_f32<R>), static_cast<int>(C::kSmem),
                                    opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Nq + f32::kBr - 1) / f32::kBr, H, B);
  flash_fwd_f32<R><<<grid, f32::kThreads, C::kSmem, stream>>>(q, k, v, out, lse, H, Nq, kv_valid, sq, sk, sv, scale);
  return static_cast<int>(cudaGetLastError());
}

// rows, per_sm: the query rows per block and the blocks an SM holds, as
// ops/attention.py::f32_plan chose them (128 rows; 3 or 2 blocks)
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H, int Nq,
               int kv_valid, Strides sq, Strides sk, Strides sv, float scale, int rows, int per_sm,
               cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  if (rows != f32::kBr) return static_cast<int>(cudaErrorInvalidValue);
  if (per_sm == 3) return launch_f32_regs<168>(qf, kf, vf, of, lse, B, H, Nq, kv_valid, sq, sk, sv, scale, stream);
  if (per_sm == 2) return launch_f32_regs<255>(qf, kf, vf, of, lse, B, H, Nq, kv_valid, sq, sk, sv, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
// kv_valid are masked. bc, stages: for bf16 the kernel's key tile and ring
// depth as ops/attention.py::flash_plan has them (they must be
// flash_fwd.cuh's); for fp32 the query rows per block and the blocks an SM
// holds as ops/attention.py::f32_plan has them (128, and 3 or 2).
// Returns cudaGetLastError() after the launch (0 on success).
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
  if (dtype == kFloat32)
    return launch_f32(q, k, v, out, l, B, H, Nq, kv_valid, sq, sk, sv, scale, bc, stages, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
