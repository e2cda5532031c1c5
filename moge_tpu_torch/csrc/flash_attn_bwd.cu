// K2b: flash attention backward, non-causal multi-head, head dim 64.
//
// Replaces moge_tpu/ops/attention.py::_flash_dq_kernel (K2b-dq) and
// ::_flash_dkv_kernel (K2b-dkv), reached through _flash_core_bwd. With
// logits s_ij = scale * q_i . k_j over the keys j < kv_valid, the forward's
// per-row logsumexp lse_i (natural log, from K2) and delta_i = sum_d dO_id O_id
// (computed by the caller in plain PyTorch, as the JAX package does in XLA):
//   P_ij  = exp(s_ij - lse_i)                 (recomputed, never stored)
//   dS_ij = P_ij * (dO_i . v_j - delta_i)
//   dQ_i  = scale * sum_j dS_ij k_j
//   dK_j  = scale * sum_i dS_ij q_i,    dV_j = sum_i P_ij dO_i
// P and dS are rounded to the input dtype before their products, with fp32
// accumulation and one rounding of each output, as in the TPU kernels.
//
// What bounds it on an H100: 5 (N, N, 64) products per head (S twice, dP
// twice, then dQ, dK and dV) and 2 N^2 exps against O(N * 64) traffic, so
// the tensor cores with the exps on the MUFU units close behind, never
// device memory, as long as P and dS stay on the chip. Two kernels, so that
// neither needs atomics and both are deterministic (the same inputs give
// the same bits).
//
// bf16, the main path: Hopper kernels in the style of flash_fwd.cuh (its
// parts in hopper.cuh), one warpgroup (128 threads) per block, thread 0
// issuing the TMA copies from 4-d tensor maps {64, H, N, B} over the
// operands' own strides (the per-head views of a (B, N, 3, H, 64) qkv
// projection are read in place), 128-byte swizzle, zeros past N.
//   dq:  one block per (64 query rows, head, batch). Q and dO once; K and V
//        in 2-slot rings of 64-key tiles. Per key tile S = Q K^T and
//        dP = dO V^T by wgmma m64n64 with both operands from shared memory
//        (K-major, K and V read as stored), p = 2^(s c - lse log2 e) (one
//        FFMA and one MUFU ex2, c = scale log2 e) and dS = p (dP - delta) on
//        the accumulator registers, dS packed to bf16 A fragments, then
//        dQ += dS K by wgmma m64n64 with A from registers and B = K N-major
//        from the same slot. The slots of tile t are refilled with tile
//        t + 2 once every warp is done with them. Only the last key tile
//        masks the keys at or past kv_valid.
//   dkv: one block per (64 keys, head, batch). K and V once; Q and dO in
//        2-slot rings of 64-query tiles, each slot with its tile's lse and
//        delta (cp.async of 4 bytes a thread, arriving on the slot's
//        barrier). Per query tile S^T = K Q^T and dP^T = V dO^T by wgmma
//        m64n64 from shared memory, P^T and dS^T on the registers, then
//        dV += P^T dO and dK += dS^T Q by wgmma m64n64 with A from registers
//        and B = dO, Q N-major. dK and dV stay in registers (2 x 32 fp32 a
//        thread). Keys at or past kv_valid get P = 0 by index; padded
//        queries get lse = +inf (P = 0); a key tile entirely past kv_valid
//        writes zeros.
// As in the forward, each warpgroup waits for its own products before it
// reads their accumulators (reading them while a product is in flight made
// ptxas serialise every wgmma, warning C7514): the resident blocks of an SM
// overlap one another's exps with their products. dq: 48 KB of shared
// memory and ~122 registers a thread, 4 blocks an SM; dkv: 50 KB, at most
// 168 registers (launch bounds), 3 blocks an SM. In development runs on the
// H100 (B = 2, H = 16, N = 1370 and 3601) 128-key dq tiles (2 blocks an
// SM), dkv at 2 blocks an SM, and 3-slot rings were each slower than this.
//
// fp32 (parity and gradient checks, not the main path): the plain-FMA
// kernels below, one block of 4 warps per 64 rows, S/dP through shared
// memory. Their numbers hold the train-step parity within 1e-4.

#include "flash_fwd.cuh"

namespace {

// ----------------------------------------------------------------- fp32 path

namespace f32 {
constexpr int kD = 64;         // head dim
constexpr int kB = 64;         // rows per tile, queries and keys alike
constexpr int kWarps = 4;      // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + kPad<float>;  // row stride of a (64, 64) fp32 operand tile
constexpr int kLdF = kB + 4;           // fp32 product tile row stride
constexpr size_t kTBytes = sizeof(float) * kB * kLd;
constexpr size_t kFBytes = sizeof(float) * kB * kLdF;

// rows [row0, row0 + kB) of one (b, h) slice into shared memory, zero at or past n.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int64_t row_stride, int row0,
                                          int n) {
  constexpr int kVpr = kD / 4;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kB * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i % kVpr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * kLd + c) = val;
  }
}

// S_w (16 x 64) = A_w (16 x 64) . B^T, B a (64, 64) tile.
__device__ __forceinline__ void abt(const float* a, const float* b, float* s, int lane) {
  for (int idx = lane; idx < 16 * kB; idx += 32) {
    const int r = idx / kB, c = idx % kB;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) acc = fmaf(a[r * kLd + d], b[c * kLd + d], acc);
    s[r * kLdF + c] = acc;
  }
}

// O_w (16 x 64) += P_w (16 x 64) . B, B a (64, 64) tile.
__device__ __forceinline__ void acc_ab(const float* p, const float* b, float* o, int lane) {
  for (int idx = lane; idx < 16 * kD; idx += 32) {
    const int r = idx / kD, c = idx % kD;
    float acc = 0.f;
#pragma unroll 16
    for (int j = 0; j < kB; ++j) acc = fmaf(p[r * kLd + j], b[j * kLd + c], acc);
    o[r * kLdF + c] += acc;
  }
}

// row r of this warp's 16 fp32 rows, times mul, into a strided output row.
__device__ __forceinline__ void store_row(float* dst, const float* src, float mul, int lane) {
  dst[lane] = src[lane] * mul;
  dst[lane + 32] = src[lane + 32] * mul;
}

struct Args {
  const float *q, *k, *v, *dout;
  const float *lse, *delta;  // (B, H, Nq) fp32
  float *dq, *dk, *dv;
  int H, Nq, Nkv, kv_valid;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
};

__global__ void __launch_bounds__(kThreads) flash_dq_f32(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + kTBytes);
  float* ks = reinterpret_cast<float*>(smem + 2 * kTBytes);
  float* vs = reinterpret_cast<float*>(smem + 3 * kTBytes);
  float* dss = reinterpret_cast<float*>(smem + 4 * kTBytes);
  float* ss = reinterpret_cast<float*>(smem + 5 * kTBytes);
  float* dps = reinterpret_cast<float*>(smem + 5 * kTBytes + kFBytes);
  float* dqs = reinterpret_cast<float*>(smem + 5 * kTBytes + 2 * kFBytes);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* k = a.k + b * a.sk.b + h * a.sk.h;
  const float* v = a.v + b * a.sv.b + h * a.sv.h;

  load_rows(qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.n, q0, a.Nq);
  load_rows(dos, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.n, q0, a.Nq);
  for (int i = threadIdx.x; i < kB * kLdF; i += kThreads) dqs[i] = 0.f;

  const int row0 = warp * 16;
  const float* qw = qs + row0 * kLd;
  const float* dow = dos + row0 * kLd;
  float* dsw = dss + row0 * kLd;
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
      dsw[r * kLd + lane] = p0 * (dpw[r * kLdF + lane] - delta[r]);
      dsw[r * kLd + lane + 32] = p1 * (dpw[r * kLdF + lane + 32] - delta[r]);
    }
    __syncwarp();

    acc_ab(dsw, ks, dqw, lane);  // dQ += dS K
    __syncwarp();
  }

  float* dq = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + row0 + r;
    if (qi < a.Nq) store_row(dq + qi * a.sdq.n, dqw + r * kLdF, a.scale, lane);
  }
}

__global__ void __launch_bounds__(kThreads) flash_dkv_f32(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  float* dk = a.dk + b * a.sdk.b + h * a.sdk.h;
  float* dv = a.dv + b * a.sdv.b + h * a.sdv.h;

  if (k0 >= a.kv_valid) {  // every key of the tile is masked: zero gradients
    for (int r = 0; r < 16; ++r) {
      const int kj = k0 + row0 + r;
      if (kj >= a.Nkv) break;
      dk[kj * a.sdk.n + lane] = dk[kj * a.sdk.n + lane + 32] = 0.f;
      dv[kj * a.sdv.n + lane] = dv[kj * a.sdv.n + lane + 32] = 0.f;
    }
    return;
  }

  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + kTBytes);
  float* qs = reinterpret_cast<float*>(smem + 2 * kTBytes);
  float* dos = reinterpret_cast<float*>(smem + 3 * kTBytes);
  float* ps = reinterpret_cast<float*>(smem + 4 * kTBytes);
  float* dss = reinterpret_cast<float*>(smem + 5 * kTBytes);
  float* ss = reinterpret_cast<float*>(smem + 6 * kTBytes);
  float* dps = reinterpret_cast<float*>(smem + 6 * kTBytes + kFBytes);
  float* dks = reinterpret_cast<float*>(smem + 6 * kTBytes + 2 * kFBytes);
  float* dvs = reinterpret_cast<float*>(smem + 6 * kTBytes + 3 * kFBytes);
  float* lse_s = reinterpret_cast<float*>(smem + 6 * kTBytes + 4 * kFBytes);
  float* delta_s = lse_s + kB;

  load_rows(ks, a.k + b * a.sk.b + h * a.sk.h, a.sk.n, k0, a.kv_valid);
  load_rows(vs, a.v + b * a.sv.b + h * a.sv.h, a.sv.n, k0, a.kv_valid);
  for (int i = threadIdx.x; i < kB * kLdF; i += kThreads) dks[i] = dvs[i] = 0.f;
  const float* q = a.q + b * a.sq.b + h * a.sq.h;
  const float* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
  const int64_t stat0 = (static_cast<int64_t>(b) * a.H + h) * a.Nq;

  const float* kw = ks + row0 * kLd;
  const float* vw = vs + row0 * kLd;
  float* pw = ps + row0 * kLd;
  float* dsw = dss + row0 * kLd;
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
      pw[r * kLd + lane] = p0;
      pw[r * kLd + lane + 32] = p1;
      dsw[r * kLd + lane] = p0 * (dpw[r * kLdF + lane] - dl0);
      dsw[r * kLd + lane + 32] = p1 * (dpw[r * kLdF + lane + 32] - dl1);
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

int launch_dq_f32(const Args& a, int B, cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};
  const int smem = static_cast<int>(5 * kTBytes + 3 * kFBytes);
  const cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(flash_dq_f32), smem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dq_f32<<<dim3((a.Nq + kB - 1) / kB, a.H, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_f32(const Args& a, int B, cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};
  const int smem = static_cast<int>(6 * kTBytes + 4 * kFBytes + 2 * kB * sizeof(float));
  const cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(flash_dkv_f32), smem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dkv_f32<<<dim3((a.Nkv + kB - 1) / kB, a.H, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace f32

// ------------------------------------------------------ bf16 path (wgmma)

namespace bwd {
constexpr int kD = 64;           // head dim
constexpr int kRows = 64;        // query rows (dq) or keys (dkv) per block: one warpgroup
constexpr int kKeyTile = 64;     // dq: keys per K/V tile
constexpr int kQueryTile = 64;   // dkv: queries per Q/dO tile
constexpr int kStages = 2;       // slots in each ring
constexpr int kThreads = 128;
constexpr int kRowBytes = kD * 2;
constexpr int kOwnBytes = kRows * kRowBytes;         // Q or dO (dq), K or V (dkv): 8 KB
constexpr int kKvBytes = kKeyTile * kRowBytes;       // one K or V slot (dq): 16 KB
constexpr int kQoBytes = kQueryTile * kRowBytes;     // one Q or dO slot (dkv): 8 KB
constexpr int kStatBytes = 2 * kQueryTile * 4;       // one slot's lse and delta (dkv)
constexpr int kDqSmem = 2 * kOwnBytes + 2 * kStages * kKvBytes + 1024;  // + slack to align to 1 KB
constexpr int kDkvSmem = 2 * kOwnBytes + 2 * kStages * kQoBytes + kStages * kStatBytes + 1024;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kQueryTile, "one thread copies each lse and each delta of a query tile");
}  // namespace bwd

struct BwdParams {
  __nv_bfloat16 *out0, *out1;  // dq (dq kernel); dk and dv (dkv kernel)
  Strides s0, s1;              // their element strides
  const float *lse, *delta;    // (B, H, Nq) fp32
  int Nq, Nkv, kv_valid;
  float c;      // scale * log2(e): logits to log2 units
  float scale;
};

// bf16 pairs of this thread's accumulator row `half` (elements i * 4 + half * 2 + j, columns
// 8 i + 2 (lane % 4) + j) times mul, stored through a row pointer already offset by 2 (lane % 4)
__device__ __forceinline__ void store_acc_row(__nv_bfloat16* row, const float (&acc)[bwd::kD / 2], int half,
                                              float mul) {
#pragma unroll
  for (int i = 0; i < bwd::kD / 8; ++i)
    *reinterpret_cast<uint32_t*>(row + i * 8) = pack_bf16x2(acc[i * 4 + half * 2] * mul, acc[i * 4 + half * 2 + 1] * mul);
}

__global__ void __launch_bounds__(bwd::kThreads)
flash_dq_wgmma(const BwdParams prm, const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map) {
  using namespace bwd;
  constexpr int S = kStages, BC = kKeyTile;
  __shared__ __align__(8) uint64_t own_full, k_full[S], v_full[S];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle atoms need 1 KB alignment
  const uint32_t do_s = q_s + kOwnBytes, k_s = do_s + kOwnBytes, v_s = k_s + S * kKvBytes;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (prm.kv_valid + BC - 1) / BC;

  // thread 0: K and V of key tile t into slot t % S
  auto load_kv = [&](int t) {
    const uint32_t kb = smem_u32(&k_full[t % S]), vb = smem_u32(&v_full[t % S]);
    mbar_expect_tx(kb, kKvBytes);
    tma_load_4d(k_s + (t % S) * kKvBytes, &k_map, 0, h, t * BC, b, kb);
    mbar_expect_tx(vb, kKvBytes);
    tma_load_4d(v_s + (t % S) * kKvBytes, &v_map, 0, h, t * BC, b, vb);
  };
  if (threadIdx.x == 0) {
    prefetch_tensormap(&q_map);
    prefetch_tensormap(&do_map);
    prefetch_tensormap(&k_map);
    prefetch_tensormap(&v_map);
    mbar_init(smem_u32(&own_full), 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(smem_u32(&k_full[i]), 1);
      mbar_init(smem_u32(&v_full[i]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(smem_u32(&own_full), 2 * kOwnBytes);
    tma_load_4d(q_s, &q_map, 0, h, q0, b, smem_u32(&own_full));
    tma_load_4d(do_s, &do_map, 0, h, q0, b, smem_u32(&own_full));
    for (int t = 0; t < S && t < n_tiles; ++t) load_kv(t);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // this thread's rows q0 + warp * 16 + lane / 4 (+ 8): lse in log2 units and delta. Rows past
  // Nq have zero q and dO, so with lse = delta = 0 their dS is p * (0 - 0) = 0.
  const int64_t stat0 = (static_cast<int64_t>(b) * gridDim.y + h) * prm.Nq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    lse2[half] = row < prm.Nq ? __ldg(prm.lse + stat0 + row) * kLog2e : 0.f;
    dlt[half] = row < prm.Nq ? __ldg(prm.delta + stat0 + row) : 0.f;
  }

  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
  const uint64_t q_desc = wgmma_desc(q_s, 16, 1024, 1), do_desc = wgmma_desc(do_s, 16, 1024, 1);
  float s[BC / 2], dp[BC / 2];  // element i * 4 + half * 2 + j: row + 8 half, key t BC + 8 i + 2 (lane % 4) + j
  uint32_t ds[BC / 16][4];      // dS as the A fragments of dS K (keys 16 kk .. 16 kk + 15)
  mbar_wait(smem_u32(&own_full), 0);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % S;
    const uint32_t parity = (t / S) & 1, k_tile = k_s + slot * kKvBytes, v_tile = v_s + slot * kKvBytes;
    mbar_wait(smem_u32(&k_full[slot]), parity);
    mbar_wait(smem_u32(&v_full[slot]), parity);
    // S = Q K^T and dP = dO V^T, one commit group; the descriptors step 32 bytes (16 dims) per k16
    wgmma_fence();
    const uint64_t k_desc = wgmma_desc(k_tile, 16, 1024, 1), v_desc = wgmma_desc(v_tile, 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<BC>::mma(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<BC>::mma(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

#pragma unroll
    for (int i = 0; i < BC / 2; ++i) s[i] = ex2(fmaf(s[i], prm.c, -lse2[(i >> 1) & 1]));
    const int k0 = t * BC;
    if (k0 + BC > prm.kv_valid) {  // the last tile: keys at or past kv_valid get P = 0
#pragma unroll
      for (int i = 0; i < BC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + i * 8 + (lane & 3) * 2 + (e & 1) >= prm.kv_valid) s[i * 4 + e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = kk * 8 + r * 2;  // r: row half r & 1, columns 16 kk + 8 (r >> 1) + 2 (lane % 4) + {0, 1}
        ds[kk][r] = pack_bf16x2(s[e] * (dp[e] - dlt[r & 1]), s[e + 1] * (dp[e + 1] - dlt[r & 1]));
      }

    // dQ += dS K, B = K N-major from the same slot (16 keys = 2048 bytes per k16)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) Wgmma<kD>::mma(dq, ds[kk], wgmma_desc(k_tile + kk * 2048, kKvBytes, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(ds);
    fence_acc(dq);
    __syncthreads();  // every warp is done with slot t % S
    if (threadIdx.x == 0 && t + S < n_tiles) load_kv(t + S);
  }

  // epilogue: scale dQ, one rounding, stored through dq's strides, rows past Nq masked
  __nv_bfloat16* out = prm.out0 + b * prm.s0.b + h * prm.s0.h + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row < prm.Nq) store_acc_row(out + row * prm.s0.n, dq, half, prm.scale);
  }
}

__global__ void __launch_bounds__(bwd::kThreads, 3)
flash_dkv_wgmma(const BwdParams prm, const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map, const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map) {
  using namespace bwd;
  constexpr int S = kStages, BQ = kQueryTile;
  __shared__ __align__(8) uint64_t own_full, qo_full[S];
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* dk_out = prm.out0 + b * prm.s0.b + h * prm.s0.h;
  __nv_bfloat16* dv_out = prm.out1 + b * prm.s1.b + h * prm.s1.h;

  if (k0 >= prm.kv_valid) {  // every key of the tile is masked: zero gradients
    for (int idx = threadIdx.x; idx < kRows * kD / 2; idx += kThreads) {
      const int r = idx / (kD / 2), c = (idx % (kD / 2)) * 2;
      if (k0 + r >= prm.Nkv) break;
      *reinterpret_cast<uint32_t*>(dk_out + (k0 + r) * prm.s0.n + c) = 0u;
      *reinterpret_cast<uint32_t*>(dv_out + (k0 + r) * prm.s1.n + c) = 0u;
    }
    return;
  }

  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023) & ~1023u;  // the swizzle atoms need 1 KB alignment
  const uint32_t v_s = k_s + kOwnBytes, q_s = v_s + kOwnBytes, do_s = q_s + S * kQoBytes;
  const uint32_t st_s = do_s + S * kQoBytes;  // per slot: lse[BQ], then delta[BQ]
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - base));
  const int n_tiles = (prm.Nq + BQ - 1) / BQ;
  const int64_t stat0 = (static_cast<int64_t>(b) * gridDim.y + h) * prm.Nq;

  // thread 0: Q and dO of query tile t into slot t % S, completing on its barrier
  auto load_qo = [&](int t) {
    const uint32_t bar = smem_u32(&qo_full[t % S]);
    mbar_expect_tx(bar, 2 * kQoBytes);
    tma_load_4d(q_s + (t % S) * kQoBytes, &q_map, 0, h, t * BQ, b, bar);
    tma_load_4d(do_s + (t % S) * kQoBytes, &do_map, 0, h, t * BQ, b, bar);
  };
  // every thread: one lse (threads 0 .. BQ - 1) or delta of query tile t into slot t % S by
  // cp.async (zero past Nq), whose completion arrives on the slot's barrier
  auto load_stats = [&](int t) {
    const int i = threadIdx.x % BQ, qi = t * BQ + i;
    const float* src = (threadIdx.x < BQ ? prm.lse : prm.delta) + stat0 + (qi < prm.Nq ? qi : 0);
    const uint32_t dst = st_s + (t % S) * kStatBytes + threadIdx.x * 4;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(qi < prm.Nq ? 4 : 0)
                 : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(&qo_full[t % S]))
                 : "memory");
  };
  if (threadIdx.x == 0) {
    prefetch_tensormap(&q_map);
    prefetch_tensormap(&do_map);
    prefetch_tensormap(&k_map);
    prefetch_tensormap(&v_map);
    mbar_init(smem_u32(&own_full), 1);
    // each phase of a slot: thread 0's arrive with the TMA bytes, and every thread's cp.async
    for (int i = 0; i < S; ++i) mbar_init(smem_u32(&qo_full[i]), 1 + kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(smem_u32(&own_full), 2 * kOwnBytes);
    tma_load_4d(k_s, &k_map, 0, h, k0, b, smem_u32(&own_full));
    tma_load_4d(v_s, &v_map, 0, h, k0, b, smem_u32(&own_full));
    for (int t = 0; t < S && t < n_tiles; ++t) load_qo(t);
  }
  __syncthreads();  // the barriers are initialised before anyone arrives on or waits for them
  for (int t = 0; t < S && t < n_tiles; ++t) load_stats(t);

  // this thread's keys k0 + warp * 16 + lane / 4 (+ 8): below kv_valid, or P = 0 (by index)
  const int key = k0 + warp * 16 + (lane >> 2);
  const bool keep[2] = {key < prm.kv_valid, key + 8 < prm.kv_valid};
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint64_t k_desc = wgmma_desc(k_s, 16, 1024, 1), v_desc = wgmma_desc(v_s, 16, 1024, 1);
  float st[BQ / 2], dpt[BQ / 2];  // element i * 4 + half * 2 + j: key + 8 half, query t BQ + 8 i + 2 (lane % 4) + j
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // P^T and dS^T as A fragments (queries 16 kk .. 16 kk + 15)
  mbar_wait(smem_u32(&own_full), 0);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % S;
    const uint32_t q_tile = q_s + slot * kQoBytes, do_tile = do_s + slot * kQoBytes;
    mbar_wait(smem_u32(&qo_full[slot]), (t / S) & 1);
    // S^T = K Q^T and dP^T = V dO^T, one commit group
    wgmma_fence();
    const uint64_t q_desc = wgmma_desc(q_tile, 16, 1024, 1), do_desc = wgmma_desc(do_tile, 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<BQ>::mma(st, k_desc + 2 * kk, q_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<BQ>::mma(dpt, v_desc + 2 * kk, do_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);
    // this thread's queries' lse (log2 units; +inf past Nq) and delta. (Loaded while the products
    // ran, they made ptxas inject a warpgroup wait and spill at 3 blocks an SM, and were slower.)
    float2 l2[BQ / 8], dl[BQ / 8];
    const float* st_slot = stats + slot * 2 * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const int col = i * 8 + (lane & 3) * 2;
      l2[i] = *reinterpret_cast<const float2*>(st_slot + col);
      dl[i] = *reinterpret_cast<const float2*>(st_slot + BQ + col);
      l2[i].x *= kLog2e;
      l2[i].y *= kLog2e;
    }
    if ((t + 1) * BQ > prm.Nq) {  // the last tile: padded queries get lse = +inf, so P = 0
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int qi = t * BQ + i * 8 + (lane & 3) * 2;
        if (qi >= prm.Nq) l2[i].x = INFINITY;
        if (qi + 1 >= prm.Nq) l2[i].y = INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, x = i * 4 + e;
        const float p = keep[half] ? ex2(fmaf(st[x], prm.c, -((e & 1) ? l2[i].y : l2[i].x))) : 0.f;
        st[x] = p;
        dpt[x] = p * (dpt[x] - ((e & 1) ? dl[i].y : dl[i].x));
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16x2(st[kk * 8 + r * 2], st[kk * 8 + r * 2 + 1]);
        dsa[kk][r] = pack_bf16x2(dpt[kk * 8 + r * 2], dpt[kk * 8 + r * 2 + 1]);
      }

    // dV += P^T dO and dK += dS^T Q, B = dO and Q N-major from the slot (16 queries = 2048 bytes per k16)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<kD>::mma(dv, pa[kk], wgmma_desc(do_tile + kk * 2048, kQoBytes, 1024, 1));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<kD>::mma(dk, dsa[kk], wgmma_desc(q_tile + kk * 2048, kQoBytes, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(pa);
    keep_regs(dsa);
    fence_acc(dv);
    fence_acc(dk);
    __syncthreads();  // every warp is done with slot t % S
    if (t + S < n_tiles) {
      if (threadIdx.x == 0) load_qo(t + S);
      load_stats(t + S);
    }
  }

  // epilogue: scale dK, one rounding each, stored through the strides; keys past Nkv masked
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = key + half * 8;
    if (kj >= prm.Nkv) continue;
    store_acc_row(dk_out + kj * prm.s0.n + (lane & 3) * 2, dk, half, prm.scale);
    store_acc_row(dv_out + kj * prm.s1.n + (lane & 3) * 2, dv, half, 1.f);
  }
}

// The bf16 launches: the four maps {64, H, N, B} (N = Nq for q and dout, kv_valid for k and v)
// with the boxes of the kernel's tiles, encoded per call (the pointers change with every layer).
int bwd_maps(CUtensorMap (&m)[4], const void* const (&ptr)[4], const Strides (&st)[4], int B, int H, int Nq,
             int kv_valid, int q_rows, int kv_rows) {
  const int n[4] = {Nq, Nq, kv_valid, kv_valid}, rows[4] = {q_rows, q_rows, kv_rows, kv_rows};
  for (int i = 0; i < 4; ++i) {
    const int rc = rows_map(&m[i], ptr[i], n[i], H, B, st[i], rows[i]);
    if (rc != 0) return rc;
  }
  return 0;
}

template <bool kDq>
int launch_bwd_bf16(const BwdParams& prm, const void* const (&ptr)[4], const Strides (&st)[4], int B, int H,
                    cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};  // per card: the >48 KB opt-in of this kernel
  const void* kernel = kDq ? reinterpret_cast<const void*>(flash_dq_wgmma)
                           : reinterpret_cast<const void*>(flash_dkv_wgmma);
  const int smem = kDq ? bwd::kDqSmem : bwd::kDkvSmem;
  const cudaError_t e = opt_in_smem(kernel, smem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap m[4];  // q, dout, k, v
  const int rc = kDq ? bwd_maps(m, ptr, st, B, H, prm.Nq, prm.kv_valid, bwd::kRows, bwd::kKeyTile)
                     : bwd_maps(m, ptr, st, B, H, prm.Nq, prm.kv_valid, bwd::kQueryTile, bwd::kRows);
  if (rc != 0) return rc;
  const dim3 grid(((kDq ? prm.Nq : prm.Nkv) + bwd::kRows - 1) / bwd::kRows, H, B);
  if constexpr (kDq)
    flash_dq_wgmma<<<grid, bwd::kThreads, smem, stream>>>(prm, m[0], m[1], m[2], m[3]);
  else
    flash_dkv_wgmma<<<grid, bwd::kThreads, smem, stream>>>(prm, m[0], m[1], m[2], m[3]);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int Nq, int Nkv, int kv_valid) {
  return B <= 0 || H <= 0 || Nq <= 0 || Nkv <= 0 || kv_valid <= 0 || kv_valid > Nkv || H > 65535 || B > 65535;
}

BwdParams bwd_params(const void* lse, const void* delta, void* out0, void* out1, Strides s0, Strides s1, int Nq,
                     int Nkv, int kv_valid, float scale) {
  BwdParams prm{};
  prm.out0 = static_cast<__nv_bfloat16*>(out0);
  prm.out1 = static_cast<__nv_bfloat16*>(out1);
  prm.s0 = s0;
  prm.s1 = s1;
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.Nq = Nq;
  prm.Nkv = Nkv;
  prm.kv_valid = kv_valid;
  prm.c = scale * bwd::kLog2e;
  prm.scale = scale;
  return prm;
}

}  // namespace

// q: (B, Nq, H, 64), k/v: (B, Nkv, H, 64), dout and dq like q; each with unit
// stride on the last axis and the given element strides for (b, n, h); the
// inputs with 16-byte aligned bases and byte strides (bf16: TMA reads them),
// dq with 4-byte aligned rows (bf16 pairs are stored). lse/delta: (B, H, Nq)
// fp32 contiguous. Keys >= kv_valid are masked. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int moge_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, int B, int H, int Nq, int Nkv, int kv_valid,
                                           const int64_t* strides, float scale, int dtype,
                                           void* stream) {
  if (bad_shape(B, H, Nq, Nkv, kv_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = strides;  // (b, n, h) of q, k, v, dout, dq
  const Strides sq{s[0], s[1], s[2]}, sk{s[3], s[4], s[5]}, sv{s[6], s[7], s[8]}, sdo{s[9], s[10], s[11]},
      sdq{s[12], s[13], s[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const BwdParams prm = bwd_params(lse, delta, dq, nullptr, sdq, {}, Nq, Nkv, kv_valid, scale);
    return launch_bwd_bf16<true>(prm, {q, dout, k, v}, {sq, sdo, sk, sv}, B, H, st);
  }
  if (dtype == kFloat32) {
    f32::Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<float*>(dq), nullptr, nullptr, H, Nq, Nkv, kv_valid, sq, sk, sv, sdo, sdq, {}, {}, scale};
    return f32::launch_dq_f32(a, B, st);
  }
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
  const Strides sq{s[0], s[1], s[2]}, sk{s[3], s[4], s[5]}, sv{s[6], s[7], s[8]}, sdo{s[9], s[10], s[11]},
      sdk{s[12], s[13], s[14]}, sdv{s[15], s[16], s[17]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const BwdParams prm = bwd_params(lse, delta, dk, dv, sdk, sdv, Nq, Nkv, kv_valid, scale);
    return launch_bwd_bf16<false>(prm, {q, dout, k, v}, {sq, sdo, sk, sv}, B, H, st);
  }
  if (dtype == kFloat32) {
    f32::Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
           nullptr, static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nkv, kv_valid,
           sq, sk, sv, sdo, {}, sdk, sdv, scale};
    return f32::launch_dkv_f32(a, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
