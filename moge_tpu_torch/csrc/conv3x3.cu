// K3 and K3-grouped: 3x3 stride-1 convolution with replicate padding, NHWC,
// fp32 accumulation.
//
// Replaces moge_tpu/ops/conv.py::_kernel (reached through conv3x3_replicate
// and conv3x3_up2_bilinear -> _conv3x3_pallas), in both of its weight forms:
// shared (3,3,C,O) weights (K3) and per-batch-group (G,3,3,C,O) weights
// (K3-grouped, the batched decoder heads of models/multihead.py), where batch
// entry b of the (G*B0, H, W, C) input uses weight group g = b / B0. Computes
//   y[b,h,w,o] = round( sum_{dh,dw,c} relu?(x[b, clamp(h+dh-1), clamp(w+dw-1), c]) * k[g,dh,dw,c,o]
//                       + bias[g,o] + residual[b,h,w,o] )
// with the sum, bias and residual in fp32 and one rounding to the input
// dtype, in conv3x3_xla's order. The shared form is the grouped one with G=1.
// Both are an implicit GEMM with M = B0*H*W pixels, N = O, K = 9*C; the
// weight group is the grid's z index, so no output tile straddles two
// groups, and a block offsets the weights by g*9*C*O and the bias by g*O.
// Nothing of the TPU's lane-group layout (conv.py:12-22) is carried over.
//
// What bounds it on an H100: at the decoder shapes (C, O = 64..256 at
// 74^2..296^2 pixels) it does 18*C flops per output element. The least bytes
// (chip_smoke.py::conv_bound) count the input, weights, residual and output
// once each; 74^2 256->256 is then bound by the tensor cores, 296^2 64->64 by
// device memory. What the kernel moves beyond that comes from L2 (50 MB; a
// 296^2 x 64 bf16 map is 11 MB): each block reads its input patch plus a
// 1-pixel halo (1.6x its pixels for an 8x8 patch, 1.4x for 8x16) and the
// weights of its N tile. An im2col gather per tap would instead read every
// input pixel 9 times, and with the per-tile weights that L2 traffic, not
// the tensor cores, would set the time; so the patch is staged once per
// channel chunk and the weights come by TMA.
//
// bf16, the main path: a Hopper kernel.
// - A block computes an 8 x TW patch of output pixels (TW = 8 or 16: BM = 64
//   or 128 pixels, one warpgroup per 64) by BN output channels, BN in {16,
//   32, 64, 128} chosen per launch from O (ops/conv.py::_tile_config), so
//   the heads' O = 12 and 4 run N = 16, not 64. K is walked as (channel chunk
//   of 64, tap): per chunk the (8+2) x (TW+2) input patch is staged once, and
//   the 9 taps are 9 shifted windows of it.
// - Tensor cores through wgmma.mma_async m64nNk16 with fp32 accumulators in
//   registers. A comes from registers: ldmatrix gives each lane the row of
//   its output pixel's tap in the staged patch (any row address, which is
//   what makes the shifted windows free), then the input ReLU is one
//   max.bf16x2 on each fragment register (exact: ReLU commutes with
//   replicate padding, and no asynchronous copy can apply it on the way in).
//   B, the 64 x BN weight slice of a tap and chunk, is read by wgmma from
//   shared memory through a matrix descriptor, stored N-major (the weights'
//   own (9*C, O) order, transpose flag set) in the canonical swizzled
//   layout: 64-wide N atoms with the 128-byte swizzle, or the 64/32-byte
//   swizzle when BN is 32/16.
// - Asynchronous copies. The patch: each thread copies contiguous channels of
//   fixed halo rows with cp.async from the CLAMPED source row and column
//   (the replicate padding; no padded copy), zero-filled past C, into one of
//   two patch slots. The weights: with 16-byte alignment (C and O multiples
//   of 8) one thread loads each slice by TMA from a 3-d tensor map {O, C,
//   9*G}, which zero-fills rows past C and columns past O and applies the
//   swizzle, completing on an mbarrier per slot; otherwise the threads copy
//   it with cp.async of 8 or 4 bytes (cp.async.ca), or, with an odd C or O,
//   through registers 2 bytes at a time (the generic variant). A ring of 4
//   weight slots, one barrier per K step, and each step's wgmma group stays
//   in flight while the block waits for the next step's data.
// - Epilogue from the accumulator registers: + bias and + residual in fp32,
//   one rounding, masked bf16x2 stores (scalar for the generic variant).
// fp32 (parity and gradient checks, not the main path): a 64x64 tile of 4
// warps with plain fp32 FMAs over scalar loads staged in shared memory.

#include "common.cuh"
#include "hopper.cuh"

#include <functional>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------- fp32 path

constexpr int kBM = 64;  // output pixels per block
constexpr int kBN = 64;  // output channels per block
constexpr int kBK = 32;  // input channels per K step
constexpr int kThreads = 128;
constexpr int kLdC = kBN + 4;

struct TileF32 {
  static constexpr int kLdA = kBK + kPad<float>;
  static constexpr int kLdB = kBN + kPad<float>;
  static constexpr size_t a = sizeof(float) * kBM * kLdA;
  static constexpr size_t b = sizeof(float) * kBK * kLdB;
  static constexpr size_t c = sizeof(float) * kBM * kLdC;
  static constexpr size_t total = (a + b) > c ? (a + b) : c;  // C aliases A and B
};

// each thread owns an 8x4 patch of the 64x64 tile
struct MmaF32 {
  using Tl = TileF32;
  float acc[8][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* a, const float* b) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float ar[8], br[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) ar[i] = a[(tr * 8 + i) * Tl::kLdA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = b[k * Tl::kLdB + tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  __device__ void store(float* c) const {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[(tr * 8 + i) * kLdC + tc * 4 + j] = acc[i][j];
  }
};

__global__ void __launch_bounds__(kThreads)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
            const float* __restrict__ res, float* __restrict__ y, int B0, int H, int W, int C, int O,
            int relu) {
  using Tl = TileF32;
  __shared__ __align__(128) unsigned char smem[Tl::total];
  __shared__ int pix_b[kBM], pix_h[kBM], pix_w[kBM];
  float* as = reinterpret_cast<float*>(smem);
  float* bs = reinterpret_cast<float*>(smem + Tl::a);
  float* cs = reinterpret_cast<float*>(smem);

  const int g = blockIdx.z;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t M = B0 * HW;
  x += static_cast<int64_t>(g) * M * C;
  y += static_cast<int64_t>(g) * M * O;
  if (res != nullptr) res += static_cast<int64_t>(g) * M * O;
  w += static_cast<int64_t>(g) * 9 * C * O;
  if (bias != nullptr) bias += static_cast<int64_t>(g) * O;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int64_t p = m0 + r;
    if (p < M) {
      const int64_t rem = p % HW;
      pix_b[r] = static_cast<int>(p / HW);
      pix_h[r] = static_cast<int>(rem / W);
      pix_w[r] = static_cast<int>(rem % W);
    } else {
      pix_b[r] = -1;
    }
  }
  __syncthreads();

  MmaF32 mma;
  mma.zero();
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += kBK) {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kc = i % kBK, c = c0 + kc;
        float val = 0.f;
        if (pix_b[r] >= 0 && c < C) {
          const int hh = min(max(pix_h[r] + dh, 0), H - 1);
          const int ww = min(max(pix_w[r] + dw, 0), W - 1);
          val = x[((static_cast<int64_t>(pix_b[r]) * H + hh) * W + ww) * C + c];
          if (relu && val < 0.f) val = 0.f;
        }
        as[r * Tl::kLdA + kc] = val;
      }
      for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
        const int kr = i / kBN, n = i % kBN, c = c0 + kr, o = n0 + n;
        bs[kr * Tl::kLdB + n] = (c < C && o < O) ? w[(static_cast<int64_t>(tap) * C + c) * O + o] : 0.f;
      }
      __syncthreads();
      mma.step(as, bs);
      __syncthreads();
    }
  }

  mma.store(cs);  // C aliases A/B: every warp passed the loop's last barrier
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, n = i % kBN, o = n0 + n;
    if (pix_b[r] < 0 || o >= O) continue;
    const int64_t idx = (m0 + r) * O + o;
    float val = cs[r * kLdC + n];
    if (bias != nullptr) val += bias[o];
    if (res != nullptr) val += res[idx];
    y[idx] = val;
  }
}

int launch_f32(const void* x, const void* w, const float* bias, const void* res, void* y, int G, int B0,
               int H, int W, int C, int O, int relu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B0) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (O + kBN - 1) / kBN, G);
  conv3x3_f32<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x), static_cast<const float*>(w), bias,
                                             static_cast<const float*>(res), static_cast<float*>(y), B0, H, W,
                                             C, O, relu);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bf16 path (wgmma)

using bf16 = __nv_bfloat16;
constexpr int kChunk = 64;  // input channels per K step: one 128-byte row per pixel of the patch

template <int BM, int BN, int VW>
struct Wg {
  static constexpr int kThreads = BM * 2;               // one warpgroup (128 threads) per 64 pixels
  static constexpr int kTH = 8, kTW = BM / 8;            // the block's output pixels: an 8 x kTW patch
  static constexpr int kHaloW = kTW + 2;                 // its input patch with the 1-pixel halo
  static constexpr int kHaloRows = (kTH + 2) * kHaloW;   // one 128-byte row (64 channels) per pixel
  static constexpr int kHaloBytes = (kHaloRows * 128 + 1023) / 1024 * 1024;
  static constexpr int kAtomN = BN < 64 ? BN : 64;       // B's swizzle atom along N, in elements
  static constexpr int kS = kAtomN / 8;                  // 16-byte chunks per atom row: 2, 4 or 8
  static constexpr uint32_t kSbo = kS * 128;             // bytes between groups of 8 k rows
  static constexpr uint32_t kLbo = kSbo * (kChunk / 8);  // bytes between N atoms
  static constexpr uint64_t kLayout = kS == 8 ? 1 : (kS == 4 ? 2 : 3);  // 128B, 64B, 32B swizzle
  static constexpr int kBBytes = kChunk * BN * 2;
  static constexpr int kStages = 4;                      // B slots; the halo has two
  static constexpr int kSmem = 2 * kHaloBytes + kStages * kBBytes + 1024;  // + slack to align to 1 KB
  static constexpr int kElems = VW / 2;                  // channels per copy
  static_assert(BM == 64 || BM == 128, "BM");
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128, "BN");
  static_assert(VW == 16 || VW == 8 || VW == 4 || VW == 2, "VW");
};

// one VW-byte copy global -> shared, zero-filled when !ok (src is then not read)
template <int VW>
__device__ __forceinline__ void copy_in(uint32_t dst, const bf16* src, bool ok) {
  if constexpr (VW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (VW == 8 || VW == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(VW),
                 "r"(ok ? VW : 0)
                 : "memory");
  } else {  // the generic variant: a 2-byte load and store through a register
    const unsigned short v = ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  uint32_t out;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(v), "r"(0u));
  return out;
}

// byte offset of B element (k, n) of a stage: N-major canonical layout of
// 8-row k groups by N atoms, then the Swizzle<log2 S, 4, 3> of the mode
template <int BM, int BN, int VW>
__device__ __forceinline__ uint32_t b_offset(int k, int n) {
  using Cf = Wg<BM, BN, VW>;
  const uint32_t off = (n / Cf::kAtomN) * Cf::kLbo + (k / 8) * Cf::kSbo + (k % 8) * (Cf::kS * 16) +
                       (n % Cf::kAtomN) * 2;
  return off ^ (((off >> 7) & (Cf::kS - 1)) << 4);
}

template <int BM, int BN, int VW>
__global__ void __launch_bounds__(BM * 2)
conv3x3_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
              const bf16* __restrict__ res, bf16* __restrict__ y, int B0, int H, int W, int C, int O,
              int relu, const __grid_constant__ CUtensorMap w_map) {
  using Cf = Wg<BM, BN, VW>;
  constexpr int T = Cf::kThreads, E = Cf::kElems, S = Cf::kStages, TW = Cf::kTW, HW2 = Cf::kHaloW;
  constexpr bool kTma = VW == 16;  // the weights by TMA (w_map); else by cp.async like the patch
  __shared__ __align__(8) uint64_t b_full[S];  // per B slot: its TMA copies landed (kTma)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle atoms need 1 KB alignment
  const uint32_t halo0 = ring, b_ring = ring + 2 * Cf::kHaloBytes;
  if (kTma && threadIdx.x == 0) {
    prefetch_tensormap(&w_map);
    for (int i = 0; i < S; ++i) mbar_init(smem_u32(&b_full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block: weight group g, image b, the 8 x TW output patch at (h0, w0), output channels n0..
  const int g = blockIdx.z;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + Cf::kTH - 1) / Cf::kTH;
  const int tx = blockIdx.x % tiles_w, ty = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = ty * Cf::kTH, w0 = tx * TW;
  const int n0 = blockIdx.y * BN;
  const int64_t M = static_cast<int64_t>(B0) * H * W;
  x += static_cast<int64_t>(g) * M * C + static_cast<int64_t>(b) * H * W * C;
  y += static_cast<int64_t>(g) * M * O;
  if (res != nullptr) res += static_cast<int64_t>(g) * M * O;
  w += static_cast<int64_t>(g) * 9 * C * O;
  if (bias != nullptr) bias += static_cast<int64_t>(g) * O;

  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int steps = 9 * n_chunks;  // K step s: channel chunk s / 9, tap s % 9

  // Copies. Each thread moves the same piece of q channels of a fixed set of
  // halo rows, and the same column piece of a fixed set of weight rows, at
  // every step, so the loops unroll fully; addresses are computed without
  // branches (a masked copy reads nothing and gets an in-bounds address).
  constexpr int kRowPieces = kChunk / E, kRowsPerPass = T / kRowPieces;
  constexpr int kHaloPasses = (Cf::kHaloRows + kRowsPerPass - 1) / kRowsPerPass;
  constexpr int kColPieces = BN / E, kBCopies = kChunk * kColPieces / T;
  static_assert(T % kRowPieces == 0 && T % kColPieces == 0 && kBCopies >= 1, "copy split");
  const int a_q = threadIdx.x % kRowPieces, a_r0 = threadIdx.x / kRowPieces;
  const int b_n = (threadIdx.x % kColPieces) * E, b_k0 = threadIdx.x / kColPieces;
  const bool b_n_ok = n0 + b_n < O;

  // the input patch of channel chunk ck, with the replicate padding as clamped
  // source rows and columns (no padded copy), into halo slot ck % 2
  auto load_halo = [&](int ck) {
    const uint32_t dst0 = halo0 + (ck & 1) * Cf::kHaloBytes;
    const int c = ck * kChunk + a_q * E;
    const bool c_ok = c < C;
    const int byte = a_q * VW;
#pragma unroll
    for (int j = 0; j < kHaloPasses; ++j) {
      const int r = a_r0 + j * kRowsPerPass;
      if (kHaloPasses * kRowsPerPass != Cf::kHaloRows && r >= Cf::kHaloRows) break;
      const int hh = min(max(h0 + r / HW2 - 1, 0), H - 1), ww = min(max(w0 + r % HW2 - 1, 0), W - 1);
      const bf16* src = x + (static_cast<int64_t>(hh) * W + ww) * C + (c_ok ? c : 0);
      copy_in<VW>(dst0 + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15), src, c_ok);
    }
  };
  // the (64 x BN) weight slice of step s into B slot s % S
  auto load_b = [&](int s) {
    const int ck = s / 9, tap = s - ck * 9, c0 = ck * kChunk;
    const uint32_t dst0 = b_ring + (s % S) * Cf::kBBytes;
    if constexpr (kTma) {  // one thread: the (64 x BN) box, an N atom at a time; rows past C read as 0
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&b_full[s % S]);
        mbar_expect_tx(bar, Cf::kBBytes);
#pragma unroll
        for (int a = 0; a < BN / Cf::kAtomN; ++a)
          tma_load_3d(dst0 + a * Cf::kLbo, &w_map, n0 + a * Cf::kAtomN, c0, g * 9 + tap, bar);
      }
    } else {
      const bf16* w_step = w + static_cast<int64_t>(tap * C + c0) * O + n0;
#pragma unroll
      for (int j = 0; j < kBCopies; ++j) {
        const int k = b_k0 + j * (T / kColPieces);
        const bool ok = b_n_ok && c0 + k < C;
        copy_in<VW>(dst0 + b_offset<BM, BN, VW>(k, b_n), ok ? w_step + k * O + b_n : w, ok);
      }
    }
  };
  // one commit group per step: its weights, and the next chunk's patch with the chunk's first tap
  auto load = [&](int s) {
    if (s % 9 == 0) load_halo(s / 9);
    load_b(s);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // this thread's ldmatrix row: output pixel m = (i, j) of the patch reads
  // halo row (i + dh + 1, j + dw + 1) at tap (dh, dw)
  const int lane = threadIdx.x & 31;
  const int m = (threadIdx.x >> 5) * 16 + (lane & 15);  // warpgroup * 64 + warp * 16 + lane % 16
  const int a_center = (m / TW + 1) * HW2 + m % TW + 1, a_half = lane >> 4;

  // The ring: the copies of step s are issued D = S - 2 steps ahead, and
  // step s's wgmma group stays in flight until step s + 1 has issued its own.
  // So the B slot that step s + D overwrites is the one step s - 2 read, and
  // the patch slot that chunk ck + 1 overwrites (issued at step 9 ck + 7) is
  // the one chunk ck - 1 read: every warpgroup finished both before the
  // barrier at the top of step s. The A fragments of the group in flight are
  // kept live (keep_regs) until the wait that retires it, so that no other
  // value is given their registers while wgmma still reads them.
  constexpr int D = S - 2;
  auto step = [&](int s, uint32_t (&a)[4][4], uint32_t (&a_prev)[4][4]) {
    cp_async_wait<D - 1>();  // this thread's copies of step s (and of its chunk's patch) landed
    if (!kTma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();         // everyone's landed; every warpgroup is done with step s-2's slots
    const int ck = s / 9, tap = s - ck * 9;
    const int hr = a_center + (tap / 3 - 1) * HW2 + tap % 3 - 1;
    const uint32_t a_row = halo0 + (ck & 1) * Cf::kHaloBytes + hr * 128;
    const uint32_t b_st = b_ring + (s % S) * Cf::kBBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4(a[kk], a_row + (((kk * 2 + a_half) ^ (hr & 7)) << 4));
      if (relu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[kk][j] = relu_bf16x2(a[kk][j]);
      }
    }
    if (kTma) mbar_wait(smem_u32(&b_full[s % S]), (s / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BN>::mma(acc, a[kk], wgmma_desc(b_st + kk * 2 * Cf::kSbo, Cf::kLbo, Cf::kSbo, Cf::kLayout));
    wgmma_commit();
    if (s + D < steps) load(s + D);  // issued while the tensor cores work on step s
    cp_async_commit();
    wgmma_wait<1>();  // step s-1's group is done; step s's runs on
    keep_regs(a_prev);
  };
#pragma unroll 1
  for (int s = 0; s < D; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  uint32_t frag0[4][4] = {}, frag1[4][4] = {};
#pragma unroll 1
  for (int s = 0; s < steps; s += 2) {
    step(s, frag0, frag1);
    if (s + 1 < steps) step(s + 1, frag1, frag0);
  }
  wgmma_wait<0>();
  keep_regs(frag0);
  keep_regs(frag1);
  fence_acc(acc);

  // epilogue: accumulator (row, col) pairs of this thread, + bias, + residual, one rounding
  // (rows row0 and row0 + 8 of the patch; columns 8i + 2 (lane % 4) and + 1)
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  int64_t pix[2];
  bool pix_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + half * 8, h = h0 + r / TW, ww = w0 + r % TW;
    pix_ok[half] = h < H && ww < W;
    pix[half] = (static_cast<int64_t>(b) * H + h) * W + ww;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int o = n0 + i * 8 + (lane & 3) * 2;
    if (o >= O) continue;
    const bool pair = o + 1 < O;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = bias[o];
      if (pair) b1 = bias[o + 1];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!pix_ok[half]) continue;
      const int64_t idx = pix[half] * O + o;
      float v0 = acc[i * 4 + half * 2] + b0, v1 = acc[i * 4 + half * 2 + 1] + b1;
      if (VW >= 4 && pair) {  // O even and 4-byte aligned pointers: one bf16x2
        if (res != nullptr) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + idx));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(y + idx) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (res != nullptr) {
          v0 += __bfloat162float(res[idx]);
          if (pair) v1 += __bfloat162float(res[idx + 1]);
        }
        y[idx] = __float2bfloat16(v0);
        if (pair) y[idx + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// the (G, 9, C, O) weights as a 3-d tensor {O, C, 9 G} with boxes of one N
// atom by 64 channels, swizzled as the kernel's B slots are. The map depends
// only on the address and the shape, so each thread keeps the maps it
// encoded (a forward reuses the same few dozen weights), keyed by both.
template <int BN>
int weight_map(CUtensorMap* map, const void* w, int G, int C, int O) {
  struct Key {
    const void* w;
    int G, C, O;
    bool operator==(const Key& k) const { return w == k.w && G == k.G && C == k.C && O == k.O; }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.w) ^ (static_cast<size_t>(k.G) << 40 ^ static_cast<size_t>(k.C) << 20 ^ k.O);
    }
  };
  thread_local std::unordered_map<Key, CUtensorMap, Hash> maps;
  const Key key{w, G, C, O};
  const auto hit = maps.find(key);
  if (hit != maps.end()) {
    *map = hit->second;
    return 0;
  }
  constexpr int kAtomN = BN < 64 ? BN : 64;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(9) * G};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(O) * 2, static_cast<cuuint64_t>(C) * O * 2};
  const cuuint32_t box[3] = {kAtomN, static_cast<cuuint32_t>(kChunk), 1}, unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = kAtomN == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kAtomN == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  if (maps.size() >= 4096) maps.clear();  // weights made anew each step (training) come and go
  maps.emplace(key, *map);
  return 0;
}

template <int BM, int BN, int VW>
int launch_wgmma(const void* x, const void* w, const float* bias, const void* res, void* y, int G, int B0,
                 int H, int W, int C, int O, int relu, cudaStream_t stream) {
  using Cf = Wg<BM, BN, VW>;
  static std::atomic<uint64_t> opted{0};  // per card: the >48 KB opt-in of this instantiation
  const cudaError_t attr = opt_in_smem(reinterpret_cast<const void*>(conv3x3_wgmma<BM, BN, VW>), Cf::kSmem, opted);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap w_map = {};
  if (VW == 16) {
    const int rc = weight_map<BN>(&w_map, w, G, C, O);
    if (rc != 0) return rc;
  }
  const int64_t tiles = static_cast<int64_t>(B0) * ((H + Cf::kTH - 1) / Cf::kTH) * ((W + Cf::kTW - 1) / Cf::kTW);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), (O + BN - 1) / BN, G);
  conv3x3_wgmma<BM, BN, VW><<<grid, Cf::kThreads, Cf::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, static_cast<const bf16*>(res),
      static_cast<bf16*>(y), B0, H, W, C, O, relu, w_map);
  return static_cast<int>(cudaGetLastError());
}

// the tiles (bm x bn, copy width vw) that ops/conv.py::_tile_config can
// return, and no others: any other tile is an error
int launch_bf16(const void* x, const void* w, const float* bias, const void* res, void* y, int G, int B0,
                int H, int W, int C, int O, int relu, int bm, int bn, int vw, cudaStream_t st) {
#define MOGE_CONV_CASE(BM_, BN_, VW_) \
  if (bm == BM_ && bn == BN_ && vw == VW_) \
    return launch_wgmma<BM_, BN_, VW_>(x, w, bias, res, y, G, B0, H, W, C, O, relu, st);
#define MOGE_CONV_WIDTHS(BM_, VW_) \
  MOGE_CONV_CASE(BM_, 16, VW_) MOGE_CONV_CASE(BM_, 32, VW_) MOGE_CONV_CASE(BM_, 64, VW_) \
  MOGE_CONV_CASE(BM_, 128, VW_)
  MOGE_CONV_WIDTHS(64, 16)
  MOGE_CONV_WIDTHS(64, 8)
  MOGE_CONV_WIDTHS(64, 4)
  MOGE_CONV_WIDTHS(64, 2)
  MOGE_CONV_CASE(128, 64, 16)
  MOGE_CONV_CASE(128, 128, 16)
#undef MOGE_CONV_WIDTHS
#undef MOGE_CONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const void* x, const void* w, const void* bias, const void* res, void* y, int G, int B0,
             int H, int W, int C, int O, int relu, int dtype, int bm, int bn, int vw, void* stream) {
  if (G <= 0 || G > 65535 || B0 <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 ||
      static_cast<int64_t>(B0) * H > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_bf16(x, w, b, res, y, G, B0, H, W, C, O, relu, bm, bn, vw, st);
  if (dtype == kFloat32) return launch_f32(x, w, b, res, y, G, B0, H, W, C, O, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K3. x: (B, H, W, C), w: (3, 3, C, O), res/y: (B, H, W, O), all contiguous
// in the given dtype; bias: (O,) fp32 or null; res may be null; bm, bn, vw:
// the bf16 kernel's tile of bm pixels by bn channels and its copy width in
// bytes (ops/conv.py::_tile_config), ignored for fp32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int moge_conv3x3(const void* x, const void* w, const void* bias, const void* res,
                            void* y, int B, int H, int W, int C, int O, int relu, int dtype, int bm, int bn,
                            int vw, void* stream) {
  return dispatch(x, w, bias, res, y, 1, B, H, W, C, O, relu, dtype, bm, bn, vw, stream);
}

// K3-grouped. x: (G*B0, H, W, C), w: (G, 3, 3, C, O), res/y: (G*B0, H, W, O),
// all contiguous in the given dtype; bias: (G, O) fp32 or null; res may be
// null. Batch entry b uses weight group b / B0. bm, bn, vw as for moge_conv3x3.
extern "C" int moge_conv3x3_grouped(const void* x, const void* w, const void* bias, const void* res,
                                    void* y, int G, int B0, int H, int W, int C, int O, int relu,
                                    int dtype, int bm, int bn, int vw, void* stream) {
  return dispatch(x, w, bias, res, y, G, B0, H, W, C, O, relu, dtype, bm, bn, vw, stream);
}
