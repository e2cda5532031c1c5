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
//
// fp32: the main path of MoGe-1's `infer` and of every fp32 `infer` (the
// command's default), the fp32 panorama and eval, the up2 parity convs. Every
// product and sum is an IEEE fp32 FFMA (no TF32 in any form). What bounds it:
// the FP32 pipes, 18*C*O flops a pixel at 66.9 TFLOP/s (128 FFMA lanes on each
// of 132 SMs at 1.98 GHz); MoGe-1's folder image (17 convs, 349.5 GFLOP) needs
// 5.22 ms, against tens of MB of maps. A register-blocked implicit GEMM:
// - A block of 256 threads computes BN output channels (32, 64 or 128, chosen
//   per launch from O and the grid by ops/conv.py::_f32_tile) by a patch of
//   16384 / BN pixels (8 x 16, 16 x 16, 16 x 32). A thread holds 8 pixels by
//   8 channels in registers (64 accumulators), so each value read from shared
//   memory feeds 8 FFMAs: per 4 input channels, 8 float4 of weights and 8
//   float4 of input (4 channels of a pixel each) for 256 FFMAs.
// - K is walked as (channel chunk of KC = 16, or 8 where 16 does not divide C:
//   C = 66 pads to 72; tap). Per chunk the (PH+2) x (PW+2) input patch is
//   staged once by cp.async (16 bytes, or 8 where C % 4 == 2) from the CLAMPED
//   source row and column (the replicate padding; no padded copy), zero past
//   C; the 9 taps are shifted windows of it. The patch is channel-innermost
//   (KC channels and 16 bytes of pad a pixel): a tap's shift moves along
//   pixels, so loads are vectorised along the channels and the output
//   channels, and a quarter-warp reads one or two pixels on different banks.
//   Each tap's (KC x BN) weight slice arrives by 16-byte cp.async, zero past
//   C and O. A ring of 4 weight slots and 2 patch slots, the copies issued 3
//   steps ahead, one barrier a step.
// - The input ReLU: once a chunk, in shared memory, each thread on the
//   elements it copied after they landed (ReLU commutes with the padding).
// - Epilogue from the registers: + bias, + residual in fp32, float4 stores.
// - An odd C, an O not a multiple of 4 or a pointer not 16-byte aligned takes
//   the generic kernel (conv3x3_f32_generic: a 64x64 tile of 4 warps, scalar
//   loads staged in shared memory, two barriers a step).

#include "common.cuh"
#include "hopper.cuh"

#include <functional>
#include <unordered_map>

namespace {

// ------------------------------------------------------------ async copies

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- fp32 path

namespace f32 {
constexpr int kThreads = 256;
constexpr int kTM = 8;                   // output pixels per thread
constexpr int kTN = 8;                   // output channels per thread: two groups of 4
constexpr int kStages = 4;               // weight slots
constexpr int kAhead = kStages - 1;      // steps whose copies are in flight ahead of the one computed

// A block: BN output channels by a patch of BM = 16384 / BN pixels (8 x 16,
// 16 x 16 or 16 x 32 for BN = 128, 64, 32), so every build holds 64
// accumulators a thread. KC input channels per K step; the patch is copied
// CW bytes (CW / 4 channels) at a time.
template <int BN, int KC, int CW>
struct Cfg {
  static constexpr int kGroupsN = BN / kTN;             // threads along N: 16, 8, 4
  static constexpr int kGroupsM = kThreads / kGroupsN;  // along the pixels: 16, 32, 64
  static constexpr int kBM = kGroupsM * kTM;            // 128, 256, 512
  static constexpr int kPW = BN == 32 ? 32 : 16;        // the patch, kPH x kPW
  static constexpr int kPH = kBM / kPW;
  static constexpr int kCols = kPW / kTM;               // pixel groups a patch row
  static constexpr int kHaloW = kPW + 2;                // the patch with its 1-pixel halo
  static constexpr int kHaloPx = (kPH + 2) * kHaloW;
  static constexpr int kLd = KC + 4;                    // floats a staged pixel: its channels, 16 bytes of pad
  static constexpr int kHalo = kHaloPx * kLd;           // floats of a patch slot (two slots)
  static constexpr int kB = KC * BN;                    // floats of a weight slot
  static constexpr int kSmem = static_cast<int>(sizeof(float)) * (2 * kHalo + kStages * kB);
  static constexpr int kWarpN = kGroupsN < 8 ? kGroupsN : 8;  // N groups a warp spans
  static constexpr int kWarpsN = kGroupsN / kWarpN;           // warps along N
  static constexpr int kCopyCh = CW / 4;                      // channels a patch copy
  static_assert(BN == 32 || BN == 64 || BN == 128, "BN");
  static_assert(KC == 8 || KC == 16, "KC");
  static_assert(CW == 8 || CW == 16, "CW");
  static_assert(kPH * kPW == kBM && kCols * kTM == kPW, "patch");
  static_assert(2 * kSmem <= 227 * 1024, "two blocks an SM");
};
}  // namespace f32

// one CW-byte copy global -> shared, zero-filled when !ok (src is then not read)
template <int CW>
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool ok) {
  const uint32_t d = smem_u32(dst);
  if constexpr (CW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(CW), "r"(ok ? CW : 0)
                 : "memory");
  }
}

__device__ __forceinline__ float4 ld4s(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[j] += a * b[j / 4].(j % 4): one channel of one pixel into the thread's 8 output channels
__device__ __forceinline__ void fma8(float (&acc)[f32::kTN], float a, const float4 (&b)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    acc[q * 4 + 0] = fmaf(a, b[q].x, acc[q * 4 + 0]);
    acc[q * 4 + 1] = fmaf(a, b[q].y, acc[q * 4 + 1]);
    acc[q * 4 + 2] = fmaf(a, b[q].z, acc[q * 4 + 2]);
    acc[q * 4 + 3] = fmaf(a, b[q].w, acc[q * 4 + 3]);
  }
}

template <int BN, int KC, int CW>
__global__ void __launch_bounds__(f32::kThreads, 2)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
            const float* __restrict__ res, float* __restrict__ y, int B0, int H, int W, int C, int O, int relu) {
  using Cf = f32::Cfg<BN, KC, CW>;
  constexpr int T = f32::kThreads, S = f32::kStages, D = f32::kAhead, TM = f32::kTM;
  extern __shared__ __align__(16) float smem_f32[];
  float* const halo = smem_f32;                  // two patch slots, [pixel][kLd]
  float* const ring = smem_f32 + 2 * Cf::kHalo;  // S weight slots, [KC][BN]

  // this block: weight group g, image b, the kPH x kPW output patch at (h0, w0), output channels n0..
  const int g = blockIdx.z;
  const int tiles_w = (W + Cf::kPW - 1) / Cf::kPW, tiles_h = (H + Cf::kPH - 1) / Cf::kPH;
  const int tx = blockIdx.x % tiles_w, ty = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = ty * Cf::kPH, w0 = tx * Cf::kPW;
  const int n0 = blockIdx.y * BN;
  const int64_t M = static_cast<int64_t>(B0) * H * W;
  x += static_cast<int64_t>(g) * M * C + static_cast<int64_t>(b) * H * W * C;
  y += static_cast<int64_t>(g) * M * O;
  if (res != nullptr) res += static_cast<int64_t>(g) * M * O;
  w += static_cast<int64_t>(g) * 9 * C * O;
  if (bias != nullptr) bias += static_cast<int64_t>(g) * O;

  // this thread: output channels 4 ng.. and BN / 2 + 4 ng.. (+ 0..3) of the 8 pixels
  // (pr, pc + kCols i) of the patch. A quarter-warp spans 8 (BN >= 64) or 4 N groups of
  // 1 or 2 pixel groups: its weight reads are 128 or 64 contiguous bytes, its patch reads
  // one pixel, or two adjacent ones kLd floats apart, on different banks.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = (warp % Cf::kWarpsN) * Cf::kWarpN + lane % Cf::kWarpN;
  const int pg = (warp / Cf::kWarpsN) * (32 / Cf::kWarpN) + lane / Cf::kWarpN;
  const int pr = pg / Cf::kCols, pc = pg % Cf::kCols;
  const int a_base = (pr * Cf::kHaloW + pc) * Cf::kLd;  // its first pixel at tap (-1, -1)

  const int chunks = (C + KC - 1) / KC, steps = 9 * chunks;  // K step s: channel chunk s / 9, tap s % 9

  // the patch of chunk ck into slot ck % 2: every halo pixel's KC channels from the
  // CLAMPED source row and column (the replicate padding; no padded copy), zero past C
  constexpr int kPieces = KC / Cf::kCopyCh;
  constexpr int kHaloCopies = Cf::kHaloPx * kPieces;
  constexpr int kHaloIters = (kHaloCopies + T - 1) / T;
  auto load_halo = [&](int ck) {
    float* const dst = halo + (ck & 1) * Cf::kHalo;
#pragma unroll
    for (int j = 0; j < kHaloIters; ++j) {
      const int i = threadIdx.x + j * T;
      if (kHaloCopies % T != 0 && i >= kHaloCopies) break;
      const int p = i / kPieces, part = (i % kPieces) * Cf::kCopyCh, c = ck * KC + part;
      const int hh = min(max(h0 + p / Cf::kHaloW - 1, 0), H - 1);
      const int ww = min(max(w0 + p % Cf::kHaloW - 1, 0), W - 1);
      const bool ok = c < C;
      cp_async_f32<CW>(dst + p * Cf::kLd + part, x + (static_cast<int64_t>(hh) * W + ww) * C + (ok ? c : 0), ok);
    }
  };
  // the input ReLU, once a chunk, on the patch elements this thread copied, after they
  // landed and before the barrier that hands them to the block (ReLU commutes with the
  // replicate padding; a copy cannot apply it on the way in)
  auto relu_halo = [&](int ck) {
    float* const dst = halo + (ck & 1) * Cf::kHalo;
#pragma unroll
    for (int j = 0; j < kHaloIters; ++j) {
      const int i = threadIdx.x + j * T;
      if (kHaloCopies % T != 0 && i >= kHaloCopies) break;
      float* const e = dst + (i / kPieces) * Cf::kLd + (i % kPieces) * Cf::kCopyCh;
      if constexpr (CW == 16) {
        float4 v = ld4s(e);
        *reinterpret_cast<float4*>(e) = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      } else {
        float2 v = *reinterpret_cast<const float2*>(e);
        *reinterpret_cast<float2*>(e) = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
      }
    }
  };
  // the (KC x BN) weight slice of step s into slot s % S, 16 bytes a copy, zero past C and O
  constexpr int kVecs = BN / 4;
  constexpr int kBCopies = KC * kVecs;
  constexpr int kBIters = (kBCopies + T - 1) / T;
  auto load_b = [&](int s) {
    const int ck = s / 9, tap = s - 9 * ck, c0 = ck * KC;
    float* const dst = ring + (s % S) * Cf::kB;
    const float* const src = w + static_cast<int64_t>(tap * C + c0) * O + n0;
#pragma unroll
    for (int j = 0; j < kBIters; ++j) {
      const int i = threadIdx.x + j * T;
      if (kBCopies % T != 0 && i >= kBCopies) break;
      const int k = i / kVecs, n = (i % kVecs) * 4;
      const bool ok = c0 + k < C && n0 + n < O;
      cp_async_f32<16>(dst + k * BN + n, ok ? src + static_cast<int64_t>(k) * O + n : w, ok);
    }
  };
  // one commit group per step: its weights, and the chunk's patch with the chunk's first tap
  auto load = [&](int s) {
    if (s % 9 == 0) load_halo(s / 9);
    load_b(s);
  };

  float acc[TM][f32::kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < f32::kTN; ++j) acc[i][j] = 0.f;

  // The ring: the copies of step s are issued D = S - 1 steps ahead, into the weight slot
  // step s - 1 read and (at a chunk's first tap) the patch slot chunk ck - 1 read; every
  // thread finished both before the barrier at the top of step s. One barrier a step.
#pragma unroll 1
  for (int s = 0; s < D; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<D - 1>();  // this thread's copies of step s (and of its chunk's patch) landed
    const int ck = s / 9, tap = s - 9 * ck;
    if (relu && tap == 0) relu_halo(ck);
    __syncthreads();         // everyone's landed; everyone is done with step s - 1's slots
    if (s + D < steps) load(s + D);
    cp_async_commit();
    // tap (dh, dw) reads the patch shifted by (dh - 1, dw - 1): a window of the staged halo
    const float* const as = halo + (ck & 1) * Cf::kHalo + a_base + ((tap / 3) * Cf::kHaloW + tap % 3) * Cf::kLd;
    const float* const bs = ring + (s % S) * Cf::kB + ng * 4;
#pragma unroll
    for (int cq = 0; cq < KC / 4; ++cq) {
      float4 bv[4][2];  // 4 channels x this thread's 8 output channels
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        bv[cc][0] = ld4s(bs + (cq * 4 + cc) * BN);
        bv[cc][1] = ld4s(bs + (cq * 4 + cc) * BN + BN / 2);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = ld4s(as + i * Cf::kCols * Cf::kLd + cq * 4);  // 4 channels of pixel i
        fma8(acc[i], a.x, bv[0]);
        fma8(acc[i], a.y, bv[1]);
        fma8(acc[i], a.z, bv[2]);
        fma8(acc[i], a.w, bv[3]);
      }
    }
  }

  // epilogue from the registers: + bias, + residual in fp32, float4 stores (O % 4 == 0)
  const int h = h0 + pr;
  if (h >= H) return;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = n0 + q * (BN / 2) + ng * 4;
    if (n >= O) continue;
    const float4 bb = bias != nullptr ? __ldg(reinterpret_cast<const float4*>(bias + n)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ww = w0 + pc + Cf::kCols * i;
      if (ww >= W) continue;
      const int64_t idx = ((static_cast<int64_t>(b) * H + h) * W + ww) * O + n;
      float4 v = make_float4(acc[i][q * 4] + bb.x, acc[i][q * 4 + 1] + bb.y, acc[i][q * 4 + 2] + bb.z,
                             acc[i][q * 4 + 3] + bb.w);
      if (res != nullptr) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(res + idx));
        v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
      }
      *reinterpret_cast<float4*>(y + idx) = v;
    }
  }
}

template <int BN, int KC, int CW>
int launch_f32_tile(const float* x, const float* w, const float* bias, const float* res, float* y, int G, int B0,
                    int H, int W, int C, int O, int relu, cudaStream_t stream) {
  using Cf = f32::Cfg<BN, KC, CW>;
  static std::atomic<uint64_t> opted{0};  // per card: the >48 KB opt-in of this instantiation
  const cudaError_t attr = opt_in_smem(reinterpret_cast<const void*>(conv3x3_f32<BN, KC, CW>), Cf::kSmem, opted);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t tiles = static_cast<int64_t>(B0) * ((H + Cf::kPH - 1) / Cf::kPH) * ((W + Cf::kPW - 1) / Cf::kPW);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), (O + BN - 1) / BN, G);
  conv3x3_f32<BN, KC, CW><<<grid, f32::kThreads, Cf::kSmem, stream>>>(x, w, bias, res, y, B0, H, W, C, O, relu);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- fp32 generic path

namespace generic {
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
conv3x3_f32_generic(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
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

int launch(const float* x, const float* w, const float* bias, const float* res, float* y, int G, int B0, int H,
           int W, int C, int O, int relu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B0) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (O + kBN - 1) / kBN, G);
  conv3x3_f32_generic<<<grid, kThreads, 0, stream>>>(x, w, bias, res, y, B0, H, W, C, O, relu);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace generic

// the fp32 launch ops/conv.py::_f32_tile chose: the tiled kernel's build (bn, kc, vw: BN,
// KC, CW; bm its pixels per block), or with vw = 0 the generic kernel. A build the call's
// shape or pointers do not fit is an error, as is a build the dispatch does not list.
int launch_f32(const void* xv, const void* wv, const float* bias, const void* resv, void* yv, int G, int B0, int H,
               int W, int C, int O, int relu, int bm, int bn, int vw, int kc, cudaStream_t st) {
  const float *x = static_cast<const float*>(xv), *w = static_cast<const float*>(wv);
  const float* res = static_cast<const float*>(resv);
  float* y = static_cast<float*>(yv);
  if (vw == 0) return generic::launch(x, w, bias, res, y, G, B0, H, W, C, O, relu, st);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (O % 4 != 0 || C % (vw / 4) != 0 || !aligned(x) || !aligned(w) || !aligned(y) ||
      (bias != nullptr && !aligned(bias)) || (res != nullptr && !aligned(res)))
    return static_cast<int>(cudaErrorInvalidValue);
#define MOGE_CONV_F32(BN_, KC_, CW_)                                                    \
  if (bn == BN_ && kc == KC_ && vw == CW_ && bm == f32::Cfg<BN_, KC_, CW_>::kBM) \
    return launch_f32_tile<BN_, KC_, CW_>(x, w, bias, res, y, G, B0, H, W, C, O, relu, st);
#define MOGE_CONV_F32_WIDTHS(KC_, CW_) \
  MOGE_CONV_F32(32, KC_, CW_) MOGE_CONV_F32(64, KC_, CW_) MOGE_CONV_F32(128, KC_, CW_)
  MOGE_CONV_F32_WIDTHS(16, 16)
  MOGE_CONV_F32_WIDTHS(8, 16)
  MOGE_CONV_F32_WIDTHS(8, 8)
#undef MOGE_CONV_F32_WIDTHS
#undef MOGE_CONV_F32
  return static_cast<int>(cudaErrorInvalidValue);
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
             int H, int W, int C, int O, int relu, int dtype, int bm, int bn, int vw, int kc, void* stream) {
  if (G <= 0 || G > 65535 || B0 <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 ||
      static_cast<int64_t>(B0) * H > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_bf16(x, w, b, res, y, G, B0, H, W, C, O, relu, bm, bn, vw, st);
  if (dtype == kFloat32) return launch_f32(x, w, b, res, y, G, B0, H, W, C, O, relu, bm, bn, vw, kc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K3. x: (B, H, W, C), w: (3, 3, C, O), res/y: (B, H, W, O), all contiguous
// in the given dtype; bias: (O,) fp32 or null; res may be null; bm, bn, vw:
// the tile of bm pixels by bn channels and the patch's copy width in bytes
// (bf16: ops/conv.py::_tile_config; fp32: _f32_tile, vw = 0 the generic
// kernel); kc: the fp32 kernel's input channels per K step, ignored for bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int moge_conv3x3(const void* x, const void* w, const void* bias, const void* res,
                            void* y, int B, int H, int W, int C, int O, int relu, int dtype, int bm, int bn,
                            int vw, int kc, void* stream) {
  return dispatch(x, w, bias, res, y, 1, B, H, W, C, O, relu, dtype, bm, bn, vw, kc, stream);
}

// K3-grouped. x: (G*B0, H, W, C), w: (G, 3, 3, C, O), res/y: (G*B0, H, W, O),
// all contiguous in the given dtype; bias: (G, O) fp32 or null; res may be
// null. Batch entry b uses weight group b / B0. bm, bn, vw, kc as for moge_conv3x3.
extern "C" int moge_conv3x3_grouped(const void* x, const void* w, const void* bias, const void* res,
                                    void* y, int G, int B0, int H, int W, int C, int O, int relu,
                                    int dtype, int bm, int bn, int vw, int kc, void* stream) {
  return dispatch(x, w, bias, res, y, G, B0, H, W, C, O, relu, dtype, bm, bn, vw, kc, stream);
}
