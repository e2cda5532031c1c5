// T3-T6: four layouts of the dense truncated-L1 objective (K4's function).
//
// Replaces the Pallas probes of tools/exp_dense_pallas.py:
//   T3 pallas_dense_objective        -> dense_v1        (term-reduce)
//   T4 pallas_dense_objective_unroll -> dense_v1_unroll (term loop unrolled)
//   T5 pallas_dense_objective_v2     -> dense_v2        (candidate-major)
//   T6 pallas_dense_objective_bf16   -> dense_bf16      (bf16 pair math)
// each computing, for R rows of L candidates and L terms,
//   F[r, j] = sum_i min(t, |A[r, j] * wx[r, i] - wy[r, i]|)
// with one scalar t. The TPU probes asked which axis the vector unit should
// reduce over; here the question is which thread owns the reduction axis and
// what bf16x2 packed math buys. Ragged rows and candidates are handled by
// bounds: no padding, no junk candidates.
//
// What bounds them on an H100: R * L^2 pairs of 3 FP32 instructions (FFMA,
// FMNMX with |.|, FADD) against O(R * L) bytes: the FP32 pipes, 132 SMs x 128
// lanes per clock (~2.6 ms at the global loss's 606 x 6912). T6 rounds the
// product and the difference (no fused multiply-add, as the TPU body), takes
// min(t, |d|) in bf16 and sums in fp32. Its SASS runs, per two pairs,
// HMUL2, HADD2 (the rounded difference), LOP3 (|.|) and HMNMX2, and the sums
// run on the tensor cores (one HMMA per 256 pairs): 2 instructions per pair
// at the dispatch rate of 128 per SM per clock (~1.7 ms at the global shape).
//
// Layouts (blocks stage the row's terms in shared memory in chunks):
// - v1: 8 warps per block, each owning CPW candidates of one row; the 32
//   lanes split the terms (lane-strided), each lane keeps CPW partial sums,
//   and a shuffle reduction per candidate ends it. One (wx, wy) read from
//   shared memory serves CPW candidates.
// - v1_unroll: v1 with the per-chunk term loop fully unrolled (a full chunk
//   has a compile-time trip count; the ragged last chunk takes a plain loop).
// - v2: K4's layout with RB rows per block: 128/RB threads per row, each
//   thread owns CPT candidates in registers and sums its terms serially in
//   index order; a (wx, wy) broadcast from shared memory serves CPT
//   candidates. Deterministic, no shuffles.
// - bf16: candidate-major, over bf16x2 term pairs, the sums on the tensor
//   cores. Each warp owns 16 * MT consecutive candidates of one row (MT
//   m16 tiles), each lane two per tile as duplicated bf16x2 (a, a), so a
//   row takes 9-36 blocks at the probe shapes and its terms are staged and
//   converted once per block, as interleaved (x pair, y pair) words: per 16
//   terms a lane reads two 8-byte words (terms 2q, 2q + 1 and 2q + 8,
//   2q + 9, q = lane % 4) and forms its A fragment of every tile, and
//   mma.m16n8k16 sums the 16 terms of 16 candidates against a B of ones in
//   fp32. A partial of kFlushPairs pairs starts at 0 and then joins an fp32
//   total in a register (the tensor cores' fp32 adds need not round to
//   nearest: a short partial keeps their error small against the total).
//   Deterministic, no shuffles; RB rows per block for
//   short rows; a warp whose candidates all lie past the row's end only
//   stages.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;           // v1 warps per block
constexpr int kChunk = 2048;        // v1 terms staged per pass (16 KB of float2)
constexpr int kChunkV2 = 1024;      // v2 terms per row per pass
constexpr int kThreadsV2 = 128;
constexpr int kThreadsBf16 = 128;
constexpr int kPairsBf16 = 2048;    // bf16 term pairs staged per pass, split over the block's rows (16 KB)
constexpr int kFlushPairs = 256;    // bf16 term pairs summed into a partial before it joins the total

template <int CPW, bool kUnroll>
__global__ void __launch_bounds__(kWarps * 32)
dense_v1_kernel(const float* __restrict__ A, const float* __restrict__ wx, const float* __restrict__ wy,
                float t, float* __restrict__ F, int L, int n_ctiles) {
  __shared__ float2 xy[kChunk];
  const int64_t row = blockIdx.x / n_ctiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = (blockIdx.x % n_ctiles) * kWarps * CPW + warp * CPW;
  const int64_t base = row * L;

  float a[CPW], acc[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    a[c] = j0 + c < L ? A[base + j0 + c] : 0.f;
    acc[c] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += kChunk) {
    const int n = min(kChunk, L - i0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kWarps * 32) xy[i] = make_float2(wx[base + i0 + i], wy[base + i0 + i]);
    __syncthreads();
    if (kUnroll && n == kChunk) {
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const float2 v = xy[k * 32 + lane];
#pragma unroll
        for (int c = 0; c < CPW; ++c) acc[c] += fminf(t, fabsf(fmaf(a[c], v.x, -v.y)));
      }
    } else {
#pragma unroll 1
      for (int i = lane; i < n; i += 32) {
        const float2 v = xy[i];
#pragma unroll
        for (int c = 0; c < CPW; ++c) acc[c] += fminf(t, fabsf(fmaf(a[c], v.x, -v.y)));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == 0 && j0 + c < L) F[base + j0 + c] = s;
  }
}

template <int RB, int CPT>
__global__ void __launch_bounds__(kThreadsV2)
dense_v2_kernel(const float* __restrict__ A, const float* __restrict__ wx, const float* __restrict__ wy,
                float t, float* __restrict__ F, int R, int L, int n_ctiles) {
  constexpr int kTpr = kThreadsV2 / RB;  // threads per row
  __shared__ float2 xy[RB][kChunkV2];
  const int rl = threadIdx.x / kTpr, tid = threadIdx.x % kTpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x / n_ctiles) * RB + rl;
  const bool row_ok = row < R;
  const int j0 = (blockIdx.x % n_ctiles) * kTpr * CPT + tid;
  const int64_t base = row * L;

  float a[CPT], acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c * kTpr;
    a[c] = row_ok && j < L ? A[base + j] : 0.f;
    acc[c] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += kChunkV2) {
    const int n = min(kChunkV2, L - i0);
    __syncthreads();
    if (row_ok)
      for (int i = tid; i < n; i += kTpr) xy[rl][i] = make_float2(wx[base + i0 + i], wy[base + i0 + i]);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float2 v = xy[rl][i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += fminf(t, fabsf(fmaf(a[c], v.x, -v.y)));
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c * kTpr;
    if (row_ok && j < L) F[base + j] = acc[c];
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }
__device__ __forceinline__ __nv_bfloat162 bf16x2_of(uint32_t w) { return *reinterpret_cast<__nv_bfloat162*>(&w); }

// min(t, |d|) of both halves: |d| by clearing the sign bits (one LOP3 on the integer pipe; __habs2 is
// an HFMA2 on the half-precision pipe, which sets the kernel's pace)
__device__ __forceinline__ uint32_t trunc_abs(__nv_bfloat162 d, __nv_bfloat162 t2) {
  return bf16x2_bits(__hmin2(t2, bf16x2_of(bf16x2_bits(d) & 0x7fff7fffu)));
}

// bf16 (see the note above): lane (g, q) = (lane / 4, lane % 4) holds
// candidates g and g + 8 of each m16 tile; its A fragment is their terms
// 2q, 2q + 1 (registers 0, 1) and 2q + 8, 2q + 9 (registers 2, 3); all 8
// columns of the product hold the same sum.
template <int RB, int MT>
__global__ void __launch_bounds__(kThreadsBf16)
dense_bf16_kernel(const float* __restrict__ A, const float* __restrict__ wx, const float* __restrict__ wy,
                  float t, float* __restrict__ F, int R, int L, int n_ctiles) {
  constexpr int kTpr = kThreadsBf16 / RB;
  constexpr int kPairs = kPairsBf16 / RB;
  __shared__ uint2 xy[RB][kPairs];
  const int rl = threadIdx.x / kTpr, tid = threadIdx.x % kTpr;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int64_t row = static_cast<int64_t>(blockIdx.x / n_ctiles) * RB + rl;
  const bool row_ok = row < R;
  const int jw = (blockIdx.x % n_ctiles) * kTpr / 32 * 16 * MT + tid / 32 * 16 * MT;  // the warp's first candidate
  const bool active = row_ok && jw < L;  // warp-uniform
  const int64_t base = row * L;
  const __nv_bfloat162 t2 = __bfloat162bfloat162(__float2bfloat16(t));
  const uint32_t ones = 0x3f803f80u;  // (1, 1) in bf16

  __nv_bfloat162 a[MT][2];
  float tot[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = jw + 16 * m + g + 8 * h;
      a[m][h] = __bfloat162bfloat162(__float2bfloat16(active && j < L ? A[base + j] : 0.f));
      tot[m][h] = 0.f;
    }
  for (int i0 = 0; i0 < L; i0 += 2 * kPairs) {
    const int n = min(2 * kPairs, L - i0), np = (n + 1) / 2, np8 = (np + 7) / 8 * 8;
    __syncthreads();
    if (row_ok)
      for (int p = tid; p < np8; p += kTpr) {  // missing terms are (0, 0): each adds min(t, 0) = 0
        const int64_t i = base + i0 + 2 * p;
        const bool one = 2 * p < n, two = 2 * p + 1 < n;
        xy[rl][p] = make_uint2(bf16x2_bits(__floats2bfloat162_rn(one ? wx[i] : 0.f, two ? wx[i + 1] : 0.f)),
                               bf16x2_bits(__floats2bfloat162_rn(one ? wy[i] : 0.f, two ? wy[i + 1] : 0.f)));
      }
    __syncthreads();
    if (!active) continue;
    for (int p0 = 0; p0 < np8; p0 += kFlushPairs) {
      const int p1 = min(np8, p0 + kFlushPairs);
      float c[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0.f;
#pragma unroll 2
      for (int p = p0; p < p1; p += 8) {
        const uint2 lo = xy[rl][p + q], hi = xy[rl][p + q + 4];
        const __nv_bfloat162 xl = bf16x2_of(lo.x), yl = bf16x2_of(lo.y), xh = bf16x2_of(hi.x), yh = bf16x2_of(hi.y);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t r0 = trunc_abs(__hsub2_rn(__hmul2_rn(a[m][0], xl), yl), t2);
          const uint32_t r1 = trunc_abs(__hsub2_rn(__hmul2_rn(a[m][1], xl), yl), t2);
          const uint32_t r2 = trunc_abs(__hsub2_rn(__hmul2_rn(a[m][0], xh), yh), t2);
          const uint32_t r3 = trunc_abs(__hsub2_rn(__hmul2_rn(a[m][1], xh), yh), t2);
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(c[m][0]), "+f"(c[m][1]), "+f"(c[m][2]), "+f"(c[m][3])
              : "r"(r0), "r"(r1), "r"(r2), "r"(r3), "r"(ones), "r"(ones));
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        tot[m][0] += c[m][0];
        tot[m][1] += c[m][2];
      }
    }
  }
  if (active && q == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jw + 16 * m + g + 8 * h;
        if (j < L) F[base + j] = tot[m][h];
      }
  }
}

int grid_check(int64_t blocks) {
  return blocks > 0x7fffffff ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <int CPW, bool kUnroll>
int launch_v1(const float* A, const float* wx, const float* wy, float t, float* F, int R, int L, cudaStream_t st) {
  const int n_ctiles = (L + kWarps * CPW - 1) / (kWarps * CPW);
  const int64_t blocks = static_cast<int64_t>(R) * n_ctiles;
  if (int e = grid_check(blocks)) return e;
  dense_v1_kernel<CPW, kUnroll><<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(A, wx, wy, t, F, L, n_ctiles);
  return static_cast<int>(cudaGetLastError());
}

template <int RB, int CPT>
int launch_v2(const float* A, const float* wx, const float* wy, float t, float* F, int R, int L, cudaStream_t st) {
  const int n_ctiles = (L + kThreadsV2 / RB * CPT - 1) / (kThreadsV2 / RB * CPT);
  const int64_t blocks = static_cast<int64_t>((R + RB - 1) / RB) * n_ctiles;
  if (int e = grid_check(blocks)) return e;
  dense_v2_kernel<RB, CPT><<<static_cast<unsigned>(blocks), kThreadsV2, 0, st>>>(A, wx, wy, t, F, R, L, n_ctiles);
  return static_cast<int>(cudaGetLastError());
}

template <int RB, int MT>
int launch_bf16(const float* A, const float* wx, const float* wy, float t, float* F, int R, int L, cudaStream_t st) {
  constexpr int kTile = kThreadsBf16 / RB / 32 * 16 * MT;
  const int n_ctiles = (L + kTile - 1) / kTile;
  const int64_t blocks = static_cast<int64_t>((R + RB - 1) / RB) * n_ctiles;
  if (int e = grid_check(blocks)) return e;
  dense_bf16_kernel<RB, MT><<<static_cast<unsigned>(blocks), kThreadsBf16, 0, st>>>(A, wx, wy, t, F, R, L, n_ctiles);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tiles the library is built with, as 100 * rows per block + m16 tiles per warp
// (tools/exp_dense_pallas.py::VARIANTS["bf16"] lists the same)
#define MOGE_BF16_CASE(RB, MT) \
  case 100 * (RB) + (MT): return launch_bf16<RB, MT>(A, wx, wy, t, F, R, L, st);

int dispatch_bf16(int tile, const float* A, const float* wx, const float* wy, float t, float* F, int R, int L,
                  cudaStream_t st) {
  switch (tile) {
    MOGE_BF16_CASE(1, 3)
    MOGE_BF16_CASE(1, 4)
    MOGE_BF16_CASE(1, 6)
    MOGE_BF16_CASE(2, 3)
    MOGE_BF16_CASE(4, 3)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// A, wx, wy, F: (R, L) fp32 contiguous; t: the scalar truncation.
// variant: 0 = v1, 1 = v1_unroll, 2 = v2, 3 = bf16. tile: the compile-time
// tile of the variant (v1, v1_unroll: candidates per warp 2/4/8; v2: rows
// per block x candidates per thread as 10 * RB + CPT, one of 18, 24, 44, 42;
// bf16: as 100 * RB + MT, MOGE_BF16_CASE). Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue
// for a tile the library was not built with.
extern "C" int moge_exp_dense(const void* A, const void* wx, const void* wy, float t, void* F, int R, int L,
                              int variant, int tile, void* stream) {
  if (R <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float *a = static_cast<const float*>(A), *x = static_cast<const float*>(wx),
              *y = static_cast<const float*>(wy);
  float* f = static_cast<float*>(F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 3) return dispatch_bf16(tile, a, x, y, t, f, R, L, st);
  switch (variant * 100 + tile) {
    case 2: return launch_v1<2, false>(a, x, y, t, f, R, L, st);
    case 4: return launch_v1<4, false>(a, x, y, t, f, R, L, st);
    case 8: return launch_v1<8, false>(a, x, y, t, f, R, L, st);
    case 104: return launch_v1<4, true>(a, x, y, t, f, R, L, st);
    case 108: return launch_v1<8, true>(a, x, y, t, f, R, L, st);
    case 218: return launch_v2<1, 8>(a, x, y, t, f, R, L, st);
    case 224: return launch_v2<2, 4>(a, x, y, t, f, R, L, st);
    case 244: return launch_v2<4, 4>(a, x, y, t, f, R, L, st);
    case 242: return launch_v2<4, 2>(a, x, y, t, f, R, L, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
