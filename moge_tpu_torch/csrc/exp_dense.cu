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
// product and the difference (no fused multiply-add, as the TPU body) and
// sums in fp32: per two pairs HMUL2, HSUB2 and HMNMX2 with |.| (packed), then
// two unpacks of a bf16 half to fp32 and two FADDs, 3.5 instructions per
// pair against fp32's 3, so bf16x2 cannot beat the fp32 layouts while
// the sum stays fp32.
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
// - bf16: v1 over bf16x2 term pairs, fp32 partial sums.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;           // v1 / bf16 warps per block
constexpr int kChunk = 2048;        // v1 terms staged per pass (16 KB of float2)
constexpr int kChunkV2 = 1024;      // v2 terms per row per pass
constexpr int kThreadsV2 = 128;

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

template <int CPW>
__global__ void __launch_bounds__(kWarps * 32)
dense_bf16_kernel(const float* __restrict__ A, const float* __restrict__ wx, const float* __restrict__ wy,
                  float t, float* __restrict__ F, int L, int n_ctiles) {
  constexpr int kPairs = kChunk / 2;
  __shared__ __nv_bfloat162 xs[kPairs], ys[kPairs];
  const int64_t row = blockIdx.x / n_ctiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = (blockIdx.x % n_ctiles) * kWarps * CPW + warp * CPW;
  const int64_t base = row * L;
  const __nv_bfloat162 t2 = __bfloat162bfloat162(__float2bfloat16(t));

  __nv_bfloat162 a[CPW];
  float acc[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    a[c] = __bfloat162bfloat162(__float2bfloat16(j0 + c < L ? A[base + j0 + c] : 0.f));
    acc[c] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += kChunk) {
    const int n = min(kChunk, L - i0), np = (n + 1) / 2;
    __syncthreads();
    for (int p = threadIdx.x; p < np; p += kWarps * 32) {  // a missing odd term is (0, 0): adds min(t, 0) = 0
      const int i = i0 + 2 * p;
      const bool two = 2 * p + 1 < n;
      xs[p] = __floats2bfloat162_rn(wx[base + i], two ? wx[base + i + 1] : 0.f);
      ys[p] = __floats2bfloat162_rn(wy[base + i], two ? wy[base + i + 1] : 0.f);
    }
    __syncthreads();
#pragma unroll 1
    for (int p = lane; p < np; p += 32) {
      const __nv_bfloat162 x2 = xs[p], y2 = ys[p];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        // bf16 rounding after the product and after the difference, as the TPU body: the _rn
        // forms keep the compiler from contracting the two into one fma.bf16x2
        const __nv_bfloat162 d = __hmin2(t2, __habs2(__hsub2_rn(__hmul2_rn(a[c], x2), y2)));
        const float2 f = __bfloat1622float2(d);
        acc[c] += f.x;
        acc[c] += f.y;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == 0 && j0 + c < L) F[base + j0 + c] = s;
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

template <int CPW>
int launch_bf16(const float* A, const float* wx, const float* wy, float t, float* F, int R, int L, cudaStream_t st) {
  const int n_ctiles = (L + kWarps * CPW - 1) / (kWarps * CPW);
  const int64_t blocks = static_cast<int64_t>(R) * n_ctiles;
  if (int e = grid_check(blocks)) return e;
  dense_bf16_kernel<CPW><<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(A, wx, wy, t, F, L, n_ctiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, wx, wy, F: (R, L) fp32 contiguous; t: the scalar truncation.
// variant: 0 = v1, 1 = v1_unroll, 2 = v2, 3 = bf16. tile: the compile-time
// tile of the variant (v1, v1_unroll, bf16: candidates per warp 2/4/8; v2:
// rows per block x candidates per thread as 10 * RB + CPT, one of 18, 24, 44,
// 42). Returns cudaGetLastError() after the launch, cudaErrorInvalidValue
// for a tile the library was not built with.
extern "C" int moge_exp_dense(const void* A, const void* wx, const void* wy, float t, void* F, int R, int L,
                              int variant, int tile, void* stream) {
  if (R <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float *a = static_cast<const float*>(A), *x = static_cast<const float*>(wx),
              *y = static_cast<const float*>(wy);
  float* f = static_cast<float*>(F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
    case 304: return launch_bf16<4>(a, x, y, t, f, R, L, st);
    case 308: return launch_bf16<8>(a, x, y, t, f, R, L, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
