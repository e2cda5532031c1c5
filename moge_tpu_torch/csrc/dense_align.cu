// K4: dense truncated-L1 alignment objective.
//
// Replaces moge_tpu/ops/alignment.py::_dense_objective_pallas (its inner
// `kernel`), reached through _align_trunc_dense. For each row r of R
// independent problems and each candidate j of its L candidates:
//   F[r, j] = sum_i min(t[r, i], |A[r, j] * wx[r, i] - wy[r, i]|)
// in fp32; t is one scalar or an (R, L) array (per-term truncation). The
// caller takes the argmin over j.
//
// What bounds it on an H100: R * L^2 candidate-term pairs at 3 fp32
// instructions each (fma, min with |.|, add) against O(R * L) bytes, so the
// FP32 pipes (~33 T instructions/s on 132 SMs), never device memory. Design:
// one block of 128 threads per (row, tile of 128 * CPT candidates); each
// thread keeps CPT candidates and their sums in registers. The row's term
// arrays pass through shared memory in chunks of 1024 terms, each (wx, wy)
// pair read as one 8-byte broadcast and reused for all CPT candidates, so
// shared-memory traffic is a fraction of the FP32 work. CPT follows L (1 at
// L <= 128, 4 at L <= 512, else 8) so a block wastes few threads on the short
// rows of the local losses. Each candidate's terms are summed in index order
// by one thread: deterministic, no atomics.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // terms staged in shared memory per pass

template <int CPT, bool kTermT>
__global__ void __launch_bounds__(kThreads)
dense_objective_kernel(const float* __restrict__ A, const float* __restrict__ wx,
                       const float* __restrict__ wy, const float* __restrict__ t, float t_scalar,
                       float* __restrict__ F, int L, int n_ctiles) {
  __shared__ float2 xy[kChunk];
  __shared__ float ts[kTermT ? kChunk : 1];
  const int64_t row = blockIdx.x / n_ctiles;
  const int j0 = (blockIdx.x % n_ctiles) * kThreads * CPT + threadIdx.x;
  const int64_t base = row * L;

  float a[CPT], acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c * kThreads;
    a[c] = j < L ? A[base + j] : 0.f;
    acc[c] = 0.f;
  }

  for (int i0 = 0; i0 < L; i0 += kChunk) {
    const int n = min(kChunk, L - i0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < n; i += kThreads) {
      xy[i] = make_float2(wx[base + i0 + i], wy[base + i0 + i]);
      if (kTermT) ts[i] = t[base + i0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float2 v = xy[i];
      const float tt = kTermT ? ts[i] : t_scalar;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += fminf(tt, fabsf(fmaf(a[c], v.x, -v.y)));
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c * kThreads;
    if (j < L) F[base + j] = acc[c];
  }
}

template <int CPT>
int launch(const float* A, const float* wx, const float* wy, const float* t, float t_scalar, float* F,
           int R, int L, cudaStream_t stream) {
  const int n_ctiles = (L + kThreads * CPT - 1) / (kThreads * CPT);
  const int64_t blocks = static_cast<int64_t>(R) * n_ctiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (t != nullptr)
    dense_objective_kernel<CPT, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        A, wx, wy, t, t_scalar, F, L, n_ctiles);
  else
    dense_objective_kernel<CPT, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        A, wx, wy, t, t_scalar, F, L, n_ctiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, wx, wy, F: (R, L) fp32 contiguous; t: (R, L) fp32 contiguous, or null
// for the scalar t_scalar. Returns cudaGetLastError() after the launch.
extern "C" int moge_dense_objective(const void* A, const void* wx, const void* wy, const void* t,
                                    float t_scalar, void* F, int R, int L, void* stream) {
  if (R <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float *a = static_cast<const float*>(A), *x = static_cast<const float*>(wx),
              *y = static_cast<const float*>(wy), *tt = static_cast<const float*>(t);
  float* f = static_cast<float*>(F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 128) return launch<1>(a, x, y, tt, t_scalar, f, R, L, st);
  if (L <= 512) return launch<4>(a, x, y, tt, t_scalar, f, R, L, st);
  return launch<8>(a, x, y, tt, t_scalar, f, R, L, st);
}
