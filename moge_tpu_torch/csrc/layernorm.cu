// K1: LayerNorm over the last axis with fp32 statistics.
//
// Replaces moge_tpu/ops/norm.py::_ln_kernel (reached through
// layer_norm_fp32). Computes, per row of an (M, D) slab:
//   mean = sum(x) / D;  var = sum((x - mean)^2) / D   (two passes, fp32)
//   y = (x - mean) * rsqrt(var + eps) * scale + bias  (fp32 affine)
// with one rounding to the input dtype, as _ln_xla does.
//
// What bounds it on an H100: bytes. It reads the slab once and writes it
// once (2 * M * D * sizeof(T)) and does ~8 flops per element, far below the
// card's ~295 flop/byte balance point.
// Design: one warp per row, the row held in registers (VPT values per lane,
// lane-strided so each warp load is one coalesced span), so the two passes
// over the row and the write cost no extra device-memory traffic. Any D up
// to 2048 and any M; tails are masked.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
ln_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
          T* __restrict__ y, int64_t M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + row * D;
  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * 32 + lane;
    v[i] = c < D ? to_f(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * 32 + lane;
    if (c < D) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
  T* yr = y + row * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * 32 + lane;
    if (c < D) yr[c] = from_f<T>((v[i] - mean) * rstd * scale[c] + bias[c]);
  }
}

template <typename T, int VPT>
void launch(const void* x, const float* scale, const float* bias, void* y, int64_t M, int D,
            float eps, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((M + kWarps - 1) / kWarps);
  ln_kernel<T, VPT><<<grid, kWarps * 32, 0, stream>>>(static_cast<const T*>(x), scale, bias,
                                                     static_cast<T*>(y), M, D, eps);
}

template <typename T>
int dispatch(const void* x, const float* scale, const float* bias, void* y, int64_t M, int D,
             float eps, cudaStream_t s) {
  const int need = (D + 31) / 32;
  if (need <= 2) launch<T, 2>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 4) launch<T, 4>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 8) launch<T, 8>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 16) launch<T, 16>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 24) launch<T, 24>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 32) launch<T, 32>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 48) launch<T, 48>(x, scale, bias, y, M, D, eps, s);
  else if (need <= 64) launch<T, 64>(x, scale, bias, y, M, D, eps, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (M, D) contiguous, dtype as given; scale, bias: (D,) fp32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int moge_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                               int64_t M, int D, float eps, int dtype, void* stream) {
  if (M <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(x, s, b, y, M, D, eps, st);
  if (dtype == kFloat32) return dispatch<float>(x, s, b, y, M, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
