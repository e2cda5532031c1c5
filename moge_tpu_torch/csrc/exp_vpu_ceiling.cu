// T2: the FP32-pipe ceiling of the dense-align pair op.
//
// Replaces tools/exp_vpu_ceiling.py::main -> make(kind) -> kernel, the TPU
// probe of the VPU's rate on a VMEM-resident tile. For each element e of a
// (256, 512) fp32 tile and i = 0 .. iters-1, with a = 1 + i * 1e-6 in fp32
// (two roundings, as JAX computes it):
//   align: acc_e += min(1, |a * x_e - y_e|)
//   fma:   acc_e += a * x_e + y_e
// and out_e = acc_e. No device-memory traffic inside the loop.
//
// What bounds it on an H100: the FP32 pipes. align is 3 instructions per
// element-iteration (FFMA, FMNMX with |.| on an operand, FADD), fma 2 (FFMA,
// FADD); the card runs 132 SMs x 128 lanes of them per clock, so 2.62e8
// element-iterations take ~23 us (align) and ~16 us (fma) at 1.98 GHz. The
// 1.5 MB of x, y and out are noise next to that.
// Design: each thread owns kElems elements in registers (independent chains,
// so one warp per scheduler hides the FP32 latency); the iters values of a
// are computed once per block into shared memory and read back four at a
// time as one broadcast, so the loop body is the pair op and nothing else.
// 256 x 512 elements at kElems = 4 are 256 blocks of 128 threads: about two
// blocks (8 warps) per SM.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kElems = 4;       // elements per thread, strided by the block size
constexpr int kMaxIters = 8192; // a values in shared memory (32 KB)

template <bool kAlign>
__global__ void __launch_bounds__(kThreads)
vpu_ceiling_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
                   int n, int iters) {
  __shared__ __align__(16) float as[kMaxIters];
  for (int i = threadIdx.x; i < iters; i += kThreads)
    as[i] = __fadd_rn(1.f, __fmul_rn(static_cast<float>(i), 1e-6f));  // no contraction: JAX's two roundings
  __syncthreads();

  const int e0 = blockIdx.x * kThreads * kElems + threadIdx.x;
  float xv[kElems], yv[kElems], acc[kElems];
#pragma unroll
  for (int c = 0; c < kElems; ++c) {
    const int e = e0 + c * kThreads;
    xv[c] = e < n ? x[e] : 0.f;
    yv[c] = e < n ? y[e] : 0.f;
    acc[c] = 0.f;
  }

  int i = 0;
  for (; i + 4 <= iters; i += 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(as + i);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < kElems; ++c) {
        if (kAlign) acc[c] += fminf(1.f, fabsf(fmaf(a[u], xv[c], -yv[c])));
        else acc[c] += fmaf(a[u], xv[c], yv[c]);
      }
    }
  }
  for (; i < iters; ++i) {
    const float a = as[i];
#pragma unroll
    for (int c = 0; c < kElems; ++c) {
      if (kAlign) acc[c] += fminf(1.f, fabsf(fmaf(a, xv[c], -yv[c])));
      else acc[c] += fmaf(a, xv[c], yv[c]);
    }
  }

#pragma unroll
  for (int c = 0; c < kElems; ++c) {
    const int e = e0 + c * kThreads;
    if (e < n) out[e] = acc[c];
  }
}

}  // namespace

// x, y, out: n fp32 elements, contiguous; kind 0 = align, 1 = fma; `launches`
// back-to-back launches of the same kernel on `stream` (for timing a ~20 us
// kernel without the host in the way). Returns cudaGetLastError() after the
// launches.
extern "C" int moge_vpu_ceiling(const void* x, const void* y, void* out, int n, int iters, int kind,
                                int launches, void* stream) {
  if (n <= 0 || iters < 0 || iters > kMaxIters || launches <= 0 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *xp = static_cast<const float*>(x), *yp = static_cast<const float*>(y);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kThreads * kElems - 1) / (kThreads * kElems));
  for (int l = 0; l < launches; ++l) {
    if (kind == 0) vpu_ceiling_kernel<true><<<blocks, kThreads, 0, st>>>(xp, yp, op, n, iters);
    else vpu_ceiling_kernel<false><<<blocks, kThreads, 0, st>>>(xp, yp, op, n, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
