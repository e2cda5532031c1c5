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
// Design: a warp per row, the row held in registers for both passes and the
// write, so the row costs one read and one write of device memory.
// - vec16: 16-byte loads and stores (8 bf16 or 4 fp32 values per lane per
//   access; at D = 1024 bf16, 4 of each per lane per row), the accesses
//   lane-strided so each one of a warp is one coalesced 512-byte span.
//   Taken where D is a multiple of the vector width and every pointer is
//   16-byte aligned (ops/norm.py::ln_plan).
// - scalar: one element per lane per access, for the rest (a contiguous view
//   with a storage offset, an odd D).
// Each warp walks several rows (stride: all the grid's warps), and starts
// the next row's loads before the current row's reductions and stores (a
// register double buffer), so its loads stay in flight while it computes.
// The grid is sized from the SM count by ln_plan. Scale and bias are staged
// once per block in shared memory and read as float4 beside the row (held
// in registers instead, 64 more a lane at D = 1024, they spilled and were
// slower at M = 3601 and 28808).
// Any D up to 2048 and any M; the tail of a row is masked.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block (ops/norm.py::WARPS)
constexpr int kMinBlocks = 4;  // blocks an SM holds at D <= 32 values per lane (ops/norm.py::BLOCKS_PER_SM)

enum LnVariant : int { kVec16 = 0, kScalar = 1 };

// 16 bytes of a row (vec16) or one element (scalar): what one lane moves per access
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

__device__ __forceinline__ void unpack(uint4 r, float* v, const __nv_bfloat16*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of an fp32
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 r, float* v, const float*) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
template <typename T>
__device__ __forceinline__ void unpack(T r, float* v, const T*) { v[0] = to_f(r); }

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even, each half
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void pack(const float* v, uint4* r, __nv_bfloat16*) {
  *r = make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]), bf16x2_bits(v[4], v[5]),
                  bf16x2_bits(v[6], v[7]));
}
__device__ __forceinline__ void pack(const float* v, uint4* r, float*) {
  *r = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <typename T>
__device__ __forceinline__ void pack(const float* v, T* r, T*) { *r = from_f<T>(v[0]); }

// VEC consecutive floats of shared memory, as float4 where VEC allows
template <int VEC>
__device__ __forceinline__ void load_affine(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      out[k] = f.x, out[k + 1] = f.y, out[k + 2] = f.z, out[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = p[k];
  }
}

// NV accesses of VEC elements per lane per row: access i of lane l covers
// elements [(i * 32 + l) * VEC, +VEC)
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32, NV * VEC <= 32 ? kMinBlocks : 1)
ln_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
          T* __restrict__ y, int64_t M, int D, float eps) {
  using R = Raw<T, VEC>;
  extern __shared__ float4 smem4[];
  float* s_scale = reinterpret_cast<float*>(smem4);
  float* s_bias = s_scale + D;
  for (int c = threadIdx.x; c < D; c += kWarps * 32) {
    s_scale[c] = scale[c];
    s_bias[c] = bias[c];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);

  R cur[NV];
  auto load_row = [&](int64_t r, R* dst) {
    const R* src = reinterpret_cast<const R*>(x + r * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int a = i * 32 + lane;
      if (a * VEC < D) dst[i] = src[a];
    }
  };
  if (row < M) load_row(row, cur);
  for (; row < M; row += stride) {
    R nxt[NV];
    if (row + stride < M) load_row(row + stride, nxt);  // in flight while this row is reduced and stored

    float v[NV][VEC];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const bool ok = (i * 32 + lane) * VEC < D;
      unpack(cur[i], v[i], static_cast<const T*>(nullptr));
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[i][k] = ok ? v[i][k] : 0.f;
        sum += v[i][k];
      }
    }
    const float mean = warp_sum(sum) / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * 32 + lane) * VEC < D) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float d = v[i][k] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
    R* dst = reinterpret_cast<R*>(y + row * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int a = i * 32 + lane;
      if (a * VEC < D) {
        float s[VEC], b[VEC], out[VEC];
        load_affine<VEC>(s_scale + a * VEC, s);
        load_affine<VEC>(s_bias + a * VEC, b);
#pragma unroll
        for (int k = 0; k < VEC; ++k) out[k] = (v[i][k] - mean) * rstd * s[k] + b[k];
        R r;
        pack(out, &r, static_cast<T*>(nullptr));
        dst[a] = r;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

template <int DTYPE>
using Elem = typename std::conditional<DTYPE == kBFloat16, __nv_bfloat16, float>::type;

template <typename T, int VEC, int NV>
int launch(const void* x, const float* scale, const float* bias, void* y, int64_t M, int D, float eps, int blocks,
           cudaStream_t stream) {
  if (D > NV * 32 * VEC) return static_cast<int>(cudaErrorInvalidValue);
  ln_kernel<T, VEC, NV><<<blocks, kWarps * 32, 2 * D * sizeof(float), stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instantiations, by (variant, dtype, accesses per lane per row): every
// D up to 2048 has one in each variant (ops/norm.py::VECTORS lists the same).
#define MOGE_LN_CASE(VARIANT, DTYPE, NV)                                                              \
  case (VARIANT) * 1000 + (DTYPE) * 100 + (NV):                                                       \
    return launch<Elem<DTYPE>, (VARIANT) == kVec16 ? 16 / static_cast<int>(sizeof(Elem<DTYPE>)) : 1, NV>( \
        x, s, b, y, M, D, eps, blocks, st);

// x, y: (M, D) contiguous, dtype as given; scale, bias: (D,) fp32. variant:
// 0 = vec16 (every pointer 16-byte aligned, D a multiple of 16 bytes), 1 =
// scalar; nv: accesses per lane per row; blocks: the grid (each warp walks
// rows with a stride of all the grid's warps). Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a case the
// library was not built with.
extern "C" int moge_layer_norm(const void* x, const void* scale, const void* bias, void* y, int64_t M, int D,
                               float eps, int dtype, int variant, int nv, int blocks, void* stream) {
  if (M <= 0 || D <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant * 1000 + dtype * 100 + nv) {
    MOGE_LN_CASE(kVec16, kBFloat16, 1)
    MOGE_LN_CASE(kVec16, kBFloat16, 2)
    MOGE_LN_CASE(kVec16, kBFloat16, 3)
    MOGE_LN_CASE(kVec16, kBFloat16, 4)
    MOGE_LN_CASE(kVec16, kBFloat16, 6)
    MOGE_LN_CASE(kVec16, kBFloat16, 8)
    MOGE_LN_CASE(kVec16, kFloat32, 1)
    MOGE_LN_CASE(kVec16, kFloat32, 2)
    MOGE_LN_CASE(kVec16, kFloat32, 3)
    MOGE_LN_CASE(kVec16, kFloat32, 4)
    MOGE_LN_CASE(kVec16, kFloat32, 6)
    MOGE_LN_CASE(kVec16, kFloat32, 8)
    MOGE_LN_CASE(kVec16, kFloat32, 12)
    MOGE_LN_CASE(kVec16, kFloat32, 16)
    MOGE_LN_CASE(kScalar, kBFloat16, 2)
    MOGE_LN_CASE(kScalar, kBFloat16, 4)
    MOGE_LN_CASE(kScalar, kBFloat16, 8)
    MOGE_LN_CASE(kScalar, kBFloat16, 16)
    MOGE_LN_CASE(kScalar, kBFloat16, 24)
    MOGE_LN_CASE(kScalar, kBFloat16, 32)
    MOGE_LN_CASE(kScalar, kBFloat16, 48)
    MOGE_LN_CASE(kScalar, kBFloat16, 64)
    MOGE_LN_CASE(kScalar, kFloat32, 2)
    MOGE_LN_CASE(kScalar, kFloat32, 4)
    MOGE_LN_CASE(kScalar, kFloat32, 8)
    MOGE_LN_CASE(kScalar, kFloat32, 16)
    MOGE_LN_CASE(kScalar, kFloat32, 24)
    MOGE_LN_CASE(kScalar, kFloat32, 32)
    MOGE_LN_CASE(kScalar, kFloat32, 48)
    MOGE_LN_CASE(kScalar, kFloat32, 64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
