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
//
// What bounds it on an H100: at the decoder shapes (C, O = 64..256 at
// 74^2..296^2 pixels) it does 18*C flops per output element against about
// 2 bytes per input and output element, well above the card's flop/byte
// balance point: it is bound by the matrix units and by how fast this simple
// loop feeds them.
// Design: an implicit GEMM with M = B*H*W pixels, N = O, K = 9*C. A block
// of 4 warps computes a 64-pixel x 64-channel output tile, walking K as
// (tap, 32-channel chunk) and staging the input patch and the weight slice
// in shared memory. The replicate padding is the clamped row and column
// index of each load (no padded copy); the input ReLU is applied on load
// (exact: ReLU commutes with replicate padding). Tails of M, C and O are
// masked, so any H, W >= 1 and any C, O work. For bf16 the products run on
// the tensor cores through WMMA 16x16x16 tiles with fp32 accumulation; the
// fp32 variant uses plain fp32 FMAs. The epilogue adds bias and residual in
// fp32 before the single rounding.
// The weight group is the grid's z index: each group is its own implicit
// GEMM with M = B0*H*W, so no 64-pixel tile straddles two weight groups, and
// a block offsets the weights by g*9*C*O and the bias by g*O. Nothing of the
// TPU's lane-group layout (conv.py:12-22) is carried over.
// Deliberately simple: scalar loads, no cp.async/TMA double buffering, no
// wgmma. Those are later optimisations.

#include "common.cuh"

#include <mma.h>

namespace {

constexpr int kBM = 64;  // output pixels per block
constexpr int kBN = 64;  // output channels per block
constexpr int kBK = 32;  // input channels per K step
constexpr int kThreads = 128;
constexpr int kLdC = kBN + 4;

template <typename T> struct Tile {
  static constexpr int kLdA = kBK + kPad<T>;
  static constexpr int kLdB = kBN + kPad<T>;
  static constexpr size_t a = sizeof(T) * kBM * kLdA;
  static constexpr size_t b = sizeof(T) * kBK * kLdB;
  static constexpr size_t c = sizeof(float) * kBM * kLdC;
  static constexpr size_t total = (a + b) > c ? (a + b) : c;  // C aliases A and B
};

template <typename T> struct TileMma;

// fp32: each thread owns an 8x4 patch of the 64x64 tile.
template <> struct TileMma<float> {
  using Tl = Tile<float>;
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

// bf16: the 4 warps tile the 64x64 output 2x2; each warp owns 2x2 WMMA tiles.
template <> struct TileMma<__nv_bfloat16> {
  using Tl = Tile<__nv_bfloat16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void step(const __nv_bfloat16* a, const __nv_bfloat16* b) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * Tl::kLdA + kk * 16, Tl::kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * 16 * Tl::kLdB + wn * 32 + j * 16, Tl::kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __device__ void store(float* c) const {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                                kLdC, wmma::mem_row_major);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
               const T* __restrict__ res, T* __restrict__ y, int B0, int H, int W, int C, int O,
               int relu) {
  using Tl = Tile<T>;
  __shared__ __align__(128) unsigned char smem[Tl::total];
  __shared__ int pix_b[kBM], pix_h[kBM], pix_w[kBM];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + Tl::a);
  float* cs = reinterpret_cast<float*>(smem);

  // weight group g: batch entries [g*B0, (g+1)*B0), weights and bias of group g
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
  const T zero = from_f<T>(0.f);

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

  TileMma<T> mma;
  mma.zero();
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += kBK) {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kc = i % kBK, c = c0 + kc;
        T val = zero;
        if (pix_b[r] >= 0 && c < C) {
          const int hh = min(max(pix_h[r] + dh, 0), H - 1);
          const int ww = min(max(pix_w[r] + dw, 0), W - 1);
          val = x[((static_cast<int64_t>(pix_b[r]) * H + hh) * W + ww) * C + c];
          if (relu && to_f(val) < 0.f) val = zero;
        }
        as[r * Tl::kLdA + kc] = val;
      }
      for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
        const int kr = i / kBN, n = i % kBN, c = c0 + kr, o = n0 + n;
        bs[kr * Tl::kLdB + n] =
            (c < C && o < O) ? w[(static_cast<int64_t>(tap) * C + c) * O + o] : zero;
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
    if (res != nullptr) val += to_f(res[idx]);
    y[idx] = from_f<T>(val);
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const void* res, void* y, int G, int B0,
           int H, int W, int C, int O, int relu, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(B0) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (O + kBN - 1) / kBN, G);
  conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<const T*>(res),
      static_cast<T*>(y), B0, H, W, C, O, relu);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* w, const void* bias, const void* res, void* y, int G, int B0,
             int H, int W, int C, int O, int relu, int dtype, void* stream) {
  if (G <= 0 || G > 65535 || B0 <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, b, res, y, G, B0, H, W, C, O, relu, st);
  if (dtype == kFloat32) return launch<float>(x, w, b, res, y, G, B0, H, W, C, O, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K3. x: (B, H, W, C), w: (3, 3, C, O), res/y: (B, H, W, O), all contiguous
// in the given dtype; bias: (O,) fp32 or null; res may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int moge_conv3x3(const void* x, const void* w, const void* bias, const void* res,
                            void* y, int B, int H, int W, int C, int O, int relu, int dtype,
                            void* stream) {
  return dispatch(x, w, bias, res, y, 1, B, H, W, C, O, relu, dtype, stream);
}

// K3-grouped. x: (G*B0, H, W, C), w: (G, 3, 3, C, O), res/y: (G*B0, H, W, O),
// all contiguous in the given dtype; bias: (G, O) fp32 or null; res may be
// null. Batch entry b uses weight group b / B0.
extern "C" int moge_conv3x3_grouped(const void* x, const void* w, const void* bias, const void* res,
                                    void* y, int G, int B0, int H, int W, int C, int O, int relu,
                                    int dtype, void* stream) {
  return dispatch(x, w, bias, res, y, G, B0, H, W, C, O, relu, dtype, stream);
}
