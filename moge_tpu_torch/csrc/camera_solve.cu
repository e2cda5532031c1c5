// K5: the camera solve, the 30-step Levenberg-Marquardt focal/shift recovery.
//
// Replaces the plain PyTorch LM loop of moge_tpu_torch/ops/solvers.py
// (recover_focal_shift) on CUDA tensors. It has no Pallas source: the JAX
// package's solve (moge_tpu/ops/solvers.py) is a lax.fori_loop that XLA
// compiles into one program. For each image b of the (B, H, W, 3) point map,
// with the N = out_h * out_w legacy-nearest samples i (source pixel src[i],
// uv[i] from a host-built table, w_i = 1 where the mask keeps the pixel, else
// 0 with the point taken as (0, 0, 1)), it minimises over the shift s
//   sum_i w_i | f(s) * xy_i / (z_i + s) - uv_i |^2
// with f(s) = sum w proj.uv / max(sum w |proj|^2, eps) in closed form (free
// focal) or the given focal (known focal), by `iters` scalar LM steps:
//   s_new = s - g / (h (1 + lam) + eps),  g = sum r dr/ds,  h = sum (dr/ds)^2,
// accepted when f_new < f_cur and f_new is finite (lam / 3, floor 1e-9),
// else rejected (lam * 10, cap 1e8); eps = 1e-12, lam0 = 1e-3. Items with
// fewer than 2 valid samples give (focal, shift) = (1, 0).
//
// What bounds it on an H100: neither bytes (B * N * 13 read once) nor
// operations (~60 flops per sample per pass), but the chain of dependent
// block reductions: 2 + 2 * iters passes over the samples, each ending in a
// reduction whose result the next pass needs. Design: one block per image, so
// the whole loop runs on one SM with no host round trip and no grid-wide
// sync. 512 threads a block; a thread gathers its samples once (up to 8 of
// them, strided by the block) and keeps them in registers for every pass;
// past 512 x 8 samples (the 64x64 default has 4096) it gathers them again
// from device memory in each pass. A pass is a thread-serial partial sum,
// warp shuffles, and one exchange through double-buffered shared slots that
// every thread then sums in the same order, so one __syncthreads per
// reduction and every thread holds the same totals and runs the scalar LM
// step itself. The evaluation at s_new also takes the sums of the derivative
// there, so an accepted step becomes the next current point as it is and a
// rejected one leaves the current sums as they were: two passes an iteration
// (free focal), one (known focal). fp32 throughout, IEEE division.

#include "common.cuh"

namespace {

constexpr int kWarps = 16;  // 512 threads a block
constexpr int kThreads = kWarps * 32;
constexpr int kHeld = 8;  // samples a thread holds in registers
constexpr float kEps = 1e-12f;

// A sample: its point (masked: (0, 0, 1)), weight w (1 or 0, so that w is
// also the residual's sqrt(w)) and uv.
struct Sample {
  float x, y, z, w, u, v;
};

struct Source {
  const float* points;    // (B, H, W, 3)
  const uint8_t* mask;    // (B, H, W) bool, or null
  const float2* uv;       // (N,)
  const int* src;         // (N,) flat pixel index y * W + x
  int64_t pixel0;         // b * H * W

  __device__ __forceinline__ Sample gather(int n) const {
    const int64_t p = pixel0 + src[n];
    const float2 t = uv[n];
    const bool keep = mask == nullptr || mask[p] != 0;
    Sample s;
    s.x = keep ? points[3 * p] : 0.f;
    s.y = keep ? points[3 * p + 1] : 0.f;
    s.z = keep ? points[3 * p + 2] : 1.f;
    s.w = keep ? 1.f : 0.f;
    s.u = t.x;
    s.v = t.y;
    return s;
  }
};

// the samples of this thread: held in registers (kHold) or gathered anew
template <bool kHold>
struct Samples {
  Sample held[kHold ? kHeld : 1];
  Source source;
  int N;

  __device__ __forceinline__ void load() {
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int n = k * kThreads + threadIdx.x;
        if (n < N) held[k] = source.gather(n);
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(F&& fn) const {
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (k * kThreads + static_cast<int>(threadIdx.x) < N) fn(held[k]);
    } else {
      for (int n = threadIdx.x; n < N; n += kThreads) fn(source.gather(n));
    }
  }
};

// The block's totals of K partial sums, the same in every thread (each
// thread adds the warps' sums in warp order). Alternating slot buffers: a
// buffer is written again only after the next reduction's barrier, which
// every thread reaches after reading it.
template <int K>
struct Reducer {
  float (*slots)[K][kWarps];
  int buf = 0;

  __device__ __forceinline__ void sum(float (&v)[K]) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) slots[buf][k][warp] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float t = 0.f;
      for (int i = 0; i < kWarps; ++i) t += slots[buf][k][i];
      v[k] = t;
    }
    buf ^= 1;
  }
};

// The sums of one point s: the focal's numerator and denominator (free focal
// only), the objective, g and h.
struct Eval {
  float num, den, f_obj, g, h;
};

template <bool kHold, bool kFree>
__global__ void __launch_bounds__(kThreads)
camera_solve_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
                    const float* __restrict__ focal, int64_t focal_stride, const float2* __restrict__ uv,
                    const int* __restrict__ src, float* __restrict__ focal_out, float* __restrict__ shift_out,
                    int64_t HW, int N, int iters) {
  __shared__ float slots[2][4][kWarps];
  const int b = blockIdx.x;
  Samples<kHold> samples{{}, {points, mask, uv, src, static_cast<int64_t>(b) * HW}, N};
  samples.load();
  Reducer<4> red{slots};

  float count[4] = {0.f, 0.f, 0.f, 0.f};
  samples.each([&](const Sample& p) { count[0] += p.w; });
  red.sum(count);
  const float n_valid = count[0];
  const float f_known = kFree ? 0.f : focal[b * focal_stride];

  // the sums at s: for the free focal, first num, den and their derivatives
  // (f and df/ds need them), then the objective, g and h
  auto evaluate = [&](float s) -> Eval {
    float f = f_known, df = 0.f, num = 0.f, den = 0.f;
    if constexpr (kFree) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};  // num, den, dnum, sum w proj.dproj
      samples.each([&](const Sample& p) {
        const float zs = p.z + s;
        const float px = p.x / zs, py = p.y / zs;
        const float dpx = -px / zs, dpy = -py / zs;
        a[0] += p.w * px * p.u + p.w * py * p.v;
        a[1] += p.w * (px * px) + p.w * (py * py);
        a[2] += p.w * dpx * p.u + p.w * dpy * p.v;
        a[3] += p.w * px * dpx + p.w * py * dpy;
      });
      red.sum(a);
      num = a[0];
      den = a[1];
      const float den_c = den < kEps ? kEps : den;  // clamp_min: NaN stays NaN
      f = num / den_c;
      df = a[2] / den_c - num * (den > kEps ? 2.f * a[3] : 0.f) / (den_c * den_c);
    }
    float r[4] = {0.f, 0.f, 0.f, 0.f};  // objective, g, h, unused
    samples.each([&](const Sample& p) {
      const float zs = p.z + s;
      const float px = p.x / zs, py = p.y / zs;
      const float dpx = -px / zs, dpy = -py / zs;
      const float rx = p.w * (f * px - p.u), ry = p.w * (f * py - p.v);
      float drx, dry;
      if constexpr (kFree) {
        drx = p.w * (df * px + f * dpx);
        dry = p.w * (df * py + f * dpy);
      } else {
        drx = p.w * f * dpx;
        dry = p.w * f * dpy;
      }
      r[0] += rx * rx + ry * ry;
      r[1] += rx * drx + ry * dry;
      r[2] += drx * drx + dry * dry;
    });
    red.sum(r);
    return {num, den, r[0], r[1], r[2]};
  };

  float s = 0.f, lam = 1e-3f;
  Eval cur = evaluate(s);
  for (int it = 0; it < iters; ++it) {
    const float s_new = s - cur.g / (cur.h * (1.f + lam) + kEps);
    const Eval nxt = evaluate(s_new);
    if (nxt.f_obj < cur.f_obj && isfinite(nxt.f_obj)) {
      s = s_new;
      cur = nxt;
      lam = fmaxf(lam / 3.f, 1e-9f);
    } else {
      lam = fminf(lam * 10.f, 1e8f);
    }
  }
  if (threadIdx.x == 0) {
    const bool degenerate = n_valid < 2.f;
    const float f = kFree ? cur.num / (cur.den < kEps ? kEps : cur.den) : f_known;
    focal_out[b] = degenerate ? 1.f : f;
    shift_out[b] = degenerate ? 0.f : s;
  }
}

template <bool kHold>
int launch(const float* points, const uint8_t* mask, const float* focal, int64_t focal_stride, const float2* uv,
           const int* src, float* focal_out, float* shift_out, int B, int64_t HW, int N, int iters,
           cudaStream_t stream) {
  if (focal == nullptr)
    camera_solve_kernel<kHold, true><<<B, kThreads, 0, stream>>>(points, mask, focal, focal_stride, uv, src,
                                                                 focal_out, shift_out, HW, N, iters);
  else
    camera_solve_kernel<kHold, false><<<B, kThreads, 0, stream>>>(points, mask, focal, focal_stride, uv, src,
                                                                  focal_out, shift_out, HW, N, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points: (B, H, W, 3) fp32 contiguous; mask: (B, H, W) bool contiguous, or
// null (every pixel valid); focal: fp32 at focal[b * focal_stride], or null
// for the free focal; uv: (N, 2) fp32 and src: (N,) int32 (flat source
// pixel), the samples' table; focal_out, shift_out: (B,) fp32. Samples are
// held in registers up to 512 x 8, gathered in every pass beyond. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for what the
// library does not take.
extern "C" int moge_camera_solve(const void* points, const void* mask, const void* focal, int64_t focal_stride,
                                 const void* uv, const void* src, void* focal_out, void* shift_out, int B,
                                 int64_t HW, int N, int iters, void* stream) {
  if (B <= 0 || N <= 0 || HW <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(points);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* f = static_cast<const float*>(focal);
  const float2* t = static_cast<const float2*>(uv);
  const int* s = static_cast<const int*>(src);
  float* fo = static_cast<float*>(focal_out);
  float* so = static_cast<float*>(shift_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= kThreads * kHeld) return launch<true>(p, m, f, focal_stride, t, s, fo, so, B, HW, N, iters, st);
  return launch<false>(p, m, f, focal_stride, t, s, fo, so, B, HW, N, iters, st);
}
