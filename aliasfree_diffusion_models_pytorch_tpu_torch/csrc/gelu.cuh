// The bf16 GELU's polynomial forms and their derivative, shared by the kernels of this directory
// that evaluate the port's gelu_exact (ops/resample.py) on bf16: the filtered-GELU pair
// (filtered_gelu.cu), which applies it between its up and down taps, and the plain GELU's pair
// (plain_gelu.cu). One definition, so that the two GELUs cannot drift apart.

#pragma once

#include <cuda_runtime.h>

namespace afdm {

// The GELU forms, as ops/resample.py:gelu_form names them (FG_GELU_FORMS, in this order): the
// form is a template parameter of the kernels, so each instantiation has one form and no branch.
// AFDM_GELU picks it for bf16, as in the JAX package (ops/resample.py:305-343): unset, the
// degree-15 polynomial; poly13, the degree-13 one; exact, the erf form. f32 takes erf always.
constexpr int kGeluPoly15 = 0, kGeluPoly13 = 1, kGeluErf = 2;

// The port's gelu_exact (ops/resample.py) on bf16: x·(0.5 + x_c·R(x_c²)), x_c = clamp(x, ±3.2·√2),
// R the JAX package's degree-15 (or degree-13) bf16 fit, each product and sum rounded as torch
// rounds them.
constexpr float kClamp = 4.5254833995939045f;
__constant__ float kPoly[8] = {
    0.39847720532397357f, -0.06533923798456039f, 0.009128171697420397f,
    -0.0008978316975850138f, 5.914830951568466e-05f, -2.454260270985954e-06f,
    5.750126543924546e-08f, -5.770954416805585e-10f};
__constant__ float kPoly13[7] = {
    0.39736903338755974f, -0.06336353822103462f, 0.008126449758425384f,
    -0.0006760143548142659f, 3.4051160496925107e-05f, -9.359854638467884e-07f,
    1.0721949130855751e-08f};

// Coefficient i of the form's polynomial, from constant memory (i is a constant once unrolled).
template <int G>
struct Poly {
  static constexpr int N = G == kGeluPoly13 ? 7 : 8;
  static __device__ __forceinline__ float at(int i) {
    if constexpr (G == kGeluPoly13) return kPoly13[i];
    return kPoly[i];
  }
};

template <int G>
__device__ __forceinline__ float gelu_poly(float x) {
  constexpr int N = Poly<G>::N;
  const float xc = fminf(fmaxf(x, -kClamp), kClamp);
  const float t = __fmul_rn(xc, xc);
  float p = Poly<G>::at(N - 1);
#pragma unroll
  for (int i = N - 2; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, t), Poly<G>::at(i));
  return __fmul_rn(x, __fadd_rn(0.5f, __fmul_rn(xc, p)));
}

// d/dx of gelu_poly: h + x·(R + 2t·R'(t)) inside the clamp, h = 0.5 + x_c·R outside it (the
// clamp's slope is zero there), as autograd of the plain version gives it.
template <int G>
__device__ __forceinline__ float gelu_poly_grad(float x) {
  constexpr int N = Poly<G>::N;
  const float xc = fminf(fmaxf(x, -kClamp), kClamp);
  const float t = xc * xc;
  float p = Poly<G>::at(N - 1), dp = 0.f;
#pragma unroll
  for (int i = N - 2; i >= 0; --i) {
    dp = fmaf(dp, t, p);
    p = fmaf(p, t, Poly<G>::at(i));
  }
  const float h = fmaf(xc, p, 0.5f);
  return (x >= -kClamp && x <= kClamp) ? fmaf(x, fmaf(2.f * t, dp, p), h) : h;
}

// g·gelu_poly'(x) as autograd of the plain version forms it, product for product and sum for sum:
// its backward runs through the forward's Horner values a_k (a_0 the last coefficient, a_{N−1} =
// R), each a_k = a_{k−1}·t + c, and sums the seven (six) contributions to t in the order it
// reaches them, from the last Horner step down; the clamp's input gets g·x·R and twice
// (Σ_t)·x_c, the clamp passes that on where |x| ≤ 3.2·√2 and 0 elsewhere, and x adds it to
// g·(0.5 + x_c·R). Where the Horner terms cancel (|x| near 4 the polynomial's terms reach ~25
// against a derivative of ~1e-3) the rounding order alone moves the result by several bf16 ulps,
// so a kernel that must give autograd's gradient repeats autograd's order (gelu_poly_grad, the
// filtered-GELU pair's, contracts with fmaf in an order of its own). The clamp keeps a NaN, as
// torch's does, so a NaN x gives a NaN gradient.
template <int G>
__device__ __forceinline__ float gelu_poly_vjp(float x, float g) {
  constexpr int N = Poly<G>::N;
  const float xc = x != x ? x : fminf(fmaxf(x, -kClamp), kClamp);
  const float t = __fmul_rn(xc, xc);
  float a[N];
  a[0] = Poly<G>::at(N - 1);
#pragma unroll
  for (int k = 1; k < N; ++k) a[k] = __fadd_rn(__fmul_rn(a[k - 1], t), Poly<G>::at(N - 1 - k));
  const float gx = __fmul_rn(g, __fadd_rn(0.5f, __fmul_rn(xc, a[N - 1])));  // x·(0.5 + x_c·R)'s x
  const float gh = __fmul_rn(g, x);  // to 0.5 + x_c·R
  float ga = __fmul_rn(gh, xc);      // to a_{N−1} = R
  float gt = __fmul_rn(ga, a[N - 2]);
#pragma unroll
  for (int k = N - 2; k >= 1; --k) {
    ga = __fmul_rn(ga, t);  // to a_k
    gt = __fadd_rn(gt, __fmul_rn(ga, a[k - 1]));
  }
  const float gtx = __fmul_rn(gt, xc);
  const float gxc = __fadd_rn(__fadd_rn(__fmul_rn(gh, a[N - 1]), gtx), gtx);
  return __fadd_rn(gx, x >= -kClamp && x <= kClamp ? gxc : 0.f);
}

}  // namespace afdm
