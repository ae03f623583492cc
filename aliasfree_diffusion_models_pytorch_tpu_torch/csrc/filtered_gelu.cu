// Filtered GELU (2x alias-free upsample → GELU → 2x alias-free downsample) in its polyphase form,
// forward and backward, for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces what the JAX package runs on its perf path: filtered_gelu_phases
// (aliasfree_diffusion_models_pytorch_tpu/ops/resample.py:345-393, index plan phase_terms
// :253-294), which XLA fuses into one loop over the original grid. It has no Pallas kernel (the
// post-mortem of two is at :23-44). The plain version is the port's ops/resample.py:
// filtered_gelu_phases, in NCHW; this file follows its steps and rounding points.
//
// The function, for odd K, p = K/2, up taps u[K][K], down taps d[K][K], on each (n, c) plane:
//   phase (a, b) ∈ {0,1}²:  P_ab[i, j] = Σ_{dy ≡ p−a, dx ≡ p−b (mod 2)} u[dy][dx]·x[i + (a+dy−p)/2,
//                                                                        j + (b+dx−p)/2]
//   (the zero-stuffed upsample's output at [2i+a, 2j+b]; K = 3 gives 1, 2, 2 and 4 taps);
//   G_ab = gelu(P_ab), zero outside the plane;
//   out[i, j] = Σ_{dy, dx} d[dy][dx]·G_{a(dy) b(dx)}[i + r(dy), j + r(dx)],
//               a(t) = (t − p) mod 2, r(t) = (t − p − a(t))/2  (the strided down conv).
// Backward, with the phases recomputed from x (the forward saves only x):
//   dG_ab[u, v] = Σ_{a(dy)=a, a(dx)=b} d[dy][dx]·g[u − r(dy), v − r(dx)];
//   dP_ab = gelu'(P_ab)·dG_ab;   dx[i, j] = Σ_ab Σ_terms u[dy][dx]·dP_ab[i − (a+dy−p)/2, ...].
//
// Types. bf16 (the model's) rounds where the plain version rounds, which is where the conv form
// rounds: P_ab to bf16; the GELU's output to bf16 (by default the JAX package's degree-15
// polynomial, evaluated in f32; see the GELU forms below); the down sum once. In the backward: dG to bf16, dP to bf16, dx once —
// the points where autograd of the plain version casts. f32 uses the exact erf GELU and its
// derivative in torch's own formulas, and rounds nowhere. The forward's products and sums are
// separate, rounded f32 operations in the plain version's order, so it is bit-equal to the plain
// version: the GELU polynomial is never contracted, and a tap product is contracted into its sum
// only in bf16, where both factors are bf16 values and the product is exact (Io::mul_add). The
// backward contracts with fmaf and sums in an order of its own (autograd's is not fixed).
//
// What bounds it: per output about 2K² multiply-adds and four GELU polynomials (~12 f32
// instructions each) in the forward, 3K² and four polynomials with their derivative in the
// backward, against 4 bytes (bf16 in and out) of device memory: at 33.5 T f32 instructions/s
// and 3.35 TB/s the instructions bound it. Written unfused, with the conversions to bf16 and
// back, the forward's own arithmetic is about 133 instructions an output (k = 3), the backward's
// about 145.
//
// Design: no shared memory and no barrier. Each thread owns a strip of RX columns × `rows` rows
// of one plane and walks down it one phase row at a time: it keeps the x rows (and, backward,
// the g rows) that the current phase row reads in registers, forms that row's phase values for
// the strip's columns and one or two halo columns (recomputing only those: 1 + 1/(2·RX) GELUs an
// output, and one phase row above the strip), and adds them into the two or three output rows
// they feed, in the plain version's tap order. An output row is stored once its last tap is in.
// x and g rows are read straight from device memory through L1: the strip's own RX columns as
// 8- or 16-byte words, the halo columns one element at a time. The taps sit in registers.
// Square planes of side 4 to 128 (k = 3, the model's) have instantiations of their own: the side
// is a template constant, so a thread finds its plane and strip by shifts, once, the strip's
// columns are never outside the plane, and a plane of side RX has no halo columns at all. A
// generic instantiation (any h, w and k; RX = 4, or 2 for k ≥ 5) divides once a thread and tests
// every column. Strip height is chosen by the caller (ops/resample.py:fg_plan): tall strips
// waste less on the recomputed phase row, short ones give a small call enough threads.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entry.cuh"
#include "gelu.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

// Scalar loads and stores, whole-strip rows as 32-bit words (two bf16 or one f32 each, read and
// written 8 or 16 bytes at a time), and the rounding to the input type.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  // c + a·b as the plain version computes it: a rounded product, then a rounded sum
  static __device__ __forceinline__ float mul_add(float a, float b, float c) {
    return __fadd_rn(c, __fmul_rn(a, b));
  }
  static __device__ __forceinline__ void unpack(unsigned w, float* v) { v[0] = __uint_as_float(w); }
  static __device__ __forceinline__ unsigned pack(const float* v) { return __float_as_uint(v[0]); }
};

template <>
struct Io<bf16> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float load(const bf16* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                           << 16);
  }
  static __device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // c + a·b for two bf16 values a and b: their product has at most 16 significant bits and is
  // exact in f32, so one fmaf rounds exactly where a rounded product and a rounded sum do.
  static __device__ __forceinline__ float mul_add(float a, float b, float c) {
    return fmaf(a, b, c);
  }
  // little-endian: the lower half of a word is the element at the lower address
  static __device__ __forceinline__ void unpack(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned pack(const float* v) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[0]))) |
           static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[1]))) << 16;
  }
};

// N elements from (to) an address aligned to 16 bytes (8 where N elements are 8 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_words(const T* p, float* v) {
  constexpr int kWords = N / Io<T>::kPerWord, kE = Io<T>::kPerWord;
  static_assert(kWords % 2 == 0, "whole 8-byte words");
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int c = 0; c < kWords / 4; ++c) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + c);
      Io<T>::unpack(q.x, v + (4 * c) * kE);
      Io<T>::unpack(q.y, v + (4 * c + 1) * kE);
      Io<T>::unpack(q.z, v + (4 * c + 2) * kE);
      Io<T>::unpack(q.w, v + (4 * c + 3) * kE);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kWords / 2; ++c) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + c);
      Io<T>::unpack(q.x, v + (2 * c) * kE);
      Io<T>::unpack(q.y, v + (2 * c + 1) * kE);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_words(T* p, const float* v) {
  constexpr int kWords = N / Io<T>::kPerWord, kE = Io<T>::kPerWord;
  static_assert(kWords % 2 == 0, "whole 8-byte words");
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int c = 0; c < kWords / 4; ++c) {
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(Io<T>::pack(v + (4 * c) * kE), Io<T>::pack(v + (4 * c + 1) * kE),
                     Io<T>::pack(v + (4 * c + 2) * kE), Io<T>::pack(v + (4 * c + 3) * kE));
    }
  } else {
#pragma unroll
    for (int c = 0; c < kWords / 2; ++c) {
      reinterpret_cast<uint2*>(p)[c] =
          make_uint2(Io<T>::pack(v + (2 * c) * kE), Io<T>::pack(v + (2 * c + 1) * kE));
    }
  }
}

// The GELU forms (kGeluPoly15, kGeluPoly13, kGeluErf) and the bf16 polynomial with its
// derivative (gelu_poly, gelu_poly_grad) are gelu.cuh's, shared with the plain GELU's kernels
// (plain_gelu.cu), so that the two cannot drift apart.
using afdm::gelu_poly;
using afdm::gelu_poly_grad;
using afdm::kGeluErf;
using afdm::kGeluPoly13;
using afdm::kGeluPoly15;

// torch's exact GELU and its derivative (GeluType::None), in f32: torch computes a bf16 GELU in
// f32 too and rounds once, so the bf16 erf form rounds where the plain version does.
__device__ __forceinline__ float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;  // 1/√(2π)
  return cdf + x * pdf;
}

template <int G>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (G == kGeluErf) return gelu_erf(x);
  return gelu_poly<G>(x);
}

template <int G>
__device__ __forceinline__ float gelu_grad(float x) {
  if constexpr (G == kGeluErf) return gelu_erf_grad(x);
  return gelu_poly_grad<G>(x);
}

// The index plan of phase_terms for odd K, as compile-time constants.
template <int K>
struct Plan {
  static constexpr int P = K / 2;
  // up term (parity a, tap t): present when a + t − p is even; shift (a + t − p)/2
  static __host__ __device__ constexpr bool up_has(int a, int t) { return ((a + t - P) & 1) == 0; }
  static __host__ __device__ constexpr int up_shift(int a, int t) { return (a + t - P) / 2; }
  // down tap t: reads phase parity (t − p) mod 2 at shift (t − p − parity)/2
  static __host__ __device__ constexpr int down_par(int t) { return (t - P) & 1; }
  static __host__ __device__ constexpr int down_shift(int t) { return (t - P - down_par(t)) / 2; }
  static constexpr int ULO = -(P / 2), UHI = (P + 1) / 2;  // range of up shifts
  static constexpr int DLO = down_shift(0), DHI = down_shift(K - 1);
  static constexpr int UR = UHI - ULO + 1, DR = DHI - DLO + 1;  // rows an up / a down term spans
  // tap dy of the down conv for phase parity a at row shift r (dy = 2r + a + p), or −1
  static __host__ __device__ constexpr int down_tap(int r, int a) {
    return (2 * r + a + P >= 0 && 2 * r + a + P < K) ? 2 * r + a + P : -1;
  }
};

// Launch geometry (ops/resample.py:fg_plan): a thread takes a strip of RX columns × `rows` rows
// of one plane, strips_x × strips_y strips a plane; strips_y = 1 << sy_shift where the plane's
// side is a template constant.
struct Geometry {
  int planes, h, w, rows, strips_x, strips_y, sy_shift;
};

// The thread's plane and the first row and column of its strip. With the side S a template
// constant this is shifts and masks; the generic instantiation divides, once a thread.
template <int S, int RX>
__device__ __forceinline__ bool locate(const Geometry& g, int& plane, int& i0, int& j0) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  unsigned sx, rest;
  if constexpr (S > 0) {
    constexpr unsigned kSX = S / RX;
    sx = tid % kSX;
    rest = tid / kSX;
    plane = static_cast<int>(rest >> g.sy_shift);
    i0 = static_cast<int>(rest & (g.strips_y - 1)) * g.rows;
  } else {
    sx = tid % g.strips_x;
    rest = tid / g.strips_x;
    plane = static_cast<int>(rest / g.strips_y);
    i0 = static_cast<int>(rest % g.strips_y) * g.rows;
  }
  j0 = static_cast<int>(sx) * RX;
  return plane < g.planes;
}

// Is column j0 + c (c relative to the strip) inside the plane? Known at compile time for the
// strip's own columns of a square-plane instantiation, and for every column where the strip is
// the whole row (S == RX).
template <int S, int RX>
__device__ __forceinline__ bool col_in(int c, int j0, int w) {
  if (S > 0 && c >= 0 && c < RX) return true;
  if (S > 0 && S == RX) return false;
  return j0 + c >= 0 && j0 + c < w;
}

// Row r of a plane at columns j0 + LO .. j0 + RX − 1 + HI into v, zero outside the plane.
template <typename T, int S, int RX, int LO, int HI>
__device__ __forceinline__ void load_row(const T* __restrict__ plane, int r, int j0, int h, int w,
                                         float* v) {
  constexpr int N = RX + HI - LO;
  if (r < 0 || r >= h) {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = 0.f;
    return;
  }
  const T* row = plane + r * w + j0;
  if constexpr (S > 0) {
    load_words<T, RX>(row, v - LO);
  }
#pragma unroll
  for (int c = LO; c < RX + HI; ++c) {
    if (S > 0 && c >= 0 && c < RX) continue;
    v[c - LO] = col_in<S, RX>(c, j0, w) ? Io<T>::load(row + c) : 0.f;
  }
}

template <typename T, int S, int RX>
__device__ __forceinline__ void store_row(T* __restrict__ plane, int r, int j0, int w,
                                          const float* v) {
  T* row = plane + r * w + j0;
  if constexpr (S > 0) {
    store_words<T, RX>(row, v);
  } else {
#pragma unroll
    for (int c = 0; c < RX; ++c) {
      if (j0 + c < w) Io<T>::store(row + c, v[c]);
    }
  }
}

// Phase (a, b) before the GELU, from the x window xr (row q holds x row u + ULO + q) at column
// index c0 of the window: products in (dy, dx) order, summed as the plain version sums (each
// product and sum rounded, Io::mul_add), or contracted with fmaf (kFma: the backward's).
template <typename T, int K, int XN, bool kFma>
__device__ __forceinline__ float up_phase(const float (&xr)[Plan<K>::UR][XN], int c0, int a, int b,
                                          const float* tu) {
  using Pl = Plan<K>;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    if (!Pl::up_has(a, dy)) continue;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      if (!Pl::up_has(b, dx)) continue;
      const float t = tu[dy * K + dx], v = xr[Pl::up_shift(a, dy) - Pl::ULO][c0 + Pl::up_shift(b, dx)];
      acc = kFma ? fmaf(t, v, acc) : Io<T>::mul_add(t, v, acc);
    }
  }
  return acc;
}

// Blocks an SM must hold: four of 128 threads (at most 128 registers a thread) for the model's
// bf16 k = 3 with a polynomial GELU, so a call of 65536 threads is one wave; fewer where more
// registers keep the erf form (f32, or bf16 under AFDM_GELU=exact) and k ≥ 5 from spilling.
template <typename T, int K, int G>
constexpr int kMinBlocks = K > 3 ? 2 : (sizeof(T) == 2 && G != kGeluErf) ? 4 : 3;

template <typename T, int K, int S, int RX, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, K, G>)
    filtered_gelu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ up,
                             const T* __restrict__ down, T* __restrict__ out, Geometry g) {
  using Pl = Plan<K>;
  int plane, i0, j0;
  if (!locate<S, RX>(g, plane, i0, j0)) return;
  const int h = S > 0 ? S : g.h, w = S > 0 ? S : g.w;
  float tu[K * K], td[K * K];
#pragma unroll
  for (int e = 0; e < K * K; ++e) {
    tu[e] = Io<T>::load(up + e);
    td[e] = Io<T>::load(down + e);
  }
  const T* xp = x + static_cast<size_t>(plane) * h * w;
  T* op = out + static_cast<size_t>(plane) * h * w;
  // phase values at columns j0 + GLO ..; the x columns they read, from j0 + XLO
  constexpr int GLO = Pl::DLO, GN = RX + Pl::DHI - Pl::DLO;
  constexpr int XLO = Pl::DLO + Pl::ULO, XHI = Pl::DHI + Pl::UHI, XN = RX + XHI - XLO;
  float xr[Pl::UR][XN];   // x rows u + ULO .. u + UHI
  float acc[Pl::DR][RX];  // acc[q]: output row u − DLO − q
  const int u0 = i0 + Pl::DLO;
#pragma unroll
  for (int q = 1; q < Pl::UR; ++q) load_row<T, S, RX, XLO, XHI>(xp, u0 + Pl::ULO + q - 1, j0, h, w, xr[q]);
#pragma unroll
  for (int q = 0; q < Pl::DR; ++q) {
#pragma unroll
    for (int c = 0; c < RX; ++c) acc[q][c] = 0.f;
  }
  const int steps = g.rows + Pl::DR - 1;
  for (int t = 0; t < steps; ++t) {
    const int u = u0 + t;  // the phase row of this step
#pragma unroll
    for (int q = 0; q + 1 < Pl::UR; ++q) {
#pragma unroll
      for (int c = 0; c < XN; ++c) xr[q][c] = xr[q + 1][c];
    }
    load_row<T, S, RX, XLO, XHI>(xp, u + Pl::UHI, j0, h, w, xr[Pl::UR - 1]);
    const bool row_in = u >= 0 && u < h;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      // Does an output row of the strip read phase row (u, a)? Output row u − DLO − q is row
      // t − q of the strip; the same answer for every thread of the launch.
      bool needed = false;
#pragma unroll
      for (int q = 0; q < Pl::DR; ++q) {
        if (Pl::down_tap(Pl::DLO + q, a) >= 0) needed = needed || (t - q >= 0 && t - q < g.rows);
      }
      if (!needed) continue;
      float gv[2][GN];  // GELU of phases (a, 0) and (a, 1), zero outside the plane
      if (row_in) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < GN; ++c) {
            gv[b][c] = col_in<S, RX>(GLO + c, j0, w)
                           ? Io<T>::round(gelu<G>(Io<T>::round(up_phase<T, K, XN, false>(xr, c + GLO - XLO, a, b, tu))))
                           : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < GN; ++c) gv[b][c] = 0.f;
        }
      }
      // the down taps of this phase row, in (dy, dx) order for every output
#pragma unroll
      for (int q = 0; q < Pl::DR; ++q) {
        const int dy = Pl::down_tap(Pl::DLO + q, a);
        if (dy < 0) continue;
#pragma unroll
        for (int j = 0; j < RX; ++j) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            acc[q][j] = Io<T>::mul_add(td[dy * K + dx],
                                       gv[Pl::down_par(dx)][j + Pl::down_shift(dx) - GLO], acc[q][j]);
          }
        }
      }
    }
    // output row u − DHI has all its taps
    const int i = u - Pl::DHI;
    if (i >= i0 && i < h) store_row<T, S, RX>(op, i, j0, w, acc[Pl::DR - 1]);
#pragma unroll
    for (int q = Pl::DR - 1; q > 0; --q) {
#pragma unroll
      for (int c = 0; c < RX; ++c) acc[q][c] = acc[q - 1][c];
    }
#pragma unroll
    for (int c = 0; c < RX; ++c) acc[0][c] = 0.f;
  }
}

template <typename T, int K, int S, int RX, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, K, G>)
    filtered_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                             const T* __restrict__ up, const T* __restrict__ down,
                             T* __restrict__ dx, Geometry g) {
  using Pl = Plan<K>;
  int plane, i0, j0;
  if (!locate<S, RX>(g, plane, i0, j0)) return;
  const int h = S > 0 ? S : g.h, w = S > 0 ? S : g.w;
  float tu[K * K], td[K * K];
#pragma unroll
  for (int e = 0; e < K * K; ++e) {
    tu[e] = Io<T>::load(up + e);
    td[e] = Io<T>::load(down + e);
  }
  const size_t base = static_cast<size_t>(plane) * h * w;
  const T* xp = x + base;
  const T* gp = gout + base;
  T* dp = dx + base;
  // dP at columns j0 + VLO ..; x one up-shift around them, g one down-shift
  constexpr int VLO = -Pl::UHI, VN = RX + Pl::UHI - Pl::ULO;
  constexpr int XLO = VLO + Pl::ULO, XHI = Pl::UHI - Pl::ULO, XN = RX + XHI - XLO;
  constexpr int GLO = VLO - Pl::DHI, GHI = -Pl::ULO - Pl::DLO, GN = RX + GHI - GLO;
  float xr[Pl::UR][XN];   // x rows u + ULO .. u + UHI
  float gr[Pl::DR][GN];   // g rows u − DHI .. u − DLO
  float acc[Pl::UR][RX];  // acc[q]: dx row u + ULO + q
  const int u0 = i0 - Pl::UHI;
#pragma unroll
  for (int q = 1; q < Pl::UR; ++q) load_row<T, S, RX, XLO, XHI>(xp, u0 + Pl::ULO + q - 1, j0, h, w, xr[q]);
#pragma unroll
  for (int q = 1; q < Pl::DR; ++q) load_row<T, S, RX, GLO, GHI>(gp, u0 - Pl::DHI + q - 1, j0, h, w, gr[q]);
#pragma unroll
  for (int q = 0; q < Pl::UR; ++q) {
#pragma unroll
    for (int c = 0; c < RX; ++c) acc[q][c] = 0.f;
  }
  const int steps = g.rows + Pl::UR - 1;
  for (int t = 0; t < steps; ++t) {
    const int u = u0 + t;  // the dP row of this step
#pragma unroll
    for (int q = 0; q + 1 < Pl::UR; ++q) {
#pragma unroll
      for (int c = 0; c < XN; ++c) xr[q][c] = xr[q + 1][c];
    }
#pragma unroll
    for (int q = 0; q + 1 < Pl::DR; ++q) {
#pragma unroll
      for (int c = 0; c < GN; ++c) gr[q][c] = gr[q + 1][c];
    }
    load_row<T, S, RX, XLO, XHI>(xp, u + Pl::UHI, j0, h, w, xr[Pl::UR - 1]);
    load_row<T, S, RX, GLO, GHI>(gp, u - Pl::DLO, j0, h, w, gr[Pl::DR - 1]);
    const bool row_in = u >= 0 && u < h;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      // Does a dx row of the strip read dP row (u, a)? Row u + s is row t − UHI + s of the strip.
      bool needed = false;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        if (!Pl::up_has(a, dy)) continue;
        const int r = t - Pl::UHI + Pl::up_shift(a, dy);
        needed = needed || (r >= 0 && r < g.rows);
      }
      if (!needed) continue;
      float dv[2][VN];  // dP of phases (a, 0) and (a, 1), zero outside the plane
      if (row_in) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < VN; ++c) {
            if (!col_in<S, RX>(VLO + c, j0, w)) {
              dv[b][c] = 0.f;
              continue;
            }
            const float p = Io<T>::round(up_phase<T, K, XN, true>(xr, c + VLO - XLO, a, b, tu));
            float dg = 0.f;
#pragma unroll
            for (int ty = 0; ty < K; ++ty) {
              if (Pl::down_par(ty) != a) continue;
#pragma unroll
              for (int tx = 0; tx < K; ++tx) {
                if (Pl::down_par(tx) != b) continue;
                dg = fmaf(td[ty * K + tx],
                          gr[Pl::DHI - Pl::down_shift(ty)][c + VLO - Pl::down_shift(tx) - GLO], dg);
              }
            }
            dv[b][c] = Io<T>::round(gelu_grad<G>(p) * Io<T>::round(dg));
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < VN; ++c) dv[b][c] = 0.f;
        }
      }
      // dx[i, j] += u[dy][dx]·dP_ab[i − s(a, dy), j − s(b, dx)], i = u + s(a, dy)
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        if (!Pl::up_has(a, dy)) continue;
        const int q = Pl::up_shift(a, dy) - Pl::ULO;
#pragma unroll
        for (int j = 0; j < RX; ++j) {
#pragma unroll
          for (int tx = 0; tx < K; ++tx) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (!Pl::up_has(b, tx)) continue;
              acc[q][j] = fmaf(tu[dy * K + tx], dv[b][j - Pl::up_shift(b, tx) - VLO], acc[q][j]);
            }
          }
        }
      }
    }
    // dx row u + ULO has all its terms
    const int i = u + Pl::ULO;
    if (i >= i0 && i < h) store_row<T, S, RX>(dp, i, j0, w, acc[0]);
#pragma unroll
    for (int q = 0; q + 1 < Pl::UR; ++q) {
#pragma unroll
      for (int c = 0; c < RX; ++c) acc[q][c] = acc[q + 1][c];
    }
#pragma unroll
    for (int c = 0; c < RX; ++c) acc[Pl::UR - 1][c] = 0.f;
  }
}

template <typename T, int K, int S, int RX, int G>
cudaError_t launch(const void* x, const void* gout, const void* up, const void* down, void* y,
                   const Geometry& geo, unsigned blocks, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* ut = static_cast<const T*>(up);
  const T* dt = static_cast<const T*>(down);
  if (gout != nullptr) {
    filtered_gelu_bwd_kernel<T, K, S, RX, G><<<blocks, kThreads, 0, stream>>>(
        xt, static_cast<const T*>(gout), ut, dt, static_cast<T*>(y), geo);
  } else {
    filtered_gelu_fwd_kernel<T, K, S, RX, G><<<blocks, kThreads, 0, stream>>>(
        xt, ut, dt, static_cast<T*>(y), geo);
  }
  return cudaGetLastError();
}

// The instantiations (ops/resample.py:fg_plan mirrors this table): square planes of side 4 to
// 128 at k = 3, RX = min(side, 8); every other shape and k generic, RX = 4 (k ≤ 3) or 2; each
// for every GELU form of its type (bf16 three, f32 the erf form).
template <typename T, int G>
cudaError_t dispatch(int k, int side, int cols, const void* x, const void* gout, const void* up,
                     const void* down, void* y, const Geometry& geo, unsigned blocks,
                     cudaStream_t st) {
  if (side == 0) {
    if (cols != (k <= 3 ? 4 : 2)) return cudaErrorInvalidValue;
    switch (k) {
      case 1: return launch<T, 1, 0, 4, G>(x, gout, up, down, y, geo, blocks, st);
      case 3: return launch<T, 3, 0, 4, G>(x, gout, up, down, y, geo, blocks, st);
      case 5: return launch<T, 5, 0, 2, G>(x, gout, up, down, y, geo, blocks, st);
      case 7: return launch<T, 7, 0, 2, G>(x, gout, up, down, y, geo, blocks, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (k != 3 || cols != (side < 8 ? side : 8)) return cudaErrorInvalidValue;
  switch (side) {
    case 4: return launch<T, 3, 4, 4, G>(x, gout, up, down, y, geo, blocks, st);
    case 8: return launch<T, 3, 8, 8, G>(x, gout, up, down, y, geo, blocks, st);
    case 16: return launch<T, 3, 16, 8, G>(x, gout, up, down, y, geo, blocks, st);
    case 32: return launch<T, 3, 32, 8, G>(x, gout, up, down, y, geo, blocks, st);
    case 64: return launch<T, 3, 64, 8, G>(x, gout, up, down, y, geo, blocks, st);
    case 128: return launch<T, 3, 128, 8, G>(x, gout, up, down, y, geo, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

// x (and, for the backward, g) and the result y: contiguous (planes, h, w) arrays of f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); up and down: contiguous k × k taps of the same type.
// gelu: the GELU form (kGeluPoly15, kGeluPoly13 or kGeluErf; f32 takes kGeluErf only).
// g == nullptr launches the forward (y = filtered GELU of x), otherwise the backward (y = dx).
// The plan from ops/resample.py:fg_plan: a thread takes `rows` rows × `cols` columns of a plane;
// `side` names a square-plane instantiation (h = w = side, k = 3, 16-byte aligned x, g and y,
// rows a power of two dividing side) or is 0 for the generic one. Launches one kernel on
// `stream` and returns its cudaError_t (0 on success).
extern "C" int afdm_filtered_gelu(const void* x, const void* g, const void* up, const void* down,
                                  void* y, int planes, int h, int w, int k, int rows, int cols,
                                  int side, int is_bf16, int gelu, void* stream) {
  if (planes < 1 || h < 1 || w < 1 || rows < 1 || rows > h || cols < 1) {
    return cudaErrorInvalidValue;
  }
  const int strips_x = (w + cols - 1) / cols, strips_y = (h + rows - 1) / rows;
  int sy_shift = 0;
  if (side != 0) {
    if (h != side || w != side || side % rows != 0 || (strips_y & (strips_y - 1)) != 0 ||
        !aligned16(x) || !aligned16(y) || (g != nullptr && !aligned16(g))) {
      return cudaErrorInvalidValue;
    }
    while ((1 << sy_shift) < strips_y) ++sy_shift;
  }
  const long long threads = static_cast<long long>(planes) * strips_x * strips_y;
  if (threads > static_cast<long long>(INT_MAX) - kThreads) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const Geometry geo{planes, h, w, rows, strips_x, strips_y, sy_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (!is_bf16) {
    if (gelu == kGeluErf) {
      err = dispatch<float, kGeluErf>(k, side, cols, x, g, up, down, y, geo, blocks, st);
    }
  } else if (gelu == kGeluPoly15) {
    err = dispatch<bf16, kGeluPoly15>(k, side, cols, x, g, up, down, y, geo, blocks, st);
  } else if (gelu == kGeluPoly13) {
    err = dispatch<bf16, kGeluPoly13>(k, side, cols, x, g, up, down, y, geo, blocks, st);
  } else if (gelu == kGeluErf) {
    err = dispatch<bf16, kGeluErf>(k, side, cols, x, g, up, down, y, geo, blocks, st);
  }
  return static_cast<int>(err);
}
