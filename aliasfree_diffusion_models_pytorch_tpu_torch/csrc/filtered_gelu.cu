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
// rounds: P_ab to bf16; the GELU's output to bf16 (the JAX package's degree-15 polynomial,
// evaluated in f32); the down sum once. In the backward: dG to bf16, dP to bf16, dx once —
// the points where autograd of the plain version casts. f32 uses the exact erf GELU and its
// derivative in torch's own formulas, and rounds nowhere. Products and sums are written as
// separate, rounded f32 operations in the plain version's order (no FMA contraction), so the
// forward repeats the plain version's arithmetic; the backward's sums run in an order of their
// own (autograd's is not fixed).
//
// What bounds it: per output about 2K² multiply-adds and four GELU polynomials (~12 f32
// instructions each) in the forward, 3K² and four polynomials with their derivative in the
// backward, against 4 bytes (bf16 in and out) of device memory: at 33.5 T f32 instructions/s
// and 3.35 TB/s the instructions bound it, about 16 operations for every byte. The design keeps
// every intermediate on chip: one block takes a tile of outputs (32 columns × 16 rows, or
// several whole planes when a plane is smaller), loads x (and g) with their halos into shared
// memory once, forms each phase value of the tile's region once (its four GELUs shared by the
// outputs that read it), and writes the result once. No 4x-size tensor reaches device memory.
// The taps come as the caller's k × k device tensors (the module's buffers, in the input's dtype)
// and each block reads them into shared memory: no host copy and no synchronisation per call.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<bf16> {
  static __device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The port's gelu_exact (ops/resample.py): x·(0.5 + x_c·R(x_c²)), x_c = clamp(x, ±3.2·√2), R the
// JAX package's degree-15 bf16 fit, each product and sum rounded as torch rounds them.
constexpr float kClamp = 4.5254833995939045f;
__constant__ float kPoly[8] = {
    0.39847720532397357f, -0.06533923798456039f, 0.009128171697420397f,
    -0.0008978316975850138f, 5.914830951568466e-05f, -2.454260270985954e-06f,
    5.750126543924546e-08f, -5.770954416805585e-10f};

__device__ __forceinline__ float gelu_poly(float x) {
  const float xc = fminf(fmaxf(x, -kClamp), kClamp);
  const float t = __fmul_rn(xc, xc);
  float p = kPoly[7];
#pragma unroll
  for (int i = 6; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, t), kPoly[i]);
  return __fmul_rn(x, __fadd_rn(0.5f, __fmul_rn(xc, p)));
}

// d/dx of gelu_poly: h + x·(R + 2t·R'(t)) inside the clamp, h = 0.5 + x_c·R outside it (the
// clamp's slope is zero there), as autograd of the plain version gives it.
__device__ __forceinline__ float gelu_poly_grad(float x) {
  const float xc = fminf(fmaxf(x, -kClamp), kClamp);
  const float t = xc * xc;
  float p = kPoly[7], dp = 0.f;
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    dp = fmaf(dp, t, p);
    p = fmaf(p, t, kPoly[i]);
  }
  const float h = fmaf(xc, p, 0.5f);
  return (x >= -kClamp && x <= kClamp) ? fmaf(x, fmaf(2.f * t, dp, p), h) : h;
}

// torch's exact GELU and its derivative (GeluType::None), in f32.
__device__ __forceinline__ float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;  // 1/√(2π)
  return cdf + x * pdf;
}

template <typename T>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (sizeof(T) == 2) return gelu_poly(x);
  return gelu_erf(x);
}

template <typename T>
__device__ __forceinline__ float gelu_grad(float x) {
  if constexpr (sizeof(T) == 2) return gelu_poly_grad(x);
  return gelu_erf_grad(x);
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
};

// Launch geometry: a block takes `pb` planes × a th × tw tile of each, tiles_y × tiles_x tiles
// a plane (ops/resample.py:fg_plan).
struct Geometry {
  int planes, h, w, th, tw, pb, tiles_y, tiles_x;
};

// Loads rows r0.. and columns c0.. of `pb` planes of src into a pb × rows × cols f32 tile,
// zeros outside the plane.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, const Geometry& g,
                                          int plane0, int r0, int c0, int rows, int cols) {
  const int n = g.pb * rows * cols;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int pl = e / (rows * cols), rem = e % (rows * cols);
    const int gi = r0 + rem / cols, gj = c0 + rem % cols, plane = plane0 + pl;
    const bool in = plane < g.planes && gi >= 0 && gi < g.h && gj >= 0 && gj < g.w;
    dst[e] = in ? Io<T>::load(src + (static_cast<size_t>(plane) * g.h + gi) * g.w + gj) : 0.f;
  }
}

// Phase (a, b) before the GELU at the position whose x tile row/column is `xr` (x[xr + shift]).
template <int K, int A, int B>
__device__ __forceinline__ float up_phase(const float* xs, int xw, const float* tu) {
  using Pl = Plan<K>;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    if (!Pl::up_has(A, dy)) continue;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      if (!Pl::up_has(B, dx)) continue;
      acc = __fadd_rn(acc, __fmul_rn(tu[dy * K + dx],
                                     xs[Pl::up_shift(A, dy) * xw + Pl::up_shift(B, dx)]));
    }
  }
  return acc;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    filtered_gelu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ up,
                             const T* __restrict__ down, T* __restrict__ out, Geometry g) {
  using Pl = Plan<K>;
  extern __shared__ float smem[];
  __shared__ float tu[K * K], td[K * K];
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    tu[e] = Io<T>::load(up + e);
    td[e] = Io<T>::load(down + e);
  }
  const int tiles = g.tiles_y * g.tiles_x;
  const int plane0 = (blockIdx.x / tiles) * g.pb;
  const int i0 = (blockIdx.x % tiles) / g.tiles_x * g.th, j0 = (blockIdx.x % tiles) % g.tiles_x * g.tw;
  // phase values at rows i0 + DLO .. i0 + th − 1 + DHI (likewise columns); x one up-shift wider
  const int ph = g.th + Pl::DHI - Pl::DLO, pw = g.tw + Pl::DHI - Pl::DLO;
  const int xh = ph + Pl::UHI - Pl::ULO, xw = pw + Pl::UHI - Pl::ULO;
  float* xs = smem;                 // [pb][xh][xw]
  float* ps = xs + g.pb * xh * xw;  // [pb][4][ph][pw] GELU of each phase
  load_tile(xs, x, g, plane0, i0 + Pl::DLO + Pl::ULO, j0 + Pl::DLO + Pl::ULO, xh, xw);
  __syncthreads();

  for (int e = threadIdx.x; e < g.pb * ph * pw; e += kThreads) {
    const int pl = e / (ph * pw), r = e % (ph * pw) / pw, c = e % pw;
    const int gi = i0 + Pl::DLO + r, gj = j0 + Pl::DLO + c;
    float* pp = ps + pl * 4 * ph * pw + r * pw + c;
    if (gi < 0 || gi >= g.h || gj < 0 || gj >= g.w) {
      pp[0] = pp[ph * pw] = pp[2 * ph * pw] = pp[3 * ph * pw] = 0.f;  // zero outside the plane
      continue;
    }
    const float* xb = xs + pl * xh * xw + (r - Pl::ULO) * xw + (c - Pl::ULO);
    pp[0] = Io<T>::round(gelu<T>(Io<T>::round(up_phase<K, 0, 0>(xb, xw, tu))));
    pp[ph * pw] = Io<T>::round(gelu<T>(Io<T>::round(up_phase<K, 0, 1>(xb, xw, tu))));
    pp[2 * ph * pw] = Io<T>::round(gelu<T>(Io<T>::round(up_phase<K, 1, 0>(xb, xw, tu))));
    pp[3 * ph * pw] = Io<T>::round(gelu<T>(Io<T>::round(up_phase<K, 1, 1>(xb, xw, tu))));
  }
  __syncthreads();

  for (int e = threadIdx.x; e < g.pb * g.th * g.tw; e += kThreads) {
    const int pl = e / (g.th * g.tw), r = e % (g.th * g.tw) / g.tw, c = e % g.tw;
    const int gi = i0 + r, gj = j0 + c, plane = plane0 + pl;
    if (plane >= g.planes || gi >= g.h || gj >= g.w) continue;
    const float* pt = ps + pl * 4 * ph * pw + (r - Pl::DLO) * pw + (c - Pl::DLO);
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int phase = 2 * Pl::down_par(dy) + Pl::down_par(dx);
        acc = __fadd_rn(acc, __fmul_rn(td[dy * K + dx],
                                       pt[phase * ph * pw + Pl::down_shift(dy) * pw +
                                          Pl::down_shift(dx)]));
      }
    }
    Io<T>::store(out + (static_cast<size_t>(plane) * g.h + gi) * g.w + gj, acc);
  }
}

// dG of phase (a, b) at the position whose g tile row/column is `gb` (g[gb − shift]).
template <int K, int A, int B>
__device__ __forceinline__ float down_grad(const float* gb, int gw, const float* td) {
  using Pl = Plan<K>;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    if (Pl::down_par(dy) != A) continue;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      if (Pl::down_par(dx) != B) continue;
      acc = fmaf(td[dy * K + dx], gb[-Pl::down_shift(dy) * gw - Pl::down_shift(dx)], acc);
    }
  }
  return acc;
}

template <typename T, int K, int A, int B>
__device__ __forceinline__ float phase_grad(const float* xb, int xw, const float* gb, int gw,
                                            const float* tu, const float* td) {
  const float p = Io<T>::round(up_phase<K, A, B>(xb, xw, tu));
  const float dg = Io<T>::round(down_grad<K, A, B>(gb, gw, td));
  return Io<T>::round(gelu_grad<T>(p) * dg);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    filtered_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                             const T* __restrict__ up, const T* __restrict__ down,
                             T* __restrict__ dx, Geometry g) {
  using Pl = Plan<K>;
  extern __shared__ float smem[];
  __shared__ float tu[K * K], td[K * K];
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    tu[e] = Io<T>::load(up + e);
    td[e] = Io<T>::load(down + e);
  }
  const int tiles = g.tiles_y * g.tiles_x;
  const int plane0 = (blockIdx.x / tiles) * g.pb;
  const int i0 = (blockIdx.x % tiles) / g.tiles_x * g.th, j0 = (blockIdx.x % tiles) % g.tiles_x * g.tw;
  // dP at rows i0 − UHI .. i0 + th − 1 − ULO; x and g around them
  constexpr int kUp = Pl::UHI - Pl::ULO, kDown = Pl::DHI - Pl::DLO;
  const int ph = g.th + kUp, pw = g.tw + kUp;
  const int xh = ph + kUp, xw = pw + kUp, gh = ph + kDown, gw = pw + kDown;
  const int pr0 = i0 - Pl::UHI, pc0 = j0 - Pl::UHI;
  float* xs = smem;                  // [pb][xh][xw]
  float* gs = xs + g.pb * xh * xw;   // [pb][gh][gw]
  float* ds = gs + g.pb * gh * gw;   // [pb][4][ph][pw] dP of each phase
  load_tile(xs, x, g, plane0, pr0 + Pl::ULO, pc0 + Pl::ULO, xh, xw);
  load_tile(gs, gout, g, plane0, pr0 - Pl::DHI, pc0 - Pl::DHI, gh, gw);
  __syncthreads();

  for (int e = threadIdx.x; e < g.pb * ph * pw; e += kThreads) {
    const int pl = e / (ph * pw), r = e % (ph * pw) / pw, c = e % pw;
    const int gi = pr0 + r, gj = pc0 + c;
    float* dp = ds + pl * 4 * ph * pw + r * pw + c;
    if (gi < 0 || gi >= g.h || gj < 0 || gj >= g.w) {
      dp[0] = dp[ph * pw] = dp[2 * ph * pw] = dp[3 * ph * pw] = 0.f;  // no phase value there
      continue;
    }
    const float* xb = xs + pl * xh * xw + (r - Pl::ULO) * xw + (c - Pl::ULO);
    const float* gb = gs + pl * gh * gw + (r + Pl::DHI) * gw + (c + Pl::DHI);
    dp[0] = phase_grad<T, K, 0, 0>(xb, xw, gb, gw, tu, td);
    dp[ph * pw] = phase_grad<T, K, 0, 1>(xb, xw, gb, gw, tu, td);
    dp[2 * ph * pw] = phase_grad<T, K, 1, 0>(xb, xw, gb, gw, tu, td);
    dp[3 * ph * pw] = phase_grad<T, K, 1, 1>(xb, xw, gb, gw, tu, td);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < g.pb * g.th * g.tw; e += kThreads) {
    const int pl = e / (g.th * g.tw), r = e % (g.th * g.tw) / g.tw, c = e % g.tw;
    const int gi = i0 + r, gj = j0 + c, plane = plane0 + pl;
    if (plane >= g.planes || gi >= g.h || gj >= g.w) continue;
    // dP_ab[i − shift]: the dP tile row of output row r is r + UHI − shift
    const float* db = ds + pl * 4 * ph * pw + (r + Pl::UHI) * pw + (c + Pl::UHI);
    float acc = 0.f;
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        if (!Pl::up_has(ab >> 1, dy)) continue;
#pragma unroll
        for (int dx2 = 0; dx2 < K; ++dx2) {
          if (!Pl::up_has(ab & 1, dx2)) continue;
          acc = fmaf(tu[dy * K + dx2], db[ab * ph * pw - Pl::up_shift(ab >> 1, dy) * pw -
                                          Pl::up_shift(ab & 1, dx2)], acc);
        }
      }
    }
    Io<T>::store(dx + (static_cast<size_t>(plane) * g.h + gi) * g.w + gj, acc);
  }
}

template <typename T, int K>
int smem_bytes(const Geometry& g, bool backward) {
  using Pl = Plan<K>;
  if (!backward) {
    const int ph = g.th + Pl::DHI - Pl::DLO, pw = g.tw + Pl::DHI - Pl::DLO;
    const int xh = ph + Pl::UHI - Pl::ULO, xw = pw + Pl::UHI - Pl::ULO;
    return 4 * g.pb * (xh * xw + 4 * ph * pw);
  }
  constexpr int kUp = Pl::UHI - Pl::ULO, kDown = Pl::DHI - Pl::DLO;
  const int ph = g.th + kUp, pw = g.tw + kUp;
  return 4 * g.pb * ((ph + kUp) * (pw + kUp) + (ph + kDown) * (pw + kDown) + 4 * ph * pw);
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* gout, const void* up, const void* down, void* y,
                   const Geometry& g, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((g.planes + g.pb - 1) / g.pb) *
                           g.tiles_y * g.tiles_x;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool backward = gout != nullptr;
  const int smem = smem_bytes<T, K>(g, backward);
  const T* xt = static_cast<const T*>(x);
  const T* ut = static_cast<const T*>(up);
  const T* dt = static_cast<const T*>(down);
  cudaError_t err = cudaSuccess;
  if (backward) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(filtered_gelu_bwd_kernel<T, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    filtered_gelu_bwd_kernel<T, K><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        xt, static_cast<const T*>(gout), ut, dt, static_cast<T*>(y), g);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(filtered_gelu_fwd_kernel<T, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    filtered_gelu_fwd_kernel<T, K><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        xt, ut, dt, static_cast<T*>(y), g);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(int k, const void* x, const void* gout, const void* up, const void* down,
                       void* y, const Geometry& g, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(x, gout, up, down, y, g, stream);
    case 3: return launch<T, 3>(x, gout, up, down, y, g, stream);
    case 5: return launch<T, 5>(x, gout, up, down, y, g, stream);
    case 7: return launch<T, 7>(x, gout, up, down, y, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (and, for the backward, g) and the result y: contiguous (planes, h, w) arrays of f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); up and down: contiguous k × k taps of the same type.
// g == nullptr launches the forward (y = filtered GELU of x), otherwise the backward (y = dx).
// (th, tw, pb): tile and planes per block from ops/resample.py:fg_plan. Launches one kernel on
// `stream` and returns its cudaError_t (0 on success).
extern "C" int afdm_filtered_gelu(const void* x, const void* g, const void* up, const void* down,
                                  void* y, int planes, int h, int w, int k, int th, int tw, int pb,
                                  int is_bf16, void* stream) {
  if (planes < 1 || h < 1 || w < 1 || th < 1 || tw < 1 || pb < 1 || th > h || tw > w) {
    return cudaErrorInvalidValue;
  }
  const Geometry geo{planes, h, w, th, tw, pb, (h + th - 1) / th, (w + tw - 1) / tw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_k<bf16>(k, x, g, up, down, y, geo, st)
                                  : dispatch_k<float>(k, x, g, up, down, y, geo, st);
  return static_cast<int>(err);
}

extern "C" const char* afdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
