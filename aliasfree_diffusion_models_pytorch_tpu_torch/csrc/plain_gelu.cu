// The plain GELU (no resampling around it) on bf16, forward and backward, for Hopper (sm_90a),
// exported with a plain C interface (ctypes).
//
// Replaces no Pallas kernel: the JAX package's gelu_exact (aliasfree_diffusion_models_pytorch_tpu/
// ops/resample.py:305-343) is an elementwise chain that XLA fuses. The port's plain version is
// ops/resample.py:gelu_poly, which PyTorch runs as some twenty f32 elementwise kernels (a cast, the
// clamp, the square, a product and a sum for each Horner step, three more and a cast back), each
// writing an f32 intermediate that autograd keeps, and whose backward runs through all of them.
//
// The function, in the bf16 polynomial forms of ops/resample.py:gelu_form (poly15, poly13), on
// every element: y = bf16(gelu_poly<G>(x)), the filtered-GELU pair's own polynomial (gelu.cuh),
// and for the cotangent g, dx = bf16(gelu_poly_vjp<G>(x, g)), g times the derivative formed as
// autograd of the plain version forms it. Both round where the plain version and its autograd
// round, f32 product for product and sum for sum, and to bf16 once at the end, so both are
// bit-equal to them.
//
// What bounds it: 2 bytes read and 2 written an element forward, 4 read and 2 written backward,
// against about 22 f32 instructions forward (the clamp, the square, the Horner steps, the last
// three and the conversions) and about 50 backward (the Horner steps again, then autograd's chain
// back through them): at 3.35 TB/s and 33.5 T instructions/s the bytes bound both, the forward by
// about 1.8 to one and the backward by about 1.2 to one.
//
// Design: one pass over the tensor's storage in memory order, so any layout that is dense and
// non-overlapping (NCHW, channels-last, (n, S, C) tokens) takes it as it is: the caller allocates
// the result with the input's strides. Each thread reads 8 bf16 as one 16-byte word through the
// read-only path, kUnroll words (and, backward, as many of g) in flight before any arithmetic,
// and writes 16-byte words; a grid-stride loop over a grid of at most as many blocks as the card
// holds at once (the SM count × the kernel's occupancy). Storage that does not start on a 16-byte
// boundary: the elements before the first whole word and after the last are done one at a time;
// where x, g and y lie at different offsets from a 16-byte boundary, every element is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entry.cuh"
#include "gelu.cuh"

namespace {

using bf16 = __nv_bfloat16;
using afdm::gelu_poly;
using afdm::gelu_poly_vjp;
using afdm::kGeluPoly13;
using afdm::kGeluPoly15;

constexpr int kThreads = 256;
constexpr int kVec = 8;     // bf16 elements in a 16-byte word
constexpr int kUnroll = 2;  // words a thread has in flight

// Where a call's elements go: [0, head) one at a time, [head, head + 8·words) as 16-byte words,
// the rest one at a time.
struct Span {
  long long n, words;
  int head;
};

__device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ unsigned pack(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16;
}

// One element: the forward's y, or the backward's dx for the cotangent g.
template <int G, bool kBwd>
__device__ __forceinline__ float apply(float x, float g) {
  if constexpr (kBwd) return gelu_poly_vjp<G>(x, g);
  return gelu_poly<G>(x);
}

template <int G, bool kBwd>
__device__ __forceinline__ unsigned apply2(unsigned x, unsigned g) {
  return pack(apply<G, kBwd>(lo(x), lo(g)), apply<G, kBwd>(hi(x), hi(g)));
}

template <int G, bool kBwd>
__device__ __forceinline__ void scalar(const bf16* __restrict__ x, const bf16* __restrict__ g,
                                       bf16* __restrict__ y, long long i) {
  const float xv = __bfloat162float(__ldg(x + i));
  y[i] = __float2bfloat16_rn(apply<G, kBwd>(xv, kBwd ? __bfloat162float(__ldg(g + i)) : 0.f));
}

template <int G, bool kBwd>
__device__ __forceinline__ void pass(const bf16* __restrict__ x, const bf16* __restrict__ g,
                                     bf16* __restrict__ y, Span s) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = tid; i < s.head; i += stride) scalar<G, kBwd>(x, g, y, i);
  const long long tail = s.head + s.words * kVec;
  for (long long i = tail + tid; i < s.n; i += stride) scalar<G, kBwd>(x, g, y, i);

  const uint4* xw = reinterpret_cast<const uint4*>(x + s.head);
  const uint4* gw = kBwd ? reinterpret_cast<const uint4*>(g + s.head) : nullptr;
  uint4* yw = reinterpret_cast<uint4*>(y + s.head);
  for (long long w0 = tid; w0 < s.words; w0 += kUnroll * stride) {
    uint4 xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + u * stride;
      xv[u] = w < s.words ? __ldg(xw + w) : make_uint4(0, 0, 0, 0);
      gv[u] = kBwd && w < s.words ? __ldg(gw + w) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + u * stride;
      if (w < s.words) {
        yw[w] = make_uint4(
            apply2<G, kBwd>(xv[u].x, gv[u].x), apply2<G, kBwd>(xv[u].y, gv[u].y),
            apply2<G, kBwd>(xv[u].z, gv[u].z), apply2<G, kBwd>(xv[u].w, gv[u].w));
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    plain_gelu_fwd_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, Span s) {
  pass<G, false>(x, nullptr, y, s);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    plain_gelu_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          bf16* __restrict__ y, Span s) {
  pass<G, true>(x, g, y, s);
}

// Blocks of `kernel` an SM holds at once, asked of the runtime once an instantiation (the first
// launch runs eagerly, before any CUDA graph captures one); 0 if the runtime cannot say.
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : 0;
}

template <int G, bool kBwd>
cudaError_t launch(const bf16* x, const bf16* g, bf16* y, const Span& s, int sms,
                   cudaStream_t stream) {
  static const int per_sm =
      kBwd ? blocks_per_sm(plain_gelu_bwd_kernel<G>) : blocks_per_sm(plain_gelu_fwd_kernel<G>);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough threads for one word pass (or for the elements done one at a time), at most a wave
  const long long scalars = s.n - s.words * kVec;
  const long long need = s.words / kUnroll + 1 > scalars ? s.words / kUnroll + 1 : scalars;
  const long long wave = static_cast<long long>(sms) * per_sm;
  const long long want = (need + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < wave ? want : wave);
  if constexpr (kBwd) {
    plain_gelu_bwd_kernel<G><<<blocks, kThreads, 0, stream>>>(x, g, y, s);
  } else {
    plain_gelu_fwd_kernel<G><<<blocks, kThreads, 0, stream>>>(x, y, s);
  }
  return cudaGetLastError();
}

template <bool kBwd>
cudaError_t dispatch(int gelu, const bf16* x, const bf16* g, bf16* y, const Span& s, int sms,
                     cudaStream_t stream) {
  switch (gelu) {
    case kGeluPoly15: return launch<kGeluPoly15, kBwd>(x, g, y, s, sms, stream);
    case kGeluPoly13: return launch<kGeluPoly13, kBwd>(x, g, y, s, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Bytes past the last 16-byte boundary.
int misalignment(const void* p) {
  return static_cast<int>(reinterpret_cast<unsigned long long>(p) & 15);
}

}  // namespace

// x (and, for the backward, g) and the result y: n bf16 elements each, in memory order (the three
// laid out alike). gelu: the polynomial form (kGeluPoly15 or kGeluPoly13); sms: the card's SM
// count. g == nullptr launches the forward (y = gelu(x)), otherwise the backward (y = dx). Launches
// one kernel on `stream` and returns its cudaError_t (0 on success); n == 0 launches nothing.
extern "C" int afdm_plain_gelu(const void* x, const void* g, void* y, long long n, int gelu,
                               int sms, void* stream) {
  if (n < 0 || sms < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int off = misalignment(x);
  if (off % 2 != 0) return cudaErrorMisalignedAddress;
  Span s{n, 0, 0};
  if (misalignment(y) == off && (g == nullptr || misalignment(g) == off)) {
    const long long head = (16 - off) % 16 / 2;
    s.head = static_cast<int>(head < n ? head : n);
    s.words = (n - s.head) / kVec;
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = g == nullptr ? dispatch<false>(gelu, xb, gb, yb, s, sms, st)
                                       : dispatch<true>(gelu, xb, gb, yb, s, sms, st);
  return static_cast<int>(err);
}
