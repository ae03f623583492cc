// Elementwise op-chain probe for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces the TPU probe kernel benchmarks/exp_micro.py: kern (:96-100), as build (:102-114)
// launches it over a (64, 1024, 1024) f32 array: per element, `chain` times,
//   acc = op(acc) - 1
// with op one of the probe's ten (copy, mul2, poly4, exp, exp2, fastexp2, tanh, erf, rsqrt1p,
// logistic; :57-89, :125-136) and one more, exp_fast = __expf, the exponential of the f32
// kernels of flash_fwd.cu and flash_bwd.cu (their bf16 kernels take exp2). The probe answers
// what one exponential costs on this card beside a polynomial on the FMA units: per-application
// cost is read off the slope against `copy`.
//
// What bounds it: every element is read once and written once (8 bytes), so a single pass is
// bound by memory bytes; sixteen chained applications make the arithmetic dominate for every op
// but copy and mul2: the special-function unit (one MUFU result per exp2/rsqrt/tanh, 16 per SM
// and clock) for the transcendental ops, the FMA pipes for poly4 and fastexp2.
//
// Design: one kernel template over (op, chain, subtract). chain = 16 is unrolled at compile
// time; any other length runs the same body in a runtime loop. Loads and stores are float4
// (16 bytes a thread, neighbouring threads on neighbouring addresses) in a grid-stride loop; the
// four lanes of a float4 are four independent chains, which hides the latency of the
// special-function unit. A tail of n % 4 elements takes the scalar path. subtract = false with
// chain = 1 is the single application that the accuracy line of the probe needs.
//
// Built WITHOUT --use_fast_math: that flag would turn expf into __expf and merge two rows.

#include <cuda_runtime.h>

#include "entry.cuh"

namespace {

enum Op {
  kCopy = 0, kMul2, kPoly4, kExp, kExp2, kFastExp2, kTanh, kErf, kRsqrt1p, kLogistic, kExpFast,
  kNumOps
};

template <int OP>
__device__ __forceinline__ float apply(float v) {
  if constexpr (OP == kCopy) {
    return v;
  } else if constexpr (OP == kMul2) {
    return v * 2.0f;
  } else if constexpr (OP == kPoly4) {
    // four chained FMAs: a yardstick of known arithmetic count
    float acc = v;
    acc = fmaf(acc, v, 0.5f);
    acc = fmaf(acc, v, 0.25f);
    acc = fmaf(acc, v, 0.125f);
    acc = fmaf(acc, v, 0.0625f);
    return acc;
  } else if constexpr (OP == kExp) {
    return expf(v);
  } else if constexpr (OP == kExp2) {
    return exp2f(v);
  } else if constexpr (OP == kFastExp2) {
    // exp(x) = 2^(x·log2e); n = round-half-even(y), f = y − n in [−0.5, 0.5];
    // 2^f by the probe's degree-3 polynomial; 2^n by adding n into the exponent field.
    // __fmul_rn keeps y a rounded f32 product (no contraction into y − n), as the plain
    // version computes it.
    const float y = __fmul_rn(v, 1.4426950408889634f);
    const float n = rintf(y);
    const float f = y - n;
    float p = fmaf(0.05550410866f, f, 0.2402265069f);
    p = fmaf(p, f, 0.6931471806f);
    p = fmaf(p, f, 1.0f);
    // Below about −87 the biased exponent is negative and its shift reaches the sign bit,
    // exactly as the int32 arithmetic of the JAX form does.
    const unsigned biased = static_cast<unsigned>(static_cast<int>(n) + 127) << 23;
    return p * __uint_as_float(biased);
  } else if constexpr (OP == kTanh) {
    return tanhf(v);
  } else if constexpr (OP == kErf) {
    return erff(v);
  } else if constexpr (OP == kRsqrt1p) {
    return rsqrtf(1.0f + v * v);
  } else if constexpr (OP == kLogistic) {
    return 1.0f / (1.0f + expf(-v));
  } else {
    return __expf(v);
  }
}

template <int OP, int CHAIN, bool SUB>
__device__ __forceinline__ float run_chain(float acc, int chain) {
  if constexpr (CHAIN > 0) {
#pragma unroll
    for (int i = 0; i < CHAIN; ++i) {
      acc = apply<OP>(acc);
      if constexpr (SUB) acc -= 1.0f;  // keeps the domain <= 0 for the exp variants
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
      acc = apply<OP>(acc);
      if constexpr (SUB) acc -= 1.0f;
    }
  }
  return acc;
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <int OP, int CHAIN, bool SUB>
__global__ void __launch_bounds__(kThreads)
    exp_chain_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                     int chain) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    float4 v = x4[i];
    v.x = run_chain<OP, CHAIN, SUB>(v.x, chain);
    v.y = run_chain<OP, CHAIN, SUB>(v.y, chain);
    v.z = run_chain<OP, CHAIN, SUB>(v.z, chain);
    v.w = run_chain<OP, CHAIN, SUB>(v.w, chain);
    out4[i] = v;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    out[i] = run_chain<OP, CHAIN, SUB>(x[i], chain);
  }
}

template <int OP, int CHAIN, bool SUB>
cudaError_t launch(const float* x, float* out, long long n, int chain, int sms,
                   cudaStream_t stream) {
  const long long n4 = n / 4 > 0 ? n / 4 : 1;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  exp_chain_kernel<OP, CHAIN, SUB>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, out, n, chain);
  return cudaGetLastError();
}

template <int OP>
cudaError_t dispatch_chain(const float* x, float* out, long long n, int chain, bool subtract,
                           int sms, cudaStream_t stream) {
  if (chain == 16) {
    return subtract ? launch<OP, 16, true>(x, out, n, chain, sms, stream)
                    : launch<OP, 16, false>(x, out, n, chain, sms, stream);
  }
  return subtract ? launch<OP, 0, true>(x, out, n, chain, sms, stream)
                  : launch<OP, 0, false>(x, out, n, chain, sms, stream);
}

}  // namespace

// x, out: n contiguous f32 values on the current device, both 16-byte aligned, not
// overlapping. op: the index of the op in ops/probes.py:OPS. sms: the card's SM count (the grid
// is at most kBlocksPerSm blocks an SM).
// Returns a cudaError_t (0 = launched).
extern "C" int afdm_exp_chain(const void* x, void* out, long long n, int op, int chain,
                              int subtract, int sms, void* stream) {
  if (n < 1 || chain < 0 || op < 0 || op >= kNumOps || sms < 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sub = subtract != 0;
  switch (op) {
    case kCopy: return dispatch_chain<kCopy>(xi, o, n, chain, sub, sms, st);
    case kMul2: return dispatch_chain<kMul2>(xi, o, n, chain, sub, sms, st);
    case kPoly4: return dispatch_chain<kPoly4>(xi, o, n, chain, sub, sms, st);
    case kExp: return dispatch_chain<kExp>(xi, o, n, chain, sub, sms, st);
    case kExp2: return dispatch_chain<kExp2>(xi, o, n, chain, sub, sms, st);
    case kFastExp2: return dispatch_chain<kFastExp2>(xi, o, n, chain, sub, sms, st);
    case kTanh: return dispatch_chain<kTanh>(xi, o, n, chain, sub, sms, st);
    case kErf: return dispatch_chain<kErf>(xi, o, n, chain, sub, sms, st);
    case kRsqrt1p: return dispatch_chain<kRsqrt1p>(xi, o, n, chain, sub, sms, st);
    case kLogistic: return dispatch_chain<kLogistic>(xi, o, n, chain, sub, sms, st);
    default: return dispatch_chain<kExpFast>(xi, o, n, chain, sub, sms, st);
  }
}
