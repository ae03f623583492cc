// Flash-attention forward for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces the TPU kernel aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py:
// _fwd_kernel (:126-163), as _flash_fwd (:395-444) launches it in "fold" and "stats" mode:
//   logits = q·kᵀ·scale in f32, m = max over keys, p = exp(logits − m), Σ = Σ_j p,
//   out    = (p rounded to the input dtype) · v, accumulated in f32, divided by Σ;
//   "stats" also writes m and Σ as (B·H, 1, S) f32, the TPU kernel's layout.
//
// What bounds it: at the UNet's head dims (D = 8..32) every (query, key) pair costs one exp and
// 2·D multiply-adds, while q, k, v and out cross device memory once (4·S·D elements per head).
// So the exp unit and the f32 multiply-adds bound it, not memory bytes, and not the tensor
// cores, which this first version does not use.
//
// Design, simple before fast: one block per (b·h, tile of 64 query rows), one thread per query
// row holding its q row and its f32 output accumulator in registers. K and V stream through
// shared memory 32 keys at a time, converted to f32 once on load; every thread of a warp reads
// the same shared address (a broadcast). An online softmax (running max and sum, the
// accumulator rescaled once per tile) makes any S work. A ragged last tile is masked with −inf
// scores and zero rows. Tensor cores (mma.sync / wgmma, with D = 8 padded to k = 16), TMA and
// exp2 with a folded log2e are later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 32;  // keys per shared-memory tile

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
  }
  // p.astype(input dtype) before the PV product, as the TPU kernel does.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                     int s, int q_tiles, float scale) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int bh = blockIdx.x / q_tiles;
  const int row = (blockIdx.x % q_tiles) * kBlockQ + threadIdx.x;
  const bool valid = row < s;
  const size_t base = static_cast<size_t>(bh) * s * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? Io<T>::load(q + base + static_cast<size_t>(row) * D + d) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F;  // running max of the scaled logits
  float l = 0.f;            // running Σ exp(logit − m), unrounded f32

  for (int k0 = 0; k0 < s; k0 += kBlockK) {
    const int nk = min(kBlockK, s - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D;
      const int d = i % D;
      const size_t off = base + static_cast<size_t>(k0 + j) * D + d;
      ks[j][d] = j < nk ? Io<T>::load(k + off) : 0.f;
      vs[j][d] = j < nk ? Io<T>::load(v + off) : 0.f;
    }
    __syncthreads();

    float sc[kBlockK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      sc[j] = j < nk ? dot * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: the tile holds at least one key
    const float alpha = __expf(m - m_new);   // 0 on the first tile (m = −inf)
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = __expf(sc[j] - m_new);  // 0 for a masked key
      l += p;
      const float pr = Io<T>::round(p);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (!valid) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    Io<T>::store(out + base + static_cast<size_t>(row) * D + d, acc[d] / l);
  }
  if (m_out != nullptr) {
    const size_t srow = static_cast<size_t>(bh) * s + row;
    m_out[srow] = m;
    l_out[srow] = l;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                   int bh, int s, float scale, cudaStream_t stream) {
  const int q_tiles = (s + kBlockQ - 1) / kBlockQ;
  const long long blocks = static_cast<long long>(bh) * q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<static_cast<unsigned>(blocks), kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), m, l, s, q_tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, float* m,
                              float* l, int bh, int s, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, out, m, l, bh, s, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, m, l, bh, s, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, m, l, bh, s, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, m, l, bh, s, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (bh, s, d) arrays of f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// m, l: (bh, s) f32 arrays for the softmax max and sum, or both null.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int afdm_flash_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                              void* l, int bh, int s, int d, float scale, int is_bf16,
                              void* stream) {
  if (bh < 1 || s < 1 || (m == nullptr) != (l == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaError_t err =
      is_bf16 ? dispatch_head_dim<__nv_bfloat16>(q, k, v, out, mf, lf, bh, s, d, scale, st)
              : dispatch_head_dim<float>(q, k, v, out, mf, lf, bh, s, d, scale, st);
  return static_cast<int>(err);
}

extern "C" const char* afdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
