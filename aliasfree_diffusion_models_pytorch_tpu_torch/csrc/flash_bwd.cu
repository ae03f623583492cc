// Flash-attention backward for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces both TPU backward kernels of
// aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py: _bwd_kernel (:166-254, the
// monolithic recompute backward for S <= 1024, launched by _flash_bwd :447-503) and
// _bwd_kernel_strips (:269-338, the query-strip backward for S > 1024, launched by
// _flash_bwd_strips :341-392). With the forward's saved softmax stats (m = row max, l = Σ):
//   logits = q·kᵀ·scale (f32);  P = exp(logits − m), unnormalised, rounded to the input dtype;
//   δ  = rowsum(g ⊙ out) in f32;
//   dV = Pᵀ·(g/l);   dP = g·vᵀ;   dS = P ⊙ ((dP − δ)/l), rounded to the input dtype;
//   dQ = dS·k·scale;  dK = dSᵀ·q·scale;  every product accumulates in f32 and dQ, dK, dV are
//   cast to the input dtype once, at the end.
//
// What bounds it: at the UNet's head dims (D = 8..64) every (query, key) pair costs one exp and
// 10·D flops over five small products, while q, k, v, out, g, dQ, dK, dV cross device memory
// once (8·S·D elements per head). So the exp unit and the f32 multiply-adds bound it, not
// memory bytes, and not the tensor cores, which this first version does not use.
//
// Design, simple before fast. On the TPU the strip grid runs in order and dK/dV accumulate in
// a resident output block; on Hopper blocks run in no order, so the work is split into two
// kernels, neither of which needs atomics, and one code path covers every S:
//  * flash_bwd_dq_kernel: one block per (b·h, tile of 64 queries), one thread per query row
//    holding its q row, g row and f32 dQ accumulator in registers; K and V stream through
//    shared memory 32 keys at a time. It also writes δ (one f32 per query) for the second kernel.
//  * flash_bwd_dkv_kernel: one block per (b·h, tile of 64 keys), one thread per key row holding
//    its k row, v row and the f32 dK and dV accumulators in registers for the whole loop over
//    query tiles (32 queries with their m, 1/l and δ in shared memory), written once. That is
//    the f32 accumulation across query strips of the TPU strip kernel.
// Both recompute P from the saved m with the forward's own multiply-add order, so the
// recomputed logits equal the forward's bit for bit. The pair costs two exps per (query, key).
// A ragged last tile is masked: its loop stops at the last real row. Tensor cores, TMA, exp2
// and sharing one exp between the two kernels are later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // rows per block, one per thread (queries for dQ, keys for dK/dV)
constexpr int kTile = 32;  // rows of the other operand per shared-memory tile

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
  // P and dS take the input dtype before the products that consume them, as on the TPU.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ out, const T* __restrict__ g,
                        const float* __restrict__ m, const float* __restrict__ l,
                        T* __restrict__ dq, float* __restrict__ delta, int s, int tiles,
                        float scale) {
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kRows + threadIdx.x;
  const bool valid = row < s;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t roff = base + static_cast<size_t>(row) * D;
  const size_t srow = static_cast<size_t>(bh) * s + row;

  float qr[D];
  float gr[D];
  float acc[D];
  float dl = 0.f;  // δ = Σ_d g·out of this query row
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? Io<T>::load(q + roff + d) : 0.f;
    gr[d] = valid ? Io<T>::load(g + roff + d) : 0.f;
    acc[d] = 0.f;
    if (valid) dl = fmaf(gr[d], Io<T>::load(out + roff + d), dl);
  }
  // A thread past the last row keeps m = 0 and 1/l = 0: its dS is 0·finite, never stored.
  const float mi = valid ? m[srow] : 0.f;
  const float inv_l = valid ? 1.f / l[srow] : 0.f;
  if (valid) delta[srow] = dl;

  for (int k0 = 0; k0 < s; k0 += kTile) {
    const int nk = min(kTile, s - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      const size_t off = base + static_cast<size_t>(k0 + j) * D + d;
      ks[j][d] = j < nk ? Io<T>::load(k + off) : 0.f;
      vs[j][d] = j < nk ? Io<T>::load(v + off) : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {  // stops at the last real key: no masked term is formed
      float dot = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qr[d], ks[j][d], dot);  // the forward's order: the same logits, bit for bit
        dp = fmaf(gr[d], vs[j][d], dp);
      }
      const float p = Io<T>::round(__expf(dot * scale - mi));
      const float ds = Io<T>::round(p * ((dp - dl) * inv_l));
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }

  if (!valid) return;
#pragma unroll
  for (int d = 0; d < D; ++d) Io<T>::store(dq + roff + d, acc[d] * scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int s, int tiles, float scale) {
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float gs[kTile][D];
  __shared__ float ms[kTile];   // row max of the forward
  __shared__ float ils[kTile];  // 1 / Σ of the forward
  __shared__ float dls[kTile];  // δ from the dQ kernel

  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kRows + threadIdx.x;
  const bool valid = row < s;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t roff = base + static_cast<size_t>(row) * D;
  const size_t sbase = static_cast<size_t>(bh) * s;

  // A thread past the last key keeps zero rows; what it accumulates is never stored.
  float kr[D];
  float vr[D];
  float dka[D];
  float dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = valid ? Io<T>::load(k + roff + d) : 0.f;
    vr[d] = valid ? Io<T>::load(v + roff + d) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int q0 = 0; q0 < s; q0 += kTile) {
    const int nq = min(kTile, s - q0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * D; i += kRows) {
      const int r = i / D;
      const int d = i % D;
      const size_t off = base + static_cast<size_t>(q0 + r) * D + d;
      qs[r][d] = r < nq ? Io<T>::load(q + off) : 0.f;
      gs[r][d] = r < nq ? Io<T>::load(g + off) : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool in = r < nq;
      ms[r] = in ? m[sbase + q0 + r] : 0.f;
      ils[r] = in ? 1.f / l[sbase + q0 + r] : 0.f;
      dls[r] = in ? delta[sbase + q0 + r] : 0.f;
    }
    __syncthreads();

    for (int r = 0; r < nq; ++r) {  // stops at the last real query
      float dot = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qs[r][d], kr[d], dot);  // the forward's order: the same logits
        dp = fmaf(gs[r][d], vr[d], dp);
      }
      const float p = Io<T>::round(__expf(dot * scale - ms[r]));
      const float w = p * ils[r];  // dV = Pᵀ·(g/l): the 1/l goes with the weight
      const float ds = Io<T>::round(p * ((dp - dls[r]) * ils[r]));
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(w, gs[r][d], dva[d]);
        dka[d] = fmaf(ds, qs[r][d], dka[d]);
      }
    }
  }

  if (!valid) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    Io<T>::store(dk + roff + d, dka[d] * scale);
    Io<T>::store(dv + roff + d, dva[d]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* g,
                   const float* m, const float* l, void* dq, void* dk, void* dv, float* delta,
                   int bh, int s, float scale, cudaStream_t stream) {
  const int tiles = (s + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(bh) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  flash_bwd_dq_kernel<T, D><<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), gt, m, l, static_cast<T*>(dq), delta, s, tiles,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Same stream: the dK/dV kernel starts after δ is written.
  flash_bwd_dkv_kernel<T, D><<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(
      qt, kt, vt, gt, m, l, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const void* out,
                              const void* g, const float* m, const float* l, void* dq, void* dk,
                              void* dv, float* delta, int bh, int s, int d, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, out, g, m, l, dq, dk, dv, delta, bh, s, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, g, m, l, dq, dk, dv, delta, bh, s, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, g, m, l, dq, dk, dv, delta, bh, s, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, g, m, l, dq, dk, dv, delta, bh, s, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out, g (inputs) and dq, dk, dv (outputs): contiguous (bh, s, d) arrays of f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1). m, l: the forward's (bh, s) f32 softmax max and sum.
// delta: (bh, s) f32 scratch. Launches both kernels on `stream` and returns the first failed
// launch's cudaError_t (0 on success).
extern "C" int afdm_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* g, const void* m, const void* l, void* dq, void* dk,
                              void* dv, void* delta, int bh, int s, int d, float scale,
                              int is_bf16, void* stream) {
  if (bh < 1 || s < 1 || m == nullptr || l == nullptr || delta == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(delta);
  cudaError_t err =
      is_bf16 ? dispatch_head_dim<__nv_bfloat16>(q, k, v, out, g, mf, lf, dq, dk, dv, df, bh, s,
                                                 d, scale, st)
              : dispatch_head_dim<float>(q, k, v, out, g, mf, lf, dq, dk, dv, df, bh, s, d,
                                         scale, st);
  return static_cast<int>(err);
}

extern "C" const char* afdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
