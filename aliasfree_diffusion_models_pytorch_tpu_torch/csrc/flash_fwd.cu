// Flash-attention forward for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces the TPU kernel aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py:
// _fwd_kernel (:126-163), as _flash_fwd (:395-444) launches it in "fold" and "stats" mode:
//   logits = q·kᵀ·scale in f32, m = max over keys, p = exp(logits − m), Σ = Σ_j p,
//   out    = (p rounded to the input dtype) · v, accumulated in f32, divided by Σ;
//   "stats" also writes m and Σ as (B·H, 1, S) f32, the TPU kernel's layout.
//
// What bounds it: at the UNet's head dims (D = 8..64) every (query, key) pair costs one exp and
// 4·D flops, while q, k, v and out cross device memory once (4·S·D elements per head). On the
// tensor cores the products are cheap, so the exp unit and the per-pair f32 work of the softmax
// (scale, max, sum, rounding) bound it, not memory bytes.
//
// bf16, the main path: flash_fwd_mma_kernel, FlashAttention-2's shape on mma.sync.
//  * Four warps a block, each owning 16 query rows; their Q fragments are loaded once into
//    registers (the A operand of S = Q·Kᵀ: m16n8k8 at D = 8, m16n8k16 above).
//  * K and V stream through two shared-memory buffers of 64 rows, filled by cp.async 16 bytes a
//    thread (the next tile in flight while this one is used; rows past S zero-filled), rows
//    padded to an odd number of 16-byte units; ldmatrix gives the B fragments of Kᵀ and
//    ldmatrix.trans those of V.
//  * Online softmax in the accumulators, in the exp2 domain: scale·log2e is folded into one
//    FFMA per pair before MUFU.EX2; the row max takes two quad shuffles per tile; the output
//    accumulators are rescaled once per tile. P is rounded to bf16 in registers and is already
//    the A operand of O += P·V. Σ sums the unrounded f32 p, as the TPU kernel does; the
//    division by Σ comes last. Stats mode stores m in natural units (m₂·ln 2).
//  * Small S: a block takes several (b, h) so that no warp idles on rows past S: one warp per
//    head and four heads a block at S <= 16, two and two at S <= 32, else one head and 64 query
//    rows a block. The launch plan is computed in Python (ops/flash_attention.py:fwd_plan) and
//    checked here. Keys past S get −inf logits; queries past S are computed from zero rows and
//    never stored.
//
// f32: flash_fwd_kernel, the CUDA-core kernel of the first port, unchanged: one thread per query
// row, f32 arithmetic throughout, __expf. It is the exact path the f32 checks hold against the
// CPU. A bf16 tensor never reaches it.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------------------------

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* m,
                       float* l, int bh, int s, float scale, cudaStream_t stream) {
  const int q_tiles = (s + kBlockQ - 1) / kBlockQ;
  const long long blocks = static_cast<long long>(bh) * q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<float, D><<<static_cast<unsigned>(blocks), kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), m, l, s, q_tiles, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 64;  // rows of K (and of V) per shared-memory tile, all heads together
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// kHeads (b, h) per block, kTileRows / kHeads keys of each per tile, 4 / kHeads warps per head.
template <int D, int kHeads>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out, int bh, int s,
                         int q_tiles, float scale_log2) {
  constexpr int kKeys = kTileRows / kHeads;
  constexpr int kWarpsPerHead = kWarps / kHeads;
  constexpr int kT = afdm::smem_stride<D>();
  constexpr int kSteps = D == 8 ? 1 : D / 16;  // MMAs along the depth of Q·Kᵀ
  constexpr int kN = kKeys / 8;                // n-tiles of logits per warp and tile
  constexpr int kO = D / 8;                    // n-tiles of the output
  constexpr int kRowChunks = D / 8;            // 16-byte chunks per row
  __shared__ __align__(16) bf16 ks[2][kTileRows * kT];
  __shared__ __align__(16) bf16 vs[2][kTileRows * kT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = lane >> 2, quad = lane & 3;
  const int head0 = (blockIdx.x / q_tiles) * kHeads;
  const int head = head0 + warp / kWarpsPerHead;
  const bool head_ok = head < bh;
  const int row0 = (blockIdx.x % q_tiles) * (16 * kWarpsPerHead) + (warp % kWarpsPerHead) * 16;
  const int hr = (warp / kWarpsPerHead) * kKeys;  // this warp's head's rows in a tile
  const size_t hbase = static_cast<size_t>(head_ok ? head : 0) * s * D;

  // Rows r of a tile: head head0 + r / kKeys, key k0 + r % kKeys; zeros past S or past B·H.
  auto load_tile = [&](int buf, int k0) {
    for (int c = tid; c < kTileRows * kRowChunks; c += kThreads) {
      const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
      const int hh = head0 + r / kKeys, key = k0 + r % kKeys;
      const bool ok = hh < bh && key < s;
      const size_t off = ok ? (static_cast<size_t>(hh) * s + key) * D + col : 0;
      afdm::cp_async_16(&ks[buf][r * kT + col], k + off, ok ? 16 : 0);
      afdm::cp_async_16(&vs[buf][r * kT + col], v + off, ok ? 16 : 0);
    }
  };

  load_tile(0, 0);
  afdm::cp_async_commit();

  // Q fragments of this warp's rows ra = row0 + group and rb = ra + 8 (zeros past S).
  const int ra = row0 + group, rb = ra + 8;
  const bool ra_ok = head_ok && ra < s, rb_ok = head_ok && rb < s;
  const bf16* qa = q + hbase + static_cast<size_t>(ra_ok ? ra : 0) * D + 2 * quad;
  const bf16* qb = q + hbase + static_cast<size_t>(rb_ok ? rb : 0) * D + 2 * quad;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    qf[t][0] = ra_ok ? afdm::ld_pair(qa + 16 * t) : 0u;
    qf[t][1] = rb_ok ? afdm::ld_pair(qb + 16 * t) : 0u;
    if constexpr (D != 8) {
      qf[t][2] = ra_ok ? afdm::ld_pair(qa + 16 * t + 8) : 0u;
      qf[t][3] = rb_ok ? afdm::ld_pair(qb + 16 * t + 8) : 0u;
    }
  }

  float o[kO][4];
#pragma unroll
  for (int n = 0; n < kO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m2[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of logit·scale·log2e, rows ra, rb
  float l[2] = {0.f, 0.f};                        // this thread's share of Σ, rows ra, rb

  const int n_tiles = (s + kKeys - 1) / kKeys;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile((it + 1) & 1, (it + 1) * kKeys);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks[it & 1] + hr * kT;
    const bf16* vt = vs[it & 1] + hr * kT;

    // S = Q·Kᵀ: 16 rows × kKeys keys, raw f32 logits.
    float sc[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      if constexpr (D == 8) {
        uint32_t b[2];
        afdm::ldmatrix_x2(b, kt + (8 * j + (lane & 15)) * kT);
        afdm::mma_m16n8k8(sc[j], qf[0][0], qf[0][1], b[0], sc[j]);
        afdm::mma_m16n8k8(sc[j + 1], qf[0][0], qf[0][1], b[1], sc[j + 1]);
      } else {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          uint32_t b[4];
          afdm::ldsm_b_nk(b, kt, kT, 8 * j, 16 * t, lane);
          afdm::mma_m16n8k16(sc[j], qf[t], b[0], b[1], sc[j]);
          afdm::mma_m16n8k16(sc[j + 1], qf[t], b[2], b[3], sc[j + 1]);
        }
      }
    }
    const int k0 = it * kKeys;
    if (k0 + kKeys > s) {  // the last tile: keys past S get −inf
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * j + 2 * quad + (e & 1) >= s) sc[j][e] = -CUDART_INF_F;
        }
      }
    }

    // Row max (a tile holds a real key, so it is finite), then rescale the running sums.
    float mneg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kN; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[h], mx * scale_log2);
      const float alpha = afdm::ex2(m2[h] - m_new);  // 0 on the first tile (m2 = −inf)
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < kO; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
      m2[h] = m_new;
      mneg[h] = -m_new;
    }

    // p = 2^(s·scale·log2e − m₂), one FFMA and one EX2; P in bf16 is the A operand of O += P·V.
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float(&c)[4] = sc[2 * kk + half];
        const float p0 = afdm::ex2(fmaf(c[0], scale_log2, mneg[0]));
        const float p1 = afdm::ex2(fmaf(c[1], scale_log2, mneg[0]));
        const float p2 = afdm::ex2(fmaf(c[2], scale_log2, mneg[1]));
        const float p3 = afdm::ex2(fmaf(c[3], scale_log2, mneg[1]));
        l[0] += p0 + p1;  // unrounded, as the TPU kernel sums
        l[1] += p2 + p3;
        pa[2 * half] = afdm::pack_bf16(p0, p1);      // row ra, keys 8·half + 2·quad, +1
        pa[2 * half + 1] = afdm::pack_bf16(p2, p3);  // row rb
      }
      if constexpr (D == 8) {
        uint32_t b[2];
        afdm::ldsm_b_kn8(b, vt, kT, 16 * kk, 0, lane);
        afdm::mma_m16n8k16(o[0], pa, b[0], b[1], o[0]);
      } else {
#pragma unroll
        for (int u = 0; u < kO / 2; ++u) {
          uint32_t b[4];
          afdm::ldsm_b_kn(b, vt, kT, 16 * kk, 16 * u, lane);
          afdm::mma_m16n8k16(o[2 * u], pa, b[0], b[1], o[2 * u]);
          afdm::mma_m16n8k16(o[2 * u + 1], pa, b[2], b[3], o[2 * u + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before the next prefetch fills it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (!(h ? rb_ok : ra_ok)) continue;
    bf16* orow = out + hbase + static_cast<size_t>(row) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < kO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          afdm::pack_bf16(o[n][2 * h] / l[h], o[n][2 * h + 1] / l[h]);
    }
    if (m_out != nullptr && quad == 0) {
      const size_t srow = static_cast<size_t>(head) * s + row;
      m_out[srow] = m2[h] * kLn2;
      l_out[srow] = l[h];
    }
  }
}

template <int D, int kHeads>
cudaError_t launch_mma_heads(const void* q, const void* k, const void* v, void* out, float* m,
                             float* l, int bh, int s, float scale, cudaStream_t stream) {
  // One head and 64 query rows a block, or kHeads heads of at most 64 / kHeads rows.
  if (kHeads > 1 && s > kTileRows / kHeads) return cudaErrorInvalidValue;
  const int q_tiles = kHeads > 1 ? 1 : (s + kTileRows - 1) / kTileRows;
  const long long blocks = static_cast<long long>((bh + kHeads - 1) / kHeads) * q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_mma_kernel<D, kHeads><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), m, l, bh, s, q_tiles, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* m,
                       float* l, int bh, int s, float scale, int heads, cudaStream_t stream) {
  switch (heads) {
    case 1: return launch_mma_heads<D, 1>(q, k, v, out, m, l, bh, s, scale, stream);
    case 2: return launch_mma_heads<D, 2>(q, k, v, out, m, l, bh, s, scale, stream);
    case 4: return launch_mma_heads<D, 4>(q, k, v, out, m, l, bh, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (bh, s, d) arrays of f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), bf16
// rows 16-byte aligned. m, l: (bh, s) f32 arrays for the softmax max and sum, or both null.
// heads_per_block: 1, 2 or 4 (bf16 only; 1 for f32), from ops/flash_attention.py:fwd_plan.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int afdm_flash_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                              void* l, int bh, int s, int d, float scale, int is_bf16,
                              int heads_per_block, void* stream) {
  if (bh < 1 || s < 1 || (m == nullptr) != (l == nullptr)) return cudaErrorInvalidValue;
  if (!is_bf16 && heads_per_block != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  const int hp = heads_per_block;
  switch (d) {
    case 8:
      return is_bf16 ? launch_mma<8>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<8>(q, k, v, out, mf, lf, bh, s, scale, st);
    case 16:
      return is_bf16 ? launch_mma<16>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<16>(q, k, v, out, mf, lf, bh, s, scale, st);
    case 32:
      return is_bf16 ? launch_mma<32>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<32>(q, k, v, out, mf, lf, bh, s, scale, st);
    case 64:
      return is_bf16 ? launch_mma<64>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<64>(q, k, v, out, mf, lf, bh, s, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* afdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
