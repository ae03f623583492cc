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
// once (8·S·D elements per head). On the tensor cores the products are cheap, so the exp unit
// and the per-pair f32 work (scale, exp, two roundings, dS) bound it, not memory bytes.
//
// bf16, the main path: three kernels on one stream, FlashAttention-2's backward on mma.sync.
//  * flash_bwd_prep_kernel, one thread per query row, bound by bytes: δ = rowsum(g ⊙ out) in f32;
//    the row's constants (−m·log2e, 1/Σ, −δ/Σ) as one float4; g/Σ rounded to bf16; and zeros
//    into the f32 dQ scratch, so no memset runs outside the flash_bwd kernels.
//  * flash_bwd_mma_kernel, one block per (b·h, tile of 64 keys), four warps of 16 keys. A warp's
//    K and V fragments sit in registers for the whole loop and its dK, dV accumulators in f32
//    registers; the loop over query tiles of 64 takes the place of the TPU's sequential strip
//    axis. Each query tile (Q, g, g/Σ, the float4 constants) is double-buffered through shared
//    memory by cp.async (rows past S zero-filled), rows padded to an odd number of 16-byte units.
//    Per 16 queries, key-major: Sᵀ = K·Qᵀ in the accumulators (m16n8k8 at D = 8, m16n8k16
//    above); Pᵀ = 2^(Sᵀ·scale·log2e − m·log2e), one FFMA and one EX2 per pair, the only exp of
//    the pair; Pᵀ rounded to bf16 in registers is already the A operand of dV += Pᵀ·(g/Σ);
//    dPᵀ = V·gᵀ; dSᵀ = Pᵀ ⊙ (dPᵀ·(1/Σ) − δ/Σ) rounded to bf16 is the A operand of dK += dSᵀ·Q.
//    dQ += dS·K needs dS as the A operand of the other orientation: each warp stages its dSᵀ in
//    shared memory, and after a barrier warp w reads queries 16w..16w+15 back with
//    ldmatrix.trans, multiplies them by the block's K tile (kept in shared memory) and adds the
//    f32 result into the dQ scratch with vector atomics. Blocks of one head start their loop at
//    different query tiles, so their atomics meet on different rows.
//  * flash_bwd_dq_cast_kernel: dQ = scratch·scale, rounded to bf16.
//  Ragged edges: keys past S and queries past S get P = 0 explicitly (their rows are zeros);
//  nothing past S is stored or added.
//
// Rounding points of the bf16 path against the plain version (ops/flash_attention.py:
// attention_backward_reference, which stays as it is):
//  1. dV's operand: the tensor cores take bf16, so g/Σ is rounded to bf16 (in the pre-pass)
//     where the plain version multiplies bf16 P by an f32 g/Σ: one more rounding per term.
//  2. The recomputed logits are no longer the forward's bit for bit: the forward forms Q·Kᵀ and
//     this kernel K·Qᵀ, each through the tensor cores' own adder, and m arrives in natural units
//     and is multiplied by log2e here, so P may exceed 1 by an ulp; that is harmless.
//  3. dQ is summed with atomics in an order that changes from run to run, so bf16 dQ varies in
//     its last bits between runs. dK and dV are sums in registers in a fixed order.
//  4. cp.async needs 16-byte-aligned rows (a D = 8 bf16 row is 16 bytes); the wrapper raises on a
//     misaligned tensor.
//
// f32: flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the CUDA-core kernels of the first port,
// unchanged and deterministic: one thread per query row (dQ, and δ) and one per key row (dK, dV),
// f32 arithmetic throughout, each recomputing P with __expf (two exps per pair). They are the
// exact path the f32 checks hold against the CPU. A bf16 tensor never reaches them.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------------------------
// f32: the CUDA-core kernels
// ---------------------------------------------------------------------------------------------

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* out,
                       const void* g, const float* m, const float* l, void* dq, void* dk,
                       void* dv, float* delta, int bh, int s, float scale, cudaStream_t stream) {
  using T = float;
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

// ---------------------------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyBlock = 16 * kWarps;  // keys per block, 16 per warp
constexpr int kQTile = 64;              // queries per tile of the loop
constexpr int kDsStride = kQTile + 8;   // dSᵀ rows in shared memory: nine 16-byte units
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of dynamic shared memory of flash_bwd_mma_kernel<D>: two buffers of the query tile's
// constants, Q, g and g/Σ; the block's K tile; the dSᵀ tile.
template <int D>
constexpr int bwd_smem_bytes() {
  constexpr int kT = afdm::smem_stride<D>();
  return 2 * kQTile * 16 + 3 * 2 * kQTile * kT * 2 + kKeyBlock * kT * 2 +
         kKeyBlock * kDsStride * 2;
}

template <int D>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_prep_kernel(const bf16* __restrict__ out, const bf16* __restrict__ g,
                          const float* __restrict__ m, const float* __restrict__ l,
                          float4* __restrict__ consts, bf16* __restrict__ g_scaled,
                          float* __restrict__ dq_acc, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (row >= rows) return;
  const uint4* gr = reinterpret_cast<const uint4*>(g + row * D);
  const uint4* orow = reinterpret_cast<const uint4*>(out + row * D);
  uint4* gsr = reinterpret_cast<uint4*>(g_scaled + row * D);
  float4* dqr = reinterpret_cast<float4*>(dq_acc + row * D);
  const float inv = 1.f / l[row];
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 gc = gr[c], oc = orow[c];  // eight bf16 values each, two a register
    const uint32_t gw[4] = {gc.x, gc.y, gc.z, gc.w}, ow[4] = {oc.x, oc.y, oc.z, oc.w};
    uint32_t sw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      delta = fmaf(afdm::bf16_lo(gw[i]), afdm::bf16_lo(ow[i]), delta);
      delta = fmaf(afdm::bf16_hi(gw[i]), afdm::bf16_hi(ow[i]), delta);
      sw[i] = afdm::pack_bf16(afdm::bf16_lo(gw[i]) * inv, afdm::bf16_hi(gw[i]) * inv);
    }
    gsr[c] = make_uint4(sw[0], sw[1], sw[2], sw[3]);
    dqr[2 * c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dqr[2 * c + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  consts[row] = make_float4(-m[row] * kLog2e, inv, -delta * inv, 0.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const bf16* __restrict__ g_scaled, const float4* __restrict__ consts,
                         float* __restrict__ dq_acc, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int s, int k_blocks, float scale,
                         float scale_log2) {
  constexpr int kT = afdm::smem_stride<D>();
  constexpr int kSteps = D == 8 ? 1 : D / 16;  // MMAs along the depth of K·Qᵀ and V·gᵀ
  constexpr int kO = D / 8;                    // n-tiles of dK, dV and dQ
  constexpr int kRowChunks = D / 8;            // 16-byte chunks per row
  constexpr int kTileElems = kQTile * kT;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cs = reinterpret_cast<float4*>(smem);           // [2][kQTile] row constants
  bf16* qs = reinterpret_cast<bf16*>(cs + 2 * kQTile);    // [2][kQTile × kT] Q
  bf16* gs = qs + 2 * kTileElems;                         // [2][...] g
  bf16* ss = gs + 2 * kTileElems;                         // [2][...] g/Σ
  bf16* ks = ss + 2 * kTileElems;                         // [kKeyBlock × kT] the block's K
  bf16* dst = ks + kKeyBlock * kT;                        // [kKeyBlock × kDsStride] dSᵀ

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = lane >> 2, quad = lane & 3;
  const int bh = blockIdx.x / k_blocks;
  const int kb = blockIdx.x % k_blocks;
  const int key0 = kb * kKeyBlock;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t sbase = static_cast<size_t>(bh) * s;
  const int real_keys = min(kKeyBlock, s - key0);
  const int key_warps = (real_keys + 15) / 16;  // warps that hold at least one real key
  const bool k_ragged = real_keys < kKeyBlock;

  // Query rows q0 .. q0 + 63 of Q, g, g/Σ and their constants; zeros past S.
  auto load_q_tile = [&](int buf, int q0) {
    for (int c = tid; c < kQTile * kRowChunks; c += kThreads) {
      const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
      const bool ok = q0 + r < s;
      const size_t off = base + (ok ? static_cast<size_t>(q0 + r) * D + col : 0);
      const int so = buf * kTileElems + r * kT + col;
      afdm::cp_async_16(qs + so, q + off, ok ? 16 : 0);
      afdm::cp_async_16(gs + so, g + off, ok ? 16 : 0);
      afdm::cp_async_16(ss + so, g_scaled + off, ok ? 16 : 0);
    }
    if (tid < kQTile) {
      const bool ok = q0 + tid < s;
      afdm::cp_async_16(cs + buf * kQTile + tid, consts + sbase + (ok ? q0 + tid : 0),
                        ok ? 16 : 0);
    }
  };

  const int n_qt = (s + kQTile - 1) / kQTile;
  const int first = kb % n_qt;
  for (int c = tid; c < kKeyBlock * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
    const bool ok = r < real_keys;
    const size_t off = base + (ok ? static_cast<size_t>(key0 + r) * D + col : 0);
    afdm::cp_async_16(ks + r * kT + col, k + off, ok ? 16 : 0);
  }
  load_q_tile(0, first * kQTile);
  afdm::cp_async_commit();

  // This warp's key rows ka = key0 + 16·warp + group and kbr = ka + 8: K and V fragments.
  const int ka = key0 + 16 * warp + group, kbr = ka + 8;
  const bool ka_ok = ka < s, kb_ok = kbr < s;
  const bf16* kpa = k + base + static_cast<size_t>(ka_ok ? ka : 0) * D + 2 * quad;
  const bf16* kpb = k + base + static_cast<size_t>(kb_ok ? kbr : 0) * D + 2 * quad;
  const bf16* vpa = v + base + static_cast<size_t>(ka_ok ? ka : 0) * D + 2 * quad;
  const bf16* vpb = v + base + static_cast<size_t>(kb_ok ? kbr : 0) * D + 2 * quad;
  uint32_t kf[kSteps][4], vf[kSteps][4];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    kf[t][0] = ka_ok ? afdm::ld_pair(kpa + 16 * t) : 0u;
    kf[t][1] = kb_ok ? afdm::ld_pair(kpb + 16 * t) : 0u;
    vf[t][0] = ka_ok ? afdm::ld_pair(vpa + 16 * t) : 0u;
    vf[t][1] = kb_ok ? afdm::ld_pair(vpb + 16 * t) : 0u;
    if constexpr (D != 8) {
      kf[t][2] = ka_ok ? afdm::ld_pair(kpa + 16 * t + 8) : 0u;
      kf[t][3] = kb_ok ? afdm::ld_pair(kpb + 16 * t + 8) : 0u;
      vf[t][2] = ka_ok ? afdm::ld_pair(vpa + 16 * t + 8) : 0u;
      vf[t][3] = kb_ok ? afdm::ld_pair(vpb + 16 * t + 8) : 0u;
    }
  }

  float dka[kO][4], dva[kO][4];
#pragma unroll
  for (int n = 0; n < kO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }

  for (int i = 0; i < n_qt; ++i) {
    const int buf = i & 1;
    const int qt = first + i < n_qt ? first + i : first + i - n_qt;
    if (i + 1 < n_qt) {
      const int next = qt + 1 < n_qt ? qt + 1 : 0;
      load_q_tile(buf ^ 1, next * kQTile);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * kQTile;
    const bool mask = k_ragged || q0 + kQTile > s;

    if (warp < key_warps) {
      const bf16* qt_s = qs + buf * kTileElems;
      const bf16* g_s = gs + buf * kTileElems;
      const bf16* gsc_s = ss + buf * kTileElems;
      const float4* c_s = cs + buf * kQTile;
#pragma unroll
      for (int c = 0; c < kQTile / 16; ++c) {  // 16 queries at a time
        // Sᵀ = K·Qᵀ and dPᵀ = V·gᵀ: 16 keys × 16 queries each, two n-tiles of 8 queries.
        float sc[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
        }
        if constexpr (D == 8) {
          uint32_t b[2];
          afdm::ldmatrix_x2(b, qt_s + (16 * c + (lane & 15)) * kT);
          afdm::mma_m16n8k8(sc[0], kf[0][0], kf[0][1], b[0], sc[0]);
          afdm::mma_m16n8k8(sc[1], kf[0][0], kf[0][1], b[1], sc[1]);
          afdm::ldmatrix_x2(b, g_s + (16 * c + (lane & 15)) * kT);
          afdm::mma_m16n8k8(dp[0], vf[0][0], vf[0][1], b[0], dp[0]);
          afdm::mma_m16n8k8(dp[1], vf[0][0], vf[0][1], b[1], dp[1]);
        } else {
#pragma unroll
          for (int t = 0; t < kSteps; ++t) {
            uint32_t b[4];
            afdm::ldsm_b_nk(b, qt_s, kT, 16 * c, 16 * t, lane);
            afdm::mma_m16n8k16(sc[0], kf[t], b[0], b[1], sc[0]);
            afdm::mma_m16n8k16(sc[1], kf[t], b[2], b[3], sc[1]);
            afdm::ldsm_b_nk(b, g_s, kT, 16 * c, 16 * t, lane);
            afdm::mma_m16n8k16(dp[0], vf[t], b[0], b[1], dp[0]);
            afdm::mma_m16n8k16(dp[1], vf[t], b[2], b[3], dp[1]);
          }
        }

        // Pᵀ and dSᵀ, rounded to bf16 in registers: the A operands of dV and dK.
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = 16 * c + 8 * j + 2 * quad;  // this thread's two queries in the tile
          const float4 c0 = c_s[qc], c1 = c_s[qc + 1];
          float p[4];
          p[0] = afdm::ex2(fmaf(sc[j][0], scale_log2, c0.x));  // key ka, query qc
          p[1] = afdm::ex2(fmaf(sc[j][1], scale_log2, c1.x));  // key ka, query qc + 1
          p[2] = afdm::ex2(fmaf(sc[j][2], scale_log2, c0.x));  // key kb, query qc
          p[3] = afdm::ex2(fmaf(sc[j][3], scale_log2, c1.x));  // key kb, query qc + 1
          if (mask) {
            const bool q_ok0 = q0 + qc < s, q_ok1 = q0 + qc + 1 < s;
            if (!(ka_ok && q_ok0)) p[0] = 0.f;
            if (!(ka_ok && q_ok1)) p[1] = 0.f;
            if (!(kb_ok && q_ok0)) p[2] = 0.f;
            if (!(kb_ok && q_ok1)) p[3] = 0.f;
          }
          const uint32_t pa_a = afdm::pack_bf16(p[0], p[1]);
          const uint32_t pa_b = afdm::pack_bf16(p[2], p[3]);
          pa[2 * j] = pa_a;
          pa[2 * j + 1] = pa_b;
          // dS = P ⊙ ((dP − δ)/Σ) = P · (dP·(1/Σ) − δ/Σ), with P the bf16 value
          dsa[2 * j] = afdm::pack_bf16(afdm::bf16_lo(pa_a) * fmaf(dp[j][0], c0.y, c0.z),
                                       afdm::bf16_hi(pa_a) * fmaf(dp[j][1], c1.y, c1.z));
          dsa[2 * j + 1] = afdm::pack_bf16(afdm::bf16_lo(pa_b) * fmaf(dp[j][2], c0.y, c0.z),
                                           afdm::bf16_hi(pa_b) * fmaf(dp[j][3], c1.y, c1.z));
        }

        // dV += Pᵀ·(g/Σ) and dK += dSᵀ·Q over these 16 queries.
        if constexpr (D == 8) {
          uint32_t b[2];
          afdm::ldsm_b_kn8(b, gsc_s, kT, 16 * c, 0, lane);
          afdm::mma_m16n8k16(dva[0], pa, b[0], b[1], dva[0]);
          afdm::ldsm_b_kn8(b, qt_s, kT, 16 * c, 0, lane);
          afdm::mma_m16n8k16(dka[0], dsa, b[0], b[1], dka[0]);
        } else {
#pragma unroll
          for (int u = 0; u < kO / 2; ++u) {
            uint32_t b[4];
            afdm::ldsm_b_kn(b, gsc_s, kT, 16 * c, 16 * u, lane);
            afdm::mma_m16n8k16(dva[2 * u], pa, b[0], b[1], dva[2 * u]);
            afdm::mma_m16n8k16(dva[2 * u + 1], pa, b[2], b[3], dva[2 * u + 1]);
            afdm::ldsm_b_kn(b, qt_s, kT, 16 * c, 16 * u, lane);
            afdm::mma_m16n8k16(dka[2 * u], dsa, b[0], b[1], dka[2 * u]);
            afdm::mma_m16n8k16(dka[2 * u + 1], dsa, b[2], b[3], dka[2 * u + 1]);
          }
        }

        // dSᵀ of this warp's keys into shared memory, for dQ.
        bf16* dr = dst + (16 * warp + group) * kDsStride + 16 * c + 2 * quad;
        *reinterpret_cast<uint32_t*>(dr) = dsa[0];
        *reinterpret_cast<uint32_t*>(dr + 8 * kDsStride) = dsa[1];
        *reinterpret_cast<uint32_t*>(dr + 8) = dsa[2];
        *reinterpret_cast<uint32_t*>(dr + 8 * kDsStride + 8) = dsa[3];
      }
    }
    __syncthreads();  // dSᵀ complete; every warp is done with this tile's buffers

    // dQ of queries q0 + 16·warp .. +15 over the block's real keys, added into the scratch.
    float dqa[kO][4];
#pragma unroll
    for (int n = 0; n < kO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
    for (int kk = 0; kk < key_warps; ++kk) {
      uint32_t a[4];
      afdm::ldsm_a_km(a, dst, kDsStride, 16 * kk, 16 * warp, lane);
      if constexpr (D == 8) {
        uint32_t b[2];
        afdm::ldsm_b_kn8(b, ks, kT, 16 * kk, 0, lane);
        afdm::mma_m16n8k16(dqa[0], a, b[0], b[1], dqa[0]);
      } else {
#pragma unroll
        for (int u = 0; u < kO / 2; ++u) {
          uint32_t b[4];
          afdm::ldsm_b_kn(b, ks, kT, 16 * kk, 16 * u, lane);
          afdm::mma_m16n8k16(dqa[2 * u], a, b[0], b[1], dqa[2 * u]);
          afdm::mma_m16n8k16(dqa[2 * u + 1], a, b[2], b[3], dqa[2 * u + 1]);
        }
      }
    }
    const int qa = q0 + 16 * warp + group, qb = qa + 8;
#pragma unroll
    for (int n = 0; n < kO; ++n) {
      if (qa < s) {
        atomicAdd(reinterpret_cast<float2*>(dq_acc + (sbase + qa) * D + 8 * n + 2 * quad),
                  make_float2(dqa[n][0], dqa[n][1]));
      }
      if (qb < s) {
        atomicAdd(reinterpret_cast<float2*>(dq_acc + (sbase + qb) * D + 8 * n + 2 * quad),
                  make_float2(dqa[n][2], dqa[n][3]));
      }
    }
    // The next iteration writes dSᵀ only after its first barrier, which every warp reaches
    // after its dQ reads here.
  }

  // dK = dSᵀ·Q·scale and dV, rows ka and kb, rounded to bf16 once.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? kbr : ka;
    if (!(h ? kb_ok : ka_ok)) continue;
    const size_t off = base + static_cast<size_t>(row) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < kO; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          afdm::pack_bf16(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          afdm::pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// dQ = scratch·scale, rounded to bf16: eight values a thread.
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_dq_cast_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                             long long chunks, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (i >= chunks) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(dq_acc)[2 * i + 1];
  reinterpret_cast<uint4*>(dq)[i] = make_uint4(
      afdm::pack_bf16(a.x * scale, a.y * scale), afdm::pack_bf16(a.z * scale, a.w * scale),
      afdm::pack_bf16(b.x * scale, b.y * scale), afdm::pack_bf16(b.z * scale, b.w * scale));
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* out,
                       const void* g, const float* m, const float* l, void* dq, void* dk,
                       void* dv, float4* consts, float* dq_acc, bf16* g_scaled, int bh, int s,
                       float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(bh) * s;
  const int k_blocks = (s + kKeyBlock - 1) / kKeyBlock;
  const long long blocks = static_cast<long long>(bh) * k_blocks;
  const long long prep_blocks = (rows + kPrepThreads - 1) / kPrepThreads;
  const long long chunks = rows * D / 8;
  const long long cast_blocks = (chunks + kPrepThreads - 1) / kPrepThreads;
  if (blocks > INT_MAX || prep_blocks > INT_MAX || cast_blocks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  const bf16* gb = static_cast<const bf16*>(g);
  flash_bwd_prep_kernel<D><<<static_cast<unsigned>(prep_blocks), kPrepThreads, 0, stream>>>(
      static_cast<const bf16*>(out), gb, m, l, consts, g_scaled, dq_acc, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kSmem = bwd_smem_bytes<D>();
  if (kSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(flash_bwd_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_mma_kernel<D><<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), gb,
      g_scaled, consts, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, k_blocks,
      scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_cast_kernel<<<static_cast<unsigned>(cast_blocks), kPrepThreads, 0, stream>>>(
      dq_acc, static_cast<bf16*>(dq), chunks, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, g (inputs) and dq, dk, dv (outputs): contiguous (bh, s, d) arrays of f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), bf16 rows 16-byte aligned. m, l: the forward's (bh, s)
// f32 softmax max and sum. Scratch, allocated by the caller (ops/flash_attention.py:bwd_scratch):
//   f32:  consts = δ, (bh, s) f32; dq_acc and g_scaled null;
//   bf16: consts (bh, s, 4) f32; dq_acc (bh, s, d) f32; g_scaled (bh, s, d) bf16.
// Launches the kernels on `stream` and returns the first failed launch's cudaError_t (0 on
// success).
extern "C" int afdm_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* g, const void* m, const void* l, void* dq, void* dk,
                              void* dv, void* consts, void* dq_acc, void* g_scaled, int bh,
                              int s, int d, float scale, int is_bf16, void* stream) {
  if (bh < 1 || s < 1 || m == nullptr || l == nullptr || consts == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (is_bf16 && (dq_acc == nullptr || g_scaled == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* cf = static_cast<float*>(consts);
  float4* c4 = static_cast<float4*>(consts);
  float* acc = static_cast<float*>(dq_acc);
  bf16* gsc = static_cast<bf16*>(g_scaled);
  cudaError_t err;
  switch (d) {
    case 8:
      err = is_bf16 ? launch_mma<8>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                    scale, st)
                    : launch_f32<8>(q, k, v, out, g, mf, lf, dq, dk, dv, cf, bh, s, scale, st);
      break;
    case 16:
      err = is_bf16 ? launch_mma<16>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                     scale, st)
                    : launch_f32<16>(q, k, v, out, g, mf, lf, dq, dk, dv, cf, bh, s, scale, st);
      break;
    case 32:
      err = is_bf16 ? launch_mma<32>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                     scale, st)
                    : launch_f32<32>(q, k, v, out, g, mf, lf, dq, dk, dv, cf, bh, s, scale, st);
      break;
    case 64:
      err = is_bf16 ? launch_mma<64>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                     scale, st)
                    : launch_f32<64>(q, k, v, out, g, mf, lf, dq, dk, dv, cf, bh, s, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* afdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
