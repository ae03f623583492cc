// Flash-attention forward for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces the TPU kernel aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py:
// _fwd_kernel (:126-163), as _flash_fwd (:395-444) launches it in "fold" and "stats" mode:
//   logits = q·kᵀ·scale in f32, m = max over keys, p = exp(logits − m), Σ = Σ_j p,
//   out    = (p rounded to the input dtype) · v, accumulated in f32, divided by Σ;
//   "stats" also writes m and Σ as (B·H, 1, S) f32, the TPU kernel's layout.
//
// What bounds it: at the UNet's head dims (D = 8..128) every (query, key) pair costs one exp and
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
//    ldmatrix.trans those of V. The buffers are dynamic shared memory: 68 KB at D = 128 (the
//    128-px UNet's 512-channel blocks), above the 48 KB a static array may take, so that
//    instantiation raises its limit with cudaFuncSetAttribute before its first launch on a
//    device (afdm::raise_smem_limit_once; never while a CUDA graph is being captured).
//  * Online softmax in the accumulators, in the exp2 domain: scale·log2e is folded into one
//    FFMA per pair before MUFU.EX2; the row max takes two quad shuffles per tile; the output
//    accumulators are rescaled once per tile. P is rounded to bf16 in registers and is already
//    the A operand of O += P·V. Σ sums the unrounded f32 p, as the TPU kernel does; the
//    division by Σ comes last. Stats mode stores m in natural units (m₂·ln 2).
//  * Small S: a block takes several (b, h) so that no warp idles on rows past S: one warp per
//    head and four heads a block at S <= 16, two and two at S <= 32, else one head and 64 query
//    rows a block (at D = 128 always one head a block). The launch plan is computed in Python
//    (ops/flash_attention.py:fwd_plan) and checked here. Keys past S get −inf logits; queries
//    past S are computed from zero rows and never stored.
//
// f32: flash_fwd_f32_kernel, register micro-tiles on the FMA pipes (attn_f32.cuh). It replaces
// the same _fwd_kernel for f32 inputs, the path the JAX package keeps on XLA's HIGHEST-precision
// einsums and the port's exact path: no TF32, every product and sum in f32.
//  * What bounds it: 4·D FLOPs of FMA per (query, key) pair against one exp, so the FMA pipes
//    (67 TFLOP/s) at D >= 16; at D = 8 the pair's softmax arithmetic (scale, max, exp, Σ) costs
//    about a third of its FMAs. The first port's kernel (one thread a query row, 32-key tiles
//    read one scalar per FMA, D = 128 spilling) reached 8% of that bound at D = 128.
//  * Four warps own 64 query rows of one head (two or four heads where S fits half or a quarter);
//    K and V stream through two shared-memory buffers of 64 keys (32 at D = 128) by cp.async.
//    Each thread forms a 4 × 8 (4 × 4) tile of Q·Kᵀ from float4 reads, so a value read from
//    shared memory feeds 4 or 8 FMAs. The eight lanes of a row take its max by three shuffles.
//    At D <= 16 on a grid of at most 528 such blocks (the sampler's S = 256 blocks at n = 32) a
//    tile of 32 keys (D = 8) or 32 rows (D = 16) a block instead: three blocks an SM would leave
//    the second wave three quarters empty.
//  * The online softmax keeps the first port's arithmetic: the logit scaled after the dot,
//    alpha = __expf(m − m_new), p = __expf(logit − m_new), Σ of the unrounded p, the division by
//    Σ last. O += P·V: at D <= 16 each lane sums its own keys into all D outputs (the eight lanes
//    added at the end); at D >= 32 P goes through shared memory and each lane owns D/8 output
//    columns, so no instantiation spills (ptxas, chip_smoke phase 1). Stats mode writes m in
//    natural units and Σ.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "entry.cuh"
#include "attn_f32.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------------------------
// f32: register micro-tiles on the FMA pipes (attn_f32.cuh)
// ---------------------------------------------------------------------------------------------

// Rows a thread (kRI) and columns a thread (kCJ) by depth: a block owns 16·kRI = 64 queries and
// streams tiles of 8·kCJ keys. Mirrored by ops/flash_attention.py:F32_TILES.
template <int D>
struct FwdTile;
template <> struct FwdTile<8> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct FwdTile<16> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct FwdTile<32> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct FwdTile<64> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct FwdTile<128> { static constexpr int kRI = 4, kCJ = 4; };
// ... and at D <= 16 on a small grid (at most kSmallGridPerSm blocks of 64 queries an SM: the
// sampler's 256-query blocks at n = 32), where three blocks an SM leave the second wave mostly
// empty: tiles of fewer rows or keys a block. Mirrored by ops/flash_attention.py:
// F32_FWD_SMALL_TILES and F32_SMALL_GRID_PER_SM.
template <int D>
struct FwdSmallTile;
template <> struct FwdSmallTile<8> { static constexpr int kRI = 4, kCJ = 4; };
template <> struct FwdSmallTile<16> { static constexpr int kRI = 2, kCJ = 8; };
constexpr long long kSmallGridPerSm = 4;

// Dynamic shared memory of flash_fwd_f32_kernel<D, *, RI, CJ>: the query tile, two K and two V
// tiles, and P staged (D >= 32).
template <int D, int RI, int CJ>
constexpr int fwd_f32_smem_bytes() {
  constexpr int R = 16 * RI, C = 8 * CJ;
  constexpr int S = afdm::f32::stride<D>();
  return 4 * (R * S + 4 * C * S + (D >= 32 ? C * afdm::f32::wstride<R>() : 0));
}

// H (b, h) pairs a block: R / H queries and C / H keys a tile of each.
template <int D, int H, int RI, int CJ>
__global__ void __launch_bounds__(afdm::f32::kThreads, afdm::f32::kMinBlocks)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out, int bh, int s,
                         int q_tiles, float scale) {
  namespace f = afdm::f32;
  constexpr int R = 16 * RI, C = 8 * CJ, S = f::stride<D>();
  constexpr bool kStaged = D >= 32;
  constexpr int kRows = R / H;  // queries of each head in the block
  constexpr int kKeys = C / H;  // keys of each head in a tile
  constexpr int kO = kStaged ? D / 8 : D;
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;        // [R][S] the block's queries
  float* ks = qs + R * S;      // [2][C][S] K, double-buffered
  float* vs = ks + 2 * C * S;  // [2][C][S] V
  float* ws = vs + 2 * C * S;  // [C][R + 4] P, staged (D >= 32)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = 4 * warp + (lane >> 3), cg = lane & 7;
  const int head0 = (blockIdx.x / q_tiles) * H;
  const int q0 = (blockIdx.x % q_tiles) * kRows;

  // Row r: head head0 + r / kRows, query q0 + r % kRows. Slot c of a tile: head head0 + c / kKeys,
  // key k0 + c % kKeys. Zeros past S or past B·H.
  f::load_rows<D>(qs, R, q, [&](int r) -> const float* {
    const int hh = head0 + r / kRows, qq = q0 + r % kRows;
    return hh < bh && qq < s ? q + (static_cast<size_t>(hh) * s + qq) * D : nullptr;
  });
  auto load_tile = [&](int buf, int k0) {
    auto slot = [&](const float* x) {
      return [=](int c) -> const float* {
        const int hh = head0 + c / kKeys, kk = k0 + c % kKeys;
        return hh < bh && kk < s ? x + (static_cast<size_t>(hh) * s + kk) * D : nullptr;
      };
    };
    f::load_rows<D>(ks + buf * C * S, C, k, slot(k));
    f::load_rows<D>(vs + buf * C * S, C, v, slot(v));
  };
  load_tile(0, 0);
  afdm::cp_async_commit();

  float o[RI][kO];
  float m[RI], l[RI];  // running max of the scaled logits; this lane's share of Σ
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kO; ++n) o[i][n] = 0.f;
  }

  const int n_tiles = (s + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile((t + 1) & 1, (t + 1) * kKeys);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + (t & 1) * C * S;
    const float* vt = vs + (t & 1) * C * S;

    float x[RI][CJ];  // logits, then p
    f::dots<D, RI, CJ>(x, qs, kt, rg, cg);
    const int k0 = t * kKeys;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) x[i][j] = __fmul_rn(x[i][j], scale);
    }
    if (H > 1 || k0 + kKeys > s) {  // keys past S, and with several heads a block other heads' keys
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = cg + 8 * j;
          if (k0 + c % kKeys >= s || (H > 1 && c / kKeys != (rg + 16 * i) / kRows)) {
            x[i][j] = -CUDART_INF_F;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CJ; ++j) mx = fmaxf(mx, x[i][j]);
      // Finite: every row has a real key of its head in every tile.
      const float m_new = fmaxf(m[i], f::row_group_max(mx));
      const float alpha = __expf(m[i] - m_new);  // 0 on the first tile (m = −inf)
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < kO; ++n) o[i][n] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        x[i][j] = __expf(x[i][j] - m_new);  // 0 for a masked key
        l[i] += x[i][j];
      }
    }
    if constexpr (kStaged) {
      f::stage<RI, CJ>(ws, x, rg, cg);
      __syncthreads();
      f::staged_sums<D, RI, C>(o, ws, vt, rg, cg);
    } else {
      f::lane_sums<D, RI, CJ>(o, x, vt, cg);
    }
    __syncthreads();  // every warp is done with this tile's buffers (and P) before they refill
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float sum[1] = {l[i]};
    f::row_group_sum(sum);
    if constexpr (!kStaged) f::row_group_sum(o[i]);
    const int r = rg + 16 * i;
    const int hh = head0 + r / kRows, qq = q0 + r % kRows;
    if (hh >= bh || qq >= s) continue;
    const size_t row = static_cast<size_t>(hh) * s + qq;
    const float total = sum[0];
    f::store_row<D, kStaged>(out + row * D, o[i], cg, [&](float a) { return a / total; });
    if (m_out != nullptr && cg == 0) {
      m_out[row] = m[i];
      l_out[row] = total;
    }
  }
}

template <int D, int H, int RI, int CJ>
cudaError_t launch_f32_heads(const void* q, const void* k, const void* v, void* out, float* m,
                             float* l, int bh, int s, float scale, cudaStream_t stream) {
  constexpr int R = 16 * RI;
  // One head and R query rows a block, or H heads of at most R / H rows (one tile of keys).
  if (H > 1 && s > R / H) return cudaErrorInvalidValue;
  const int q_tiles = H > 1 ? 1 : (s + R - 1) / R;
  const long long blocks = static_cast<long long>((bh + H - 1) / H) * q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int kSmem = fwd_f32_smem_bytes<D, RI, CJ>();
  if constexpr (kSmem > 48 * 1024) {
    static std::atomic<bool> smem_set[afdm::kMaxDevices];
    const cudaError_t err = afdm::raise_smem_limit_once(
        reinterpret_cast<const void*>(flash_fwd_f32_kernel<D, H, RI, CJ>), kSmem, smem_set,
        stream);
    if (err != cudaSuccess) return err;
  }
  flash_fwd_f32_kernel<D, H, RI, CJ>
      <<<static_cast<unsigned>(blocks), afdm::f32::kThreads, kSmem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), m, l, bh, s, q_tiles, scale);
  return cudaGetLastError();
}

template <int D, int RI, int CJ>
cudaError_t launch_f32_tile(const void* q, const void* k, const void* v, void* out, float* m,
                            float* l, int bh, int s, float scale, int heads,
                            cudaStream_t stream) {
  if constexpr (D == 128) {
    if (heads != 1) return cudaErrorInvalidValue;  // one head a block at this depth
    return launch_f32_heads<D, 1, RI, CJ>(q, k, v, out, m, l, bh, s, scale, stream);
  } else {
    switch (heads) {
      case 1: return launch_f32_heads<D, 1, RI, CJ>(q, k, v, out, m, l, bh, s, scale, stream);
      case 2: return launch_f32_heads<D, 2, RI, CJ>(q, k, v, out, m, l, bh, s, scale, stream);
      case 4: return launch_f32_heads<D, 4, RI, CJ>(q, k, v, out, m, l, bh, s, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* m,
                       float* l, int bh, int s, float scale, int heads, int sms,
                       cudaStream_t stream) {
  if constexpr (D <= 16) {
    if (static_cast<long long>(bh) * ((s + 63) / 64) <= kSmallGridPerSm * sms) {
      return launch_f32_tile<D, FwdSmallTile<D>::kRI, FwdSmallTile<D>::kCJ>(
          q, k, v, out, m, l, bh, s, scale, heads, stream);
    }
  }
  return launch_f32_tile<D, FwdTile<D>::kRI, FwdTile<D>::kCJ>(q, k, v, out, m, l, bh, s, scale,
                                                               heads, stream);
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
  constexpr int kBuf = kTileRows * kT;         // elements of one K (or V) buffer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kBuf]: K, double-buffered
  bf16* vs = ks + 2 * kBuf;                  // [2][kBuf]: V

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
      afdm::cp_async_16(ks + buf * kBuf + r * kT + col, k + off, ok ? 16 : 0);
      afdm::cp_async_16(vs + buf * kBuf + r * kT + col, v + off, ok ? 16 : 0);
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
    const bf16* kt = ks + (it & 1) * kBuf + hr * kT;
    const bf16* vt = vs + (it & 1) * kBuf + hr * kT;

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
  constexpr int kSmem = 4 * kTileRows * afdm::smem_stride<D>() * static_cast<int>(sizeof(bf16));
  if constexpr (kSmem > 48 * 1024) {
    static std::atomic<bool> smem_set[afdm::kMaxDevices];
    const cudaError_t err = afdm::raise_smem_limit_once(
        reinterpret_cast<const void*>(flash_fwd_mma_kernel<D, kHeads>), kSmem, smem_set, stream);
    if (err != cudaSuccess) return err;
  }
  flash_fwd_mma_kernel<D, kHeads><<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), m, l, bh, s, q_tiles, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* m,
                       float* l, int bh, int s, float scale, int heads, cudaStream_t stream) {
  if constexpr (D == 128) {
    // One head a block only: with two heads this depth spills registers.
    if (heads != 1) return cudaErrorInvalidValue;
    return launch_mma_heads<D, 1>(q, k, v, out, m, l, bh, s, scale, stream);
  } else {
    switch (heads) {
      case 1: return launch_mma_heads<D, 1>(q, k, v, out, m, l, bh, s, scale, stream);
      case 2: return launch_mma_heads<D, 2>(q, k, v, out, m, l, bh, s, scale, stream);
      case 4: return launch_mma_heads<D, 4>(q, k, v, out, m, l, bh, s, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// q, k, v, out: contiguous (bh, s, d) arrays of f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned (cp.async). m, l: (bh, s) f32 arrays for the softmax max and sum, or both null.
// heads_per_block: 1, 2 or 4 (1 at d = 128), from ops/flash_attention.py:fwd_plan (bf16) or
// f32_plan (f32). sms: the card's SM count (the f32 forward's tile at d <= 16 depends on it).
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int afdm_flash_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                              void* l, int bh, int s, int d, float scale, int is_bf16,
                              int heads_per_block, int sms, void* stream) {
  if (bh < 1 || s < 1 || sms < 1 || (m == nullptr) != (l == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  const int hp = heads_per_block;
  switch (d) {
    case 8:
      return is_bf16 ? launch_mma<8>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<8>(q, k, v, out, mf, lf, bh, s, scale, hp, sms, st);
    case 16:
      return is_bf16 ? launch_mma<16>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<16>(q, k, v, out, mf, lf, bh, s, scale, hp, sms, st);
    case 32:
      return is_bf16 ? launch_mma<32>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<32>(q, k, v, out, mf, lf, bh, s, scale, hp, sms, st);
    case 64:
      return is_bf16 ? launch_mma<64>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<64>(q, k, v, out, mf, lf, bh, s, scale, hp, sms, st);
    case 128:
      return is_bf16 ? launch_mma<128>(q, k, v, out, mf, lf, bh, s, scale, hp, st)
                     : launch_f32<128>(q, k, v, out, mf, lf, bh, s, scale, hp, sms, st);
    default:
      return cudaErrorInvalidValue;
  }
}
