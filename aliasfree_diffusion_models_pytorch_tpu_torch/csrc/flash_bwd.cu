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
// What bounds it: at the UNet's head dims (D = 8..128) every (query, key) pair costs one exp and
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
//    axis. At D = 128 that would be 64 registers of fragments and 128 of accumulators a thread,
//    192 of the 255 before anything else: there the block's K and V tiles stay in shared memory
//    and each 16-query step reads the warp's fragments back with ldmatrix (16 loads of 16 bytes
//    a lane per step, against 32 MMAs), and dQ is formed and added in two halves of 64 columns,
//    so the accumulators of dK and dV are the only large live set. Each query tile (Q, g, g/Σ, the float4 constants) is double-buffered through shared
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
// f32: two passes on the FMA pipes, each recomputing P, deterministic (no atomics, every sum in
// a fixed order: a graphed f32 train step and an exact resume are bit-equal because of it). They
// replace the same TPU kernels for f32 inputs, the port's exact path.
//  * What bounds it: 10·D FLOPs of FMA per pair in the five products (67 TFLOP/s), plus the
//    pair's exp and dS. Two passes form S and dP twice (14·D FLOPs a pair, and two exps) because
//    the one-pass alternative needs dQ partials per key tile, (S/64)·S·D floats a head (8.6 GB at
//    128-px sa6), or atomics. The first port's kernels (one thread a row, 32-row tiles read one
//    scalar per FMA) spilled at D >= 64 and reached 2% of the bound at D = 128.
//  * The dQ pass (flash_bwd_dq_f32_kernel): a block owns 64 queries (32 at D = 128) and streams
//    K and V tiles by cp.async; it also writes each query's (−m·log2e, 1/Σ, −δ/Σ), δ summed from
//    g ⊙ out, for the second pass. The dK/dV pass (flash_bwd_dkv_f32_kernel): a block owns 64 or
//    32 keys and streams Q, g and those constants. Both form S and dP (or Sᵀ and dPᵀ) as register
//    micro-tiles (attn_f32.cuh), P = 2^(s·scale·log2e − m·log2e) by one FFMA and one EX2, and
//    dS = P·(dP·(1/Σ) − δ/Σ) by one FFMA and one FMUL; dS (and P/Σ) go through shared memory
//    and each lane sums D/8 output columns over the tile (staged), so no instantiation spills.
//  * D <= 16, and D = 32 at S <= 32 (flash_bwd_{dq,dkv}_f32_rows_kernel): a pair costs more in
//    its exp and dS than in its products, and micro-tiles' logits, dP and accumulators outgrow
//    the registers that the small depth saves (at S = 16 their 64-row tiles would also stand
//    three quarters past S); so one row a thread, 64 a block, every lane reading the same
//    streamed row (a broadcast), tiles of 32 by cp.async, the same folded arithmetic.
//  Rounding points against the plain version: P from the exp2 domain differs from exp(s − m) in
//  its last bits; every product sums in another order. Within 2e-5 of the largest entry.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entry.cuh"
#include "attn_f32.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------------------------
// f32: register micro-tiles on the FMA pipes (attn_f32.cuh)
// ---------------------------------------------------------------------------------------------

constexpr float kLog2eF32 = 1.4426950408889634f;

// D >= 32: rows a thread (kRI) and columns a thread (kCJ) by pass and depth: a block owns 16·kRI
// rows (queries in the dQ pass, keys in the dK/dV pass) and streams tiles of 8·kCJ rows of the
// other operand. Mirrored by ops/flash_attention.py:F32_TILES.
template <int D>
struct DqTile;
template <> struct DqTile<32> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct DqTile<64> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct DqTile<128> { static constexpr int kRI = 2, kCJ = 4; };
template <int D>
struct DkvTile;
template <> struct DkvTile<32> { static constexpr int kRI = 4, kCJ = 8; };
template <> struct DkvTile<64> { static constexpr int kRI = 2, kCJ = 8; };
template <> struct DkvTile<128> { static constexpr int kRI = 2, kCJ = 4; };

// Dynamic shared memory: the dQ pass holds the block's Q and g tiles, two K and two V tiles and
// dS staged; the dK/dV pass the block's K and V tiles, two Q, two g and two tiles of the query
// constants, and P/Σ and dS staged.
template <int D>
constexpr int dq_f32_smem_bytes() {
  constexpr int R = 16 * DqTile<D>::kRI, C = 8 * DqTile<D>::kCJ;
  constexpr int S = afdm::f32::stride<D>();
  return 4 * (2 * R * S + 4 * C * S + C * afdm::f32::wstride<R>());
}

template <int D>
constexpr int dkv_f32_smem_bytes() {
  constexpr int R = 16 * DkvTile<D>::kRI, C = 8 * DkvTile<D>::kCJ;
  constexpr int S = afdm::f32::stride<D>();
  return 4 * (2 * R * S + 4 * C * S + 2 * 4 * C + 2 * C * afdm::f32::wstride<R>());
}

// dQ, and per query (m, 1/Σ, δ) for the dK/dV pass: one block per (b·h, 16·kRI queries), looping
// over tiles of 8·kCJ keys.
template <int D>
__global__ void __launch_bounds__(afdm::f32::kThreads, afdm::f32::kMinBlocks)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ out,
                            const float* __restrict__ g, const float* __restrict__ m,
                            const float* __restrict__ l, float* __restrict__ dq,
                            float4* __restrict__ consts, int s, int row_tiles, float scale,
                            float scale_log2) {
  namespace f = afdm::f32;
  constexpr int RI = DqTile<D>::kRI, CJ = DqTile<D>::kCJ;
  constexpr int R = 16 * RI, C = 8 * CJ, S = f::stride<D>();
  constexpr int kO = D / 8;  // this lane's output columns (staged sums)
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;        // [R][S] the block's queries
  float* gs = qs + R * S;      // [R][S] their cotangents
  float* ks = gs + R * S;      // [2][C][S] K, double-buffered
  float* vs = ks + 2 * C * S;  // [2][C][S] V
  float* ws = vs + 2 * C * S;  // [C][R + 4] dS, staged

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = 4 * warp + (lane >> 3), cg = lane & 7;
  const int bh = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * R;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t sbase = static_cast<size_t>(bh) * s;

  auto rows_from = [&](const float* x, int first) {
    return [=](int r) -> const float* {
      return first + r < s ? x + base + static_cast<size_t>(first + r) * D : nullptr;
    };
  };
  f::load_rows<D>(qs, R, q, rows_from(q, r0));
  f::load_rows<D>(gs, R, g, rows_from(g, r0));
  auto load_tile = [&](int buf, int k0) {
    f::load_rows<D>(ks + buf * C * S, C, k, rows_from(k, k0));
    f::load_rows<D>(vs + buf * C * S, C, v, rows_from(v, k0));
  };
  load_tile(0, 0);
  afdm::cp_async_commit();

  // Per query row: −m·log2e, 1/Σ and −δ/Σ, with δ = Σ_d g·out (the eight lanes of the row split
  // the depth into float4 chunks, then add). A row past S keeps zeros: its dS is 0, never stored.
  float nm[RI], il[RI], nd[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + rg + 16 * i;
    const bool valid = row < s;
    float part[1] = {0.f};
    if (valid) {
      for (int c = cg; c < D / 4; c += 8) {
        const float4 gv = *reinterpret_cast<const float4*>(g + base + static_cast<size_t>(row) * D + 4 * c);
        const float4 ov = *reinterpret_cast<const float4*>(out + base + static_cast<size_t>(row) * D + 4 * c);
        part[0] = fmaf(gv.x, ov.x, part[0]);
        part[0] = fmaf(gv.y, ov.y, part[0]);
        part[0] = fmaf(gv.z, ov.z, part[0]);
        part[0] = fmaf(gv.w, ov.w, part[0]);
      }
    }
    f::row_group_sum(part);
    nm[i] = valid ? -m[sbase + row] * kLog2eF32 : 0.f;
    il[i] = valid ? 1.f / l[sbase + row] : 0.f;
    nd[i] = -part[0] * il[i];
    if (valid && cg == 0) consts[sbase + row] = make_float4(nm[i], il[i], nd[i], 0.f);
  }

  float acc[RI][kO];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int n = 0; n < kO; ++n) acc[i][n] = 0.f;
  }

  const int n_tiles = (s + C - 1) / C;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile((t + 1) & 1, (t + 1) * C);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + (t & 1) * C * S;
    const float* vt = vs + (t & 1) * C * S;

    float x[RI][CJ], dp[RI][CJ];  // logits, then dS; g·vᵀ
    f::dots<D, RI, CJ>(x, qs, kt, rg, cg);
    f::dots<D, RI, CJ>(dp, gs, vt, rg, cg);
    const int k0 = t * C;
    const bool ragged = k0 + C > s;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        // P = 2^(q·k·scale·log2e − m·log2e), unnormalised; dS = P·(dP/Σ − δ/Σ).
        const float p = afdm::ex2(fmaf(x[i][j], scale_log2, nm[i]));
        x[i][j] = p * fmaf(dp[i][j], il[i], nd[i]);
      }
    }
    if (ragged) {  // no term of a key past S
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (k0 + cg + 8 * j >= s) {
#pragma unroll
          for (int i = 0; i < RI; ++i) x[i][j] = 0.f;
        }
      }
    }
    f::stage<RI, CJ>(ws, x, rg, cg);
    __syncthreads();
    f::staged_sums<D, RI, C>(acc, ws, kt, rg, cg);
    __syncthreads();  // every warp is done with this tile's buffers (and dS) before they refill
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + rg + 16 * i;
    if (row >= s) continue;
    f::store_row<D, true>(dq + base + static_cast<size_t>(row) * D, acc[i], cg,
                          [&](float a) { return a * scale; });
  }
}

// dK and dV: one block per (b·h, 16·kRI keys), looping over tiles of 8·kCJ queries with their
// constants (m, 1/Σ, δ) from the dQ pass.
template <int D>
__global__ void __launch_bounds__(afdm::f32::kThreads, afdm::f32::kMinBlocks)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ g,
                             const float4* __restrict__ consts, float* __restrict__ dk,
                             float* __restrict__ dv, int s, int row_tiles, float scale,
                             float scale_log2) {
  namespace f = afdm::f32;
  constexpr int RI = DkvTile<D>::kRI, CJ = DkvTile<D>::kCJ;
  constexpr int R = 16 * RI, C = 8 * CJ, S = f::stride<D>();
  constexpr int kO = D / 8;  // this lane's output columns (staged sums)
  constexpr int kW = C * f::wstride<R>();
  extern __shared__ __align__(16) float f32_smem[];
  float* kss = f32_smem;                                   // [R][S] the block's keys
  float* vss = kss + R * S;                                // [R][S] their values
  float* qs = vss + R * S;                                 // [2][C][S] Q, double-buffered
  float* gs = qs + 2 * C * S;                              // [2][C][S] g
  float4* cs = reinterpret_cast<float4*>(gs + 2 * C * S);  // [2][C] (m, 1/Σ, δ, 0)
  float* ws = reinterpret_cast<float*>(cs + 2 * C);        // [2][C][R + 4] P/Σ, dS, staged

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = 4 * warp + (lane >> 3), cg = lane & 7;
  const int bh = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * R;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t sbase = static_cast<size_t>(bh) * s;

  auto rows_from = [&](const float* x, int first) {
    return [=](int r) -> const float* {
      return first + r < s ? x + base + static_cast<size_t>(first + r) * D : nullptr;
    };
  };
  f::load_rows<D>(kss, R, k, rows_from(k, r0));
  f::load_rows<D>(vss, R, v, rows_from(v, r0));
  auto load_tile = [&](int buf, int q0) {
    f::load_rows<D>(qs + buf * C * S, C, q, rows_from(q, q0));
    f::load_rows<D>(gs + buf * C * S, C, g, rows_from(g, q0));
    for (int c = threadIdx.x; c < C; c += f::kThreads) {
      const bool ok = q0 + c < s;
      afdm::cp_async_16(cs + buf * C + c, consts + sbase + (ok ? q0 + c : 0), ok ? 16 : 0);
    }
  };
  load_tile(0, 0);
  afdm::cp_async_commit();

  float dka[RI][kO], dva[RI][kO];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int n = 0; n < kO; ++n) dka[i][n] = dva[i][n] = 0.f;
  }

  const int n_tiles = (s + C - 1) / C;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile((t + 1) & 1, (t + 1) * C);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + (t & 1) * C * S;
    const float* gt = gs + (t & 1) * C * S;
    const float4* ct = cs + (t & 1) * C;

    float x[RI][CJ], y[RI][CJ];  // logits, then P/Σ; v·gᵀ, then dS
    f::dots<D, RI, CJ>(x, kss, qt, rg, cg);
    f::dots<D, RI, CJ>(y, vss, gt, rg, cg);
    const int q0 = t * C;
    const bool ragged = q0 + C > s;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const float4 c = ct[cg + 8 * j];  // −m·log2e, 1/Σ, −δ/Σ of query q0 + cg + 8j
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = afdm::ex2(fmaf(x[i][j], scale_log2, c.x));
        x[i][j] = p * c.y;  // dV = Pᵀ·(g/Σ): the 1/Σ goes with the weight
        y[i][j] = p * fmaf(y[i][j], c.y, c.z);
      }
    }
    if (ragged) {  // no term of a query past S
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (q0 + cg + 8 * j >= s) {
#pragma unroll
          for (int i = 0; i < RI; ++i) x[i][j] = y[i][j] = 0.f;
        }
      }
    }
    f::stage<RI, CJ>(ws, x, rg, cg);
    f::stage<RI, CJ>(ws + kW, y, rg, cg);
    __syncthreads();
    f::staged_sums<D, RI, C>(dva, ws, gt, rg, cg);
    f::staged_sums<D, RI, C>(dka, ws + kW, qt, rg, cg);
    __syncthreads();  // every warp is done with this tile's buffers (and P, dS) before they refill
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + rg + 16 * i;
    if (row >= s) continue;
    const size_t off = base + static_cast<size_t>(row) * D;
    f::store_row<D, true>(dk + off, dka[i], cg, [&](float a) { return a * scale; });
    f::store_row<D, true>(dv + off, dva[i], cg, [](float a) { return a; });
  }
}

// D <= 16, and D = 32 at S <= 32: one row a thread. At these depths a pair costs more in its exp
// and dS than in its products, and a micro-tile's logits, dP and accumulators outgrow the
// registers that the depth saves; so every lane of a warp takes the same streamed row, each
// shared-memory read is a broadcast, and the pair's arithmetic runs once per pair, in
// registers. Mirrored by ops/flash_attention.py:F32_ROWS.
constexpr int kRowThreads = 64;  // rows a block, one a thread
constexpr int kRowTile = 32;     // streamed rows a tile

// Streamed rows in flight: four at D <= 16; one at D = 32, whose rows take 32 registers each.
template <int D>
__host__ __device__ constexpr int row_unroll() {
  return D <= 16 ? 4 : 1;
}

// Row `row` of a (bh·s, D) array into registers as float4s; zeros where `ok` is false.
template <int D>
__device__ __forceinline__ void load_row(float (&r)[D], const float* src, bool ok) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 v = ok ? *reinterpret_cast<const float4*>(src + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    r[d] = v.x, r[d + 1] = v.y, r[d + 2] = v.z, r[d + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[D], float mul) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    *reinterpret_cast<float4*>(dst + d) =
        make_float4(r[d] * mul, r[d + 1] * mul, r[d + 2] * mul, r[d + 3] * mul);
  }
}

// Rows first..first + kRowTile − 1 of x into a [kRowTile][D] tile; zeros past S.
template <int D>
__device__ __forceinline__ void load_row_tile(float (*dst)[D], const float* x, size_t base, int first,
                                              int s) {
  for (int c = threadIdx.x; c < kRowTile * D / 4; c += kRowThreads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const bool ok = first + r < s;
    afdm::cp_async_16(&dst[r][col], x + base + (ok ? static_cast<size_t>(first + r) * D + col : 0),
                      ok ? 16 : 0);
  }
}

// dQ, and per query (−m·log2e, 1/Σ, −δ/Σ) for the dK/dV pass.
template <int D>
__global__ void __launch_bounds__(kRowThreads)
    flash_bwd_dq_f32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ out,
                                 const float* __restrict__ g, const float* __restrict__ m,
                                 const float* __restrict__ l, float* __restrict__ dq,
                                 float4* __restrict__ consts, int s, int row_tiles, float scale,
                                 float scale_log2) {
  __shared__ __align__(16) float ks[2][kRowTile][D];
  __shared__ __align__(16) float vs[2][kRowTile][D];
  const int bh = blockIdx.x / row_tiles;
  const int row = (blockIdx.x % row_tiles) * kRowThreads + threadIdx.x;
  const bool valid = row < s;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t sbase = static_cast<size_t>(bh) * s;
  load_row_tile<D>(ks[0], k, base, 0, s);
  load_row_tile<D>(vs[0], v, base, 0, s);
  afdm::cp_async_commit();

  // A thread past the last row keeps zeros: its dS is 0·finite, never stored.
  const size_t roff = base + static_cast<size_t>(valid ? row : 0) * D;
  float qr[D], gr[D], orow[D], acc[D];
  load_row<D>(qr, q + roff, valid);
  load_row<D>(gr, g + roff, valid);
  load_row<D>(orow, out + roff, valid);
  float delta = 0.f;  // δ = Σ_d g·out
#pragma unroll
  for (int d = 0; d < D; ++d) {
    delta = fmaf(gr[d], orow[d], delta);
    acc[d] = 0.f;
  }
  const float nm = valid ? -m[sbase + row] * kLog2eF32 : 0.f;
  const float il = valid ? 1.f / l[sbase + row] : 0.f;
  const float nd = -delta * il;
  if (valid) consts[sbase + row] = make_float4(nm, il, nd, 0.f);

  const int n_tiles = (s + kRowTile - 1) / kRowTile;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_row_tile<D>(ks[(t + 1) & 1], k, base, (t + 1) * kRowTile, s);
      load_row_tile<D>(vs[(t + 1) & 1], v, base, (t + 1) * kRowTile, s);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const int nk = min(kRowTile, s - t * kRowTile);
#pragma unroll (row_unroll<D>())
    for (int j = 0; j < nk; ++j) {  // stops at the last real key: no masked term is formed
      float kr[D], vr[D];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&ks[t & 1][j][d]);
        const float4 b = *reinterpret_cast<const float4*>(&vs[t & 1][j][d]);
        kr[d] = a.x, kr[d + 1] = a.y, kr[d + 2] = a.z, kr[d + 3] = a.w;
        vr[d] = b.x, vr[d + 1] = b.y, vr[d + 2] = b.z, vr[d + 3] = b.w;
      }
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qr[d], kr[d], dot);
        dp = fmaf(gr[d], vr[d], dp);
      }
      // P = 2^(q·k·scale·log2e − m·log2e), unnormalised; dS = P·(dP/Σ − δ/Σ).
      const float p = afdm::ex2(fmaf(dot, scale_log2, nm));
      const float ds = p * fmaf(dp, il, nd);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
    __syncthreads();  // every thread is done with this tile's buffers before they refill
  }
  if (valid) store_row<D>(dq + roff, acc, scale);
}

// dK and dV: each thread one key, over tiles of queries with their constants.
template <int D>
__global__ void __launch_bounds__(kRowThreads)
    flash_bwd_dkv_f32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ g,
                                  const float4* __restrict__ consts, float* __restrict__ dk,
                                  float* __restrict__ dv, int s, int row_tiles, float scale,
                                  float scale_log2) {
  __shared__ __align__(16) float qs[2][kRowTile][D];
  __shared__ __align__(16) float gs[2][kRowTile][D];
  __shared__ float4 cs[2][kRowTile];
  const int bh = blockIdx.x / row_tiles;
  const int row = (blockIdx.x % row_tiles) * kRowThreads + threadIdx.x;
  const bool valid = row < s;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const size_t sbase = static_cast<size_t>(bh) * s;
  auto load_tile = [&](int buf, int q0) {
    load_row_tile<D>(qs[buf], q, base, q0, s);
    load_row_tile<D>(gs[buf], g, base, q0, s);
    for (int c = threadIdx.x; c < kRowTile; c += kRowThreads) {
      const bool ok = q0 + c < s;
      afdm::cp_async_16(&cs[buf][c], consts + sbase + (ok ? q0 + c : 0), ok ? 16 : 0);
    }
  };
  load_tile(0, 0);
  afdm::cp_async_commit();

  // A thread past the last key keeps zero rows; what it accumulates is never stored.
  const size_t roff = base + static_cast<size_t>(valid ? row : 0) * D;
  float kr[D], vr[D], dka[D], dva[D];
  load_row<D>(kr, k + roff, valid);
  load_row<D>(vr, v + roff, valid);
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;

  const int n_tiles = (s + kRowTile - 1) / kRowTile;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile((t + 1) & 1, (t + 1) * kRowTile);
      afdm::cp_async_commit();
      afdm::cp_async_wait<1>();
    } else {
      afdm::cp_async_wait<0>();
    }
    __syncthreads();
    const int nq = min(kRowTile, s - t * kRowTile);
#pragma unroll (row_unroll<D>())
    for (int r = 0; r < nq; ++r) {  // stops at the last real query
      float qv[D], gv[D];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[t & 1][r][d]);
        const float4 b = *reinterpret_cast<const float4*>(&gs[t & 1][r][d]);
        qv[d] = a.x, qv[d + 1] = a.y, qv[d + 2] = a.z, qv[d + 3] = a.w;
        gv[d] = b.x, gv[d + 1] = b.y, gv[d + 2] = b.z, gv[d + 3] = b.w;
      }
      const float4 c = cs[t & 1][r];  // −m·log2e, 1/Σ, −δ/Σ
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(kr[d], qv[d], dot);
        dp = fmaf(vr[d], gv[d], dp);
      }
      const float p = afdm::ex2(fmaf(dot, scale_log2, c.x));
      const float w = p * c.y;  // dV = Pᵀ·(g/Σ): the 1/Σ goes with the weight
      const float ds = p * fmaf(dp, c.y, c.z);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(w, gv[d], dva[d]);
        dka[d] = fmaf(ds, qv[d], dka[d]);
      }
    }
    __syncthreads();  // every thread is done with this tile's buffers before they refill
  }
  if (valid) {
    store_row<D>(dk + roff, dka, scale);
    store_row<D>(dv + roff, dva, 1.f);
  }
}

template <typename Kernel>
cudaError_t raise_f32_smem(Kernel kernel, int bytes, std::atomic<bool> (&done)[afdm::kMaxDevices],
                           cudaStream_t stream) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return afdm::raise_smem_limit_once(reinterpret_cast<const void*>(kernel), bytes, done, stream);
}

template <int D>
cudaError_t launch_f32_rows(const float* q, const float* k, const float* v, const float* out,
                            const float* g, const float* m, const float* l, float* dq, float* dk,
                            float* dv, float4* consts, int bh, int s, float scale,
                            cudaStream_t stream) {
  const int tiles = (s + kRowThreads - 1) / kRowThreads;
  const long long blocks = static_cast<long long>(bh) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_f32_rows_kernel<D><<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
      q, k, v, out, g, m, l, dq, consts, s, tiles, scale, scale * kLog2eF32);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Same stream: the dK/dV pass starts after every query's constants are written.
  flash_bwd_dkv_f32_rows_kernel<D><<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
      q, k, v, g, consts, dk, dv, s, tiles, scale, scale * kLog2eF32);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_tiles(const float* q, const float* k, const float* v, const float* out,
                             const float* g, const float* m, const float* l, float* dq,
                             float* dk, float* dv, float4* consts, int bh, int s, float scale,
                             cudaStream_t stream) {
  constexpr int kDqRows = 16 * DqTile<D>::kRI, kKvRows = 16 * DkvTile<D>::kRI;
  constexpr int kDqSmem = dq_f32_smem_bytes<D>(), kKvSmem = dkv_f32_smem_bytes<D>();
  const int dq_tiles = (s + kDqRows - 1) / kDqRows, kv_tiles = (s + kKvRows - 1) / kKvRows;
  const long long dq_blocks = static_cast<long long>(bh) * dq_tiles;
  const long long kv_blocks = static_cast<long long>(bh) * kv_tiles;
  if (dq_blocks > INT_MAX || kv_blocks > INT_MAX) return cudaErrorInvalidValue;
  static std::atomic<bool> dq_set[afdm::kMaxDevices], kv_set[afdm::kMaxDevices];
  cudaError_t err = raise_f32_smem(flash_bwd_dq_f32_kernel<D>, kDqSmem, dq_set, stream);
  if (err != cudaSuccess) return err;
  err = raise_f32_smem(flash_bwd_dkv_f32_kernel<D>, kKvSmem, kv_set, stream);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D>
      <<<static_cast<unsigned>(dq_blocks), afdm::f32::kThreads, kDqSmem, stream>>>(
          q, k, v, out, g, m, l, dq, consts, s, dq_tiles, scale, scale * kLog2eF32);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Same stream: the dK/dV pass starts after every query's constants are written.
  flash_bwd_dkv_f32_kernel<D>
      <<<static_cast<unsigned>(kv_blocks), afdm::f32::kThreads, kKvSmem, stream>>>(
          q, k, v, g, consts, dk, dv, s, kv_tiles, scale, scale * kLog2eF32);
  return cudaGetLastError();
}

// One row a thread at D <= 16, and at D = 32 where S fits one tile (the micro-tiles' 64 rows
// would stand mostly past S); register micro-tiles otherwise.
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* out,
                       const void* g, const float* m, const float* l, void* dq, void* dk,
                       void* dv, float4* consts, int bh, int s, float scale, cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(out);
  const float* gf = static_cast<const float*>(g);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if constexpr (D <= 32) {
    if (D <= 16 || s <= kRowTile) {
      return launch_f32_rows<D>(qf, kf, vf, of, gf, m, l, dqf, dkf, dvf, consts, bh, s, scale,
                                stream);
    }
  }
  if constexpr (D >= 32) {
    return launch_f32_tiles<D>(qf, kf, vf, of, gf, m, l, dqf, dkf, dvf, consts, bh, s, scale,
                               stream);
  }
  return cudaErrorInvalidValue;  // not reached: D <= 16 takes one row a thread
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

// K and V fragments from shared memory (ldmatrix per step) instead of registers: at D = 128.
template <int D>
__host__ __device__ constexpr bool kv_in_smem() {
  return D == 128;
}

// Bytes of dynamic shared memory of flash_bwd_mma_kernel<D>: two buffers of the query tile's
// constants, Q, g and g/Σ; the block's K tile (and V tile at D = 128); the dSᵀ tile.
template <int D>
constexpr int bwd_smem_bytes() {
  constexpr int kT = afdm::smem_stride<D>();
  return 2 * kQTile * 16 + 3 * 2 * kQTile * kT * 2 + (kv_in_smem<D>() ? 2 : 1) * kKeyBlock * kT * 2 +
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
  constexpr bool kKvSmem = kv_in_smem<D>();
  constexpr int kFragSteps = kKvSmem ? 1 : kSteps;  // register fragments (none used at D = 128)
  constexpr int kDqCols = D < 64 ? D : 64;           // dQ columns per pass of its product
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cs = reinterpret_cast<float4*>(smem);           // [2][kQTile] row constants
  bf16* qs = reinterpret_cast<bf16*>(cs + 2 * kQTile);    // [2][kQTile × kT] Q
  bf16* gs = qs + 2 * kTileElems;                         // [2][...] g
  bf16* ss = gs + 2 * kTileElems;                         // [2][...] g/Σ
  bf16* ks = ss + 2 * kTileElems;                         // [kKeyBlock × kT] the block's K
  bf16* vs = ks + kKeyBlock * kT;                         // [kKeyBlock × kT] V (D = 128 only)
  bf16* dst = vs + (kKvSmem ? kKeyBlock * kT : 0);        // [kKeyBlock × kDsStride] dSᵀ

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
    if constexpr (kKvSmem) afdm::cp_async_16(vs + r * kT + col, v + off, ok ? 16 : 0);
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
  uint32_t kf[kFragSteps][4], vf[kFragSteps][4];
#pragma unroll
  for (int t = 0; t < (kKvSmem ? 0 : kSteps); ++t) {
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
            uint32_t ka[4], va[4], b[4];
            if constexpr (kKvSmem) {
              afdm::ldsm_a_mk(ka, ks, kT, 16 * warp, 16 * t, lane);
              afdm::ldsm_a_mk(va, vs, kT, 16 * warp, 16 * t, lane);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) ka[e] = kf[t][e], va[e] = vf[t][e];
            }
            afdm::ldsm_b_nk(b, qt_s, kT, 16 * c, 16 * t, lane);
            afdm::mma_m16n8k16(sc[0], ka, b[0], b[1], sc[0]);
            afdm::mma_m16n8k16(sc[1], ka, b[2], b[3], sc[1]);
            afdm::ldsm_b_nk(b, g_s, kT, 16 * c, 16 * t, lane);
            afdm::mma_m16n8k16(dp[0], va, b[0], b[1], dp[0]);
            afdm::mma_m16n8k16(dp[1], va, b[2], b[3], dp[1]);
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

    // dQ of queries q0 + 16·warp .. +15 over the block's real keys, added into the scratch, in
    // passes of kDqCols columns (two at D = 128, one below).
    const int qa = q0 + 16 * warp + group, qb = qa + 8;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += kDqCols) {
      float dqa[kDqCols / 8][4];
#pragma unroll
      for (int n = 0; n < kDqCols / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
      for (int kk = 0; kk < key_warps; ++kk) {
        uint32_t a[4];
        afdm::ldsm_a_km(a, dst, kDsStride, 16 * kk, 16 * warp, lane);
        if constexpr (D == 8) {
          uint32_t b[2];
          afdm::ldsm_b_kn8(b, ks, kT, 16 * kk, 0, lane);
          afdm::mma_m16n8k16(dqa[0], a, b[0], b[1], dqa[0]);
        } else {
#pragma unroll
          for (int u = 0; u < kDqCols / 16; ++u) {
            uint32_t b[4];
            afdm::ldsm_b_kn(b, ks, kT, 16 * kk, c0 + 16 * u, lane);
            afdm::mma_m16n8k16(dqa[2 * u], a, b[0], b[1], dqa[2 * u]);
            afdm::mma_m16n8k16(dqa[2 * u + 1], a, b[2], b[3], dqa[2 * u + 1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kDqCols / 8; ++n) {
        const int col = c0 + 8 * n + 2 * quad;
        if (qa < s) {
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (sbase + qa) * D + col),
                    make_float2(dqa[n][0], dqa[n][1]));
        }
        if (qb < s) {
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (sbase + qb) * D + col),
                    make_float2(dqa[n][2], dqa[n][3]));
        }
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
    static std::atomic<bool> smem_set[afdm::kMaxDevices];
    err = afdm::raise_smem_limit_once(reinterpret_cast<const void*>(flash_bwd_mma_kernel<D>),
                                      kSmem, smem_set, stream);
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
// (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned (cp.async). m, l: the forward's (bh, s)
// f32 softmax max and sum. Scratch, allocated by the caller (ops/flash_attention.py:bwd_scratch):
//   f32:  consts (bh, s, 4) f32, per query (m, 1/Σ, δ, 0) from the dQ pass; dq_acc and g_scaled
//         null;
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
  float4* c4 = static_cast<float4*>(consts);
  float* acc = static_cast<float*>(dq_acc);
  bf16* gsc = static_cast<bf16*>(g_scaled);
  cudaError_t err;
  switch (d) {
    case 8:
      err = is_bf16 ? launch_mma<8>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                    scale, st)
                    : launch_f32<8>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, bh, s, scale, st);
      break;
    case 16:
      err = is_bf16 ? launch_mma<16>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                     scale, st)
                    : launch_f32<16>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, bh, s, scale, st);
      break;
    case 32:
      err = is_bf16 ? launch_mma<32>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                     scale, st)
                    : launch_f32<32>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, bh, s, scale, st);
      break;
    case 64:
      err = is_bf16 ? launch_mma<64>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                     scale, st)
                    : launch_f32<64>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, bh, s, scale, st);
      break;
    case 128:
      err = is_bf16 ? launch_mma<128>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, acc, gsc, bh, s,
                                      scale, st)
                    : launch_f32<128>(q, k, v, out, g, mf, lf, dq, dk, dv, c4, bh, s, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
