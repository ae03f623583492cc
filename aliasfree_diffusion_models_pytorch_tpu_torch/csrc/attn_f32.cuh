// f32 attention building blocks for Hopper (sm_90a) on the FMA pipes, shared by the f32 kernels
// of flash_fwd.cu (every depth) and flash_bwd.cu (D >= 32): a block of four warps, register
// micro-tiles of products between a tile the block owns and a tile it streams, and the two ways
// the second product of a pass sums over the streamed tile.
//
// The thread map (the CPU tests simulate it: tests/test_torch_attention_f32.py):
//  * 128 threads; lane l of warp w is row group rg = 4w + l/8 (0..15) and column group
//    cg = l % 8. The eight lanes of a row group are one aligned group of eight lanes of one warp,
//    so a reduction over a row takes three xor-shuffles (1, 2, 4).
//  * The block owns R = 16·RI rows (queries in the forward and the dQ pass, keys in the dK/dV
//    pass); a thread holds rows rg + 16·i, i < RI. The block streams tiles of C = 8·CJ rows of
//    the other operand; a thread takes columns cg + 8·j, j < CJ. Strided, not contiguous: the
//    eight column groups then read eight neighbouring rows, and rows padded to D + 4 floats fall
//    into eight different 16-byte bank groups, so every float4 read is conflict-free.
//  * Products over the depth (dots): x[i][j] = Σ_d a[rg + 16i][d]·b[cg + 8j][d], d ascending,
//    one FMA a term, four depths a float4: each value read from shared memory feeds RI or CJ
//    FMAs (RI·CJ·4 FMAs per RI + CJ 16-byte reads).
//  * The second product sums a weight w[i][j] times a streamed row over the streamed tile:
//      lane sums (the forward at D <= 16): each thread sums its own CJ columns into all D
//        outputs of its RI rows; the eight lanes of a row are added by xor-shuffles once, after
//        the last tile. RI·4 FMAs per 16-byte read, and no staging.
//      staged (D >= 32): the weights go through shared memory, stored [column][row] with the
//        thread's RI rows side by side (one float2/float4 store and load), and each lane owns
//        D/8 output columns, the float4 chunks cg + 8·k: RI·D/8 accumulators instead of RI·D.
// Every sum runs in a fixed order (no atomics), so the kernels are deterministic.

#pragma once

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace afdm {
namespace f32 {

constexpr int kThreads = 128;
// Blocks an SM should hold at once: caps a thread at 168 registers (three blocks of four warps an
// SM). Without the cap the compiler keeps a whole unrolled depth's loads in flight, up to 255
// registers and two blocks an SM, and spills where even that is short.
constexpr int kMinBlocks = 3;

// Depth chunks of dots() in flight: two, but one at D = 16, where the forward's lane sums hold
// 64 accumulators a thread and a second chunk's loads would spill.
template <int D>
__host__ __device__ constexpr int dot_unroll() {
  return D == 16 ? 1 : 2;
}

// Row stride of a [rows][D] f32 tile in shared memory: 16 bytes of padding.
template <int D>
__host__ __device__ constexpr int stride() {
  return D + 4;
}

// Row stride of a staged [C][R] weight tile.
template <int R>
__host__ __device__ constexpr int wstride() {
  return R + 4;
}

// Copies `rows` rows of D floats into a [rows][D + 4] tile, 16 bytes a copy; row r comes from
// src(r), and where src(r) is null it is filled with zeros (`any` is a valid address that is
// never read).
template <int D, typename Src>
__device__ __forceinline__ void load_rows(float* dst, int rows, const float* any, Src src) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const float* row = src(r);
    cp_async_16(dst + r * stride<D>() + col, row ? row + col : any, row ? 16 : 0);
  }
}

// x[i][j] = Σ_d a[rg + 16i][d]·b[cg + 8j][d], d ascending from zero.
template <int D, int RI, int CJ>
__device__ __forceinline__ void dots(float (&x)[RI][CJ], const float* a, const float* b, int rg,
                                     int cg) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CJ; ++j) x[i][j] = 0.f;
  }
#pragma unroll (dot_unroll<D>())
  for (int d = 0; d < D; d += 4) {
    float4 av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (rg + 16 * i) * stride<D>() + d);
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(b + (cg + 8 * j) * stride<D>() + d);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        x[i][j] = fmaf(av[i].x, bv[j].x, x[i][j]);
        x[i][j] = fmaf(av[i].y, bv[j].y, x[i][j]);
        x[i][j] = fmaf(av[i].z, bv[j].z, x[i][j]);
        x[i][j] = fmaf(av[i].w, bv[j].w, x[i][j]);
      }
    }
  }
}

// Lane sums: o[i][d] += Σ_j w[i][j]·e[cg + 8j][d], j ascending.
template <int D, int RI, int CJ>
__device__ __forceinline__ void lane_sums(float (&o)[RI][D], const float (&w)[RI][CJ],
                                          const float* e, int cg) {
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const float* row = e + (cg + 8 * j) * stride<D>();
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 ev = *reinterpret_cast<const float4*>(row + d);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        o[i][d] = fmaf(w[i][j], ev.x, o[i][d]);
        o[i][d + 1] = fmaf(w[i][j], ev.y, o[i][d + 1]);
        o[i][d + 2] = fmaf(w[i][j], ev.z, o[i][d + 2]);
        o[i][d + 3] = fmaf(w[i][j], ev.w, o[i][d + 3]);
      }
    }
  }
}

// Adds the eight lanes of each row group: afterwards every lane holds the same sums (each step
// adds two equal-order partial sums, and f32 addition commutes).
template <int N>
__device__ __forceinline__ void row_group_sum(float (&v)[N]) {
#pragma unroll
  for (int mask = 1; mask < 8; mask <<= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], mask);
  }
}

__device__ __forceinline__ float row_group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

// Staged weights: ws[(cg + 8j)·(R + 4) + rg·RI + i] = w[i][j].
template <int RI, int CJ>
__device__ __forceinline__ void stage(float* ws, const float (&w)[RI][CJ], int rg, int cg) {
  constexpr int kW = wstride<16 * RI>();
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    float* dst = ws + (cg + 8 * j) * kW + rg * RI;
    if constexpr (RI == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(w[0][j], w[1][j], w[2][j], w[3][j]);
    } else {
      static_assert(RI == 2, "staged tiles hold 2 or 4 rows a thread");
      *reinterpret_cast<float2*>(dst) = make_float2(w[0][j], w[1][j]);
    }
  }
}

// Staged sums: o[i][4k + e] += Σ_{c < C} ws[c][rg·RI + i]·e[c][4(cg + 8k) + e], c ascending: the
// lane's output columns are the float4 chunks cg + 8k, k < D/32.
template <int D, int RI, int C>
__device__ __forceinline__ void staged_sums(float (&o)[RI][D / 8], const float* ws, const float* e,
                                            int rg, int cg) {
  static_assert(D % 32 == 0, "staged sums need D/8 columns a lane in float4 chunks");
  constexpr int kW = wstride<16 * RI>();
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float w[RI];
    if constexpr (RI == 4) {
      const float4 v = *reinterpret_cast<const float4*>(ws + c * kW + rg * RI);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(ws + c * kW + rg * RI);
      w[0] = v.x, w[1] = v.y;
    }
    const float* row = e + c * stride<D>() + 4 * cg;
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      const float4 ev = *reinterpret_cast<const float4*>(row + 32 * k);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        o[i][4 * k] = fmaf(w[i], ev.x, o[i][4 * k]);
        o[i][4 * k + 1] = fmaf(w[i], ev.y, o[i][4 * k + 1]);
        o[i][4 * k + 2] = fmaf(w[i], ev.z, o[i][4 * k + 2]);
        o[i][4 * k + 3] = fmaf(w[i], ev.w, o[i][4 * k + 3]);
      }
    }
  }
}

// Stores one row's outputs, each through f: o holds all D values (lane sums: lane cg writes the
// float4 chunks c with c % 8 == cg) or the lane's own D/8 (staged: chunks cg + 8k).
template <int D, bool kStaged, int N, typename F>
__device__ __forceinline__ void store_row(float* dst, const float (&o)[N], int cg, F f) {
  if constexpr (kStaged) {
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      *reinterpret_cast<float4*>(dst + 4 * (cg + 8 * k)) =
          make_float4(f(o[4 * k]), f(o[4 * k + 1]), f(o[4 * k + 2]), f(o[4 * k + 3]));
    }
  } else {
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      if (c % 8 == cg) {
        *reinterpret_cast<float4*>(dst + 4 * c) =
            make_float4(f(o[4 * c]), f(o[4 * c + 1]), f(o[4 * c + 2]), f(o[4 * c + 3]));
      }
    }
  }
}

}  // namespace f32
}  // namespace afdm
