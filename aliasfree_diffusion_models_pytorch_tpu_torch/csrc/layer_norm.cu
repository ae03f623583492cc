// LayerNorm over the channels of (n, S, C) tokens, forward and backward, on bf16 and f32, for
// Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces no Pallas kernel: the JAX package's attention block normalises its tokens with
// flax's nn.LayerNorm, which XLA fuses. The port's SelfAttention (models/blocks.py) normalises
// twice a block: `ln` on the block's NCHW map read as tokens (the view x.flatten(2).transpose(1,
// 2), channel-major: a channel's S tokens lie together) and `ff_ln` on the residual sum, which
// is (n, S, C) in row order. nn.LayerNorm ran both as PyTorch's row kernels, one block a row of
// C = 32-128 channels, and copied the channel-major view into row order first. The plain version
// is ops/layer_norm.py:layer_norm_plain (and layer_norm_bwd_plain); the CPU keeps F.layer_norm.
//
// The function, per token row x of C channels, weight w and bias b (eps from the module):
//   mean = Σx / C,  rstd = rsqrt(Σ(x − mean)² / C + eps)  (two passes over the row, in f32),
//   y = fma(w, (x − mean)·rstd, b), rounded once to the input's type; mean and rstd are kept (f32).
// Backward, for the cotangent dy (row order), with x̂ = (x − mean)·rstd recomputed from them:
//   g = w·dy,  A = Σ g,  B = Σ g·x̂  (over the row),  dx = (C·g − x̂·B − A)·(rstd / C),
//   dw = Σ_rows dy·x̂,  db = Σ_rows dy.
// PyTorch's CUDA LayerNorm computes y and dx in the same order; it sums the moments another way
// (Welford), so bf16 results may differ from it by one unit in the last place.
//
// What bounds it: bytes. The forward reads x and writes y (4 bytes an element in bf16), the
// backward reads x and dy and writes dx (6), against ~8 and ~16 f32 instructions an element: at
// 3.35 TB/s and 33.5 T instructions/s the bytes bound both by a wide margin.
//
// Design. A warp owns a tile of `tw` consecutive tokens (a multiple of the 8 bf16 or 4 f32 that
// fill 16 bytes, up to about 4 KB, smaller where a call's rows would leave the card's warps
// without tiles: ops/layer_norm.py:tile_tokens) across all C channels, in its own slice of
// shared memory, in row order: row r, 16-byte word j of it (channels j·8 ..., or j·4 ... in f32) at word
// r·(C / 8) + (j xor swz(r)), swz(r) = ((r / 8)·swz_stride) & swz_mask (r / 4 in f32; the plan of
// ops/layer_norm.py:ln_plan), a permutation of each row's words that keeps the channel-major
// moves below from meeting in a bank. Loading the tile:
//   * row order: the tile is one contiguous span, copied in 16-byte words by cp.async;
//   * channel-major: the lanes walk (channel, 16-byte word along S) items, consecutive lanes on
//     consecutive words of one channel's tokens, so a warp's load covers whole 32-byte sectors
//     and lines of each channel it touches, eight items a lane in flight; each word's tokens go
//     into the tile one element at a time. Where S is not a multiple of those 8 or 4 tokens
//     the same walk reads one token at a time.
// Then `lpr` lanes (a power of two, at most 32) take a row, each `cpl` 16-byte words of it, and
// the rows of the tile go through 32 / lpr at a time: each lane reads its words from shared
// memory once, the row's sums go through lpr lanes by xor shuffles (no barrier), and the
// normalised words go back in place. The tile leaves in 16-byte words: row order as one span;
// channel-major (dx) by the reverse of the load's walk. A warp walks its tiles in a grid-stride
// loop over a grid of at most as many 256-thread blocks as the card holds at once, sized from
// the row count (a small call takes few blocks, each warp a tile). The backward's dw and db are
// summed in registers over a lane's rows, then across the warp by shuffles and across the
// block's warps in shared memory, in a fixed order, into one f32 partial row a block; a second
// launch sums the partial rows in a fixed order. No atomics: two runs give equal gradients.
// Nothing is allocated here and nothing synchronises with the host: the caller allocates y,
// dx, mean, rstd, the partial rows and dw, db (ops/layer_norm.py), and the launches can be
// captured in a CUDA graph.

#include <atomic>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entry.cuh"
#include "mma_bf16.cuh"  // cp_async_16 and its waits, raise_smem_limit_once

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowMajor = 0, kChannelMajor = 1;
constexpr int kMaxTileTokens = 64;  // rows of a warp's tile at most (ops/layer_norm.py:LN_MAX_TW)
// 16-byte words a lane has in flight when loading along S: forward, backward (which holds its
// dw and db sums in registers besides)
constexpr int kBatchFwd = 8, kBatchBwd = 4;
constexpr int kParts = 32;          // partial rows the second launch sums apart, per column

struct Plan {
  long long rows;    // tokens over all images: n·S
  long long tokens;  // S, the tokens of an image (a channel's stride, channel-major)
  int channels;      // C
  int chunks;        // 16-byte words a row: C / kVec
  int lpr;           // lanes a row, a power of two
  int tw;            // rows of a warp's tile, a multiple of kVec
  int swz_stride;    // the tile's word permutation: j xor ((r / kVec)·swz_stride & swz_mask)
  int swz_mask;
  int layout;        // kRowMajor or kChannelMajor
  int along_s;       // channel-major: whole 16-byte words along S
  float eps;
};

// A type's 16-byte words, as floats and as the elements' bits.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  using Bits = unsigned;
  __device__ static void unpack(const uint4& w, float (&v)[kVec]) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 pack(const float (&v)[kVec]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static void split(const uint4& w, Bits (&b)[kVec]) {
    b[0] = w.x;
    b[1] = w.y;
    b[2] = w.z;
    b[3] = w.w;
  }
  __device__ static uint4 join(const Bits (&b)[kVec]) {
    return make_uint4(b[0], b[1], b[2], b[3]);
  }
  __device__ static float out(float v) { return v; }
};

template <>
struct Io<bf16> {
  static constexpr int kVec = 8;
  using Bits = unsigned short;
  __device__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ static float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static unsigned bits(float v) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  __device__ static void unpack(const uint4& w, float (&v)[kVec]) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = lo(u[i]);
      v[2 * i + 1] = hi(u[i]);
    }
  }
  __device__ static uint4 pack(const float (&v)[kVec]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = bits(v[2 * i]) | bits(v[2 * i + 1]) << 16;
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
  __device__ static void split(const uint4& w, Bits (&b)[kVec]) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = static_cast<Bits>(u[i] & 0xffffu);
      b[2 * i + 1] = static_cast<Bits>(u[i] >> 16);
    }
  }
  __device__ static uint4 join(const Bits (&b)[kVec]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = static_cast<unsigned>(b[2 * i]) | static_cast<unsigned>(b[2 * i + 1]) << 16;
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
  __device__ static bf16 out(float v) { return __float2bfloat16_rn(v); }
};

// The tile's 16-byte word that holds word j of row r.
template <typename T>
__device__ __forceinline__ int word_at(const Plan& p, int r, int j) {
  return r * p.chunks + (j ^ ((r / Io<T>::kVec * p.swz_stride) & p.swz_mask));
}

// The sum over the `lpr` lanes of a row (aligned groups of consecutive lanes); every lane of
// the warp takes part.
__device__ __forceinline__ float row_sum(float v, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row order in: the tile's `rows` rows from device memory, a committed cp.async group (the
// caller waits).
// Walks the 16-byte words m = lane, lane + 32, ... of a span of `rows` rows, with the row r
// and the word j of it that each is (carried from one to the next, not divided out).
struct SpanWalk {
  int m, r, j;
  const int end, chunks, dr, dj;
  __device__ SpanWalk(int lane, int rows, int chunks_)
      : m(lane), r(lane / chunks_), j(lane % chunks_), end(rows * chunks_), chunks(chunks_),
        dr(32 / chunks_), dj(32 % chunks_) {}
  __device__ bool more() const { return m < end; }
  __device__ void next() {
    m += 32;
    r += dr;
    j += dj;
    if (j >= chunks) {
      j -= chunks;
      ++r;
    }
  }
};

template <typename T>
__device__ __forceinline__ void load_span(const T* __restrict__ src, const Plan& p, int rows,
                                          unsigned char* tile, int lane) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(tile);
  for (SpanWalk w(lane, rows, p.chunks); w.more(); w.next()) {
    afdm::cp_async_16(d + word_at<T>(p, w.r, w.j), s + w.m);
  }
  afdm::cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void store_span(T* __restrict__ dst, const Plan& p, int rows,
                                           const unsigned char* tile, int lane) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(tile);
  for (SpanWalk w(lane, rows, p.chunks); w.more(); w.next()) d[w.m] = s[word_at<T>(p, w.r, w.j)];
}

// Element (row r, channel c) of the tile, as bits.
template <typename T>
__device__ __forceinline__ typename Io<T>::Bits& element(const Plan& p, unsigned char* tile,
                                                          int r, int c) {
  constexpr int V = Io<T>::kVec;
  return reinterpret_cast<typename Io<T>::Bits*>(tile)[word_at<T>(p, r, c / V) * V + c % V];
}

// Where (token tok of the whole call, channel c) lies in a channel-major map.
__device__ __forceinline__ long long cm_offset(const Plan& p, int tok, int c) {
  const int s_len = static_cast<int>(p.tokens), img = tok / s_len;
  return (static_cast<long long>(img) * p.channels + c) * s_len + (tok - img * s_len);
}

// Channel-major in: the tile's `rows` tokens from g0 on, of every channel, into the tile. Items
// (channel c, word w along S) with w fastest, so consecutive lanes read consecutive words;
// kBatch of them a lane in flight.
template <int kBatch, typename T>
__device__ __forceinline__ void load_channels(const T* __restrict__ x, const Plan& p,
                                              long long g0, int rows, unsigned char* tile,
                                              int lane) {
  using Bits = typename Io<T>::Bits;
  constexpr int V = Io<T>::kVec;
  const Bits* xb = reinterpret_cast<const Bits*>(x);
  if (p.along_s) {
    const int words = rows / V, items = p.channels * words;  // rows is a multiple of V here
    for (int base = 0; base < items; base += 32 * kBatch) {
      uint4 a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + lane + 32 * u, c = i / words;
        if (i < items) {
          const int tok = static_cast<int>(g0) + (i - c * words) * V;
          a[u] = __ldg(reinterpret_cast<const uint4*>(xb + cm_offset(p, tok, c)));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + lane + 32 * u, c = i / words;
        if (i < items) {
          Bits b[V];
          Io<T>::split(a[u], b);
          const int r0 = (i - c * words) * V;
#pragma unroll
          for (int k = 0; k < V; ++k) element<T>(p, tile, r0 + k, c) = b[k];
        }
      }
    }
  } else {
    for (int i = lane; i < p.channels * rows; i += 32) {
      const int c = i / rows, r = i - c * rows;
      element<T>(p, tile, r, c) = xb[cm_offset(p, static_cast<int>(g0) + r, c)];
    }
  }
}

// Channel-major out: the reverse of load_channels.
template <typename T>
__device__ __forceinline__ void store_channels(T* __restrict__ out, const Plan& p, long long g0,
                                               int rows, unsigned char* tile, int lane) {
  using Bits = typename Io<T>::Bits;
  constexpr int V = Io<T>::kVec;
  Bits* ob = reinterpret_cast<Bits*>(out);
  if (p.along_s) {
    const int words = rows / V, items = p.channels * words;
    for (int i = lane; i < items; i += 32) {
      const int c = i / words, r0 = (i - c * words) * V;
      Bits b[V];
#pragma unroll
      for (int k = 0; k < V; ++k) b[k] = element<T>(p, tile, r0 + k, c);
      const long long at = cm_offset(p, static_cast<int>(g0) + r0, c);
      *reinterpret_cast<uint4*>(ob + at) = Io<T>::join(b);
    }
  } else {
    for (int i = lane; i < p.channels * rows; i += 32) {
      const int c = i / rows, r = i - c * rows;
      ob[cm_offset(p, static_cast<int>(g0) + r, c)] = element<T>(p, tile, r, c);
    }
  }
}

// This lane's channels of w (and b): the words jl + lpr·i of a row, zero past its end.
template <typename T, int kCpl>
__device__ __forceinline__ void load_params(const T* __restrict__ w, const Plan& p, int jl,
                                            float (&out)[kCpl][Io<T>::kVec]) {
#pragma unroll
  for (int i = 0; i < kCpl; ++i) {
    const int j = jl + p.lpr * i;
    if (j < p.chunks) {
      Io<T>::unpack(__ldg(reinterpret_cast<const uint4*>(w) + j), out[i]);
    } else {
#pragma unroll
      for (int e = 0; e < Io<T>::kVec; ++e) out[i][e] = 0.f;
    }
  }
}

template <typename T, int kCpl>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                  const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, const Plan p) {
  constexpr int V = Io<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* tile = smem + warp * p.tw * p.channels * static_cast<int>(sizeof(T));
  uint4* words = reinterpret_cast<uint4*>(tile);
  const int jl = lane & (p.lpr - 1), rl = lane / p.lpr, rpp = 32 / p.lpr;
  float w[kCpl][V], b[kCpl][V];
  load_params<T, kCpl>(weight, p, jl, w);
  load_params<T, kCpl>(bias, p, jl, b);
  const float c = static_cast<float>(p.channels);
  const long long tiles = (p.rows + p.tw - 1) / p.tw;
  for (long long ti = static_cast<long long>(blockIdx.x) * kWarps + warp; ti < tiles;
       ti += static_cast<long long>(gridDim.x) * kWarps) {
    const long long g0 = ti * p.tw;
    const int rows = static_cast<int>(p.rows - g0 < p.tw ? p.rows - g0 : p.tw);
    if (p.layout == kRowMajor) {
      load_span(x + g0 * p.channels, p, rows, tile, lane);
      afdm::cp_async_wait<0>();
    } else {
      load_channels<kBatchFwd>(x, p, g0, rows, tile, lane);
    }
    __syncwarp();
    for (int r0 = 0; r0 < rows; r0 += rpp) {
      const int r = r0 + rl;
      float v[kCpl][V];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int j = jl + p.lpr * i;
        if (r < rows && j < p.chunks) {
          Io<T>::unpack(words[word_at<T>(p, r, j)], v[i]);
#pragma unroll
          for (int e = 0; e < V; ++e) sum += v[i][e];
        }
      }
      const float mean = row_sum(sum, p.lpr) / c;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        if (r < rows && jl + p.lpr * i < p.chunks) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float d = v[i][e] - mean;
            sq = fmaf(d, d, sq);
          }
        }
      }
      const float rstd = rsqrtf(row_sum(sq, p.lpr) / c + p.eps);
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int j = jl + p.lpr * i;
        if (r < rows && j < p.chunks) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) o[e] = fmaf(w[i][e], (v[i][e] - mean) * rstd, b[i][e]);
          words[word_at<T>(p, r, j)] = Io<T>::pack(o);
        }
      }
      if (r < rows && jl == 0) {
        mean_out[g0 + r] = mean;
        rstd_out[g0 + r] = rstd;
      }
    }
    __syncwarp();
    store_span(y + g0 * p.channels, p, rows, tile, lane);
    __syncwarp();  // the next tile's load overwrites the tile
  }
}

template <typename T, int kCpl>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ weight,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  T* __restrict__ dx, float* __restrict__ partials, const Plan p) {
  constexpr int V = Io<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile_bytes = p.tw * p.channels * static_cast<int>(sizeof(T));
  unsigned char* gtile = smem + warp * 2 * tile_bytes;  // dy, then dx in place
  unsigned char* xtile = gtile + tile_bytes;
  uint4* gwords = reinterpret_cast<uint4*>(gtile);
  const uint4* xwords = reinterpret_cast<const uint4*>(xtile);
  float* stats = reinterpret_cast<float*>(smem + kWarps * 2 * tile_bytes) + warp * 2 * p.tw;
  const int jl = lane & (p.lpr - 1), rl = lane / p.lpr, rpp = 32 / p.lpr;
  float w[kCpl][V], dw[kCpl][V], db[kCpl][V];
  load_params<T, kCpl>(weight, p, jl, w);
#pragma unroll
  for (int i = 0; i < kCpl; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) dw[i][e] = db[i][e] = 0.f;
  }
  const float c = static_cast<float>(p.channels);
  const long long tiles = (p.rows + p.tw - 1) / p.tw;
  for (long long ti = static_cast<long long>(blockIdx.x) * kWarps + warp; ti < tiles;
       ti += static_cast<long long>(gridDim.x) * kWarps) {
    const long long g0 = ti * p.tw;
    const int rows = static_cast<int>(p.rows - g0 < p.tw ? p.rows - g0 : p.tw);
    load_span(dy + g0 * p.channels, p, rows, gtile, lane);
    if (p.layout == kRowMajor) {
      load_span(x + g0 * p.channels, p, rows, xtile, lane);
    } else {
      load_channels<kBatchBwd>(x, p, g0, rows, xtile, lane);
    }
    for (int t = lane; t < rows; t += 32) {
      stats[t] = __ldg(mean + g0 + t);
      stats[p.tw + t] = __ldg(rstd + g0 + t);
    }
    afdm::cp_async_wait<0>();
    __syncwarp();
    for (int r0 = 0; r0 < rows; r0 += rpp) {
      const int r = r0 + rl;
      const float mu = r < rows ? stats[r] : 0.f, rs = r < rows ? stats[p.tw + r] : 0.f;
      float g[kCpl][V], xh[kCpl][V];
      float a = 0.f, bs = 0.f;
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int j = jl + p.lpr * i;
        if (r < rows && j < p.chunks) {
          float dv[V], xv[V];
          Io<T>::unpack(gwords[word_at<T>(p, r, j)], dv);
          Io<T>::unpack(xwords[word_at<T>(p, r, j)], xv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            xh[i][e] = (xv[e] - mu) * rs;
            g[i][e] = w[i][e] * dv[e];
            a += g[i][e];
            bs = fmaf(g[i][e], xh[i][e], bs);
            dw[i][e] = fmaf(dv[e], xh[i][e], dw[i][e]);
            db[i][e] += dv[e];
          }
        }
      }
      a = row_sum(a, p.lpr);
      bs = row_sum(bs, p.lpr);
      const float scale = rs / c;
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int j = jl + p.lpr * i;
        if (r < rows && j < p.chunks) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) o[e] = (c * g[i][e] - xh[i][e] * bs - a) * scale;
          gwords[word_at<T>(p, r, j)] = Io<T>::pack(o);
        }
      }
    }
    __syncwarp();
    if (p.layout == kRowMajor) {
      store_span(dx + g0 * p.channels, p, rows, gtile, lane);
    } else {
      store_channels(dx, p, g0, rows, gtile, lane);
    }
    __syncwarp();
  }
  // dw, db: over the warp's row groups (lanes lpr apart), then over the block's warps
#pragma unroll
  for (int i = 0; i < kCpl; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      for (int off = p.lpr; off < 32; off <<= 1) {
        dw[i][e] += __shfl_xor_sync(0xffffffffu, dw[i][e], off);
        db[i][e] += __shfl_xor_sync(0xffffffffu, db[i][e], off);
      }
    }
  }
  __syncthreads();  // every warp is done with its tiles
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][2C]
  const int cols = 2 * p.channels;
  if (lane < p.lpr) {
#pragma unroll
    for (int i = 0; i < kCpl; ++i) {
      const int j = lane + p.lpr * i;
      if (j < p.chunks) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          red[warp * cols + j * V + e] = dw[i][e];
          red[warp * cols + p.channels + j * V + e] = db[i][e];
        }
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < cols; col += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k * cols + col];
    partials[static_cast<long long>(blockIdx.x) * cols + col] = s;
  }
}

// dw and db: each column of the partial rows summed in a fixed order, kParts threads a column
// taking every kParts-th row, then their kParts sums in order.
template <typename T>
__global__ void __launch_bounds__(32 * kParts)
    ln_dparams_kernel(const float* __restrict__ partials, int blocks, int channels,
                      T* __restrict__ dweight, T* __restrict__ dbias) {
  __shared__ float part[kParts][33];
  const int cols = 2 * channels, col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < cols) {
#pragma unroll 4
    for (int b = threadIdx.y; b < blocks; b += kParts) {
      s += partials[static_cast<long long>(b) * cols + col];
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
    for (int k = 0; k < kParts; ++k) t += part[k][threadIdx.x];
    if (col < channels) {
      dweight[col] = Io<T>::out(t);
    } else {
      dbias[col - channels] = Io<T>::out(t);
    }
  }
}

// The largest tile an instantiation takes: at most 4 KB up to 256 channels
// (ops/layer_norm.py:ln_plan), 16 bytes a channel beyond, up to 32·kCpl words a row.
template <typename T, int kCpl>
constexpr int max_tile_bytes() {
  return 512 * kCpl * Io<T>::kVec > 4096 ? 512 * kCpl * Io<T>::kVec : 4096;
}

template <typename T, int kCpl>
constexpr int max_smem(bool bwd) {
  return bwd ? kWarps * (2 * max_tile_bytes<T, kCpl>() + 2 * kMaxTileTokens * 4)
             : kWarps * max_tile_bytes<T, kCpl>();
}

// Blocks of `kernel` an SM holds at once with `smem` bytes of shared memory; 0 if the runtime
// cannot say.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem) {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : 0;
}

// An instantiation's pair, made ready at its first launch (which runs eagerly, before any CUDA
// graph captures one): both kernels' shared-memory limits raised to their largest tiles, then
// the blocks an SM holds of each at that size.
template <typename T, int kCpl>
cudaError_t ready(cudaStream_t stream, int& fwd_per_sm, int& bwd_per_sm) {
  static std::atomic<bool> fwd_set[afdm::kMaxDevices], bwd_set[afdm::kMaxDevices];
  cudaError_t err = afdm::raise_smem_limit_once(
      reinterpret_cast<const void*>(ln_fwd_kernel<T, kCpl>), max_smem<T, kCpl>(false), fwd_set,
      stream);
  if (err != cudaSuccess) return err;
  err = afdm::raise_smem_limit_once(reinterpret_cast<const void*>(ln_bwd_kernel<T, kCpl>),
                                    max_smem<T, kCpl>(true), bwd_set, stream);
  if (err != cudaSuccess) return err;
  static const int fwd = blocks_per_sm(ln_fwd_kernel<T, kCpl>, max_smem<T, kCpl>(false));
  static const int bwd = blocks_per_sm(ln_bwd_kernel<T, kCpl>, max_smem<T, kCpl>(true));
  fwd_per_sm = fwd;
  bwd_per_sm = bwd;
  return fwd > 0 && bwd > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

struct Args {
  const void *x, *dy, *weight, *bias;
  void* out;
  float *mean, *rstd, *partials;
  int partial_blocks;
  void *dweight, *dbias;
};

template <typename T, int kCpl>
cudaError_t launch(const Args& a, const Plan& p, int sms, cudaStream_t stream) {
  const bool bwd = a.dy != nullptr;
  const int tile_bytes = p.tw * p.channels * static_cast<int>(sizeof(T));
  const int smem = bwd ? kWarps * (2 * tile_bytes + 2 * p.tw * 4) : kWarps * tile_bytes;
  if (smem > max_smem<T, kCpl>(bwd)) return cudaErrorInvalidValue;
  int fwd_per_sm = 0, bwd_per_sm = 0;
  cudaError_t err = ready<T, kCpl>(stream, fwd_per_sm, bwd_per_sm);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.rows + p.tw - 1) / p.tw;
  long long blocks = (tiles + kWarps - 1) / kWarps;
  const long long wave = static_cast<long long>(sms) * (bwd ? bwd_per_sm : fwd_per_sm);
  if (blocks > wave) blocks = wave;
  if (bwd && blocks > a.partial_blocks) blocks = a.partial_blocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (!bwd) {
    ln_fwd_kernel<T, kCpl><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.weight),
        static_cast<const T*>(a.bias), static_cast<T*>(a.out), a.mean, a.rstd, p);
    return cudaGetLastError();
  }
  ln_bwd_kernel<T, kCpl><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<const T*>(a.weight),
      a.mean, a.rstd, static_cast<T*>(a.out), a.partials, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned col_blocks = static_cast<unsigned>((2 * p.channels + 31) / 32);
  ln_dparams_kernel<T><<<col_blocks, dim3(32, kParts), 0, stream>>>(
      a.partials, static_cast<int>(grid), p.channels, static_cast<T*>(a.dweight),
      static_cast<T*>(a.dbias));
  return cudaGetLastError();
}

bool aligned(const void* ptr) { return (reinterpret_cast<unsigned long long>(ptr) & 15) == 0; }

}  // namespace

// One LayerNorm over the channels of `rows` tokens of `channels` channels (images of `tokens`
// tokens each), in the plan of ops/layer_norm.py:ln_plan (lpr lanes a row, cpl words a lane, tw
// rows a warp's tile, the tile's word permutation). dy == nullptr launches the forward: out = y
// (rows × channels, row order), mean and rstd (rows, f32). Otherwise the backward: out = dx (laid out as x), dweight and dbias
// (channels each), through `partials` (partial_blocks rows of 2·channels f32). x is row order
// (layout 0) or channel-major (layout 1: element (token, channel) of image i at
// (i·channels + channel)·tokens + token); dy is row order; every tensor of the input's type
// (bf16 != 0: bfloat16, else float32) but mean, rstd and partials. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int afdm_layer_norm(const void* x, const void* dy, const void* weight, const void* bias,
                               void* out, void* mean, void* rstd, void* partials,
                               int partial_blocks, void* dweight, void* dbias, long long rows,
                               long long tokens, int channels, int lpr, int cpl, int tw,
                               int swz_stride, int swz_mask, int layout, int bf16_io, float eps,
                               int sms, void* stream) {
  const int vec = bf16_io ? 8 : 4;
  const bool bwd = dy != nullptr;
  if (rows < 1 || rows > INT_MAX || tokens < 1 || rows % tokens != 0 || sms < 1) {
    return cudaErrorInvalidValue;
  }
  if (channels < vec || channels % vec != 0 || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 ||
      lpr * cpl * vec < channels || (lpr > 1 && lpr / 2 * vec >= channels) || tw < vec ||
      tw % vec != 0 || tw > kMaxTileTokens || (layout != kRowMajor && layout != kChannelMajor)) {
    return cudaErrorInvalidValue;
  }
  // the permutation stays inside each row: xor with less than a power of two dividing its words
  if (swz_stride < 0 || swz_mask < 0 || (swz_mask & (swz_mask + 1)) != 0 ||
      (channels / vec) % (swz_mask + 1) != 0) {
    return cudaErrorInvalidValue;
  }
  if (bwd && (partial_blocks < 1 || partials == nullptr || dweight == nullptr || !dbias)) {
    return cudaErrorInvalidValue;
  }
  const void* spans[] = {x, dy, weight, bias, out};
  for (const void* s : spans) {
    if (s != nullptr && !aligned(s)) return cudaErrorMisalignedAddress;
  }
  Plan p{rows,       tokens,   channels, channels / vec, lpr, tw, swz_stride,
         swz_mask,   layout,   layout == kChannelMajor && tokens % vec == 0, eps};
  Args a{x, dy, weight, bias, out, static_cast<float*>(mean), static_cast<float*>(rstd),
         static_cast<float*>(partials), partial_blocks, dweight, dbias};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bf16_io) {
    switch (cpl) {
      case 1: err = launch<bf16, 1>(a, p, sms, st); break;
      case 2: err = launch<bf16, 2>(a, p, sms, st); break;
      default: break;
    }
  } else {
    switch (cpl) {
      case 1: err = launch<float, 1>(a, p, sms, st); break;
      case 2: err = launch<float, 2>(a, p, sms, st); break;
      case 4: err = launch<float, 4>(a, p, sms, st); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}
