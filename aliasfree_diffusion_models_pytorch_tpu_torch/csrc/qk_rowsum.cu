// QKᵀ row-sum probe for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces the TPU probe kernel benchmarks/attn_headpack.py: qk_rowsum_kernel (:84-92), as
// make_qk_probe (:94-113) launches it: for every group n
//   out[n, 0, q] = Σ_k Σ_d K[n, k, d] · Qᵀ[n, d, q]
// with K (n, s, d) and Qᵀ (n, d, s) in bf16, f32 accumulation, out (n, 1, s) in f32. The
// (keys × queries) logits are formed in registers, tile by tile, and only their sums over the
// keys leave the kernel: the S×S block never reaches device memory, so the time is the cost of
// the products (and of one add per logit) and not of memory traffic. Summing K over the keys
// first would give the same numbers and measure nothing; the kernel does not do that.
//
// What bounds it: 2·n·s·s·d FLOPs against (2·n·s·d·2 + n·s·4) bytes: at s = 1024, d = 8 that is
// 1000 FLOPs a byte, far above the card's 295, so the matrix unit bounds it, and at d = 8 the one
// f32 add per logit weighs as much as the product.
//
// Design: one block per (n, strip of 128 queries), four warps, on the tensor cores:
// mma.sync.aligned.m16n8k8 (d = 8, no padding) or m16n8k16 (d a multiple of 16), bf16 operands,
// f32 accumulators. Each warp owns 32 queries (four n-tiles of 8) and keeps their B fragments in
// registers for the whole loop. K streams through two shared-memory buffers of 64 or 128 keys,
// filled by cp.async (16 bytes a thread, the next tile in flight while this one is used) and
// shared by the four warps; ldmatrix turns a row tile of 16 keys into A fragments. Per row tile
// and n-tile the d/16 (or one k8) MMAs start from a zero accumulator, so the accumulator holds
// that tile's logits, and these are added into per-thread f32 sums. A shuffle reduction over the
// eight row groups ends the loop. wgmma and TMA are later work. The mma.sync, ldmatrix and
// cp.async helpers are shared with the attention kernels (mma_bf16.cuh). The first port also
// had a CUDA-core variant, 6.6x slower at d = 8 (PERF.md keeps its figures).
//
// s must be a multiple of 128; d one of 8, 16, 32, 64, 128.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using afdm::cp_async_16;
using afdm::cp_async_commit;
using afdm::cp_async_wait;
using afdm::ldmatrix_x4;
using afdm::mma_m16n8k16;
using afdm::mma_m16n8k8;

constexpr int kQBlock = 128;  // queries per block
constexpr int kThreads = 128;

// Two bf16 values of neighbouring depth for one query, packed as a B-fragment register
// (the lower depth index in the lower half).
__device__ __forceinline__ uint32_t pack_qt(const __nv_bfloat16* qn, int s, int d, int q) {
  const uint32_t lo = __bfloat16_as_ushort(qn[static_cast<size_t>(d) * s + q]);
  const uint32_t hi = __bfloat16_as_ushort(qn[static_cast<size_t>(d + 1) * s + q]);
  return lo | (hi << 16);
}

constexpr int kNTiles = 4;  // n-tiles of 8 queries per warp: 32 queries a warp

// Shapes of the K tiles in shared memory, rows padded as afdm::smem_stride says.
template <int D>
struct KTile {
  static constexpr int kKeys = D <= 32 ? 128 : 64;          // keys per tile
  static constexpr int kStride = afdm::smem_stride<D>();    // elements per row in shared memory
  static constexpr int kChunks = kKeys * D / 8;       // 16-byte chunks per tile
};

// Copies keys k0 .. k0 + kKeys of one group into a shared-memory tile, 16 bytes a thread and
// instruction, neighbouring threads on neighbouring addresses; asynchronous (cp.async).
template <int D>
__device__ __forceinline__ void load_k_tile(__nv_bfloat16* tile, const __nv_bfloat16* kn, int k0) {
  constexpr int kRowChunks = D / 8;
  for (int c = threadIdx.x; c < KTile<D>::kChunks; c += kThreads) {
    const int row = c / kRowChunks, col = (c % kRowChunks) * 8;
    cp_async_16(tile + row * KTile<D>::kStride + col,
                kn + static_cast<size_t>(k0 + row) * D + col);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    qk_rowsum_mma_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ qt,
                         float* __restrict__ out, int s) {
  constexpr bool kK8 = (D == 8);
  constexpr int kSteps = kK8 ? 1 : D / 16;   // MMAs along the depth per n-tile
  constexpr int kBRegs = kK8 ? 1 : 2;        // B-fragment registers per MMA
  constexpr int kKeys = KTile<D>::kKeys;
  constexpr int kStride = KTile<D>::kStride;
  __shared__ __align__(16) __nv_bfloat16 tiles[2][kKeys * kStride];

  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = lane / 4;   // fragment row (A, C) or column (B)
  const int quad = lane % 4;    // fragment depth pair (A, B) or column pair (C)
  const int q0 = blockIdx.x * kQBlock + warp * (8 * kNTiles);
  const __nv_bfloat16* kn = k + static_cast<size_t>(n) * s * D;
  const __nv_bfloat16* qn = qt + static_cast<size_t>(n) * D * s;

  load_k_tile<D>(tiles[0], kn, 0);
  cp_async_commit();

  // B fragments of this warp's queries: loop-invariant, held in registers.
  uint32_t b[kNTiles][kSteps][kBRegs];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int q = q0 + 8 * j + group;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      b[j][t][0] = pack_qt(qn, s, 16 * t + 2 * quad, q);
      if constexpr (!kK8) b[j][t][1] = pack_qt(qn, s, 16 * t + 2 * quad + 8, q);
    }
  }

  // sums[j][c]: Σ over this thread's key rows of the logits of query 8j + 2·quad + c.
  float sums[kNTiles][2];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) sums[j][0] = sums[j][1] = 0.0f;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const int num_tiles = s / kKeys;
  for (int tile = 0; tile < num_tiles; ++tile) {
    // Prefetch the next tile into the other buffer, then wait for this one.
    if (tile + 1 < num_tiles) {
      load_k_tile<D>(tiles[(tile + 1) % 2], kn, (tile + 1) * kKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = tiles[tile % 2];

    if constexpr (kK8) {
      // One ldmatrix brings the A fragments of two 16-key row tiles (32 keys × 8 deep).
#pragma unroll 2
      for (int r = 0; r < kKeys; r += 32) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + (r + lane) * kStride);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) {
            float c[4];  // 16 keys × 8 queries of logits: rows group and group + 8
            mma_m16n8k8(c, a[2 * half], a[2 * half + 1], b[j][0][0], zero);
            sums[j][0] += c[0] + c[2];
            sums[j][1] += c[1] + c[3];
          }
        }
      }
    } else {
#pragma unroll 2
      for (int r = 0; r < kKeys; r += 16) {
        float c[kNTiles][4];
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          uint32_t a[4];
          ldmatrix_x4(a, kt + (r + lane % 16) * kStride + 16 * t + (lane / 16) * 8);
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) {
            if (t == 0) {
              mma_m16n8k16(c[j], a, b[j][t][0], b[j][t][1], zero);
            } else {
              mma_m16n8k16(c[j], a, b[j][t][0], b[j][t][1], c[j]);
            }
          }
        }
        // c[j] now holds this row tile's logits; add them into the sums.
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          sums[j][0] += c[j][0] + c[j][2];
          sums[j][1] += c[j][1] + c[j][3];
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before the next prefetch overwrites it
  }

  // Reduce over the eight row groups (lane bits 2..4); lanes 0..3 hold the result.
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      float v = sums[j][c2];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (group == 0) out[static_cast<size_t>(n) * s + q0 + 8 * j + 2 * quad + c2] = v;
    }
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* k, const __nv_bfloat16* qt, float* out, int n, int s,
                   cudaStream_t stream) {
  const dim3 grid(s / kQBlock, n);
  qk_rowsum_mma_kernel<D><<<grid, kThreads, 0, stream>>>(k, qt, out, s);
  return cudaGetLastError();
}

}  // namespace

// k: (n, s, d) bf16, qt: (n, d, s) bf16, out: (n, 1, s) f32, all contiguous on the current
// device. Returns a cudaError_t.
extern "C" int afdm_qk_rowsum(const void* k, const void* qt, void* out, int n, int s, int d,
                              void* stream) {
  if (n < 1 || n > 65535 || s < kQBlock || s % kQBlock != 0) return cudaErrorInvalidValue;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(qt);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(kp, qp, o, n, s, st);
    case 16: return launch<16>(kp, qp, o, n, s, st);
    case 32: return launch<32>(kp, qp, o, n, s, st);
    case 64: return launch<64>(kp, qp, o, n, s, st);
    case 128: return launch<128>(kp, qp, o, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* afdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
