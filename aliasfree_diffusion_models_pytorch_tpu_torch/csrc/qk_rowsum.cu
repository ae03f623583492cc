// QKᵀ row-sum probe for Hopper (sm_90a), exported with a plain C interface (ctypes).
//
// Replaces the TPU probe kernel benchmarks/attn_headpack.py: qk_rowsum_kernel (:84-92), as
// make_qk_probe (:94-113) launches it: for every group n
//   out[n, 0, q] = Σ_k Σ_d K[n, k, d] · Qᵀ[n, d, q]
// with K (n, s, d) and Qᵀ (n, d, s) in bf16, f32 accumulation, out (n, 1, s) in f32. Every
// (query × key) logit is formed on the tensor cores, and only the sums over the keys leave the
// kernel: the S×S block never reaches device memory, so the time is the cost of the products.
// Summing K over the keys first would give the same numbers and measure nothing; the kernel does
// not do that. Its issued tensor-core FLOPs are 2·n·s·s·max(d, 16) (d = 8 is padded to wgmma's
// depth of 16).
//
// What bounds it: 2·n·s·s·d FLOPs against (2·n·s·d·2 + n·s·4) bytes: at s = 1024, d = 8 that is
// 1000 FLOPs a byte, far above the card's 295, so the tensor cores bound it.
//
// Design: wgmma with the queries as A, in registers, and the keys as B, both tiles brought by
// TMA. A work item is 256 queries of one group; the grid holds as many blocks as the SMs take
// at once (one an SM, two at d <= 16), and each walks the items blockIdx.x, + gridDim.x, ...,
// the query block fastest, so the blocks at work share each group's K through L2. A block is
// one producer warpgroup and two consumer warpgroups of 128 queries (two m64 tiles each); the
// producer gives its registers to the consumers (setmaxnreg: 24 a thread against 240, or 104
// where two blocks share an SM). The producer's first thread loads an item's queries' tile (Qᵀ's
// d rows of 256 queries, 128-byte swizzled) once the consumers hold the previous item's in
// registers, and streams its 128-key tiles of K's natural (s, d) layout, which is K-major for B,
// through a ring of shared-memory stages that runs on from item to item. Each stage and the
// queries' tile have a "full" mbarrier (expect_tx: the bytes) and an "empty" one (one arrival per
// consumer warp). A consumer warpgroup turns the queries' tile into A fragments with
// ldmatrix.trans (at d = 8 depth 8..15 is zero) and keeps them for the item; per key tile, key
// chunk of N and depth step it issues one wgmma.mma_async m64nNk16 per query tile into an f32
// accumulator of 64 queries × N keys that carries over every chunk and tile of the item (N = 128,
// or 64 at d <= 16): the tensor cores add the logits of keys N apart, and a thread sums its N/4
// accumulator columns once, at the end, then over its quad with two shuffles. A stage goes back
// to the producer when the wgmma group that read it has completed (wait_group 1, one tile later).
// Where s / 128 is odd the last query block's second warpgroup has no queries: it only passes
// the ring's tiles on.
// Shared-memory layout of a key tile as TMA writes it and the wgmma descriptor reads it: rows of
// d bf16 values, swizzled by the width of a row (32, 64 or 128 bytes; d = 128 is two boxes of
// 64 columns, one after the other); at d = 8 a row is 16 bytes, unswizzled, and the descriptor's
// k-step offset (LBO) is 0, so depth 8..15 reads the same finite keys that the zero A fragments
// multiply. Every stage and query tile starts on a 1024-byte boundary.
//
// s must be a multiple of 128; d one of 8, 16, 32, 64, 128. The launch plan is computed in
// Python (ops/probes.py:qk_plan) and checked here.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entry.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = afdm::sm90;

constexpr int kConsumers = 2;                    // consumer warpgroups a block
constexpr int kRowTiles = 2;                     // m64 query tiles a consumer warpgroup
constexpr int kWarpgroupQueries = 64 * kRowTiles;
constexpr int kBlockQueries = kConsumers * kWarpgroupQueries;
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kKeys = 128;                       // keys a TMA tile: s is a multiple
constexpr int kAlign = 1024;                     // a swizzled tile's alignment in shared memory

// By depth: keys of a wgmma (its N, and the accumulator's columns: a 128-key tile is 128 / N
// products into the same accumulator), ring stages, TMA swizzle width of a key tile in bytes
// (0: none), blocks an SM.
template <int D>
struct Tile;
template <>
struct Tile<8> {
  static constexpr int kAccKeys = 64, kStages = 8, kSwizzle = 0, kBlocksPerSm = 2;
};
template <>
struct Tile<16> {
  static constexpr int kAccKeys = 64, kStages = 8, kSwizzle = 32, kBlocksPerSm = 2;
};
template <>
struct Tile<32> {
  static constexpr int kAccKeys = 128, kStages = 8, kSwizzle = 64, kBlocksPerSm = 1;
};
template <>
struct Tile<64> {
  static constexpr int kAccKeys = 128, kStages = 6, kSwizzle = 128, kBlocksPerSm = 1;
};
template <>
struct Tile<128> {
  static constexpr int kAccKeys = 128, kStages = 4, kSwizzle = 128, kBlocksPerSm = 1;
};

// Registers a thread of the producer and of a consumer warpgroup after setmaxnreg, by blocks an
// SM. At launch every thread has kLaunch, 65536 / (384 · blocks) rounded down to 8; the
// producer gives back what the consumers take. With fewer at launch a consumer's setmaxnreg.inc
// would wait forever, so the launch checks the built kernel's count.
template <int kBlocksPerSm>
struct Registers;
template <>
struct Registers<1> {
  static constexpr int kLaunch = 168, kProducer = 24, kConsumer = 240;
};
template <>
struct Registers<2> {
  static constexpr int kLaunch = 80, kProducer = 24, kConsumer = 104;
};

// Shared memory: the ring of key tiles, the queries' tile, then the mbarriers and d = 8's zeros.
template <int D>
struct Geometry {
  static constexpr int kBox = D < 64 ? D : 64;  // a key box's columns: at most the swizzle width
  static constexpr int kRowBytes = kBox * 2;    // a key's row in one box
  static constexpr int kBoxBytes = kKeys * kRowBytes;
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kStageBytes = (kTileBytes + kAlign - 1) / kAlign * kAlign;
  static constexpr int kQBoxBytes = D * 128;  // one query tile of Qᵀ: d rows of 64 queries
  static constexpr int kQBytes = kConsumers * kRowTiles * kQBoxBytes;
  static constexpr int kSteps = D < 16 ? 1 : D / 16;  // k16 steps of wgmma
  static constexpr int kBarriers = 2 * Tile<D>::kStages + 2;
  static constexpr int kSmemBytes = kAlign + Tile<D>::kStages * kStageBytes + kQBytes +
                                    kBarriers * 8 + 4 * kRowTiles * 4;
};

// The wgmma descriptor of depth step kk and key chunk c (keys c·N .. c·N + N - 1) of the key
// tile at `tile`.
template <int D>
__device__ __forceinline__ uint64_t key_desc(const uint8_t* tile, int kk, int c) {
  using L = Geometry<D>;
  const uint8_t* rows = tile + c * Tile<D>::kAccKeys * L::kRowBytes;
  if constexpr (D == 8) {
    return sm90::wgmma_desc(rows, sm90::kNoSwizzle, 0, 8 * 16);
  } else {
    constexpr sm90::Layout kLayout = L::kRowBytes == 128  ? sm90::kSwizzle128
                                     : L::kRowBytes == 64 ? sm90::kSwizzle64
                                                          : sm90::kSwizzle32;
    const int col = 16 * kk;
    return sm90::wgmma_desc(rows + (col / L::kBox) * L::kBoxBytes + (col % L::kBox) * 2, kLayout,
                            16, 8 * L::kRowBytes);
  }
}

// Address of the 8 queries q0 .. q0 + 7 (q0 a multiple of 8) at depth `depth` in a query tile
// that TMA wrote with the 128-byte swizzle: row `depth` of 128 bytes, its 16-byte chunks
// permuted by the row's low three bits.
__device__ __forceinline__ const __nv_bfloat16* q_row(const uint8_t* qtile, int depth, int q0) {
  return reinterpret_cast<const __nv_bfloat16*>(qtile + depth * 128 +
                                                (((q0 / 8) ^ (depth & 7)) * 16));
}

template <int kBlocksPerSm>
constexpr bool registers_add_up() {
  using R = Registers<kBlocksPerSm>;
  return R::kLaunch == 65536 / (kThreads * kBlocksPerSm) / 8 * 8 &&
         128 * R::kProducer + 128 * kConsumers * R::kConsumer <= kThreads * R::kLaunch;
}
static_assert(registers_add_up<1>() && registers_add_up<2>(), "setmaxnreg hand-over");

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kBlocksPerSm)
    qk_rowsum_kernel(__grid_constant__ const CUtensorMap k_map,
                     __grid_constant__ const CUtensorMap q_map, float* __restrict__ out, int n,
                     int s) {
  using T = Tile<D>;
  using L = Geometry<D>;
  using R = Registers<T::kBlocksPerSm>;
  constexpr int kAcc = T::kAccKeys / 2;  // accumulator registers of one query tile
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  uint8_t* qtiles = tiles + kStages * L::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(qtiles + L::kQBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;
  // Zeros for A's depth 8..15 at d = 8, read back from memory: as constants ptxas rebuilds each
  // wgmma's A registers for every product, spills and serializes the wgmmas.
  uint32_t* pad = reinterpret_cast<uint32_t*>(q_empty + 1);

  const int q_blocks = (s + kBlockQueries - 1) / kBlockQueries;
  const int items = n * q_blocks;  // (group, query block), the query block fastest
  const int num_tiles = s / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], 4 * kConsumers);  // every consumer warp
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 4 * kConsumers);
    for (int i = 0; i < 4 * kRowTiles; ++i) pad[i] = 0u;
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup: its first thread issues every load
    sm90::setmaxnreg_dec<R::kProducer>();
    if (threadIdx.x == 0) {
      int t_all = 0;  // key tiles issued by this block: the ring's position
      int j = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int g = item / q_blocks;
        const int q_block = (item % q_blocks) * kBlockQueries;
        // The queries' tile, once the consumers hold the previous one in registers: the query
        // tiles below s (all but the second warpgroup's where s / 128 is odd).
        const int q_tiles = min(kConsumers * kRowTiles, (s - q_block) / 64);
        if (j > 0) sm90::mbar_wait(q_empty, (j - 1) & 1);
        sm90::mbar_arrive_expect_tx(q_full, q_tiles * L::kQBoxBytes);
        for (int m = 0; m < q_tiles; ++m) {
          sm90::tma_load_2d(qtiles + m * L::kQBoxBytes, &q_map, q_full, q_block + 64 * m, g * D);
        }
        for (int t = 0; t < num_tiles; ++t, ++t_all) {
          const int stage = t_all % kStages;
          if (t_all >= kStages) sm90::mbar_wait(&empty[stage], (t_all / kStages - 1) & 1);
          sm90::mbar_arrive_expect_tx(&full[stage], L::kTileBytes);
          uint8_t* dst = tiles + stage * L::kStageBytes;
#pragma unroll
          for (int b = 0; b < D / L::kBox; ++b) {
            sm90::tma_load_2d(dst + b * L::kBoxBytes, &k_map, &full[stage], b * L::kBox,
                              g * s + t * kKeys);
          }
        }
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<R::kConsumer>();
  const int consumer = wg - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int group = lane / 4;
  const int quad = lane % 4;
  const int mi = lane / 8;  // the ldmatrix matrix this lane addresses a row of
  const uint8_t* my_q = qtiles + consumer * kRowTiles * L::kQBoxBytes;

  int t_all = 0;
  int j = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
    const int g = item / q_blocks;
    const int q_wg = (item % q_blocks) * kBlockQueries + consumer * kWarpgroupQueries;
    const bool active = q_wg < s;

    // A fragments of this warp's queries (rows) by depth (k), from the queries' tile: held in
    // registers for the whole item. ldmatrix.trans turns the tile's depth rows into A's query
    // rows: matrix mi is depth 8·(mi / 2) .. +7 of queries 8·(mi % 2) .. +7 of this warp's 16.
    uint32_t a[kRowTiles][L::kSteps][4];
    sm90::mbar_wait(q_full, j & 1);
    if (active) {
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        const uint8_t* qtile = my_q + mt * L::kQBoxBytes;
        const int q0 = 16 * warp + 8 * (mi % 2);
#pragma unroll
        for (int kk = 0; kk < L::kSteps; ++kk) {
          if constexpr (D == 8) {
            uint32_t lo[2];
            afdm::ldmatrix_x2_trans(lo, q_row(qtile, lane % 8, q0));
            a[mt][kk][0] = lo[0];
            a[mt][kk][1] = lo[1];
            a[mt][kk][2] = static_cast<const volatile uint32_t*>(pad)[4 * mt];
            a[mt][kk][3] = static_cast<const volatile uint32_t*>(pad)[4 * mt + 1];
          } else {
            const int depth = 16 * kk + 8 * (mi / 2) + lane % 8;
            afdm::ldmatrix_x4_trans(a[mt][kk], q_row(qtile, depth, q0));
          }
        }
      }
    }
    // The tile's generic reads come before the producer's next TMA write of it.
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(q_empty);

    if (!active) {  // queries past s: keep the ring's count of arrivals
      for (int t = 0; t < num_tiles; ++t, ++t_all) {
        const int stage = t_all % kStages;
        sm90::mbar_wait(&full[stage], (t_all / kStages) & 1);
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      }
      continue;
    }

    float acc[kRowTiles][kAcc];
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[mt][i] = 0.0f;
    }
    for (int t = 0; t < num_tiles; ++t, ++t_all) {
      const int stage = t_all % kStages;
      sm90::mbar_wait(&full[stage], (t_all / kStages) & 1);
      const uint8_t* tile = tiles + stage * L::kStageBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kKeys / T::kAccKeys; ++c) {
#pragma unroll
        for (int kk = 0; kk < L::kSteps; ++kk) {
          const uint64_t desc = key_desc<D>(tile, kk, c);
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt) {
            sm90::wgmma_rs<T::kAccKeys>(acc[mt], a[mt][kk], desc);
          }
        }
      }
      sm90::wgmma_commit();
      if (t > 0) {
        sm90::wgmma_wait<1>();  // the previous tile's products are done: release its stage
        if (lane == 0) sm90::mbar_arrive(&empty[(t_all - 1) % kStages]);
      }
    }
    sm90::wgmma_wait<0>();
    if (lane == 0) sm90::mbar_arrive(&empty[(t_all - 1) % kStages]);
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sm90::fence_operand(acc[mt][i]);
    }

    // Row group (h = 0) and group + 8 (h = 1) of each query tile: this thread's columns, then
    // its quad's.
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < kAcc / 4; ++i) v += acc[mt][4 * i + 2 * h] + acc[mt][4 * i + 2 * h + 1];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (quad == 0) {
          out[static_cast<size_t>(g) * s + q_wg + 64 * mt + 16 * warp + group + 8 * h] = v;
        }
      }
    }
  }
}

// A 2-D tensor map of bf16 (rows × cols, cols contiguous) whose box is box_rows × box_cols.
int encode_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols, int box_rows,
               int box_cols, CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : afdm::kTensorMapError + static_cast<int>(res);
}

template <int D>
int launch(const void* k, const void* qt, float* out, int n, int s, int keys_per_tile,
           int acc_keys, int queries_per_block, int stages, int swizzle, int smem_bytes,
           int grid, cudaStream_t stream) {
  using T = Tile<D>;
  using L = Geometry<D>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(n) * ((s + kBlockQueries - 1) / kBlockQueries);
  const long long blocks = items < sms * T::kBlocksPerSm ? items : sms * T::kBlocksPerSm;
  if (keys_per_tile != kKeys || acc_keys != T::kAccKeys || queries_per_block != kBlockQueries ||
      stages != T::kStages || swizzle != T::kSwizzle || smem_bytes != L::kSmemBytes ||
      grid != blocks) {
    return cudaErrorInvalidValue;  // a plan this build does not have
  }
  // K as (n·s keys × d), a box one key tile (two at d = 128); Qᵀ as (n·d × s), a box the d
  // depths of 64 queries.
  CUtensorMap k_map, q_map;
  const CUtensorMapSwizzle k_swizzle = T::kSwizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : T::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : T::kSwizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  int res = encode_map(&k_map, k, static_cast<uint64_t>(n) * s, D, kKeys, L::kBox, k_swizzle);
  if (res == 0) {
    res = encode_map(&q_map, qt, static_cast<uint64_t>(n) * D, s, D, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (res != 0) return res;
  // The registers the kernel starts with, as the setmaxnreg hand-over needs them (a build whose
  // ptxas allotted otherwise would hang, not fail).
  static const int launch_regs = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, qk_rowsum_kernel<D>) == cudaSuccess ? attr.numRegs : -1;
  }();
  if (launch_regs != Registers<T::kBlocksPerSm>::kLaunch) return cudaErrorInvalidKernelImage;
  if constexpr (L::kSmemBytes > 48 * 1024) {
    static std::atomic<bool> smem_set[afdm::kMaxDevices];
    err = afdm::raise_smem_limit_once(reinterpret_cast<const void*>(qk_rowsum_kernel<D>),
                                      L::kSmemBytes, smem_set, stream);
    if (err != cudaSuccess) return err;
  }
  qk_rowsum_kernel<D><<<static_cast<unsigned>(blocks), kThreads, L::kSmemBytes, stream>>>(
      k_map, q_map, out, n, s);
  return cudaGetLastError();
}

}  // namespace

// k: (n, s, d) bf16, qt: (n, d, s) bf16, out: (n, 1, s) f32, all contiguous on the current
// device; k and qt 16-byte aligned (TMA). The plan's integers (keys_per_tile, acc_keys,
// queries_per_block, stages, swizzle, smem_bytes, grid) come from ops/probes.py:qk_plan and must
// match this build's and this device's. Returns a cudaError_t, or afdm::kTensorMapError (entry.cuh)
// + the CUresult where a tensor map was refused.
extern "C" int afdm_qk_rowsum(const void* k, const void* qt, void* out, int n, int s, int d,
                              int keys_per_tile, int acc_keys, int queries_per_block, int stages,
                              int swizzle, int smem_bytes, int grid, void* stream) {
  if (n < 1 || s < 128 || s % 128 != 0 || static_cast<long long>(n) * s > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kp = keys_per_tile, ak = acc_keys, qb = queries_per_block, ns = stages, sw = swizzle,
            sb = smem_bytes, gr = grid;
  switch (d) {
    case 8: return launch<8>(k, qt, o, n, s, kp, ak, qb, ns, sw, sb, gr, st);
    case 16: return launch<16>(k, qt, o, n, s, kp, ak, qb, ns, sw, sb, gr, st);
    case 32: return launch<32>(k, qt, o, n, s, kp, ak, qb, ns, sw, sb, gr, st);
    case 64: return launch<64>(k, qt, o, n, s, kp, ak, qb, ns, sw, sb, gr, st);
    case 128: return launch<128>(k, qt, o, n, s, kp, ak, qb, ns, sw, sb, gr, st);
    default: return cudaErrorInvalidValue;
  }
}
