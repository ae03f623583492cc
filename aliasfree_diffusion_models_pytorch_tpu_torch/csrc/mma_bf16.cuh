// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the kernels of this directory:
// mma.sync products with f32 accumulators, ldmatrix fragment loads from shared memory, cp.async
// 16-byte copies into shared memory, and the one-instruction exp2.
//
// Fragment layouts of mma.sync m16n8k16 (bf16 in, f32 out), with group = lane / 4 and
// quad = lane % 4:
//   A (16×16, row-major)  a[0]: row group,   cols 2·quad, 2·quad+1     a[1]: row group+8, same cols
//                         a[2]: row group,   cols 2·quad+8, +9         a[3]: row group+8, same cols
//   B (16×8, k × n)       b[0]: k 2·quad, 2·quad+1 of col group        b[1]: k 2·quad+8, +9
//   C, D (16×8, f32)      c[0], c[1]: row group, cols 2·quad, +1       c[2], c[3]: row group+8
// m16n8k8 takes a[0], a[1] and b[0] alone. So the C tiles of two neighbouring n-tiles, rounded
// to bf16 in pairs, are the A fragment of the next product: no shuffle, no shared memory.
// Each 32-bit register holds two bf16 values, the lower index in the lower half.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace afdm {

// d = a·b + c on the tensor cores: a 16×16 (row-major), b 16×8 (column-major), bf16; c, d 16×8 f32.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The same with a 16×8 and b 8×8: depth 8 without padding.
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                            const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8×8 bf16 matrices from shared memory into fragment registers: lanes 8i..8i+7 give the
// row addresses of matrix i (16 bytes a row); lane t receives row t/4, columns 2(t%4), +1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Two matrices: lanes 0..15 give the row addresses (the others' are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// Transposed: lane t receives column t/4, rows 2(t%4), +1 of each stored matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// B fragments (k × n) of a matrix X stored row-major as [n][k] (k contiguous) with `stride`
// elements a row: n-rows n0..n0+15 at depth k0..k0+15 give b[0], b[1] for the n-tile n0..n0+7
// and b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const __nv_bfloat16* x, int stride,
                                          int n0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, x + (n0 + (mi >> 1) * 8 + r) * stride + k0 + (mi & 1) * 8);
}

// B fragments (k × n) of a matrix X stored row-major as [k][n] (n contiguous): k-rows
// k0..k0+15 at columns n0..n0+15 give b[0], b[1] for the n-tile n0..n0+7 and b[2], b[3] for
// n0+8..n0+15.
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4], const __nv_bfloat16* x, int stride,
                                          int k0, int n0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, x + (k0 + (mi & 1) * 8 + r) * stride + n0 + (mi >> 1) * 8);
}

// The same for one n-tile (8 columns): b[0], b[1].
__device__ __forceinline__ void ldsm_b_kn8(uint32_t (&b)[2], const __nv_bfloat16* x, int stride,
                                           int k0, int n0, int lane) {
  ldmatrix_x2_trans(b, x + (k0 + (lane & 15)) * stride + n0);
}

// A fragment (m × k, 16×16) of a matrix X stored row-major as [k][m] (m contiguous): rows
// k0..k0+15, columns m0..m0+15.
__device__ __forceinline__ void ldsm_a_km(uint32_t (&a)[4], const __nv_bfloat16* x, int stride,
                                          int k0, int m0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a, x + (k0 + (mi >> 1) * 8 + r) * stride + m0 + (mi & 1) * 8);
}

// 16 bytes global -> shared, asynchronous. With `bytes` = 0 nothing is read and the 16 bytes
// are filled with zeros (the ragged edge of a tile); `gmem` must still be a valid address.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x in one special-function instruction (MUFU.EX2); subnormal results flush to 0, and
// 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to nearest even as bf16 and packed into one register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two bf16 values of a packed register, as f32.
__device__ __forceinline__ float bf16_lo(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// A 32-bit load of two neighbouring bf16 values from global memory (4-byte aligned).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Row stride in shared memory of a tile whose rows hold D bf16 values: an odd number of 16-byte
// units, so the eight row addresses of an ldmatrix fall into eight different bank groups.
// (At depth 8 a row is one unit and needs no padding.)
template <int D>
__host__ __device__ constexpr int smem_stride() {
  return D == 8 ? 8 : D + 8;
}

}  // namespace afdm
