// Tensor-core and asynchronous-copy primitives shared by the kernels of this
// directory (sm_90a): bf16 products, and the TF32 products that the fp32
// kernels run three at a time (3xTF32). ops/_nvcc.py hashes this header with
// each source that includes it, so an edit rebuilds both libraries.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

// c += a b, mma.sync m16n8k16: a is the row-major A fragment (4 registers of
// 2 bf16), b the column-major B fragment (2 registers), c fp32. Lane l holds
// a's rows l/4 and l/4 + 8 and b's column l/4, at k 2(l%4), +1 and +8, +9.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid = false writes 16 zero
// bytes and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (cp.async.ca); valid = false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i (lane l: row l/4, columns 2(l%4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed (lane l: rows 2(l%4), +1 of column l/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma): four warps issue one asynchronous m64nNk16
// product whose A and B both come from shared memory through descriptors.

// Shared-memory matrix descriptor without swizzle, for an operand whose rows
// (M or N) hold K contiguously: a core matrix is 8 rows x 16 bytes stored as
// 128 contiguous bytes; `k_stride` is the byte offset between the two core
// matrices of a k16 step, `row_stride` between one 8-row group and the next.
__device__ __forceinline__ uint64_t wgmma_descriptor(uint32_t addr, uint32_t k_stride,
                                                     uint32_t row_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(k_stride >> 4) << 16) |
         ((uint64_t)(row_stride >> 4) << 32);
}

// Writes to shared memory by this thread (st.shared, completed cp.async)
// become visible to the asynchronous proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a b, m64n64k16, bf16 in, fp32 out. Warp w of the warpgroup holds rows
// 16w .. 16w + 15 of d as eight m16n8 fragments: d[4j + i] is element i of the
// fragment at columns 8j .. 8j + 7 (row l/4 + 8 (i/2), column 2 (l%4) + i%2).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += a b, m64n64k8, TF32 in (both operands K-major), fp32 out; d as in
// wgmma_m64n64k16. The descriptors' geometry is the bf16 one in bytes: a core
// matrix is 8 rows x 16 bytes (4 values), and a k8 step is two of them.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// 3xTF32: x = hi + lo with hi = x rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero) and lo = x - hi, which is exact in fp32.
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi in fp32 keeps fp32's accuracy on the
// tensor cores. hi is rounded on the bits (two integer operations; cvt.rna
// measured slower in the attention kernel); lo goes in as it is, the
// tensor cores reading the 19 high bits of a .tf32 operand, which drops under
// 2^-21 |x| beside the dropped a_lo b_lo. A NaN's hi may round to -0 on the
// bits, but its lo stays NaN and carries it into the product.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, mma.sync m16n8k8, TF32 in, fp32 out. Lane l holds a's (row l/4,
// k l%4), (row l/4 + 8, k l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4) and b's
// (k l%4, column l/4), (k l%4 + 4, column l/4); c as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32 from split operands: the small products first.
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const uint32_t* b_hi, const uint32_t* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// Keeps the compiler from moving reads or writes of `x` across this point
// (around wgmma's asynchronous register writes).
__device__ __forceinline__ void register_fence(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// ---------------------------------------------------------------------------
// Bulk copies (the TMA's one-dimensional form) that report to an mbarrier: one
// thread asks for a contiguous run of global memory to be copied into shared
// memory; the barrier's phase completes when the expected bytes have landed.

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// Makes initialised barriers visible to the asynchronous proxy.
__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come in this phase.
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed; traps rather than
// hang if it never does.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (int spins = 0; spins < (1 << 22); ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// `bytes` (a multiple of 16; 16-byte aligned addresses) global -> shared.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
