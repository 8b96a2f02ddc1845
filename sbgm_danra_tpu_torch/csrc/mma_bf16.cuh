// The tensor-core product shared by the kernels of this directory (sm_90a).
// ops/_nvcc.py hashes this header with each source that includes it, so an
// edit rebuilds both libraries.
#pragma once

#include <stdint.h>

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
