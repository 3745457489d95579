// Tensor-core building blocks shared by flash_fwd.cu and flash_bwd.cu:
// cp.async tile copies, mma.sync m16n8k16 with bf16 operands and f32
// accumulators, ldmatrix.trans, and the packing of two f32 values into
// a bf16 pair.  kernel_build.py hashes this header into every library
// name, so an edit here rebuilds both sources.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));  // size 0 writes zeros
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c += a b: m16n8k16, a row-major bf16, b column-major bf16, c f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two floats rounded to bf16, the lower column in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of m16n8k16 (lane = 4 * g + c):
//   A regs 0..3: (row g, cols 2c..2c+1), (row g+8, same), (row g,
//     cols 8+2c..), (row g+8, cols 8+2c..);
//   B regs 0..1: (rows 2c..2c+1, col g), (rows 8+2c.., col g);
//   C regs 0..3: (row g, cols 2c, 2c+1), (row g+8, cols 2c, 2c+1).
// So the C fragments of two neighbouring 8-column tiles of a product are
// the A fragment of one 16-deep step of the next product.

}  // namespace mma_bf16
