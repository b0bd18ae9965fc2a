// The sequential fold of a sparse row's slot products, shared by the sparse
// serving kernel (megakernel_sparse_idf_logistic.cu) and the row-local
// table's sparse_logistic op (rowlocal_ops.cuh).
//
// The plain version (ops/kernels.segment_sum, the JAX package's
// sparse_dot_fn) sums a row's K products strictly left to right from +0.0,
// padding slots included (each adds 0 * coef[0]), so a row's margin is the
// same bits at every nnz cap. Both kernels keep that order without
// shuffles: their lanes write the products to shared memory and one lane
// per row folds them there, reading four at a time (one 16-byte load) and
// adding them in slot order with __fadd_rn, which the compiler never
// contracts into an FMA. The loads do not depend on the sum, so an unrolled
// fold has them in flight ahead of its adds: a row costs about K dependent
// adds.
#pragma once

#include <cuda_runtime.h>

namespace sparse_fold {

// An id into a vector of d values, clamped as the JAX package's gather does:
// a negative id counts from the end, then it is clipped into range.
// In 32 bits: for id < 0 and 0 < d < 2^31, id + d cannot overflow.
__device__ __forceinline__ int clamp_id(int id, int d) {
  const int i = id < 0 ? id + d : id;
  return min(max(i, 0), d - 1);
}

// acc + p[0] + p[1] + ... + p[n - 1], in that order, each add rounded to
// nearest. p is 16-byte aligned shared memory.
__device__ __forceinline__ float fold(const float* p, int n, float acc) {
  const float4* q = reinterpret_cast<const float4*>(p);
  int j = 0;
#pragma unroll 4
  for (; j + 4 <= n; j += 4) {
    const float4 t = q[j / 4];
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, t.x), t.y), t.z), t.w);
  }
  for (; j < n; ++j) acc = __fadd_rn(acc, p[j]);
  return acc;
}

}  // namespace sparse_fold
