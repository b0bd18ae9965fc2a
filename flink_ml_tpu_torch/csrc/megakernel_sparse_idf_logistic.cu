// The serving megakernel for the sparse IDF -> LogisticRegression chain.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("sparse_idf", "sparse_logistic"),
// ("sparse_logistic",) and, in its head-less mode (with_head 0: tfidf only,
// no coef read and no margin), ("sparse_idf",). Inputs are one sparse column in the padded layout
// of servable/sparse.py: values [rows, K] f32 and ids [rows, K] i32, padding
// slots id 0 / value 0. Per row r it computes
//   tfidf[r,k] = values[r,k] * idf[ids[r,k]]          (with the IDF stage)
//   margin[r]  = (((0 + t[r,0]*coef[ids[r,0]]) + t[r,1]*coef[ids[r,1]]) + ...)
//                over all K slots in slot order, t = tfidf or, without the
//                IDF stage, values
//   prediction = margin >= 0 ? 1 : 0
//   raw        = [1 - sigmoid(margin), sigmoid(margin)]
// and writes tfidf (when asked), margin, prediction and raw (with the head).
// The ids and the
// row counts pass through untouched: the wrapper hands on its input tensors.
//
// Bound: memory. Per row it reads K values and K ids, writes K tfidf values
// and 16 bytes of heads, and gathers idf and coef at each slot's id: at
// d = 2^22 (16 MB per model vector) those gathers are scattered 32-byte
// sectors, most of them missing L2 on a cold call. About 13 MB at 4096 x 64,
// some 4 us at the H100's 3.35 TB/s; the arithmetic (two multiplies and an
// add per slot) is negligible.
//
// Design: one warp per row, kRowsPerBlock rows per block. Lanes take slots
// k = base + lane for base = 0, 32, ... so loads and the tfidf store are
// coalesced; idf and coef are gathered through the read-only path. The
// margin must be bit-identical to the plain version's strictly sequential
// fold (ops/kernels.segment_sum), whose result is the same at every nnz cap.
// So each chunk of 32 products is broadcast lane by lane with __shfl_sync and
// every lane adds it, in slot order, to its own copy of the sum: all lanes
// hold the same sequential sum and no lane diverges. All K slots are added,
// padding included, exactly as the plain version does (a padding slot adds
// 0 * coef[0]), and no slot beyond K. No atomics.
//
// Numerics: the products use __fmul_rn and the sum __fadd_rn, which the
// compiler never contracts into an FMA, so tfidf and margin are bit-equal to
// the plain PyTorch version. The sigmoid is 1 / (1 + expf(-m)), the formula
// of torch.sigmoid and of megakernel_scale_logistic.cu. An id outside [0, d)
// is clamped as the JAX package's gather does: a negative id counts from the
// end, then it is clipped into range. No fast-math flags.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ long long clamp_id(int id, int d) {
  long long i = id;
  if (i < 0) i += d;
  if (i < 0) i = 0;
  if (i > d - 1) i = d - 1;
  return i;
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
sparse_idf_logistic_kernel(const float* __restrict__ values, const int* __restrict__ ids,
                           const float* __restrict__ idf, const float* __restrict__ coef,
                           float* __restrict__ tfidf, float* __restrict__ margin,
                           float* __restrict__ prediction, float* __restrict__ raw,
                           int rows, int K, int d, int with_idf, int write_tfidf,
                           int with_head) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // row is uniform across the warp: all 32 lanes leave
  const size_t off = static_cast<size_t>(row) * K;
  float acc = 0.0f;
  for (int base = 0; base < K; base += kWarp) {
    const int k = base + lane;
    float term = 0.0f;
    if (k < K) {
      float v = __ldg(values + off + k);
      const long long id = clamp_id(__ldg(ids + off + k), d);
      if (with_idf) {
        v = __fmul_rn(v, __ldg(idf + id));
        if (write_tfidf) tfidf[off + k] = v;
      }
      if (with_head) term = __fmul_rn(v, __ldg(coef + id));
    }
    if (!with_head) continue;  // uniform: the head-less mode writes tfidf only
    const int n = min(kWarp, K - base);  // uniform: the slots this chunk holds
    for (int j = 0; j < n; ++j) {
      acc = __fadd_rn(acc, __shfl_sync(kFullMask, term, j));
    }
  }
  if (with_head && lane == 0) {
    const float p = 1.0f / (1.0f + expf(-acc));
    margin[row] = acc;
    prediction[row] = acc >= 0.0f ? 1.0f : 0.0f;
    raw[2 * static_cast<size_t>(row)] = 1.0f - p;
    raw[2 * static_cast<size_t>(row) + 1] = p;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head-less launch that would write nothing.
// idf may be null when with_idf is 0; tfidf may be null when write_tfidf is
// 0; coef, margin, prediction and raw may be null when with_head is 0.
// rows == 0 launches nothing.
int megakernel_sparse_idf_logistic(const void* values, const void* ids, const void* idf,
                                   const void* coef, void* tfidf, void* margin,
                                   void* prediction, void* raw, int rows, int K, int d,
                                   int with_idf, int write_tfidf, int with_head, void* stream) {
  if (!with_head && !(with_idf && write_tfidf)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    const dim3 block(kWarp * kRowsPerBlock);
    sparse_idf_logistic_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int*>(ids),
        static_cast<const float*>(idf), static_cast<const float*>(coef),
        static_cast<float*>(tfidf), static_cast<float*>(margin),
        static_cast<float*>(prediction), static_cast<float*>(raw), rows, K, d, with_idf,
        write_tfidf, with_head);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
