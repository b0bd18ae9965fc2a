// The serving megakernel for the StandardScaler -> KMeans chain.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("scale", "kmeans") and
// ("kmeans",). Per row it computes
//   h          = (x - mean) * inv_std       (each step only if its flag is set)
//   dist[c]    = the distance of h to centroid c under the measure, in the
//                JAX package's op order (flink_ml_tpu/ops/distance.py):
//                  euclidean  sqrt(max((|h|^2 + |c|^2) - 2 (h . c), 0))
//                  manhattan  sum_j |h_j - c_j|
//                  cosine     1 - ((h . c) / |h|) / |c|,  |v| = sqrt(sum v^2)
//   prediction = the first c of minimal dist, a NaN counting as the minimum
//                (as jnp.argmin and torch.argmin take it)
// and writes scaled (h, when the chain keeps the scale stage's output) and
// the prediction as an int32 index. All float32.
//
// Bound: memory. Per row it reads d floats of x, writes d floats of scaled
// and a 4-byte index; the model (k x d centroids, mean, inv_std) is read by
// every row but stays in L1/L2. At 4096 x d 100 x k 10 that is 3,297,984 B,
// 0.98 us at the H100's 3.35 TB/s, against about 10 MFLOP (0.15 us at 67
// TFLOP/s of float32).
//
// Design: one warp per row, kRowsPerBlock rows per block, the grid capped
// at kMaxBlocks blocks that stride over the rows. Each lane holds its d/32
// elements of h in registers (kSlots of them, a template argument chosen
// from d, so a row costs no more slots than it has), reads each centroid's
// row with the same lane layout (coalesced, from L1 after the first warp),
// and reduces its partial sum with an xor butterfly of __shfl_xor_sync:
// IEEE addition commutes, so every lane ends with the same bits and tracks
// the same (best value, best index) with no divergence. A block first
// computes |c|^2 (euclidean) or |c| (cosine) of every centroid once into
// shared memory. No intermediate goes through device memory.
//
// Numerics: scaled uses __fsub_rn / __fmul_rn, which the compiler never
// contracts into an FMA, so it is bit-identical to the plain version. The
// distance's own operations are written with the _rn intrinsics in the JAX
// package's order (the expanded euclidean form, not sum (h - c)^2; the
// square root before the argmin); only the dot products and norms sum in
// another order than the plain version's, so a row's index can differ only
// where its two nearest distances lie within rounding of each other. The
// clamp at 0 keeps a NaN (fmaxf would drop it). A zero row under cosine
// gives 0/0 = NaN in every column, and so does a NaN feature under every
// measure: the index is 0, as in the JAX package. No fast-math flags.
//
// Limits, mirrored by servable/megakernels.py chain_eligible: 1 <= k <=
// kMaxK centroids (their norms fit the block's shared memory) and 1 <= d <=
// kMaxDim features (a lane's slots fit its registers).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMaxK = 1024;
constexpr int kMaxDim = 1024;
constexpr int kMaxBlocks = 132 * 8;  // a few waves of the H100's 132 SMs; blocks stride beyond
static_assert(kMaxDim == 32 * kWarp, "the widest slot count, 32, covers kMaxDim");

enum Measure { kEuclidean = 0, kManhattan = 1, kCosine = 2 };

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// The warp's total of v, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

template <int kSlots, int kMeasure>
__global__ void __launch_bounds__(kThreads)
scale_kmeans_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv_std, const float* __restrict__ centroids,
                    float* __restrict__ scaled, int* __restrict__ prediction, int rows, int d,
                    int k, int with_mean, int with_std, int write_scaled) {
  __shared__ float c_norm[kMaxK];  // |c|^2 (euclidean) or |c| (cosine)
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;

  if (kMeasure != kManhattan) {
    for (int c = warp; c < k; c += kRowsPerBlock) {
      const float* cr = centroids + static_cast<size_t>(c) * d;
      float acc = 0.0f;
      for (int j = lane; j < d; j += kWarp) {
        const float v = __ldg(cr + j);
        acc = __fmaf_rn(v, v, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) c_norm[c] = kMeasure == kCosine ? __fsqrt_rn(acc) : acc;
    }
    __syncthreads();
  }

  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;
       row += gridDim.x * kRowsPerBlock) {  // row is uniform across the warp
    const float* xr = x + static_cast<size_t>(row) * d;
    float h[kSlots];
    float p2 = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * kWarp + lane;
      float v = 0.0f;
      if (j < d) {
        v = __ldg(xr + j);
        if (with_mean) v = __fsub_rn(v, __ldg(mean + j));
        if (with_std) v = __fmul_rn(v, __ldg(inv_std + j));
        if (write_scaled) scaled[static_cast<size_t>(row) * d + j] = v;
      }
      h[s] = v;
      p2 = __fmaf_rn(v, v, p2);
    }
    if (kMeasure != kManhattan) p2 = warp_sum(p2);
    const float pn = __fsqrt_rn(p2);  // cosine's |h|

    float best = 0.0f;
    int best_idx = 0;
    for (int c = 0; c < k; ++c) {
      const float* cr = centroids + static_cast<size_t>(c) * d;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        const float cv = j < d ? __ldg(cr + j) : 0.0f;  // past d: 0 against h's 0
        if (kMeasure == kManhattan) {
          acc = __fadd_rn(acc, fabsf(__fsub_rn(h[s], cv)));
        } else {
          acc = __fmaf_rn(h[s], cv, acc);
        }
      }
      acc = warp_sum(acc);
      float dist;
      if (kMeasure == kEuclidean) {
        const float sq = __fsub_rn(__fadd_rn(p2, c_norm[c]), __fmul_rn(2.0f, acc));
        dist = __fsqrt_rn(sq < 0.0f ? 0.0f : sq);  // NaN < 0 is false: NaN stays
      } else if (kMeasure == kCosine) {
        dist = __fsub_rn(1.0f, __fdiv_rn(__fdiv_rn(acc, pn), c_norm[c]));
      } else {
        dist = acc;
      }
      // the first minimum; once best is NaN nothing replaces it
      if (c == 0 || (!is_nan(best) && (is_nan(dist) || dist < best))) {
        best = dist;
        best_idx = c;
      }
    }
    if (lane == 0) prediction[row] = best_idx;
  }
}

template <int kSlots>
cudaError_t launch_slots(int measure, dim3 grid, cudaStream_t stream, const float* x,
                         const float* mean, const float* inv_std, const float* centroids,
                         float* scaled, int* prediction, int rows, int d, int k, int with_mean,
                         int with_std, int write_scaled) {
  switch (measure) {
    case kEuclidean:
      scale_kmeans_kernel<kSlots, kEuclidean><<<grid, kThreads, 0, stream>>>(
          x, mean, inv_std, centroids, scaled, prediction, rows, d, k, with_mean, with_std,
          write_scaled);
      break;
    case kManhattan:
      scale_kmeans_kernel<kSlots, kManhattan><<<grid, kThreads, 0, stream>>>(
          x, mean, inv_std, centroids, scaled, prediction, rows, d, k, with_mean, with_std,
          write_scaled);
      break;
    case kCosine:
      scale_kmeans_kernel<kSlots, kCosine><<<grid, kThreads, 0, stream>>>(
          x, mean, inv_std, centroids, scaled, prediction, rows, d, k, with_mean, with_std,
          write_scaled);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a measure other than 0 (euclidean), 1
// (manhattan), 2 (cosine) or for k, d past the kernel's limits. mean and
// inv_std may be null when their flag is off; scaled may be null when
// write_scaled is 0. rows == 0 launches nothing.
int megakernel_scale_kmeans(const void* x, const void* mean, const void* inv_std,
                            const void* centroids, void* scaled, void* prediction, int rows,
                            int d, int k, int measure, int with_mean, int with_std,
                            int write_scaled, void* stream) {
  if (k < 1 || k > kMaxK || d < 1 || d > kMaxDim || measure < kEuclidean || measure > kCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const float* mf = static_cast<const float*>(mean);
    const float* sf = static_cast<const float*>(inv_std);
    const float* cf = static_cast<const float*>(centroids);
    float* out = static_cast<float*>(scaled);
    int* pred = static_cast<int*>(prediction);
    cudaError_t rc;
    if (d <= kWarp) {
      rc = launch_slots<1>(measure, grid, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean,
                           with_std, write_scaled);
    } else if (d <= 2 * kWarp) {
      rc = launch_slots<2>(measure, grid, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean,
                           with_std, write_scaled);
    } else if (d <= 4 * kWarp) {
      rc = launch_slots<4>(measure, grid, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean,
                           with_std, write_scaled);
    } else if (d <= 8 * kWarp) {
      rc = launch_slots<8>(measure, grid, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean,
                           with_std, write_scaled);
    } else if (d <= 16 * kWarp) {
      rc = launch_slots<16>(measure, grid, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean,
                            with_std, write_scaled);
    } else {
      rc = launch_slots<32>(measure, grid, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean,
                            with_std, write_scaled);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
