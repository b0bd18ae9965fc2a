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
// every row but stays on chip. At 4096 x d 100 x k 10 that is 3,297,984 B,
// 0.98 us at the H100's 3.35 TB/s, against about 10 MFLOP (0.15 us at 67
// TFLOP/s of float32).
//
// Design: a persistent grid, about as many blocks of kWarpsFor(kSlots) warps
// (16, or 8 at kSlots 32) as the SMs hold at once, whose warps walk tasks of R rows (task t: rows t R ... t R +
// R - 1, tasks strided over the grid's warps). Before its first row a block
// puts in flight every copy of mean, inv_std and (where k rows of d fit
// kCentroidFloats) the centroids into shared memory, the centroid rows
// padded with zeros to 32 terms a step at a stride of 4 mod 8 floats, while
// each warp's first task's rows are loaded into registers; it waits once and
// computes |c|^2 (euclidean) or |c| (cosine) of every centroid from the
// staged rows. A warp scales its task's rows as the lanes of a warp-per-row
// kernel would (lane l: elements l, l + 32, ...), coalesced, writes scaled,
// closes each row's |h|^2 with the warp's butterfly and puts each row into
// its strip of shared memory; then loads its next task's rows into the same
// registers, in flight while it searches. The search is rowlocal_ops.cuh's
// kmeans_search, which the row-local kernel's kmeans op runs too, so a row
// gets the same cluster whichever kernel serves its chain: a row's 32 / R
// lanes take centroids i, i + 32 / R, ..., each forms its centroids' whole
// distances from 32 partial sums, and a (value, index) butterfly over the
// row's lanes picks the first minimum. R = 32 / (the next power of two at or
// above k), at least 1, at most kRowsMax(kSlots) (a task's rows fit a
// lane's registers), so at k 10 a warp takes 2 rows of 16 lanes. No
// intermediate goes through device memory. Centroids past kCentroidFloats
// are read from L1/L2 with the same bits.
//
// Limits, mirrored by servable/megakernels.py chain_eligible: 1 <= k <=
// kMaxK centroids (their norms fit the block's shared memory) and 1 <= d <=
// kMaxDim features (a lane's slots fit its registers).
#include "rowlocal_ops.cuh"

namespace {

using rowlocal::kCosine;
using rowlocal::kEuclidean;
using rowlocal::kManhattan;
using rowlocal::kWarp;

constexpr int kMaxK = rowlocal::kMaxK;
constexpr int kMaxDim = rowlocal::kMaxDim;
constexpr int kCentroidFloats = 24 * 1024;  // 96 KB of staged centroids; more are read from L1/L2

// A task's rows: at most 8 registers of x a lane below 8 slots.
__host__ __device__ constexpr int kRowsMax(int slots) { return slots >= 8 ? 1 : 8 / slots; }

// A block's warps: 16, so that fewer blocks stage the model, or 8 at 32
// slots a lane, whose registers would not fit 128 a thread.
__host__ __device__ constexpr int kWarpsFor(int slots) { return slots >= 32 ? 8 : 16; }

// Where a block keeps its model and rows, in floats of dynamic shared memory.
struct Layout {
  int rows;       // R, the rows of a warp's task
  int stride;     // a padded row: 32 terms a step, + 4
  int mean;
  int inv_std;
  int centroids;  // -1: read from global memory
  int strips;     // the block's warps x R rows of `stride`
  int floats;
};

// A task's rows of x into the lanes' registers (lane l: elements l, l + 32,
// ... of each row; zeros past d and for rows past `rows`).
template <int kSlots, int kRows>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, float (&xv)[kRows][kSlots], int task,
                                          int R, int rows, int d, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= R) break;
    const int row = task * R + r;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * kWarp + lane;
      xv[r][s] = j < d && row < rows ? __ldg(x + static_cast<size_t>(row) * d + j) : 0.0f;
    }
  }
}

template <int kSlots, int kMeasure>
__global__ void __launch_bounds__(kWarp * kWarpsFor(kSlots))
scale_kmeans_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv_std, const float* __restrict__ centroids,
                    float* __restrict__ scaled, int* __restrict__ prediction, int rows, int d,
                    int k, int with_mean, int with_std, int write_scaled, const Layout L) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRows = kRowsMax(kSlots);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int R = L.rows, lanes = kWarp / R;
  const int g = lane / lanes, i = lane % lanes;  // this lane's row of the task, and its place there
  const int pad = (d + kWarp - 1) / kWarp * kWarp;
  float* const norms = smem;
  float* const s_mean = smem + L.mean;
  float* const s_inv_std = smem + L.inv_std;
  float* const strips = smem + L.strips + warp * R * L.stride;
  const float* cents = L.centroids >= 0 ? smem + L.centroids : centroids;
  const int c_stride = L.centroids >= 0 ? L.stride : 0;

  if (with_mean) rowlocal::stage(s_mean, mean, d, threadIdx.x, blockDim.x);
  if (with_std) rowlocal::stage(s_inv_std, inv_std, d, threadIdx.x, blockDim.x);
  if (L.centroids >= 0) {
    rowlocal::stage_rows(smem + L.centroids, centroids, k, d, L.stride, pad, warp, n_warps, lane);
  }
  const int n_tasks = (rows + R - 1) / R;
  const int step = gridDim.x * n_warps;
  int task = blockIdx.x * n_warps + warp;
  float xv[kRows][kSlots];
  if (task < n_tasks) load_rows<kSlots, kRows>(x, xv, task, R, rows, d, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (kMeasure != kManhattan) {
    rowlocal::centroid_norms(cents, c_stride ? c_stride : d, k, d, kMeasure, norms, warp, n_warps, lane);
    __syncthreads();
  }

  for (; task < n_tasks; task += step) {  // uniform across the warp
    const int row0 = task * R;
    float p2 = 0.0f;  // this lane's row's |h|^2
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= R) break;
      const int row = row0 + r;
      float* h = strips + r * L.stride;
      float p = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        float v = 0.0f;
        if (j < d) {
          v = xv[r][s];
          if (with_mean) v = __fsub_rn(v, s_mean[j]);
          if (with_std) v = __fmul_rn(v, s_inv_std[j]);
          if (write_scaled && row < rows) scaled[static_cast<size_t>(row) * d + j] = v;
        }
        if (j < pad) h[j] = v;
        p = __fmaf_rn(v, v, p);
      }
      if (kMeasure != kManhattan) p = rowlocal::warp_sum(p);
      if (r == g) p2 = p;
    }
    if (task + step < n_tasks) load_rows<kSlots, kRows>(x, xv, task + step, R, rows, d, lane);
    __syncwarp();
    const int idx = rowlocal::kmeans_search(strips + g * L.stride, p2, cents, c_stride, norms, k, d, kMeasure,
                                            i, lanes);
    if (i == 0 && row0 + g < rows) prediction[row0 + g] = idx;
    __syncwarp();  // the strips are read before the next task rewrites them
  }
}

// The layout for kSlots registers a row and k centroids of d features.
Layout plan_layout(int slots, int d, int k) {
  Layout L;
  int lanes = 1;
  while (lanes < k && lanes < kWarp) lanes *= 2;
  L.rows = kWarp / lanes < kRowsMax(slots) ? kWarp / lanes : kRowsMax(slots);
  L.stride = (d + kWarp - 1) / kWarp * kWarp + 4;  // 4 mod 8: 16-byte loads free of bank conflicts
  int off = (k + 3) & ~3;  // the norms
  L.mean = off;
  off += (d + 3) & ~3;
  L.inv_std = off;
  off += (d + 3) & ~3;
  L.centroids = k * L.stride <= kCentroidFloats ? off : -1;
  if (L.centroids >= 0) off += k * L.stride;
  L.strips = off;
  off += kWarpsFor(slots) * L.rows * L.stride;
  L.floats = off;
  return L;
}

template <int kSlots, int kMeasure>
cudaError_t launch_kernel(cudaStream_t stream, const float* x, const float* mean, const float* inv_std,
                          const float* centroids, float* scaled, int* prediction, int rows, int d, int k,
                          int with_mean, int with_std, int write_scaled) {
  auto kernel = scale_kmeans_kernel<kSlots, kMeasure>;
  const Layout L = plan_layout(kSlots, d, k);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.floats);
  constexpr int kThreads = kWarp * kWarpsFor(kSlots);
  long long resident = 0;
  const cudaError_t rc = rowlocal::resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem, &resident);
  if (rc != cudaSuccess) return rc;
  const int rows_per_block = kWarpsFor(kSlots) * L.rows;
  const long long wanted = (static_cast<long long>(rows) + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(wanted < resident ? wanted : resident));
  kernel<<<grid, kThreads, smem, stream>>>(x, mean, inv_std, centroids, scaled, prediction, rows, d, k,
                                           with_mean, with_std, write_scaled, L);
  return cudaSuccess;
}

template <int kSlots>
cudaError_t launch_slots(int measure, cudaStream_t stream, const float* x, const float* mean,
                         const float* inv_std, const float* centroids, float* scaled, int* prediction,
                         int rows, int d, int k, int with_mean, int with_std, int write_scaled) {
  switch (measure) {
    case kEuclidean:
      return launch_kernel<kSlots, kEuclidean>(stream, x, mean, inv_std, centroids, scaled, prediction, rows,
                                               d, k, with_mean, with_std, write_scaled);
    case kManhattan:
      return launch_kernel<kSlots, kManhattan>(stream, x, mean, inv_std, centroids, scaled, prediction, rows,
                                               d, k, with_mean, with_std, write_scaled);
    case kCosine:
      return launch_kernel<kSlots, kCosine>(stream, x, mean, inv_std, centroids, scaled, prediction, rows, d,
                                            k, with_mean, with_std, write_scaled);
    default:
      return cudaErrorInvalidValue;
  }
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
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const float* mf = static_cast<const float*>(mean);
    const float* sf = static_cast<const float*>(inv_std);
    const float* cf = static_cast<const float*>(centroids);
    float* out = static_cast<float*>(scaled);
    int* pred = static_cast<int*>(prediction);
    cudaError_t rc;
    if (d <= kWarp) {
      rc = launch_slots<1>(measure, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean, with_std,
                           write_scaled);
    } else if (d <= 2 * kWarp) {
      rc = launch_slots<2>(measure, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean, with_std,
                           write_scaled);
    } else if (d <= 4 * kWarp) {
      rc = launch_slots<4>(measure, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean, with_std,
                           write_scaled);
    } else if (d <= 8 * kWarp) {
      rc = launch_slots<8>(measure, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean, with_std,
                           write_scaled);
    } else if (d <= 16 * kWarp) {
      rc = launch_slots<16>(measure, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean, with_std,
                            write_scaled);
    } else {
      rc = launch_slots<32>(measure, s, xf, mf, sf, cf, out, pred, rows, d, k, with_mean, with_std,
                            write_scaled);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
