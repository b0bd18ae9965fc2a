// The serving megakernel for the StandardScaler -> MLPClassifier chain.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("scale", "mlp") and ("mlp",).
// Per row it computes
//   h0          = (x - mean) * inv_std       (each step only if its flag is set)
//   h{l+1}      = relu(h{l} @ W{l} + b{l})   for every hidden layer
//   logits      = h{L-1} @ W{L-1} + b{L-1}
//   probability = softmax(logits)
//   prediction  = labels[argmax(logits)]     (the first maximal index; NaN
//                                             counts as the maximum)
// and writes scaled (h0, when the chain keeps the scale stage's output),
// prediction and the probabilities. All float32.
//
// Bound: operations. At the serving shape (4096 rows, 256 -> 512 -> 512 -> 8)
// the three products are 3.25 GFLOP, 48.6 us at the H100's 67 TFLOP/s of
// float32 outside the tensor cores, against about 10 MB of inputs, outputs
// and weights (3 us at 3.35 TB/s). No tensor core and no TF32: the fast
// tier's 16,384-ulp envelope is about 2^-9 relative, and TF32 keeps 10
// mantissa bits.
//
// Design: one block of kThreads threads per tile of kRows rows; the grid
// covers all rows, and a ragged last tile computes zero rows that are never
// stored. The tile's activations live in dynamic shared memory as two
// ping-pong buffers of kRows x kMaxWidth floats: layer l reads one and
// writes the other, so no intermediate goes through device memory. A layer's
// product runs in chunks of kN output columns; for each chunk the block
// stages W in K-slices of kK x kN through shared memory (the next slice is
// loaded into registers while the current one is used; the weights of the
// published model, 1.59 MB, stay in L2 across blocks). Each warp owns
// kRowsPerWarp rows and each lane kColsPerLane neighbouring columns: a 4 x 4
// register tile accumulated with float32 FMAs in ascending k. A warp reads
// its rows' activations as broadcasts and the W slice as one contiguous
// 512-byte row, so shared memory sees no bank conflict. The bias is added
// after the K loop (h @ W, then + b), as the plain version does. Columns
// past a layer's width are written as zeros, so the next layer's last
// K-slice adds exact zeros. The head runs one warp per row over the <= 32
// logits: shuffle reductions for the max, the sum of expf(x - max) and the
// argmax.
//
// Numerics: scaled uses __fsub_rn / __fmul_rn, which the compiler never
// contracts into an FMA, so it is bit-identical to the plain version. The
// products sum in another order than cuBLAS or the CPU, and the softmax sums
// in another order than torch.softmax: both stay inside the fast tier's ulp
// envelope. No fast-math flags.
//
// Limits, mirrored by servable/megakernels.py chain_eligible: at most
// kMaxLayers layers, every width at most kMaxWidth, at most kMaxClasses
// classes.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 512;
constexpr int kMaxClasses = 32;
constexpr int kWarp = 32;
constexpr int kRows = 32;       // rows per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kK = 32;          // W rows staged per K-slice
constexpr int kN = 128;         // output columns per chunk
constexpr int kRowsPerWarp = kRows / (kThreads / kWarp);  // 4
constexpr int kColsPerLane = kN / kWarp;                   // 4
constexpr int kSliceLoads = kK * kN / kThreads;            // 16 W values per thread per slice
constexpr size_t kSmemBytes = sizeof(float) * (2 * kRows * kMaxWidth + kK * kN);  // 144 KB

static_assert(kRowsPerWarp == 4 && kColsPerLane == 4, "the inner loop is written for a 4 x 4 tile");
static_assert(kMaxWidth % kN == 0, "a chunk never runs past the activation buffer");
static_assert(kMaxClasses <= kWarp, "the head holds one logit per lane");

struct MlpLayers {
  const float* W[kMaxLayers];  // [width[l], width[l + 1]] row-major
  const float* b[kMaxLayers];  // [width[l + 1]]
  int width[kMaxLayers + 1];
  int n_layers;
};

__device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// The W values of the K-slice at k0 of the chunk at n0 that this thread
// stages (zero outside [K, N]); consecutive threads read consecutive columns.
__device__ __forceinline__ void load_slice(float (&dst)[kSliceLoads], const float* __restrict__ W,
                                           int K, int N, int k0, int n0, int tid) {
#pragma unroll
  for (int j = 0; j < kSliceLoads; ++j) {
    const int i = tid + j * kThreads;
    const int gk = k0 + i / kN, gn = n0 + i % kN;
    dst[j] = (gk < K && gn < N) ? __ldg(W + static_cast<size_t>(gk) * N + gn) : 0.0f;
  }
}

// Whether (a, ia) comes first in argmax order: NaN above every number, then
// the larger value, then the lower index.
__device__ __forceinline__ bool ranks_first(float a, int ia, float b, int ib) {
  const bool na = is_nan(a), nb = is_nan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

__global__ void __launch_bounds__(kThreads)
scale_mlp_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ inv_std, const MlpLayers net,
                 const float* __restrict__ labels, float* __restrict__ scaled,
                 float* __restrict__ prediction, float* __restrict__ probabilities,
                 int rows, int with_mean, int with_std, int write_scaled) {
  extern __shared__ __align__(16) float smem[];
  float* const w_tile = smem + 2 * kRows * kMaxWidth;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int row0 = blockIdx.x * kRows;

  // 1. scale: the tile's rows into buffer 0, zero-padded to a whole K-slice.
  const int d0 = net.width[0];
  const int d0_pad = round_up(d0, kK);
  for (int i = tid; i < kRows * d0_pad; i += kThreads) {
    const int r = i / d0_pad, k = i % d0_pad;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < rows && k < d0) {
      const size_t at = static_cast<size_t>(row) * d0 + k;
      v = __ldg(x + at);
      if (with_mean) v = __fsub_rn(v, __ldg(mean + k));
      if (with_std) v = __fmul_rn(v, __ldg(inv_std + k));
      if (write_scaled) scaled[at] = v;
    }
    smem[r * kMaxWidth + k] = v;  // buffer 0
  }
  __syncthreads();

  // 2. the layers, ping-ponging between buffer 0 and buffer 1.
  int cur = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    const float* __restrict__ W = net.W[l];
    const float* __restrict__ bias = net.b[l];
    const int K = net.width[l], N = net.width[l + 1];
    const int K_pad = round_up(K, kK);
    const bool hidden = l + 1 < net.n_layers;
    const float* hin = smem + (cur * kRows + warp * kRowsPerWarp) * kMaxWidth;
    float* hout = smem + ((cur ^ 1) * kRows + warp * kRowsPerWarp) * kMaxWidth;
    for (int n0 = 0; n0 < N; n0 += kN) {
      float acc[kRowsPerWarp][kColsPerLane] = {};
      float next[kSliceLoads];
      load_slice(next, W, K, N, 0, n0, tid);
      for (int k0 = 0; k0 < K_pad; k0 += kK) {
#pragma unroll
        for (int j = 0; j < kSliceLoads; ++j) w_tile[tid + j * kThreads] = next[j];
        __syncthreads();
        if (k0 + kK < K_pad) load_slice(next, W, K, N, k0 + kK, n0, tid);  // in flight meanwhile
#pragma unroll
        for (int kk = 0; kk < kK; kk += 4) {
          float4 a[kRowsPerWarp], w[4];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            a[i] = *reinterpret_cast<const float4*>(hin + i * kMaxWidth + k0 + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = *reinterpret_cast<const float4*>(w_tile + (kk + j) * kN + lane * kColsPerLane);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][0] = fmaf(av[j], w[j].x, acc[i][0]);
              acc[i][1] = fmaf(av[j], w[j].y, acc[i][1]);
              acc[i][2] = fmaf(av[j], w[j].z, acc[i][2]);
              acc[i][3] = fmaf(av[j], w[j].w, acc[i][3]);
            }
          }
        }
        __syncthreads();  // w_tile is rewritten next
      }
      // + b, then relu for a hidden layer (NaN passes, as torch.relu lets it);
      // columns past N are zeros for the next layer's last K-slice.
      const int c0 = n0 + lane * kColsPerLane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float o[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          float v = 0.0f;
          if (c0 + c < N) {
            v = __fadd_rn(acc[i][c], __ldg(bias + c0 + c));
            if (hidden && v < 0.0f) v = 0.0f;
          }
          o[c] = v;
        }
        *reinterpret_cast<float4*>(hout + i * kMaxWidth + c0) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();  // the layer's outputs are the next layer's inputs
    cur ^= 1;
  }

  // 3. the head: one warp per row over the logits.
  const int C = net.width[net.n_layers];
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int row = row0 + r;
    if (row >= rows) break;  // uniform across the warp
    const float v = lane < C ? smem[(cur * kRows + r) * kMaxWidth + lane] : __int_as_float(0xff800000);  // -inf
    float m = v;  // the max, NaN propagating as in torch.softmax
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, m, offset);
      m = (is_nan(o) || o > m) ? o : m;
    }
    const float e = lane < C ? expf(v - m) : 0.0f;
    float s = e;
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset >>= 1) s += __shfl_xor_sync(0xffffffffu, s, offset);
    if (lane < C) probabilities[static_cast<size_t>(row) * C + lane] = e / s;
    float best = v;
    int best_idx = lane;  // lanes past C hold -inf at a higher index than any class
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, best, offset);
      const int oi = __shfl_xor_sync(0xffffffffu, best_idx, offset);
      if (ranks_first(o, oi, best, best_idx)) {
        best = o;
        best_idx = oi;
      }
    }
    if (lane == 0) prediction[row] = __ldg(labels + best_idx);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a network past the kernel's limits. weights,
// biases and widths are host arrays of n_layers, n_layers and n_layers + 1
// entries (device pointers, and the widths [d_in, hidden..., classes]).
// mean and inv_std may be null when their flag is off; scaled may be null
// when write_scaled is 0. rows == 0 launches nothing.
int megakernel_scale_mlp(const void* x, const void* mean, const void* inv_std,
                         const void* const* weights, const void* const* biases,
                         const int* widths, int n_layers, const void* labels, void* scaled,
                         void* prediction, void* probabilities, int rows, int with_mean,
                         int with_std, int write_scaled, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  MlpLayers net = {};
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1 || widths[i] > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
  }
  if (widths[n_layers] > kMaxClasses) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_layers; ++l) {
    net.W[l] = static_cast<const float*>(weights[l]);
    net.b[l] = static_cast<const float*>(biases[l]);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      scale_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (rows > 0) {
    const dim3 grid((rows + kRows - 1) / kRows);
    scale_mlp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(inv_std), net, static_cast<const float*>(labels),
        static_cast<float*>(scaled), static_cast<float*>(prediction),
        static_cast<float*>(probabilities), rows, with_mean, with_std, write_scaled);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
