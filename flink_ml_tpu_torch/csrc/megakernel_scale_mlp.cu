// The serving megakernel for every chain that ends in an MLP head: the MLP
// alone, StandardScaler -> MLPClassifier, and any other chain of row-local
// table ops before it.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("mlp",), ("scale", "mlp"),
// ("normalize", "mlp"), ("elementwise_product", "scale", "mlp"), ... : every
// chain whose last op is the MLP and whose earlier ops are row-local table
// ops (rowlocal_ops.cuh). The kernel runs the table on each row of its tile
// as its prologue, writes every output the table declares, and puts the
// head's input row into buffer 0; an empty table stages the input column
// itself. Per row it then computes
//   h{l+1}      = relu(h{l} @ W{l} + b{l})   for every hidden layer, h0 the head's input
//   logits      = h{L-1} @ W{L-1} + b{L-1}
//   probability = softmax(logits)
//   prediction  = labels[argmax(logits)]     (the first maximal index; NaN
//                                             counts as the maximum)
// and writes prediction and the probabilities. All float32.
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
// stored. The prologue is a warp per row, the row in lane registers, as in
// megakernel_rowlocal.cu. The tile's activations live in dynamic shared
// memory as two ping-pong buffers of kRows x kMaxWidth floats: layer l reads
// one and writes the other, so no intermediate goes through device memory. A
// layer's product runs in chunks of kN output columns; for each chunk the
// block stages W in K-slices of kK x kN through shared memory (the next slice
// is loaded into registers while the current one is used; the weights of the
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
// Numerics: the prologue's ops are as rowlocal_ops.cuh states (a scale is
// bit-identical to the plain version). The products sum in another order
// than cuBLAS or the CPU, and the softmax sums in another order than
// torch.softmax: both stay inside the fast tier's ulp envelope. No fast-math
// flags.
//
// Limits, mirrored by servable/megakernels.py chain_eligible: at most
// kMaxLayers layers, every width at most kMaxWidth, at most kMaxClasses
// classes; the prologue's table within rowlocal_ops.cuh's limits, with at
// most kMaxNormFloats centroids over its kmeans ops. The table (2.6 KB) and
// the layers (168 B) share the 4 KB of kernel parameters.
#include "rowlocal_ops.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 512;
constexpr int kMaxClasses = 32;
using rowlocal::kWarp;
constexpr int kRows = 32;       // rows per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kK = 32;          // W rows staged per K-slice
constexpr int kN = 128;         // output columns per chunk
constexpr int kRowsPerWarp = kRows / (kThreads / kWarp);  // 4
constexpr int kColsPerLane = kN / kWarp;                   // 4
constexpr int kSliceLoads = kK * kN / kThreads;            // 16 W values per thread per slice
constexpr size_t kSmemBytes = sizeof(float) * (2 * kRows * kMaxWidth + kK * kN);  // 144 KB
constexpr int kMaxNormFloats = 16 * 1024;  // 64 KB of centroid norms after the 144 KB

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

using rowlocal::is_nan;

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

// Steps 2 and 3 of a tile whose buffer 0 holds its rows' inputs: the layers
// and the head, writing prediction and probabilities of rows row0 ... .
__device__ __forceinline__ void layers_and_head(float* smem, const MlpLayers& net,
                                                const float* __restrict__ labels,
                                                float* __restrict__ prediction,
                                                float* __restrict__ probabilities, int rows,
                                                int row0) {
  float* const w_tile = smem + 2 * kRows * kMaxWidth;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;

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

// The prologue for one row (uniform across the warp): the table's ops, then
// the head's input slot into dst[0, d0), zeros to d0_pad; a row past `rows`
// is all zeros. Not inlined: inlined, ptxas held the kernel to 128 registers
// and spilled at kSlots 8 and 16, and the layers ran slower than without a
// prologue (PERF.md); out of line, no instance spills.
template <int kSlots>
__device__ __noinline__ void prologue_row(const rowlocal::Table& table, int head_src, int row,
                                          int rows, int lane, const float* norms, float* dst,
                                          int d0, int d0_pad) {
  float v[kSlots];
  if (row < rows) {
    const int cur = rowlocal::run_row<kSlots>(table, row, lane, v, norms);
    if (cur != head_src) rowlocal::load_row<kSlots>(table.slots[head_src], row, lane, v);
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    if (j < d0_pad) dst[j] = (row < rows && j < d0) ? v[s] : 0.0f;
  }
}

// 1. the table's ops on each row of the tile (a warp per row), every declared
// output written, then the head's input slot staged into buffer 0; then
// steps 2 and 3.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
rowlocal_mlp_kernel(const __grid_constant__ rowlocal::Table table, int head_src,
                    const __grid_constant__ MlpLayers net, const float* __restrict__ labels,
                    float* __restrict__ prediction, float* __restrict__ probabilities, int rows,
                    int with_norms) {
  extern __shared__ __align__(16) float smem[];
  float* const norms = smem + kSmemBytes / sizeof(float);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int row0 = blockIdx.x * kRows;
  if (with_norms) {
    rowlocal::table_norms(table, norms, warp, kThreads / kWarp, lane);
    __syncthreads();
  }

  // 1. the prologue: buffer 0 row r holds the head's input, zero-padded to a
  // whole K-slice (d0_pad <= kSlots * 32, so the lanes' slots cover it).
  const int d0 = net.width[0];
  const int d0_pad = round_up(d0, kK);
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int row = row0 + r;
    prologue_row<kSlots>(table, head_src, row, rows, lane, norms, smem + r * kMaxWidth, d0, d0_pad);
  }
  __syncthreads();
  layers_and_head(smem, net, labels, prediction, probabilities, rows, row0);
}

template <int kSlots>
cudaError_t launch_rowlocal_mlp(const rowlocal::Table& table, int head_src, const MlpLayers& net,
                                const float* labels, float* prediction, float* probabilities,
                                int rows, int norm_floats, cudaStream_t stream) {
  const size_t smem = kSmemBytes + sizeof(float) * static_cast<size_t>(norm_floats);
  const cudaError_t attr = cudaFuncSetAttribute(
      rowlocal_mlp_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((rows + kRows - 1) / kRows);
  rowlocal_mlp_kernel<kSlots><<<grid, kThreads, smem, stream>>>(
      table, head_src, net, labels, prediction, probabilities, rows, norm_floats > 0);
  return cudaSuccess;
}

// The network of n_layers layers from host arrays, or false past the limits.
bool load_net(MlpLayers& net, const void* const* weights, const void* const* biases,
              const int* widths, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  net = {};
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1 || widths[i] > kMaxWidth) return false;
    net.width[i] = widths[i];
  }
  if (widths[n_layers] > kMaxClasses) return false;
  for (int l = 0; l < n_layers; ++l) {
    net.W[l] = static_cast<const float*>(weights[l]);
    net.b[l] = static_cast<const float*>(biases[l]);
  }
  return true;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table or a network past the limits, or a head
// input slot whose width is not the network's input width. ops and slots are
// the row-local table (rowlocal_ops.cuh; n_ops may be 0), head_src the slot
// the MLP reads. weights, biases and widths are host arrays of n_layers,
// n_layers and n_layers + 1 entries (device pointers, and the widths
// [d_in, hidden..., classes]). rows == 0 launches nothing.
int megakernel_rowlocal_mlp(const void* ops, int n_ops, const void* slots, int n_slots,
                            int head_src, const void* const* weights, const void* const* biases,
                            const int* widths, int n_layers, const void* labels,
                            void* prediction, void* probabilities, int rows, void* stream) {
  rowlocal::Table table;
  int widest = 1, norm_floats = 0;
  cudaError_t rc = rowlocal::load_table(table, ops, n_ops, slots, n_slots, &widest, &norm_floats);
  MlpLayers net;
  if (rc != cudaSuccess || norm_floats > kMaxNormFloats || head_src < 0 || head_src >= n_slots ||
      !load_net(net, weights, biases, widths, n_layers) || table.slots[head_src].width != widths[0]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* lab = static_cast<const float*>(labels);
    float* pred = static_cast<float*>(prediction);
    float* probs = static_cast<float*>(probabilities);
    if (widest <= kWarp) {
      rc = launch_rowlocal_mlp<1>(table, head_src, net, lab, pred, probs, rows, norm_floats, s);
    } else if (widest <= 2 * kWarp) {
      rc = launch_rowlocal_mlp<2>(table, head_src, net, lab, pred, probs, rows, norm_floats, s);
    } else if (widest <= 4 * kWarp) {
      rc = launch_rowlocal_mlp<4>(table, head_src, net, lab, pred, probs, rows, norm_floats, s);
    } else if (widest <= 8 * kWarp) {
      rc = launch_rowlocal_mlp<8>(table, head_src, net, lab, pred, probs, rows, norm_floats, s);
    } else if (widest <= 16 * kWarp) {
      rc = launch_rowlocal_mlp<16>(table, head_src, net, lab, pred, probs, rows, norm_floats, s);
    } else {
      rc = launch_rowlocal_mlp<32>(table, head_src, net, lab, pred, probs, rows, norm_floats, s);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
