// The serving megakernel for every chain with an MLP head in it: the MLP
// alone, StandardScaler -> MLPClassifier, any chain of table ops before it,
// table ops after it, and more than one MLP head.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("mlp",), ("scale", "mlp"),
// ("normalize", "mlp"), ("mlp", "scale"), ("normalize", "mlp", "binarize") on
// rawPrediction, ("mlp", "kmeans"), ("mlp", "mlp"), ... : every chain of table
// ops (rowlocal_ops.cuh, sparse ones included) with one or more MLP heads
// anywhere in it. The chain is one op table; an mlp entry marks a head. The
// kernel works through the table in phases: the ops before a head run on each
// row of the block's tile (its prologue), writing every output they declare,
// and the head's input row goes into buffer 0; an empty prologue stages the
// head's input slot itself. Per row the head computes
//   h{l+1}      = relu(h{l} @ W{l} + b{l})   for every hidden layer, h0 the head's input
//   logits      = h{L-1} @ W{L-1} + b{L-1}
//   probability = softmax(logits)
//   prediction  = labels[argmax(logits)]     (the first maximal index; NaN
//                                             counts as the maximum)
// and writes prediction and the probabilities into its two slots, float32.
// Then the next phase: the ops up to the next head, or after the last head
// (the epilogue), one warp per row of the tile as in the prologue; they may
// read the head's outputs or any other slot.
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
// stored. A table phase is a warp per row, the row in lane registers, as in
// megakernel_rowlocal.cu; a __syncthreads() closes each phase, so the next
// sees every output of the one before in device memory. The tile's
// activations live in dynamic shared memory as two ping-pong buffers of kRows
// x kMaxWidth floats: layer l reads one and writes the other, so no
// intermediate goes through device memory. A
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
// Numerics: the table's ops are as rowlocal_ops.cuh states (a scale is
// bit-identical to the plain version). The products sum in another order
// than cuBLAS or the CPU, and the softmax sums in another order than
// torch.softmax: both stay inside the fast tier's ulp envelope. No fast-math
// flags.
//
// Limits, mirrored by servable/megakernels.py chain_eligible: at most
// kMaxHeads MLP heads, each of at most kMaxLayers layers, every width at most
// kMaxWidth, at most kMaxClasses classes; the table within rowlocal_ops.cuh's
// limits, with at most kMaxNormFloats centroids over its kmeans ops. The table
// (2.6 KB) and the networks (4 x 168 B) share the 4 KB of kernel parameters.
#include "rowlocal_ops.cuh"

namespace {

constexpr int kMaxHeads = 4;
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

// The networks of the table's mlp heads, in the order of their Op.k.
struct MlpNets {
  MlpLayers net[kMaxHeads];
};
static_assert(sizeof(rowlocal::Table) + sizeof(MlpNets) + 16 <= 4096,
              "the table, the networks and the scalars fit the 4 KB of kernel parameters");

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
// and the head, writing prediction and probabilities of rows row0 ... . Not
// inlined: inlined into the loop over the table's phases, the layers ran 6%
// slower than the single-prologue kernel's (PERF.md); out of line they run
// as fast.
__device__ __noinline__ void layers_and_head(float* smem, const MlpLayers& net,
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

// One phase for one row (uniform across the warp): the table's ops [begin,
// end), then, with dst, the head's input slot into dst[0, d0), zeros to d0_pad;
// a row past `rows` runs no op, and stages zeros. Not inlined: inlined, ptxas
// held the kernel to 128 registers and spilled at kSlots 8 and 16, and the
// layers ran slower than without a prologue (PERF.md); out of line, no
// instance spills.
template <int kSlots>
__device__ __noinline__ void phase_row(const rowlocal::Table& table, int begin, int end,
                                       int head_src, int row, int rows, int lane,
                                       const float* norms, float* dst, int d0, int d0_pad) {
  float v[kSlots];
  if (row < rows) {
    const int cur = rowlocal::run_row<kSlots>(table, begin, end, row, lane, v, norms);
    if (dst != nullptr && cur != head_src) rowlocal::load_row<kSlots>(table.slots[head_src], row, lane, v);
  }
  if (dst == nullptr) return;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    if (j < d0_pad) dst[j] = (row < rows && j < d0) ? v[s] : 0.0f;
  }
}

// The table in phases (file comment): for each mlp head, the ops before it on
// each row of the tile (a warp per row), the head's input staged into buffer
// 0, then its layers and head; after the last head, the epilogue's ops.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
rowlocal_mlp_kernel(const __grid_constant__ rowlocal::Table table,
                    const __grid_constant__ MlpNets nets, int rows, int with_norms) {
  extern __shared__ __align__(16) float smem[];
  float* const norms = smem + kSmemBytes / sizeof(float);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int row0 = blockIdx.x * kRows;
  if (with_norms) {
    rowlocal::table_norms(table, norms, warp, kThreads / kWarp, lane);
    __syncthreads();
  }
  int begin = 0;
  while (begin <= table.n_ops) {  // uniform: the table decides every branch
    int end = begin;
    while (end < table.n_ops && table.ops[end].op != rowlocal::kMlp) ++end;
    if (end == table.n_ops) {  // the epilogue
      if (begin < end) {
        for (int i = 0; i < kRowsPerWarp; ++i) {
          phase_row<kSlots>(table, begin, end, -1, row0 + warp * kRowsPerWarp + i, rows, lane, norms,
                            nullptr, 0, 0);
        }
      }
      break;
    }
    // the prologue of the head at `end`: buffer 0 row r holds the head's
    // input, zero-padded to a whole K-slice (d0_pad <= kSlots * 32, so the
    // lanes' slots cover it)
    const rowlocal::Op& head = table.ops[end];
    const MlpLayers& net = nets.net[head.k];
    const int d0 = net.width[0];
    const int d0_pad = round_up(d0, kK);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      phase_row<kSlots>(table, begin, end, head.src, row0 + r, rows, lane, norms, smem + r * kMaxWidth,
                        d0, d0_pad);
    }
    __syncthreads();
    layers_and_head(smem, net, head.a, table.slots[head.dst].ptr, table.slots[head.dst2].ptr, rows,
                    row0);
    __syncthreads();  // the head's outputs are in device memory for the next phase
    begin = end + 1;
  }
}

template <int kSlots>
cudaError_t launch_rowlocal_mlp(const rowlocal::Table& table, const MlpNets& nets, int rows,
                                int norm_floats, cudaStream_t stream) {
  const size_t smem = kSmemBytes + sizeof(float) * static_cast<size_t>(norm_floats);
  const cudaError_t attr = cudaFuncSetAttribute(
      rowlocal_mlp_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((rows + kRows - 1) / kRows);
  rowlocal_mlp_kernel<kSlots><<<grid, kThreads, smem, stream>>>(table, nets, rows, norm_floats > 0);
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
// cudaErrorInvalidValue for a table or a network past the limits, a table
// load_table refuses, or an mlp head whose slots do not fit its network (its
// input slot of another width than the network's input, its prediction slot
// not [rows], its probabilities slot not [rows, classes], float32). ops and
// slots are the table (rowlocal_ops.cuh) with n_heads >= 1 mlp entries, the
// i-th of them with Op.k == i. The networks come as host arrays: n_layers
// [n_heads] layer counts, and weights, biases (device pointers) and widths
// ([d_in, hidden..., classes]) of every head one after the other. rows == 0
// launches nothing.
int megakernel_rowlocal_mlp(const void* ops, int n_ops, const void* slots, int n_slots,
                            const void* const* weights, const void* const* biases,
                            const int* widths, const int* n_layers, int n_heads, int rows,
                            void* stream) {
  if (n_heads < 1 || n_heads > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  rowlocal::Table table;
  int widest = 1, norm_floats = 0;
  cudaError_t rc = rowlocal::load_table(table, ops, n_ops, slots, n_slots, n_heads, &widest,
                                        &norm_floats);
  if (rc != cudaSuccess || norm_floats > kMaxNormFloats) return static_cast<int>(cudaErrorInvalidValue);
  MlpNets nets = {};
  for (int h = 0, layer = 0, width = 0; h < n_heads; ++h) {
    if (!load_net(nets.net[h], weights + layer, biases + layer, widths + width, n_layers[h])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    layer += n_layers[h];
    width += n_layers[h] + 1;
  }
  int seen = 0;
  for (int i = 0; i < n_ops; ++i) {
    const rowlocal::Op& op = table.ops[i];
    if (op.op != rowlocal::kMlp) continue;
    const MlpLayers& net = nets.net[op.k];
    const rowlocal::Slot& probs = table.slots[op.dst2];
    if (op.k != seen++ || op.a == nullptr || table.slots[op.src].width != net.width[0] ||
        probs.width != net.width[net.n_layers]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (seen != n_heads) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (widest <= kWarp) {
      rc = launch_rowlocal_mlp<1>(table, nets, rows, norm_floats, s);
    } else if (widest <= 2 * kWarp) {
      rc = launch_rowlocal_mlp<2>(table, nets, rows, norm_floats, s);
    } else if (widest <= 4 * kWarp) {
      rc = launch_rowlocal_mlp<4>(table, nets, rows, norm_floats, s);
    } else if (widest <= 8 * kWarp) {
      rc = launch_rowlocal_mlp<8>(table, nets, rows, norm_floats, s);
    } else if (widest <= 16 * kWarp) {
      rc = launch_rowlocal_mlp<16>(table, nets, rows, norm_floats, s);
    } else {
      rc = launch_rowlocal_mlp<32>(table, nets, rows, norm_floats, s);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
