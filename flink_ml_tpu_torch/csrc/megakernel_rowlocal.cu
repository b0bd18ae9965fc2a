// The serving megakernel for any chain of the table ops without an MLP head:
// the row-local feature ops, the dense logistic and kmeans heads, the sparse
// IDF and logistic ops, in any order and mixed.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for every chain over scale, normalize,
// elementwise_product, idf, binarize, impute, sparse_idf and sparse_logistic
// with any number of logistic, kmeans and sparse logistic heads anywhere in it
// (("normalize", "kmeans"), feature6 -> logistic, ("sparse_idf",
// "sparse_logistic", "scale"), ("sparse_idf", "sparse_idf"), ("kmeans",
// "binarize") on the index, ...), except the chains with a kernel of their own
// (servable/megakernels.py MEGAKERNEL_CHAINS and ("sparse_idf",)). The Pallas
// kernel traces the chain's Python bodies; a CUDA kernel cannot, so this one
// is built once and composes the chain at launch from a small op table, as
// build_megakernel_fn composes it at trace time. The ops, the slots and their
// dtypes (float32; int32 for a kmeans index, a binarize of one, and a sparse
// column's ids and nnz), what each op computes and their numerics are in
// rowlocal_ops.cuh; a kmeans op runs the closest-centroid search of the
// dedicated scale -> kmeans kernel, so a row gets the same cluster from
// either, and a sparse op keeps the sparse kernel's products and sequential
// margin (the fold of sparse_fold.cuh), bit-equal to it.
//
// Bound: memory. Per row it reads its input columns once and writes every
// output once; the model vectors and centroids are read by every row but
// stay on chip, except a sparse op's idf or coef of up to 2^22 values (16
// MB), gathered at the row's ids. feature6 -> logistic at 4096 x 100 moves
// 11,520,352 B, 3.44 us at the H100's 3.35 TB/s, against about 6 MFLOP.
//
// Design. A table without sparse ops runs the dense interpreter
// (rowlocal_ops.cuh run_rows) on a persistent grid: about as many blocks of
// kWarps warps as the SMs hold at once, each walking tasks of 32 / L rows a
// warp, L lanes a row (L the next power of two at or above the widest slot
// when that is at most 16, else 32; lane i of a row holds elements i, i + L,
// ... in registers, kSlots of them). The host decodes the table (DenseTable,
// a __grid_constant__ kernel parameter): each op with its slots' pointers,
// widths and dtypes and its offsets in shared memory (DenseOp), the model
// vectors to stage and the input slots to stage, planned by plan_table (the
// norms and, below 32 lanes a row, the kmeans row strips always, then model
// vectors in op order and input slots while they fit kStageFloats; what does
// not fit is read from global memory with the same bits). A block first puts
// in flight every copy of the staged vectors (scale's mean and inv_std, the
// product's scaling, idf, the logistic coef, impute's surrogate and, below 32
// lanes a row, the kmeans centroids in rows padded to 32 terms a step and a
// stride of 4 mod 8 floats, so that lanes walking different centroids read
// 16 bytes each without bank conflicts), warp w taking copies w, w + kWarps,
// ..., beside each warp's copies of its first task's input rows; while they fly it copies the
// ops into shared memory, so that a row reads each op's fields there and not
// through a run-time index into the kernel's parameters; it waits for the
// model and computes the centroid norms while the rows are still in flight. A kmeans op at 32 lanes a row runs the warp's
// search (kmeans_assign), below that the search over the row's lanes
// (kmeans_search). Tables without a kmeans op run instances without the
// search, whose registers leave room for more blocks an SM. A table with a
// sparse op keeps the warp-per-row interpreter (run_row), one warp a row and
// the grid capped at kMaxBlocks blocks that stride over the rows; a block
// with kmeans ops first computes their norms into dynamic shared memory, and
// a sparse head folds in its warp's strip of static shared memory
// (sparse_fold.cuh).
//
// Host work a launch: the device's SM count and shared memory and each
// instance's resident blocks are asked once and cached (rowlocal_ops.cuh
// resident_blocks).
//
// Limits, mirrored by servable/megakernels.py: every slot 1 <= width <=
// kMaxDim (a lane's registers; a sparse column's cap too), at most kMaxOps ops
// and kMaxSlots slots (the table fits the 4 KB of kernel parameters), at most
// kMaxK centroids an op and kMaxNormFloats centroids over the table's kmeans
// ops.
#include "rowlocal_ops.cuh"

namespace {

using namespace rowlocal;

constexpr int kWarps = 8;  // a block's warps (fewer where the mandatory shared memory needs it)
constexpr int kThreads = kWarp * kWarps;
constexpr int kMaxBlocks = 132 * 8;  // the sparse path's grid: a few waves of the H100's 132 SMs
constexpr int kMaxNormFloats = 48 * 1024;  // 192 KB of norms, inside the 227 KB a block may take
constexpr int kStageFloats = 12 * 1024;    // 48 KB of model vectors and input rows past the norms and strips

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The sparse path: one warp a row (run_row); dynamic shared memory holds the
// centroid norms.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
rowlocal_sparse_kernel(const __grid_constant__ Table table, int rows, int with_norms) {
  extern __shared__ float norms[];
  __shared__ __align__(16) float strips[kWarps][kWarp];  // each warp's sparse fold (run_row)
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (with_norms) {
    table_norms(table, norms, warp, kWarps, lane);
    __syncthreads();
  }
  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {  // row is uniform across the warp
    float v[kSlots];
    run_row<kSlots>(table, 0, table.n_ops, row, lane, v, norms, strips[warp]);
  }
}

// The dense path: tasks of kRows = 32 / kLanes rows a warp on a persistent grid.
template <int kSlots, int kLanes, bool kWithKmeans>
__global__ void __launch_bounds__(kThreads)
rowlocal_kernel(const __grid_constant__ DenseTable table, int rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) DenseOp ops[kMaxOps];
  constexpr int kRows = kWarp / kLanes;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int n_ops = table.n_ops;
  const int g = lane / kLanes, i = lane % kLanes;
  float* region = smem + table.inputs + warp * table.input_floats;
  float* strip = smem + table.strips + (warp * kRows + g) * table.strip_floats;
  const int n_tasks = (rows + kRows - 1) / kRows;
  const int step = gridDim.x * n_warps;
  int task = blockIdx.x * n_warps + warp;
  stage_vectors(table, smem, warp, n_warps, lane);
  cp_async_commit();
  if (task < n_tasks) stage_inputs<kRows>(table, region, task * kRows, rows, lane);
  cp_async_commit();  // the first task's rows: in flight until its first op
  decode_ops(table, ops, warp, n_warps, lane);  // while the copies are in flight
  cp_async_wait<1>();  // the model
  __syncthreads();
  if (kWithKmeans) {
    dense_norms(ops, n_ops, smem, warp, n_warps, lane);
    __syncthreads();
  }
  for (bool first = true; task < n_tasks; task += step, first = false) {  // uniform across the warp
    if (!first) {
      stage_inputs<kRows>(table, region, task * kRows, rows, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();  // the region's rows are seen by every lane
    run_rows<kSlots, kLanes, kWithKmeans>(ops, n_ops, smem, region, strip, task * kRows + g, rows, g, i);
    __syncwarp();  // every lane is done with the region before the next copies
  }
}

// The dense path's table for `lanes` lanes a row and n_warps warps a block:
// each op decoded (DenseOp) and the shared memory planned, the floats as the
// result. The norms and (below 32 lanes a row) the kmeans strips first, then
// model vectors in op order and input slots (read by an op, written by none)
// while they fit kStageFloats more and `limit`. At 32 lanes a row a kmeans
// op's centroids stay in global memory: the warp's search reads each
// centroid's row coalesced, through L1. A table with no model to stage, no
// norms to compute and one input slot stages nothing: its rows' loads would
// overlap nothing, and staging would add a trip through shared memory.
int plan_table(const Table& table, int lanes, int n_warps, int limit, DenseTable& dense) {
  std::memset(&dense, 0, sizeof(dense));
  dense.n_ops = table.n_ops;
  int off = 0, widest_kmeans = 0;
  bool written[kMaxSlots] = {};
  for (int i = 0; i < table.n_ops; ++i) {
    const Op& op = table.ops[i];
    const Slot& in = table.slots[op.src];
    DenseOp& d = dense.ops[i];
    d.src = in.ptr;
    d.dst = table.slots[op.dst].ptr;
    d.dst2 = op.op == kLogistic ? table.slots[op.dst2].ptr : nullptr;
    d.a = op.a;
    d.b = op.b;
    d.op = op.op;
    d.flags = op.flags | (in.dtype == kI32 ? kSrcI32 : 0) | (table.slots[op.dst].dtype == kI32 ? kDstI32 : 0);
    d.k = op.k;
    d.w = in.width;
    d.a_off = d.b_off = d.in_off = -1;
    d.c_stride = 0;
    d.s0 = op.s0;
    d.s1 = op.s1;
    written[op.dst] = true;
    if (op.op == kLogistic) written[op.dst2] = true;
    if (op.op == kKmeans) {
      d.b_off = off;  // the norms
      off += op.k;
      if (in.width > widest_kmeans) widest_kmeans = in.width;
    }
  }
  const int norms = off;
  off = round4(off);
  const int rows_per_warp = kWarp / lanes;
  dense.strip_floats = widest_kmeans && lanes < kWarp ? (widest_kmeans + kWarp - 1) / kWarp * kWarp + 4 : 0;
  dense.strips = off;
  off += n_warps * rows_per_warp * dense.strip_floats;
  const int budget = off + kStageFloats < limit ? off + kStageFloats : limit;
  auto take = [&](int floats) {
    if (off + round4(floats) > budget || dense.n_copies == kMaxCopies) return -1;
    const int at = off;
    off += round4(floats);
    return at;
  };
  auto copy = [&](const float* src, int count, int rows, int stride, int pad) {
    const int at = take(rows * stride);
    if (at >= 0) dense.copies[dense.n_copies++] = DenseCopy{src, at, count, rows, stride, pad};
    return at;
  };
  for (int i = 0; i < table.n_ops; ++i) {
    const Op& op = table.ops[i];
    DenseOp& d = dense.ops[i];
    switch (op.op) {
      case kScale:
        if (op.flags & kWithMean) d.a_off = copy(op.a, d.w, 1, d.w, d.w);
        if (op.flags & kWithStd) d.b_off = copy(op.b, d.w, 1, d.w, d.w);
        break;
      case kElementwiseProduct:
      case kIdf:
      case kLogistic:
        d.a_off = copy(op.a, d.w, 1, d.w, d.w);
        break;
      case kImpute:
        d.a_off = copy(op.a, 1, 1, 1, 1);
        break;
      case kKmeans: {
        if (lanes == kWarp) break;
        const int pad = (d.w + kWarp - 1) / kWarp * kWarp;
        const int stride = pad + 4;  // 4 mod 8: 16-byte loads free of conflicts
        d.a_off = copy(op.a, d.w, op.k, stride, pad);
        if (d.a_off >= 0) d.c_stride = stride;
        break;
      }
      default:
        break;
    }
  }
  dense.inputs = off;
  dense.input_floats = 0;
  int staged[kMaxSlots];
  for (int s = 0; s < kMaxSlots; ++s) staged[s] = -2;  // -2: not yet seen
  int n_in = 0;  // the input slots the ops read
  for (int i = 0; i < table.n_ops; ++i) {
    const int s = table.ops[i].src;
    if (!written[s] && staged[s] == -2) {
      staged[s] = -1;
      ++n_in;
    }
  }
  if (n_in < 2 && dense.n_copies == 0 && norms == 0) return off;  // nothing for the rows' loads to overlap
  for (int s = 0; s < kMaxSlots; ++s) staged[s] = -2;
  for (int i = 0; i < table.n_ops; ++i) {
    const int s = table.ops[i].src;
    DenseOp& d = dense.ops[i];
    if (written[s]) continue;
    if (staged[s] == -2) {  // the slot's first reader stages it, if it fits
      const int need = round4(rows_per_warp * d.w);
      staged[s] = off + n_warps * (dense.input_floats + need) <= budget ? dense.input_floats : -1;
      if (staged[s] >= 0) {
        dense.staged[dense.n_inputs++] = DenseInput{table.slots[s].ptr, d.w, staged[s]};
        dense.input_floats += need;
      }
    }
    d.in_off = staged[s];
  }
  return off + n_warps * dense.input_floats;
}

template <int kSlots, int kLanes, bool kWithKmeans>
cudaError_t launch_dense(const Table& table, int rows, cudaStream_t stream) {
  auto kernel = rowlocal_kernel<kSlots, kLanes, kWithKmeans>;
  DeviceFacts dev;
  cudaError_t rc = device_facts(dev);
  if (rc != cudaSuccess) return rc;
  DenseTable dense;
  const int limit = (dev.smem_optin - static_cast<int>(sizeof(DenseOp)) * kMaxOps) / static_cast<int>(sizeof(float));
  int n_warps = kWarps;
  size_t smem = sizeof(float) * plan_table(table, kLanes, n_warps, limit, dense);
  while (smem > sizeof(float) * limit && n_warps > 1) {
    n_warps /= 2;
    smem = sizeof(float) * plan_table(table, kLanes, n_warps, limit, dense);
  }
  if (smem > sizeof(float) * limit) return cudaErrorInvalidValue;
  long long resident = 0;
  rc = resident_blocks(reinterpret_cast<const void*>(kernel), n_warps * kWarp, smem, &resident);
  if (rc != cudaSuccess) return rc;
  const int rows_per_block = n_warps * (kWarp / kLanes);
  const long long wanted = (static_cast<long long>(rows) + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(wanted < resident ? wanted : resident));
  kernel<<<grid, n_warps * kWarp, smem, stream>>>(dense, rows);
  return cudaSuccess;
}

template <int kSlots, int kLanes>
cudaError_t launch_dense(const Table& table, int rows, bool kmeans, cudaStream_t stream) {
  return kmeans ? launch_dense<kSlots, kLanes, true>(table, rows, stream)
                : launch_dense<kSlots, kLanes, false>(table, rows, stream);
}

template <int kSlots>
cudaError_t launch_sparse(const Table& table, int rows, int norm_floats, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(norm_floats);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        rowlocal_sparse_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  rowlocal_sparse_kernel<kSlots><<<grid, kThreads, smem, stream>>>(table, rows, norm_floats > 0);
  return cudaSuccess;
}

// The launch for the table's widest slot: lanes per row (dense path) and
// registers per lane.
cudaError_t launch(const Table& table, int rows, int widest, int norm_floats, cudaStream_t s) {
  bool sparse = false, kmeans = false;
  for (int i = 0; i < table.n_ops; ++i) {
    sparse = sparse || table.ops[i].op == kSparseIdf || table.ops[i].op == kSparseLogistic;
    kmeans = kmeans || table.ops[i].op == kKmeans;
  }
  if (sparse) {
    if (widest <= kWarp) return launch_sparse<1>(table, rows, norm_floats, s);
    if (widest <= 2 * kWarp) return launch_sparse<2>(table, rows, norm_floats, s);
    if (widest <= 4 * kWarp) return launch_sparse<4>(table, rows, norm_floats, s);
    if (widest <= 8 * kWarp) return launch_sparse<8>(table, rows, norm_floats, s);
    if (widest <= 16 * kWarp) return launch_sparse<16>(table, rows, norm_floats, s);
    return launch_sparse<32>(table, rows, norm_floats, s);
  }
  if (widest <= 1) return launch_dense<1, 1>(table, rows, kmeans, s);
  if (widest <= 2) return launch_dense<1, 2>(table, rows, kmeans, s);
  if (widest <= 4) return launch_dense<1, 4>(table, rows, kmeans, s);
  if (widest <= 8) return launch_dense<1, 8>(table, rows, kmeans, s);
  if (widest <= 16) return launch_dense<1, 16>(table, rows, kmeans, s);
  if (widest <= kWarp) return launch_dense<1, kWarp>(table, rows, kmeans, s);
  if (widest <= 2 * kWarp) return launch_dense<2, kWarp>(table, rows, kmeans, s);
  if (widest <= 4 * kWarp) return launch_dense<4, kWarp>(table, rows, kmeans, s);
  if (widest <= 8 * kWarp) return launch_dense<8, kWarp>(table, rows, kmeans, s);
  if (widest <= 16 * kWarp) return launch_dense<16, kWarp>(table, rows, kmeans, s);
  return launch_dense<32, kWarp>(table, rows, kmeans, s);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for the table of n_ops ops over n_slots
// slots (host arrays, copied into the kernel's parameters) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty table, a table
// past the limits, an mlp head, or a table load_table refuses (a slot width
// outside 1..kMaxDim, an op's slots of the wrong width or dtype). rows == 0
// launches nothing.
int megakernel_rowlocal(const void* ops, int n_ops, const void* slots, int n_slots, int rows,
                        void* stream) {
  Table table;
  int widest = 1, norm_floats = 0;
  cudaError_t rc = load_table(table, ops, n_ops, slots, n_slots, 0, &widest, &norm_floats);
  if (rc != cudaSuccess || n_ops < 1 || norm_floats > kMaxNormFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    rc = launch(table, rows, widest, norm_floats, static_cast<cudaStream_t>(stream));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
