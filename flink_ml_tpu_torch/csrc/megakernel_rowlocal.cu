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
// rowlocal_ops.cuh; a kmeans op computes its centroid norms and distances
// with the dedicated scale -> kmeans kernel's code, so a row gets the same
// cluster from either, and a sparse op keeps the sparse kernel's products and
// sequential margin (the fold of sparse_fold.cuh), bit-equal to it.
//
// Bound: memory. Per row it reads its input columns once and writes every
// output once; the model vectors and centroids are read by every row but
// stay in L1/L2, except a sparse op's idf or coef of up to 2^22 values (16
// MB), gathered at the row's ids. feature6 -> logistic at 4096 x 100 moves
// 11,520,352 B, 3.44 us at the H100's 3.35 TB/s, against about 6 MFLOP.
//
// Design: one warp per row, kRowsPerBlock rows per block, the grid capped at
// kMaxBlocks blocks that stride over the rows. The table (ops and slots)
// is a __grid_constant__ kernel parameter, so every warp reads the same entry
// from the constant bank and the switch per entry never diverges. Lane l
// holds elements l, l + 32, ... of the current row in registers (kSlots of
// them, a template argument chosen from the widest slot, a sparse slot's cap
// included). Normalize's norm is one xor butterfly of __shfl_xor_sync; the
// logistic head is the warp dot and head of megakernel_scale_logistic.cu. A
// block with kmeans ops first computes their centroid norms into dynamic
// shared memory; a sparse head folds in its warp's strip of static shared
// memory (sparse_fold.cuh).
//
// Limits, mirrored by servable/megakernels.py: every slot 1 <= width <=
// kMaxDim (a lane's registers; a sparse column's cap too), at most kMaxOps ops
// and kMaxSlots slots (the table fits the 4 KB of kernel parameters), at most
// kMaxK centroids an op and kMaxNormFloats centroids over the table's kmeans
// ops.
#include "rowlocal_ops.cuh"

namespace {

using namespace rowlocal;

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMaxBlocks = 132 * 8;  // a few waves of the H100's 132 SMs; blocks stride beyond
constexpr int kMaxNormFloats = 48 * 1024;  // 192 KB of norms, inside the 227 KB a block may take

template <int kSlots>
__global__ void __launch_bounds__(kThreads)
rowlocal_kernel(const __grid_constant__ Table table, int rows, int with_norms) {
  extern __shared__ float norms[];
  __shared__ __align__(16) float strips[kRowsPerBlock][kWarp];  // each warp's sparse fold (run_row)
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (with_norms) {
    table_norms(table, norms, warp, kRowsPerBlock, lane);
    __syncthreads();
  }
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;
       row += gridDim.x * kRowsPerBlock) {  // row is uniform across the warp
    float v[kSlots];
    run_row<kSlots>(table, 0, table.n_ops, row, lane, v, norms, strips[warp]);
  }
}

template <int kSlots>
cudaError_t launch(const Table& table, int rows, int norm_floats, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(norm_floats);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        rowlocal_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  rowlocal_kernel<kSlots><<<grid, kThreads, smem, stream>>>(table, rows, norm_floats > 0);
  return cudaSuccess;
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
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (widest <= kWarp) {
      rc = launch<1>(table, rows, norm_floats, s);
    } else if (widest <= 2 * kWarp) {
      rc = launch<2>(table, rows, norm_floats, s);
    } else if (widest <= 4 * kWarp) {
      rc = launch<4>(table, rows, norm_floats, s);
    } else if (widest <= 8 * kWarp) {
      rc = launch<8>(table, rows, norm_floats, s);
    } else if (widest <= 16 * kWarp) {
      rc = launch<16>(table, rows, norm_floats, s);
    } else {
      rc = launch<32>(table, rows, norm_floats, s);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
