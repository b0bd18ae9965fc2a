// The row-local op interpreter and the closest-centroid search, shared by the
// serving megakernels.
//
// Three kernels include this header:
//   megakernel_rowlocal.cu     any chain of table ops without an MLP head, one
//                              warp per row;
//   megakernel_scale_mlp.cu    the same table with one or more MLP heads in it:
//                              the ops before a head are its prologue, the
//                              ops after the last head its epilogue;
//   megakernel_scale_kmeans.cu the dedicated scale -> kmeans kernel, which
//                              uses the centroid norms and the per-row
//                              assignment below, so a row gets the same
//                              cluster whichever kernel serves its chain.
//
// A chain is an op table: each Op reads one slot and writes one (two for the
// heads). Slots are the chain's input columns, then each op's outputs, each
// [rows] (width 1) or [rows, width], contiguous, typed (Slot.dtype): float32,
// or int32 for a kmeans index, a binarize of one, and a sparse column's ids
// and nnz. A SparseVector column rides the sparse calling convention
// (servable/sparse.py) as three slots: values [rows, cap] f32, ids [rows, cap]
// i32 and nnz [rows] i32, padding slots id 0 / value 0. No op reads nnz: a
// sparse op's output shares its input's ids and nnz slots. Per row, entry by
// entry, an op computes on the row of its input slot
//   scale                (x - mean) * inv_std   (each step only if its flag is set)
//   normalize            x / (n == 0 ? 1 : n),  n = (sum |x|^p)^(1/p)
//   elementwise_product  x * scaling
//   idf                  x * idf
//   binarize             x > threshold ? 1 : 0  (NaN gives 0), in x's dtype
//   impute               missing(x) ? surrogate : x, missing = isnan(x) or x == placeholder
//   logistic             margin = x . coef, prediction = margin >= 0,
//                        raw = [1 - sigmoid(margin), sigmoid(margin)]
//   kmeans               the index of the closest of k centroids under the
//                        op's measure (below), int32
//   sparse_idf           values * idf[ids], each slot, padding included
//                        (0 * idf[0]); ids and nnz pass through
//   sparse_logistic      margin = (((0 + t0) + t1) + ...) over all cap slots,
//                        t = values * coef[ids]; then the logistic head
//   mlp                  megakernel_scale_mlp.cu's block-wide head (only there)
// An int32 input is read as float32 (exact for indices below 2^24), so binarize
// and impute compare as the JAX package does after its promotion; binarize
// writes its input's dtype, every other op float32 (kmeans: int32). An id
// outside [0, d) is clamped as the JAX package's gather does: a negative id
// counts from the end, then it is clipped into range.
// Lane l of the row's warp holds elements l, l + 32, ... of the current row in
// registers (kSlots of them), a sparse row's entries as a dense row's; so a
// cap, like a width, is at most kMaxDim. While an op reads the slot the
// previous op wrote, the row stays in registers; an op that reads any other
// slot loads that slot's row (an input, or an output this same warp wrote
// earlier). A sparse op reads its ids from memory. Slots use plain loads, not
// __ldg: the kernels write some of them. The heads write from lane 0 and then
// __syncwarp(), so a later op that reads their outputs from other lanes sees
// them.
//
// Numerics: every elementwise op uses the _rn intrinsics, which the compiler
// never contracts into an FMA, so each output of a chain without normalize
// and before a head is bit-identical to the plain PyTorch version, sparse_idf
// included. The sparse head folds as the sparse kernel does
// (megakernel_sparse_idf_logistic.cu), with the fold of sparse_fold.cuh: the
// warp writes a chunk of 32 slot products to its strip of shared memory and
// lane 0 adds them in slot order, chunk after chunk, the strictly sequential
// fold of ops/kernels.segment_sum, so its margin and prediction are
// bit-equal to the plain version's at every cap. Normalize
// mirrors torch.pow on CUDA, which special-cases the exponent: p = 1 is |x|
// itself, p = 2 is |x| * |x|, p = 3 is (|x| * |x|) * |x|, other p are powf;
// the root is the sum itself for p = 1, sqrtf for p = 2 (torch takes ** 0.5 as
// sqrt), powf(sum, 1/p) otherwise; then one correctly rounded divide. The row
// sum runs in another order than torch.sum's, so outputs from a normalize on
// are held to the fast tier's envelope, as the dense logistic head's margin
// (a warp butterfly) is. The sigmoid is torch.sigmoid's formula
// 1 / (1 + expf(-m)). No fast-math flags.
//
// The closest centroid, in the JAX package's op order
// (flink_ml_tpu/ops/distance.py):
//   euclidean  sqrt(max((|h|^2 + |c|^2) - 2 (h . c), 0))
//   manhattan  sum_j |h_j - c_j|
//   cosine     1 - ((h . c) / |h|) / |c|,  |v| = sqrt(sum v^2)
// the first c of minimal distance, a NaN counting as the minimum (as
// jnp.argmin and torch.argmin take it). The dot products and norms are lane
// partial sums (fmaf in slot order) closed by one xor butterfly of
// __shfl_xor_sync: IEEE addition commutes, so every lane ends with the same
// bits and tracks the same (best value, best index) with no divergence. They
// sum in another order than the plain version's, so a row's index can differ
// only where its two nearest distances lie within rounding of each other. The
// clamp at 0 keeps a NaN (fmaxf would drop it). A block computes |c|^2
// (euclidean) or |c| (cosine) of every centroid once into shared memory.
//
// Limits: every slot 1 <= width <= kMaxDim, at most kMaxOps ops and kMaxSlots
// slots (the table is a kernel parameter), k <= kMaxK centroids a kmeans op;
// a sparse op's model vector (idf, coef) is a pointer of any length d < 2^31.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "sparse_fold.cuh"

namespace rowlocal {

constexpr int kWarp = 32;
constexpr int kMaxDim = 1024;   // a lane's registers: 32 slots of a row
constexpr int kMaxOps = 32;
constexpr int kMaxSlots = 64;
constexpr int kMaxK = 1024;     // centroids of one kmeans op
static_assert(kMaxDim == 32 * kWarp, "the widest slot count, 32, covers kMaxDim");

enum OpCode {
  kScale = 0,
  kNormalize = 1,
  kElementwiseProduct = 2,
  kIdf = 3,
  kBinarize = 4,
  kImpute = 5,
  kLogistic = 6,
  kKmeans = 7,
  kSparseIdf = 8,
  kSparseLogistic = 9,
  kMlp = 10,  // megakernel_scale_mlp.cu only
};

enum Flags {
  kWithMean = 1,     // scale
  kWithStd = 2,      // scale
  kMissingNaN = 1,   // impute
};

enum Measure { kEuclidean = 0, kManhattan = 1, kCosine = 2 };

enum SlotType { kF32 = 0, kI32 = 1 };

// One op of the chain. Mirrors servable/megakernels.py _Op (ctypes).
struct Op {
  int op;       // OpCode
  int src;      // the slot read (a sparse op: the values slot)
  int dst;      // the slot written (the heads: prediction)
  int dst2;     // logistic, sparse_logistic: rawPrediction; mlp: the probabilities
  int flags;    // Flags; kmeans: the Measure; sparse ops: d, the length of a
  int k;        // kmeans: the number of centroids; sparse ops: the ids slot;
                // mlp: the network's index (megakernel_scale_mlp.cu)
  float s0;     // normalize p; binarize threshold; impute placeholder
  float s1;     // normalize 1/p
  const float* a;  // scale mean; the product's scaling; idf; impute's surrogate (one value);
                   // logistic coef; kmeans centroids [k, width]; sparse_idf idf [d];
                   // sparse_logistic coef [d]; mlp labels [classes]
  const float* b;  // scale inv_std
};

// One column of the chain: [rows] (width 1) or [rows, width], contiguous, of
// dtype SlotType. Mirrors servable/megakernels.py _Slot (ctypes).
struct Slot {
  float* ptr;  // an int32 slot's data through reinterpret_cast<int*>
  int width;
  int dtype;   // SlotType
};

struct Table {
  int n_ops;
  int n_slots;
  Op ops[kMaxOps];
  Slot slots[kMaxSlots];
};
static_assert(sizeof(Table) <= 3072, "the table leaves room in the 4 KB of kernel parameters");

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

using sparse_fold::clamp_id;  // an id into a vector of d values, clamped as the JAX package's gather does

// The warp's total of v, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// |x|^p as torch.pow computes it on CUDA for these exponents.
__device__ __forceinline__ float pow_p(float t, float p) {
  if (p == 1.0f) return t;
  if (p == 2.0f) return __fmul_rn(t, t);
  if (p == 3.0f) return __fmul_rn(__fmul_rn(t, t), t);
  return powf(t, p);
}

// sum^(1/p), the same way.
__device__ __forceinline__ float root_p(float sum, float p, float inv_p) {
  if (p == 1.0f) return sum;
  if (p == 2.0f) return __fsqrt_rn(sum);
  return powf(sum, inv_p);
}

// |c|^2 (euclidean) or |c| (cosine) of each of the k centroids [k, d] into
// norms[0, k): warp `warp` of `n_warps` takes centroids warp, warp + n_warps,
// ...; nothing for manhattan. The caller synchronises the block afterwards.
__device__ __forceinline__ void centroid_norms(const float* __restrict__ centroids, int k, int d,
                                               int measure, float* norms, int warp, int n_warps,
                                               int lane) {
  if (measure == kManhattan) return;
  for (int c = warp; c < k; c += n_warps) {
    const float* cr = centroids + static_cast<size_t>(c) * d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += kWarp) {
      const float v = __ldg(cr + j);
      acc = __fmaf_rn(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) norms[c] = measure == kCosine ? __fsqrt_rn(acc) : acc;
  }
}

// The index of the closest of the k centroids [k, d] to the row h (lane l
// holds h's elements l, l + 32, ...; elements at or past d are taken as 0),
// with the block's centroid norms. The same value in every lane.
template <int kSlots>
__device__ __forceinline__ int kmeans_assign(const float (&h)[kSlots],
                                             const float* __restrict__ centroids,
                                             const float* norms, int k, int d, int measure,
                                             int lane) {
  float p2 = 0.0f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const float v = s * kWarp + lane < d ? h[s] : 0.0f;
    p2 = __fmaf_rn(v, v, p2);
  }
  if (measure != kManhattan) p2 = warp_sum(p2);
  const float pn = __fsqrt_rn(p2);  // cosine's |h|

  float best = 0.0f;
  int best_idx = 0;
  for (int c = 0; c < k; ++c) {
    const float* cr = centroids + static_cast<size_t>(c) * d;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * kWarp + lane;
      const float hv = j < d ? h[s] : 0.0f;
      const float cv = j < d ? __ldg(cr + j) : 0.0f;  // past d: 0 against h's 0
      if (measure == kManhattan) {
        acc = __fadd_rn(acc, fabsf(__fsub_rn(hv, cv)));
      } else {
        acc = __fmaf_rn(hv, cv, acc);
      }
    }
    acc = warp_sum(acc);
    float dist;
    if (measure == kEuclidean) {
      const float sq = __fsub_rn(__fadd_rn(p2, norms[c]), __fmul_rn(2.0f, acc));
      dist = __fsqrt_rn(sq < 0.0f ? 0.0f : sq);  // NaN < 0 is false: NaN stays
    } else if (measure == kCosine) {
      dist = __fsub_rn(1.0f, __fdiv_rn(__fdiv_rn(acc, pn), norms[c]));
    } else {
      dist = acc;
    }
    // the first minimum; once best is NaN nothing replaces it
    if (c == 0 || (!is_nan(best) && (is_nan(dist) || dist < best))) {
      best = dist;
      best_idx = c;
    }
  }
  return best_idx;
}

// A row of a slot into the lanes' registers, an int32 slot's values as float32.
template <int kSlots>
__device__ __forceinline__ void load_row(const Slot& slot, int row, int lane, float (&v)[kSlots]) {
  const size_t base = static_cast<size_t>(row) * slot.width;
  if (slot.dtype == kI32) {
    const int* p = reinterpret_cast<const int*>(slot.ptr) + base;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * kWarp + lane;
      v[s] = j < slot.width ? __int2float_rn(p[j]) : 0.0f;
    }
    return;
  }
  const float* p = slot.ptr + base;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    v[s] = j < slot.width ? p[j] : 0.0f;
  }
}

// The lanes' row into a slot; an int32 slot takes binarize's 0 / 1 exactly.
template <int kSlots>
__device__ __forceinline__ void store_row(const Slot& slot, int row, int lane, const float (&v)[kSlots]) {
  const size_t base = static_cast<size_t>(row) * slot.width;
  if (slot.dtype == kI32) {
    int* p = reinterpret_cast<int*>(slot.ptr) + base;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * kWarp + lane;
      if (j < slot.width) p[j] = __float2int_rz(v[s]);
    }
    return;
  }
  float* p = slot.ptr + base;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    if (j < slot.width) p[j] = v[s];
  }
}

// The logistic head's outputs for one row, from lane 0 (whose margin is the
// row's), then __syncwarp().
__device__ __forceinline__ void logistic_head(const Table& table, const Op& op, int row, int lane,
                                              float margin) {
  if (lane == 0) {
    const float p = 1.0f / (1.0f + expf(-margin));
    table.slots[op.dst].ptr[row] = margin >= 0.0f ? 1.0f : 0.0f;
    table.slots[op.dst2].ptr[2 * static_cast<size_t>(row)] = 1.0f - p;
    table.slots[op.dst2].ptr[2 * static_cast<size_t>(row) + 1] = p;
  }
  __syncwarp();
}

// The centroid norms of every kmeans op of the table, op after op, into
// norms (the block's shared memory, table_norm_floats(table) floats). The
// caller synchronises the block afterwards.
__device__ __forceinline__ void table_norms(const Table& table, float* norms, int warp,
                                            int n_warps, int lane) {
  int off = 0;
  for (int i = 0; i < table.n_ops; ++i) {
    const Op& op = table.ops[i];
    if (op.op != kKmeans) continue;
    centroid_norms(op.a, op.k, table.slots[op.src].width, op.flags, norms + off, warp, n_warps,
                   lane);
    off += op.k;
  }
}

// Where the norms of the kmeans ops from `begin` on start in table_norms' layout.
__device__ __forceinline__ int norm_offset(const Table& table, int begin) {
  int off = 0;
  for (int i = 0; i < begin; ++i) {
    if (table.ops[i].op == kKmeans) off += table.ops[i].k;
  }
  return off;
}

// Runs the table's ops [begin, end) on one row (uniform across the warp),
// writing every op's output slot; no op there may be an mlp head. `strip` is
// the warp's kWarp floats of shared memory (16-byte aligned), where a sparse
// head folds. Returns the slot whose row v holds afterwards (-1: none).
template <int kSlots>
__device__ __forceinline__ int run_row(const Table& table, int begin, int end, int row, int lane,
                                       float (&v)[kSlots], const float* norms, float* strip) {
  int cur = -1;  // the slot whose row v holds
  int norm_off = norm_offset(table, begin);
  for (int i = begin; i < end; ++i) {
    const Op& op = table.ops[i];
    const int w = table.slots[op.src].width;
    if (op.src != cur) load_row<kSlots>(table.slots[op.src], row, lane, v);
    cur = op.src;
    if (op.op == kLogistic) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        if (j < w) acc = __fmaf_rn(v[s], __ldg(op.a + j), acc);
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, offset);
      }
      logistic_head(table, op, row, lane, acc);
      continue;  // v still holds the head's input row
    }
    if (op.op == kSparseLogistic) {
      const int* ids = reinterpret_cast<const int*>(table.slots[op.k].ptr) + static_cast<size_t>(row) * w;
      float term[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        term[s] = j < w ? __fmul_rn(v[s], __ldg(op.a + clamp_id(ids[j], op.flags))) : 0.0f;
      }
      float acc = 0.0f;  // lane 0: the sequential fold over slots 0, 1, ..., w - 1
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int n = min(kWarp, w - s * kWarp);  // uniform: the slots this chunk holds
        if (n <= 0) break;
        strip[lane] = term[s];
        __syncwarp();
        if (lane == 0) acc = sparse_fold::fold(strip, n, acc);
        __syncwarp();  // the next chunk rewrites the strip
      }
      logistic_head(table, op, row, lane, acc);  // from lane 0
      continue;  // v still holds the values row
    }
    if (op.op == kKmeans) {
      const int idx = kmeans_assign<kSlots>(v, op.a, norms + norm_off, op.k, w, op.flags, lane);
      norm_off += op.k;
      if (lane == 0) reinterpret_cast<int*>(table.slots[op.dst].ptr)[row] = idx;
      __syncwarp();
      continue;  // v still holds the head's input row
    }
    if (op.op == kNormalize) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        if (j < w) acc = __fadd_rn(acc, pow_p(fabsf(v[s]), op.s0));
      }
      const float norm = root_p(warp_sum(acc), op.s0, op.s1);
      const float denom = norm == 0.0f ? 1.0f : norm;  // NaN == 0 is false: NaN stays
#pragma unroll
      for (int s = 0; s < kSlots; ++s) v[s] = s * kWarp + lane < w ? __fdiv_rn(v[s], denom) : 0.0f;
    } else if (op.op == kSparseIdf) {
      const int* ids = reinterpret_cast<const int*>(table.slots[op.k].ptr) + static_cast<size_t>(row) * w;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        if (j < w) v[s] = __fmul_rn(v[s], __ldg(op.a + clamp_id(ids[j], op.flags)));
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kWarp + lane;
        if (j >= w) continue;
        float x = v[s];
        switch (op.op) {
          case kScale:
            if (op.flags & kWithMean) x = __fsub_rn(x, __ldg(op.a + j));
            if (op.flags & kWithStd) x = __fmul_rn(x, __ldg(op.b + j));
            break;
          case kElementwiseProduct:
          case kIdf:
            x = __fmul_rn(x, __ldg(op.a + j));
            break;
          case kBinarize:
            x = x > op.s0 ? 1.0f : 0.0f;
            break;
          case kImpute:
            if ((op.flags & kMissingNaN) ? is_nan(x) : x == op.s0) x = __ldg(op.a);
            break;
          default:
            break;
        }
        v[s] = x;
      }
    }
    store_row<kSlots>(table.slots[op.dst], row, lane, v);
    cur = op.dst;
  }
  return cur;
}

// Host side: copies n_ops (0 or more) ops and n_slots slots into table and
// checks them: every width in 1..kMaxDim and dtype known, every slot index in
// range, each op's slots of the widths and dtypes it reads and writes (below),
// a kmeans op's k in 1..kMaxK and its measure known, a sparse op's d >= 1, and
// an mlp head only where `mlp_heads` allows (its network index below it). Sets
// *widest to the widest slot and *norm_floats to the shared-memory floats of
// the kmeans ops' norms. Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t load_table(Table& table, const void* ops, int n_ops, const void* slots,
                              int n_slots, int mlp_heads, int* widest, int* norm_floats) {
  if (n_ops < 0 || n_ops > kMaxOps || n_slots < 1 || n_slots > kMaxSlots) {
    return cudaErrorInvalidValue;
  }
  std::memset(&table, 0, sizeof(table));
  table.n_ops = n_ops;
  table.n_slots = n_slots;
  std::memcpy(table.ops, ops, sizeof(Op) * n_ops);
  std::memcpy(table.slots, slots, sizeof(Slot) * n_slots);
  *widest = 1;
  *norm_floats = 0;
  for (int i = 0; i < n_slots; ++i) {
    const Slot& slot = table.slots[i];
    if (slot.width < 1 || slot.width > kMaxDim || (slot.dtype != kF32 && slot.dtype != kI32)) {
      return cudaErrorInvalidValue;
    }
    if (slot.width > *widest) *widest = slot.width;
  }
  auto in_range = [n_slots](int s) { return s >= 0 && s < n_slots; };
  for (int i = 0; i < n_ops; ++i) {
    const Op& op = table.ops[i];
    if (op.op < kScale || op.op > kMlp || !in_range(op.src) || !in_range(op.dst)) {
      return cudaErrorInvalidValue;
    }
    const Slot& in = table.slots[op.src];
    const Slot& out = table.slots[op.dst];
    const bool head = op.op == kLogistic || op.op == kSparseLogistic || op.op == kMlp;
    if (head && !in_range(op.dst2)) return cudaErrorInvalidValue;
    // what each op reads: binarize and impute any dtype; the rest float32
    if (in.dtype != kF32 && op.op != kBinarize && op.op != kImpute) return cudaErrorInvalidValue;
    // what each op writes: kmeans int32; binarize its input's dtype; the rest float32
    const int out_dtype = op.op == kKmeans ? kI32 : op.op == kBinarize ? in.dtype : kF32;
    if (out.dtype != out_dtype || (head && table.slots[op.dst2].dtype != kF32)) {
      return cudaErrorInvalidValue;
    }
    if (!head && op.op != kKmeans && out.width != in.width) return cudaErrorInvalidValue;
    if ((head || op.op == kKmeans) && out.width != 1) return cudaErrorInvalidValue;
    if ((op.op == kLogistic || op.op == kSparseLogistic) && table.slots[op.dst2].width != 2) {
      return cudaErrorInvalidValue;
    }
    if (op.op == kSparseIdf || op.op == kSparseLogistic) {
      if (!in_range(op.k) || table.slots[op.k].dtype != kI32 || table.slots[op.k].width != in.width ||
          op.flags < 1 || op.a == nullptr) {
        return cudaErrorInvalidValue;
      }
    }
    if (op.op == kMlp && (op.k < 0 || op.k >= mlp_heads)) return cudaErrorInvalidValue;
    if (op.op == kKmeans) {
      if (op.k < 1 || op.k > kMaxK || op.flags < kEuclidean || op.flags > kCosine) {
        return cudaErrorInvalidValue;
      }
      *norm_floats += op.k;
    }
  }
  return cudaSuccess;
}

}  // namespace rowlocal
