// The row-local op interpreter and the closest-centroid search, shared by the
// serving megakernels.
//
// Three kernels include this header:
//   megakernel_rowlocal.cu     any chain of table ops, one warp per row;
//   megakernel_scale_mlp.cu    the same table (perhaps empty) as the prologue
//                              of an MLP head;
//   megakernel_scale_kmeans.cu the dedicated scale -> kmeans kernel, which
//                              uses the centroid norms and the per-row
//                              assignment below, so a row gets the same
//                              cluster whichever kernel serves its chain.
//
// A chain is an op table: each Op reads one slot and writes one (two for the
// logistic head). Slots are the chain's input columns, then each op's
// outputs, each [rows] (width 1) or [rows, width] float32, contiguous; a
// kmeans op's output slot holds int32 indices. Per row, entry by entry, an op
// computes on the row of its input slot
//   scale                (x - mean) * inv_std   (each step only if its flag is set)
//   normalize            x / (n == 0 ? 1 : n),  n = (sum |x|^p)^(1/p)
//   elementwise_product  x * scaling
//   idf                  x * idf
//   binarize             x > threshold ? 1 : 0  (NaN gives 0)
//   impute               missing(x) ? surrogate : x, missing = isnan(x) or x == placeholder
//   logistic             margin = x . coef, prediction = margin >= 0,
//                        raw = [1 - sigmoid(margin), sigmoid(margin)]
//   kmeans               the index of the closest of k centroids under the
//                        op's measure (below)
// Lane l of the row's warp holds elements l, l + 32, ... of the current row in
// registers (kSlots of them). While an op reads the slot the previous op
// wrote, the row stays in registers; an op that reads any other slot loads
// that slot's row (an input, or an output this same warp wrote earlier).
// Slots use plain loads, not __ldg: the kernels write some of them. The
// heads write from lane 0 and then __syncwarp(), so a later op that reads
// their outputs from other lanes sees them.
//
// Numerics: every elementwise op uses the _rn intrinsics, which the compiler
// never contracts into an FMA, so each output of a chain without normalize
// and before a head is bit-identical to the plain PyTorch version. Normalize
// mirrors torch.pow on CUDA, which special-cases the exponent: p = 1 is |x|
// itself, p = 2 is |x| * |x|, p = 3 is (|x| * |x|) * |x|, other p are powf;
// the root is the sum itself for p = 1, sqrtf for p = 2 (torch takes ** 0.5 as
// sqrt), powf(sum, 1/p) otherwise; then one correctly rounded divide. The row
// sum runs in another order than torch.sum's, so outputs from a normalize on
// are held to the fast tier's envelope. The sigmoid is torch.sigmoid's formula
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
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

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
};

enum Flags {
  kWithMean = 1,     // scale
  kWithStd = 2,      // scale
  kMissingNaN = 1,   // impute
};

enum Measure { kEuclidean = 0, kManhattan = 1, kCosine = 2 };

// One op of the chain. Mirrors servable/megakernels.py _Op (ctypes).
struct Op {
  int op;       // OpCode
  int src;      // the slot read
  int dst;      // the slot written (logistic: prediction)
  int dst2;     // logistic: rawPrediction; else unused
  int flags;    // Flags; kmeans: the Measure
  int k;        // kmeans: the number of centroids
  float s0;     // normalize p; binarize threshold; impute placeholder
  float s1;     // normalize 1/p
  const float* a;  // scale mean; the product's scaling; idf; impute's surrogate (one value);
                   // logistic coef; kmeans centroids [k, width]
  const float* b;  // scale inv_std
};

// One column of the chain: [rows] (width 1) or [rows, width], contiguous.
// Mirrors servable/megakernels.py _Slot (ctypes).
struct Slot {
  float* ptr;
  int width;
  int pad;
};

struct Table {
  int n_ops;
  int n_slots;
  Op ops[kMaxOps];
  Slot slots[kMaxSlots];
};
static_assert(sizeof(Table) <= 3072, "the table leaves room in the 4 KB of kernel parameters");

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

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

template <int kSlots>
__device__ __forceinline__ void load_row(const Slot& slot, int row, int lane, float (&v)[kSlots]) {
  const float* p = slot.ptr + static_cast<size_t>(row) * slot.width;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    v[s] = j < slot.width ? p[j] : 0.0f;
  }
}

template <int kSlots>
__device__ __forceinline__ void store_row(const Slot& slot, int row, int lane, const float (&v)[kSlots]) {
  float* p = slot.ptr + static_cast<size_t>(row) * slot.width;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    if (j < slot.width) p[j] = v[s];
  }
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

// Runs the table's ops on one row (uniform across the warp), writing every
// op's output slot. Returns the slot whose row v holds afterwards.
template <int kSlots>
__device__ __forceinline__ int run_row(const Table& table, int row, int lane, float (&v)[kSlots],
                                       const float* norms) {
  int cur = -1;  // the slot whose row v holds
  int norm_off = 0;
  for (int i = 0; i < table.n_ops; ++i) {
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
      if (lane == 0) {
        const float p = 1.0f / (1.0f + expf(-acc));
        table.slots[op.dst].ptr[row] = acc >= 0.0f ? 1.0f : 0.0f;
        table.slots[op.dst2].ptr[2 * static_cast<size_t>(row)] = 1.0f - p;
        table.slots[op.dst2].ptr[2 * static_cast<size_t>(row) + 1] = p;
      }
      __syncwarp();
      continue;  // v still holds the head's input row
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
// checks them:
// every width in 1..kMaxDim, every slot index in range, a kmeans op's k in
// 1..kMaxK and its measure known. Sets *widest to the widest slot and
// *norm_floats to the shared-memory floats of the kmeans ops' norms. Returns
// cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t load_table(Table& table, const void* ops, int n_ops, const void* slots,
                              int n_slots, int* widest, int* norm_floats) {
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
    if (table.slots[i].width < 1 || table.slots[i].width > kMaxDim) return cudaErrorInvalidValue;
    if (table.slots[i].width > *widest) *widest = table.slots[i].width;
  }
  for (int i = 0; i < n_ops; ++i) {
    const Op& op = table.ops[i];
    if (op.op < kScale || op.op > kKmeans || op.src < 0 || op.src >= n_slots || op.dst < 0 ||
        op.dst >= n_slots || (op.op == kLogistic && (op.dst2 < 0 || op.dst2 >= n_slots))) {
      return cudaErrorInvalidValue;
    }
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
