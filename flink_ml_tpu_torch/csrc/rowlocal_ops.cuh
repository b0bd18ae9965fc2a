// The row-local op interpreter and the closest-centroid search, shared by the
// serving megakernels.
//
// Four kernels include this header:
//   megakernel_rowlocal.cu     any chain of table ops without an MLP head:
//                              the dense interpreter, or the warp-per-row
//                              one for a table with sparse ops;
//   megakernel_scale_mlp.cu    the same table with one or more MLP heads in it:
//                              the ops before a head are its prologue, the
//                              ops after the last head its epilogue;
//   megakernel_scale_kmeans.cu the dedicated scale -> kmeans kernel, which
//                              uses the centroid norms and the per-row
//                              assignment below, so a row gets the same
//                              cluster whichever kernel serves its chain;
//   megakernel_scale_logistic.cu the dedicated scale -> logistic kernel,
//                              which closes a row's margin with group_sum
//                              and sizes its persistent grid with
//                              resident_blocks.
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
// Rows and lanes. The warp-per-row interpreter (run_row: the MLP kernel's
// phases and a table with sparse ops) gives a row one warp: lane l holds
// elements l, l + 32, ... of the current row in registers (kSlots of them), a
// sparse row's entries as a dense row's; so a cap, like a width, is at most
// kMaxDim. The dense interpreter (run_rows: megakernel_rowlocal.cu's tables
// without sparse ops) gives a row L = kLanes lanes, the next power of two at
// or above the table's widest slot when that is at most 16, else 32: lane i
// of the row's group holds elements i, i + L, ..., and 32 / L rows share a
// warp (a chain of scalar columns runs one lane per row). It reads its ops
// from the block's shared memory, as the host decoded them (DenseOp), each
// op's model vectors from there too where the host planned room for them,
// and the rows of the table's input slots from the warp's input region,
// staged there before the first op runs, while the block stages its model
// (a table with nothing to stage but one input slot reads its rows where
// its first op runs). While an op reads
// the slot the previous op wrote, the row stays in registers; an op that
// reads any other slot loads that slot's row (an input, or an output this
// same warp wrote earlier). A sparse op reads its ids from memory. Slots use
// plain loads, not __ldg: the kernels write some of them. The heads write
// from the row's first lane and then __syncwarp(), so a later op that reads
// their outputs from other lanes sees them.
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
// (a butterfly over the row's lanes) is. Both sums are lane partials closed
// by an xor butterfly over the row's L lanes, which are the bits of the
// 32-lane butterfly: lanes past the width add +0, which changes no sum but
// the sign of a zero one. The sigmoid is torch.sigmoid's formula
// 1 / (1 + expf(-m)). No fast-math flags.
//
// The closest centroid, in the JAX package's op order
// (flink_ml_tpu/ops/distance.py):
//   euclidean  sqrt(max((|h|^2 + |c|^2) - 2 (h . c), 0))
//   manhattan  sum_j |h_j - c_j|
//   cosine     1 - ((h . c) / |h|) / |c|,  |v| = sqrt(sum v^2)
// the first c of minimal distance, a NaN counting as the minimum (as
// jnp.argmin and torch.argmin take it). The search where rows share a warp,
// kmeans_search, serves the scale -> kmeans kernel and the dense
// interpreter below 32 lanes a row: the L lanes of a row take centroids
// c = i, i + L, ... Each lane forms the whole distance of its centroid from
// 32 partial sums in registers, partial t summing the terms j = t, t + 32,
// ... in slot order (fmaf; manhattan __fadd_rn of |h_j - c_j|), then closes
// them in the tree of the xor butterfly of 32 lanes (t += t + 16, then + 8,
// 4, 2, 1): the bits a warp gets when lane t holds partial t and the lanes
// shuffle them together, as centroid_norms does, with 32 independent chains
// of fmaf in one lane. |h|^2 is the row's lane partials closed by a
// butterfly over its L lanes; lanes past the width hold +0, so that is the
// 32-lane butterfly's sum. A (value, index) butterfly over the L lanes then
// applies the order of kmeans_before, a total order, so its tree does not
// matter. Where a row has the warp (the warp-per-row interpreter, and the
// dense one at 32 lanes a row), kmeans_assign walks the centroids with the
// whole warp: lane t's partial t of each dot product closed by the warp's
// butterfly, the same sums, so the same bits and index. The sums run in
// another order than the plain version's, so a row's index can differ only
// where its two nearest distances lie within rounding of each other. The
// clamp at 0 keeps a NaN (fmaxf would drop it). A block computes |c|^2
// (euclidean) or |c| (cosine) of every centroid once into shared memory.
//
// Limits: every slot 1 <= width <= kMaxDim, at most kMaxOps ops and kMaxSlots
// slots (the table is a kernel parameter), k <= kMaxK centroids a kmeans op;
// a sparse op's model vector (idf, coef) is a pointer of any length d < 2^31.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include "sparse_fold.cuh"
#include "tf32_mma.cuh"  // cp.async

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

// One op as the dense interpreter (run_rows) reads it: decoded on the host
// from the table and its slots (megakernel_rowlocal.cu), copied into each
// block's shared memory once, so that a row's ops read their fields there.
// Offsets are in floats of the block's dynamic shared memory, multiples of 4
// (16 bytes); a vector with no offset (-1) is read from global memory, with
// the same bits.
struct alignas(16) DenseOp {
  const float* src;  // the slot read (its rows)
  float* dst;        // the slot written (the heads: prediction)
  float* dst2;       // logistic: rawPrediction
  const float* a;    // Op.a (impute: its one surrogate)
  const float* b;    // Op.b
  int op;            // OpCode
  int flags;         // Op.flags (kmeans: the Measure) | kSrcI32 | kDstI32
  int k;             // kmeans: the centroids
  int w;             // the src slot's width
  int a_off;         // a staged (kmeans: the centroids' rows)
  int b_off;         // b staged; kmeans: its centroid norms (always staged)
  int in_off;        // the src slot's rows in a warp's input region (-1: read from global memory)
  int c_stride;      // kmeans: the staged centroids' row stride (0: not staged)
  float s0;          // Op.s0
  float s1;          // Op.s1
};
static_assert(sizeof(DenseOp) == 80, "five 16-byte words an op");

enum DenseFlags {
  kOpFlags = 0xff,       // the op's own flags
  kSrcI32 = 1 << 8,      // the src slot is int32
  kDstI32 = 1 << 9,      // the dst slot is int32
};

constexpr int kMaxCopies = 24;  // staged model vectors (more are read from global memory)

// A model vector or a kmeans op's centroids that the dense kernel stages:
// `rows` rows of `count` floats from src (contiguous) into shared memory at
// `dst`, `stride` floats apart, zeros from `count` to `pad` in each row.
struct DenseCopy {
  const float* src;
  int dst;
  int count;
  int rows;
  int stride;
  int pad;
};

// An input slot whose rows the warps stage: a task's rows of `width`
// floats at `off` in the warp's input region.
struct DenseInput {
  const float* src;
  int width;
  int off;
};

// A table without sparse ops or mlp heads as the dense interpreter takes
// it: its decoded ops, what the blocks stage, and where the block's shared
// memory holds what.
struct alignas(16) DenseTable {
  int n_ops;
  int n_copies;
  int n_inputs;
  int inputs;        // the warps' input regions, one after another
  int input_floats;  // one warp's input region
  int strips;        // the kmeans row strips, one per row of a warp
  int strip_floats;  // one strip: the widest kmeans input padded to 32 terms a step, + 4
  DenseOp ops[kMaxOps];
  DenseCopy copies[kMaxCopies];
  DenseInput staged[kMaxOps];
};
static_assert(sizeof(DenseTable) <= 4096 - 16, "the table fits the kernel parameters");

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

using sparse_fold::clamp_id;  // an id into a vector of d values, clamped as the JAX package's gather does

// The total of v over a row's kLanes lanes (xor offsets kLanes / 2 ... 1,
// within the row's group), the same bits in each of them.
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// The warp's total of v, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) { return group_sum<kWarp>(v); }

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

// ---------------------------------------------------------------------------
// staging: copies into shared memory that the issuing thread does not wait for
// ---------------------------------------------------------------------------

// count floats from global src to shared dst, thread t of n taking every
// n-th float, as 4-byte copies (16-byte ones, where both ends would allow
// them, took longer on the card to stage a block's model). The caller
// commits and waits.
__device__ __forceinline__ void stage(float* dst, const float* src, int count, int t, int n) {
  for (int j = t; j < count; j += n) cp_async4(dst + j, src + j, 4);
}

// k rows of d floats (global, contiguous) into shared rows of `stride`
// floats, zeros from d to `pad`: warp w of n_warps takes rows w, w + n_warps, ...
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int k, int d, int stride,
                                           int pad, int warp, int n_warps, int lane) {
  for (int c = warp; c < k; c += n_warps) {
    stage(dst + c * stride, src + static_cast<size_t>(c) * d, d, lane, kWarp);
    for (int j = d + lane; j < pad; j += kWarp) dst[c * stride + j] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the closest centroid
// ---------------------------------------------------------------------------

// |c|^2 (euclidean) or |c| (cosine) of each of the k centroids (rows of d
// values, `stride` apart, in global or shared memory) into norms[0, k): warp
// `warp` of `n_warps` takes centroids warp, warp + n_warps, ...; nothing for
// manhattan. Lane l sums the terms j = l, l + 32, ... in order, then the
// warp's butterfly. The caller synchronises the block afterwards.
__device__ __forceinline__ void centroid_norms(const float* centroids, int stride, int k, int d,
                                               int measure, float* norms, int warp, int n_warps,
                                               int lane) {
  if (measure == kManhattan) return;
  for (int c = warp; c < k; c += n_warps) {
    const float* cr = centroids + static_cast<size_t>(c) * stride;
    float acc = 0.0f;
    for (int j = lane; j < d; j += kWarp) {
      const float v = cr[j];
      acc = __fmaf_rn(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) norms[c] = measure == kCosine ? __fsqrt_rn(acc) : acc;
  }
}

// The argmin's order: (a, ia) before (b, ib) when a is NaN and b is not, or
// a < b; on equal values, or two NaNs, the lower index first. A total order
// on distinct indices: the first minimum, a NaN counting as the minimum.
__device__ __forceinline__ bool kmeans_before(float a, int ia, float b, int ib) {
  const bool na = is_nan(a), nb = is_nan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

// One term of partial t: h_j . c_j (fmaf), or manhattan's |h_j - c_j|.
template <bool kL1>
__device__ __forceinline__ float kmeans_term(float acc, float h, float c) {
  return kL1 ? __fadd_rn(acc, fabsf(__fsub_rn(h, c))) : __fmaf_rn(h, c, acc);
}

// One step of the butterfly's tree: partial t += partial t + kOffset, t <
// kOffset. A template step, so that each loop's trip count is a constant
// and the partials stay in registers.
template <int kOffset, int kN>
__device__ __forceinline__ void close_step(float (&acc)[kN]) {
#pragma unroll
  for (int t = 0; t < kOffset; ++t) acc[t] = __fadd_rn(acc[t], acc[t + kOffset]);
}

// The 32 partials closed in the xor butterfly's tree: partial t += partial
// t + 16, then + 8, 4, 2, 1 (the value lane 0 of a 32-lane butterfly ends with).
__device__ __forceinline__ float close32(float (&acc)[kWarp]) {
  close_step<16>(acc);
  close_step<8>(acc);
  close_step<4>(acc);
  close_step<2>(acc);
  close_step<1>(acc);
  return acc[0];
}

// The distance from the closed sum (a dot product, or manhattan's total),
// |h|^2, cosine's |h| and centroid c's norm.
__device__ __forceinline__ float kmeans_distance(float acc, float p2, float pn, const float* norms,
                                                 int c, int measure) {
  if (measure == kEuclidean) {
    const float sq = __fsub_rn(__fadd_rn(p2, norms[c]), __fmul_rn(2.0f, acc));
    return __fsqrt_rn(sq < 0.0f ? 0.0f : sq);  // NaN < 0 is false: NaN stays
  }
  if (measure == kCosine) return __fsub_rn(1.0f, __fdiv_rn(__fdiv_rn(acc, pn), norms[c]));
  return acc;
}

// (best, best_idx) of the row's `lanes` lanes, by kmeans_before: a
// butterfly of (value, index) pairs; the same index in every lane of the row.
__device__ __forceinline__ int group_argmin(float best, int best_idx, int lanes) {
  for (int offset = lanes / 2; offset > 0; offset >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, best, offset);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, offset);
    if (kmeans_before(o, oi, best, best_idx)) {
      best = o;
      best_idx = oi;
    }
  }
  return best_idx;
}

// The closed sum of a row h (shared memory, 16-byte aligned, zeros from d to
// n_s * 32) against centroid row c: staged (`padded`: shared memory, 16-byte
// aligned, zeros from d as h) or global (d values).
template <bool kL1>
__device__ __forceinline__ float strip_dot(const float* h, const float* c, int n_s, int d, bool padded) {
  float acc[kWarp];
#pragma unroll
  for (int t = 0; t < kWarp; ++t) acc[t] = 0.0f;
  if (padded) {
    for (int s = 0; s < n_s; ++s) {
      const float4* h4 = reinterpret_cast<const float4*>(h + s * kWarp);
      const float4* c4 = reinterpret_cast<const float4*>(c + s * kWarp);
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) {
        const float4 hv = h4[q];
        const float4 cv = c4[q];
        acc[4 * q] = kmeans_term<kL1>(acc[4 * q], hv.x, cv.x);
        acc[4 * q + 1] = kmeans_term<kL1>(acc[4 * q + 1], hv.y, cv.y);
        acc[4 * q + 2] = kmeans_term<kL1>(acc[4 * q + 2], hv.z, cv.z);
        acc[4 * q + 3] = kmeans_term<kL1>(acc[4 * q + 3], hv.w, cv.w);
      }
    }
  } else {
    for (int s = 0; s < n_s; ++s) {
#pragma unroll
      for (int t = 0; t < kWarp; ++t) {
        const int j = s * kWarp + t;
        acc[t] = kmeans_term<kL1>(acc[t], h[j], j < d ? __ldg(c + j) : 0.0f);
      }
    }
  }
  return close32(acc);
}

// The index of the closest of the k centroids to the row h of d values in
// the row's strip (shared memory, 16-byte aligned, zeros from d to the next
// multiple of 32), searched by the row's `lanes` lanes: lane i takes
// centroids i, i + lanes, ... The centroids are shared rows `stride` floats
// apart, zero-padded as h (stride != 0), or global [k, d] (stride 0); norms
// the block's; p2 = |h|^2 as the row's lanes summed it. The same value in
// every lane of the row.
__device__ __forceinline__ int kmeans_search(const float* h, float p2, const float* centroids, int stride,
                                             const float* norms, int k, int d, int measure, int i,
                                             int lanes) {
  const int n_s = (d + kWarp - 1) / kWarp;
  const float pn = measure == kCosine ? __fsqrt_rn(p2) : 0.0f;  // cosine's |h|
  float best = __int_as_float(0x7f800000);  // +inf at INT_MAX: after every centroid
  int best_idx = INT_MAX;
  for (int c = i; c < k; c += lanes) {
    const float* cr = stride ? centroids + c * stride : centroids + static_cast<size_t>(c) * d;
    const float acc = measure == kManhattan ? strip_dot<true>(h, cr, n_s, d, stride != 0)
                                            : strip_dot<false>(h, cr, n_s, d, stride != 0);
    const float dist = kmeans_distance(acc, p2, pn, norms, c, measure);
    if (kmeans_before(dist, c, best, best_idx)) {
      best = dist;
      best_idx = c;
    }
  }
  return group_argmin(best, best_idx, lanes);
}

// The index of the closest of the k centroids [k, d] (global memory) to the
// row h that a warp holds in registers (lane l holds h's elements l, l + 32,
// ...; elements at or past d are taken as 0), with the block's centroid
// norms, a centroid after another: the lanes' partial sums of each dot
// product closed by the warp's butterfly, the same bits as kmeans_search's.
// The warp-per-row interpreter runs it (the MLP kernel's prologue: there
// kmeans_search's 32 partials a lane spilled more registers), and the dense
// one at 32 lanes a row, where kmeans_search would keep only k of the row's
// lanes busy. The same value in every lane.
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

// ---------------------------------------------------------------------------
// rows
// ---------------------------------------------------------------------------

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
    const int w = table.slots[op.src].width;
    centroid_norms(op.a, w, op.k, w, op.flags, norms + off, warp, n_warps, lane);
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

// ---------------------------------------------------------------------------
// the warp-per-row interpreter
// ---------------------------------------------------------------------------

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
      logistic_head(table, op, row, lane, warp_sum(acc));
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

// ---------------------------------------------------------------------------
// the dense interpreter
// ---------------------------------------------------------------------------

// The table's ops into the block's shared memory (`ops`, 16-byte aligned):
// warp w copies 64-byte lines w, w + n_warps, ... of them, four lanes a line,
// so that each warp's load touches one line of the kernel's parameters and
// the warps' first reads of them are in flight together. The caller
// synchronises the block afterwards.
__device__ __forceinline__ void decode_ops(const DenseTable& table, DenseOp* ops, int warp, int n_warps,
                                           int lane) {
  const int4* from = reinterpret_cast<const int4*>(table.ops);
  int4* to = reinterpret_cast<int4*>(ops);
  const int words = table.n_ops * static_cast<int>(sizeof(DenseOp) / sizeof(int4));
  if (lane >= 4) return;
  for (int q = 4 * warp + lane; q < words; q += 4 * n_warps) to[q] = from[q];
}

// The table's staged model vectors and centroids into the block's shared
// memory, warp w taking copies w, w + n_warps, ... with its lanes, every
// copy in flight (the caller commits and waits).
__device__ __forceinline__ void stage_vectors(const DenseTable& table, float* smem, int warp, int n_warps,
                                              int lane) {
  for (int e = warp; e < table.n_copies; e += n_warps) {
    const DenseCopy& c = table.copies[e];
    stage_rows(smem + c.dst, c.src, c.rows, c.count, c.stride, c.pad, 0, 1, lane);
  }
}

// The centroid norms of the table's kmeans ops into their place in the
// block's shared memory, from the staged centroids where there are some.
// The caller synchronises the block afterwards.
__device__ __forceinline__ void dense_norms(const DenseOp* ops, int n_ops, float* smem, int warp, int n_warps,
                                            int lane) {
  for (int i = 0; i < n_ops; ++i) {
    const DenseOp& op = ops[i];
    if (op.op != kKmeans) continue;
    centroid_norms(op.c_stride ? smem + op.a_off : op.a, op.c_stride ? op.c_stride : op.w, op.k, op.w,
                   op.flags & kOpFlags, smem + op.b_off, warp, n_warps, lane);
  }
}

// The rows [row0, row0 + kRows) (those below `rows`) of every staged input
// slot into the warp's input region, as raw 32-bit words, every copy in
// flight (the caller commits and waits).
template <int kRows>
__device__ __forceinline__ void stage_inputs(const DenseTable& table, float* region, int row0, int rows,
                                             int lane) {
  const int n = min(kRows, rows - row0);
  for (int e = 0; e < table.n_inputs; ++e) {
    const DenseInput& in = table.staged[e];
    const float* src = in.src + static_cast<size_t>(row0) * in.width;
    for (int j = lane; j < n * in.width; j += kWarp) cp_async4(region + in.off + j, src + j, 4);
  }
}

// Runs every op of a dense table on one row (row g of the warp's kRows = 32
// / kLanes; lane i of its group holds elements i, i + kLanes, ...), reading
// the ops from shared memory and writing every op's output slot. Every lane
// of the warp runs every op, so the groups' shuffles line up; a row at or
// past `rows` (`live` false) reads and writes nothing. `region` is the
// warp's staged input rows, `strip` the row's strip for a kmeans op below 32
// lanes a row (16-byte aligned); kWithKmeans: the table has kmeans ops.
template <int kSlots, int kLanes, bool kWithKmeans>
__device__ __forceinline__ void run_rows(const DenseOp* ops, int n_ops, const float* smem, const float* region,
                                         float* strip, int row, int rows, int g, int i) {
  const bool live = row < rows;
  float v[kSlots];
  const float* cur = nullptr;  // the slot whose row v holds
  for (int n = 0; n < n_ops; ++n) {
    const DenseOp& op = ops[n];
    const int w = op.w;
    const int flags = op.flags;
    if (op.src != cur) {
      const bool i32 = flags & kSrcI32;
      const float* p = op.in_off >= 0 ? region + op.in_off + g * w : op.src + static_cast<size_t>(row) * w;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kLanes + i;
        const float x = j < w && live ? p[j] : 0.0f;
        v[s] = i32 ? __int2float_rn(__float_as_int(x)) : x;
      }
      cur = op.src;
    }
    const float* a = op.a_off >= 0 ? smem + op.a_off : op.a;
    if (op.op == kLogistic) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kLanes + i;
        if (j < w) acc = __fmaf_rn(v[s], a[j], acc);
      }
      const float margin = group_sum<kLanes>(acc);
      if (i == 0 && live) {
        const float p = 1.0f / (1.0f + expf(-margin));
        op.dst[row] = margin >= 0.0f ? 1.0f : 0.0f;
        op.dst2[2 * static_cast<size_t>(row)] = 1.0f - p;
        op.dst2[2 * static_cast<size_t>(row) + 1] = p;
      }
      __syncwarp();  // a later op's lanes read the head's outputs
      continue;  // v still holds the head's input row
    }
    if (kWithKmeans && kLanes == kWarp && op.op == kKmeans) {  // a row a warp: the warp's search
      const int idx = kmeans_assign<kSlots>(v, op.a, smem + op.b_off, op.k, w, flags & kOpFlags, i);
      if (i == 0 && live) reinterpret_cast<int*>(op.dst)[row] = idx;
      __syncwarp();  // the index is seen by its readers
      continue;  // v still holds the head's input row
    }
    if (kWithKmeans && kLanes < kWarp && op.op == kKmeans) {
      const int measure = flags & kOpFlags;
      const int pad = (w + kWarp - 1) / kWarp * kWarp;
      float p2 = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kLanes + i;
        const float x = j < w ? v[s] : 0.0f;
        if (j < pad) strip[j] = x;
        p2 = __fmaf_rn(x, x, p2);
      }
      for (int j = kSlots * kLanes + i; j < pad; j += kLanes) strip[j] = 0.0f;  // the rest of 32
      if (measure != kManhattan) p2 = group_sum<kLanes>(p2);
      __syncwarp();
      const int idx = kmeans_search(strip, p2, a, op.c_stride, smem + op.b_off, op.k, w, measure, i, kLanes);
      if (i == 0 && live) reinterpret_cast<int*>(op.dst)[row] = idx;
      __syncwarp();  // the index is seen by its readers; the strip may be rewritten
      continue;  // v still holds the head's input row
    }
    if (op.op == kNormalize) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kLanes + i;
        if (j < w) acc = __fadd_rn(acc, pow_p(fabsf(v[s]), op.s0));
      }
      const float norm = root_p(group_sum<kLanes>(acc), op.s0, op.s1);
      const float denom = norm == 0.0f ? 1.0f : norm;  // NaN == 0 is false: NaN stays
#pragma unroll
      for (int s = 0; s < kSlots; ++s) v[s] = s * kLanes + i < w ? __fdiv_rn(v[s], denom) : 0.0f;
    } else {
      const float* b = op.b_off >= 0 ? smem + op.b_off : op.b;
      const int opf = flags & kOpFlags;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kLanes + i;
        if (j >= w) continue;
        float x = v[s];
        switch (op.op) {
          case kScale:
            if (opf & kWithMean) x = __fsub_rn(x, a[j]);
            if (opf & kWithStd) x = __fmul_rn(x, b[j]);
            break;
          case kElementwiseProduct:
          case kIdf:
            x = __fmul_rn(x, a[j]);
            break;
          case kBinarize:
            x = x > op.s0 ? 1.0f : 0.0f;
            break;
          case kImpute:
            if ((opf & kMissingNaN) ? is_nan(x) : x == op.s0) x = a[0];
            break;
          default:
            break;
        }
        v[s] = x;
      }
    }
    if (live) {
      const size_t base = static_cast<size_t>(row) * w;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = s * kLanes + i;
        if (j >= w) continue;
        if (flags & kDstI32) {
          reinterpret_cast<int*>(op.dst)[base + j] = __float2int_rz(v[s]);  // binarize's 0 / 1 exactly
        } else {
          op.dst[base + j] = v[s];
        }
      }
    }
    cur = op.dst;
  }
}

// Host side: the current device's SM count and the shared memory a block
// may opt in to, asked once a device.
struct DeviceFacts {
  int sms = 0;
  int smem_optin = 0;
};

inline cudaError_t device_facts(DeviceFacts& facts) {
  static std::mutex mu;
  static std::map<int, DeviceFacts> known;
  int id = 0;
  cudaError_t rc = cudaGetDevice(&id);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(id);
  if (it == known.end()) {
    DeviceFacts f;
    rc = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, id);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&f.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, id);
    if (rc != cudaSuccess) return rc;
    it = known.emplace(id, f).first;
  }
  facts = it->second;
  return cudaSuccess;
}

// Host side: the blocks of `threads` threads and `smem` bytes of dynamic
// shared memory that `kernel` keeps resident on the current device at once
// (at least one an SM), for a persistent grid. Asked once for each kernel,
// device, block size and shared memory; the first ask opts the kernel in to
// all the dynamic shared memory the device allows it when smem and the
// kernel's static shared memory pass 48 KB.
inline cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, long long* blocks) {
  using Key = std::tuple<const void*, int, int, size_t>;
  static std::mutex mu;
  static std::map<Key, long long> known;
  DeviceFacts dev;
  cudaError_t rc = device_facts(dev);
  if (rc != cudaSuccess) return rc;
  int id = 0;
  rc = cudaGetDevice(&id);
  if (rc != cudaSuccess) return rc;
  const Key key{kernel, id, threads, smem};
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    cudaFuncAttributes attr;
    rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc != cudaSuccess) return rc;
    if (smem + attr.sharedSizeBytes > 48 * 1024) {
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dev.smem_optin - static_cast<int>(attr.sharedSizeBytes));
      if (rc != cudaSuccess) return rc;
    }
    int per_sm = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (rc != cudaSuccess) return rc;
    it = known.emplace(key, static_cast<long long>(dev.sms) * (per_sm > 0 ? per_sm : 1)).first;
  }
  *blocks = it->second;
  return cudaSuccess;
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
