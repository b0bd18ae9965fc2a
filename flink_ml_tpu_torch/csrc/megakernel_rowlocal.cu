// The serving megakernel for any chain of the row-local feature ops,
// optionally ending in the dense logistic head.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for every chain over scale, normalize,
// elementwise_product, idf, binarize and impute, with or without a closing
// logistic head. The Pallas kernel traces the chain's Python bodies; a CUDA
// kernel cannot, so this one is built once and composes the chain at launch
// from a small op table, as build_megakernel_fn composes it at trace time.
// Per row, entry by entry, it computes (each op on the row of its input slot)
//   scale                (x - mean) * inv_std   (each step only if its flag is set)
//   normalize            x / (n == 0 ? 1 : n),  n = (sum |x|^p)^(1/p)
//   elementwise_product  x * scaling
//   idf                  x * idf
//   binarize             x > threshold ? 1 : 0  (NaN gives 0)
//   impute               missing(x) ? surrogate : x, missing = isnan(x) or x == placeholder
//   logistic             margin = x . coef, prediction = margin >= 0,
//                        raw = [1 - sigmoid(margin), sigmoid(margin)]
// and writes every op's output slot, once per row, as the JAX body writes
// every declared output. All float32.
//
// Bound: memory. Per row it reads its input columns once and writes every
// output once; the model vectors are read by every row but stay in L1/L2.
// feature6 -> logistic at 4096 x 100 moves 11,520,352 B, 3.44 us at the
// H100's 3.35 TB/s, against about 6 MFLOP.
//
// Design: one warp per row, kRowsPerBlock rows per block, the grid capped at
// kMaxBlocks blocks that stride over the rows. The table (ops and slots)
// is a __grid_constant__ kernel parameter, so every warp reads the same entry
// from the constant bank and the switch per entry never diverges. A slot is
// an external input column or an op's output, with its width (a scalar
// column is width 1); lane l holds elements l, l + 32, ... of the current row
// in registers (kSlots of them, a template argument chosen from the widest
// slot). While an op reads the slot the previous op wrote, the row stays in
// registers; an op that reads any other slot loads that slot's row (an
// input, or an output this same lane wrote earlier, still in L1/L2). Slots
// use plain loads, not __ldg: the kernel writes some of them. Normalize's
// norm is one xor butterfly of __shfl_xor_sync; the head is the warp dot and
// head of megakernel_scale_logistic.cu.
//
// Numerics: every elementwise op uses the _rn intrinsics, which the compiler
// never contracts into an FMA, so each output of a chain without normalize
// and before the head is bit-identical to the plain PyTorch version.
// Normalize mirrors torch.pow on CUDA, which special-cases the exponent:
// p = 1 is |x| itself, p = 2 is |x| * |x|, p = 3 is (|x| * |x|) * |x|, other p
// are powf; the root is the sum itself for p = 1, sqrtf for p = 2 (torch takes
// ** 0.5 as sqrt), powf(sum, 1/p) otherwise; then one correctly rounded
// divide. The row sum runs in another order than torch.sum's, so outputs
// from a normalize on are held to the fast tier's feature6 envelope. The
// sigmoid is torch.sigmoid's formula 1 / (1 + expf(-m)). No fast-math flags.
//
// Limits, mirrored by servable/megakernels.py: every slot 1 <= width <=
// kMaxDim (a lane's registers), at most kMaxOps ops and kMaxSlots slots (the
// table fits the 4 KB of kernel parameters).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMaxDim = 1024;
constexpr int kMaxOps = 32;
constexpr int kMaxSlots = 64;
constexpr int kMaxBlocks = 132 * 8;  // a few waves of the H100's 132 SMs; blocks stride beyond
static_assert(kMaxDim == 32 * kWarp, "the widest slot count, 32, covers kMaxDim");

enum OpCode {
  kScale = 0,
  kNormalize = 1,
  kElementwiseProduct = 2,
  kIdf = 3,
  kBinarize = 4,
  kImpute = 5,
  kLogistic = 6,
};

enum Flags {
  kWithMean = 1,     // scale
  kWithStd = 2,      // scale
  kMissingNaN = 1,   // impute
};

// One op of the chain. Mirrors servable/megakernels.py _Op (ctypes).
struct Op {
  int op;       // OpCode
  int src;      // the slot read
  int dst;      // the slot written (logistic: prediction)
  int dst2;     // logistic: rawPrediction; else unused
  int flags;    // Flags
  float s0;     // normalize p; binarize threshold; impute placeholder
  float s1;     // normalize 1/p
  int pad;
  const float* a;  // scale mean; the product's scaling; idf; impute's surrogate (one value); coef
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
static_assert(sizeof(Table) <= 4096, "the table must fit the kernel parameter space");

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

template <int kSlots>
__global__ void __launch_bounds__(kThreads)
rowlocal_kernel(const __grid_constant__ Table table, int rows) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;
       row += gridDim.x * kRowsPerBlock) {  // row is uniform across the warp
    float v[kSlots];
    int cur = -1;  // the slot whose row v holds
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
        for (int s = 0; s < kSlots; ++s) v[s] = __fdiv_rn(v[s], denom);
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
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for the table of n_ops ops over n_slots
// slots (host arrays, copied into the kernel's parameters) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a table past the limits
// or a slot width outside 1..kMaxDim. rows == 0 launches nothing.
int megakernel_rowlocal(const void* ops, int n_ops, const void* slots, int n_slots, int rows,
                        void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || n_slots < 1 || n_slots > kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  std::memset(&table, 0, sizeof(table));
  table.n_ops = n_ops;
  table.n_slots = n_slots;
  std::memcpy(table.ops, ops, sizeof(Op) * n_ops);
  std::memcpy(table.slots, slots, sizeof(Slot) * n_slots);
  int widest = 1;
  for (int i = 0; i < n_slots; ++i) {
    if (table.slots[i].width < 1 || table.slots[i].width > kMaxDim) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (table.slots[i].width > widest) widest = table.slots[i].width;
  }
  for (int i = 0; i < n_ops; ++i) {
    const Op& op = table.ops[i];
    if (op.op < kScale || op.op > kLogistic || op.src < 0 || op.src >= n_slots || op.dst < 0 ||
        op.dst >= n_slots || (op.op == kLogistic && (op.dst2 < 0 || op.dst2 >= n_slots))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rows > 0) {
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (widest <= kWarp) {
      rowlocal_kernel<1><<<grid, kThreads, 0, s>>>(table, rows);
    } else if (widest <= 2 * kWarp) {
      rowlocal_kernel<2><<<grid, kThreads, 0, s>>>(table, rows);
    } else if (widest <= 4 * kWarp) {
      rowlocal_kernel<4><<<grid, kThreads, 0, s>>>(table, rows);
    } else if (widest <= 8 * kWarp) {
      rowlocal_kernel<8><<<grid, kThreads, 0, s>>>(table, rows);
    } else if (widest <= 16 * kWarp) {
      rowlocal_kernel<16><<<grid, kThreads, 0, s>>>(table, rows);
    } else {
      rowlocal_kernel<32><<<grid, kThreads, 0, s>>>(table, rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
