// The serving megakernel for the StandardScaler -> LogisticRegression chain.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("scale", "logistic") and
// ("logistic",). Per row it computes
//   scaled     = (x - mean) * inv_std      (each step only if its flag is set)
//   margin     = scaled . coef
//   prediction = margin >= 0 ? 1 : 0
//   raw        = [1 - sigmoid(margin), sigmoid(margin)]
// and writes scaled (when the chain has the scale stage), prediction and raw.
// All float32.
//
// Bound: memory. Per row it reads d floats of x and writes d floats of scaled
// plus 12 bytes of heads; the model (3 vectors of d) is read once. At 4096 x
// 100 that is 3,327,152 B, 0.99 us at the H100's 3.35 TB/s, against about 1.7
// MFLOP of arithmetic.
//
// Design: a row is cut into groups, 16 bytes each (float4) on the 16-byte
// path (d % 4 == 0 and x, scaled, mean, inv_std and coef, those in use,
// 16-byte aligned, as the entry point finds them) or one float each on the
// scalar path (any other d or alignment). A row gets L lanes, the next power of two at or
// above its groups, at most 32; 32 / L rows sit side by side in a warp (row
// group g = lane / L), and lane i of a row group owns the row's groups i,
// i + L, ... (kSlots of them). So at d 100 a warp takes one row on 32 lanes,
// 25 of them loading one float4; at d 8, 16 rows on 2 lanes each.
//   The model in registers: up to kModelFloats floats of each model vector a
// lane (d <= 512 on either path), a lane loads its columns of mean, inv_std
// and coef once and keeps them for every row it walks. A wider row (the wide
// path) is walked in chunks of kModelFloats floats a lane and reads the model
// through L1 for each chunk. No shared memory, no block barrier.
//   Rows in flight: a persistent grid of kWarps-warp blocks, at most as many
// as the card keeps resident, whose warps walk tasks: task t is rows t P R ...
// t P R + P R - 1 (P = 32 / L rows side by side, R rows a row group; row
// t P R + r P + g is row group g's r-th), tasks strided over the grid's
// warps. A warp loads its first task's rows and its model columns at once,
// then, for each task, scales the rows it holds and stores scaled, issues the
// loads of its next task into the same registers, and only then closes the
// margins. R is the fewest rows, at most kDepth (R kSlots floats of x a lane
// fit kRowFloats, and P R <= 32), that need no more than one block an SM;
// past kDepth the grid grows to the blocks the card keeps resident, and past
// those the walk takes more tasks a warp. So at 4096 x 100, R = 4: 1,024
// warps in 128 blocks hold all of x's 1.6 MB (12.4 KB an SM) in one round of
// loads and read the model 1,024 times, not 4,096; R = 1 on every resident
// warp ran 5% slower warm there (tools/logistic_variants.py, "fill").
//   Heads written together: after the margins close, lane k < P R takes row
// t P R + k (its margin shuffled from row group k % P), so prediction is
// written as consecutive floats and raw as one float2 a row, by consecutive
// lanes. No intermediate goes through memory.
//
// Numerics: the subtract and multiply use __fsub_rn / __fmul_rn, which the
// compiler never contracts into an FMA, so scaled is bit-identical to the
// plain PyTorch version ((x - mean) * inv_std). The margin's order: each lane
// folds its groups i, i + L, i + 2L, ... in increasing order, each group's
// floats in order, by __fmaf_rn from 0; then an xor butterfly over the row's
// L lanes (offsets L / 2 ... 1, rowlocal_ops.cuh group_sum), the same bits in
// every lane. That is another order than a GEMV's, and the sigmoid uses the
// same formula as torch.sigmoid (1 / (1 + expf(-m))); both stay inside the
// fast tier's ulp envelope. No fast-math flags.
#include "rowlocal_ops.cuh"

namespace {

using rowlocal::kWarp;

constexpr int kWarps = 8;         // a block's warps
constexpr int kModelFloats = 16;  // a lane's floats of each model vector in registers: d <= 32 x 16
constexpr int kRowFloats = 16;    // a lane's floats of x in flight for one task

// R's ceiling: a task's rows fit a lane's kRowFloats and one 32-lane round of heads.
__host__ __device__ constexpr int depth_for(int vec, int lanes, int slots, bool held) {
  return !held ? 1 : (kRowFloats / (slots * vec) < lanes ? kRowFloats / (slots * vec) : lanes);
}

struct Args {
  const float* x;
  const float* mean;
  const float* inv_std;
  const float* coef;
  float* scaled;
  float* prediction;
  float* raw;
  int rows;
  int d;
  int groups;  // d / kVec
  int depth;   // R
  int with_mean;
  int with_std;
  int write_scaled;
};

template <int kVec>
__device__ __forceinline__ void load_group(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_group(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// One group of a row: scaled into v (stored when the chain keeps it), folded
// into acc.
template <int kVec>
__device__ __forceinline__ float scale_fold(const Args& a, float (&v)[kVec], const float (&m)[kVec],
                                            const float (&s)[kVec], const float (&c)[kVec], float* out,
                                            float acc) {
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    if (a.with_mean) v[q] = __fsub_rn(v[q], m[q]);
    if (a.with_std) v[q] = __fmul_rn(v[q], s[q]);
    acc = __fmaf_rn(v[q], c[q], acc);
  }
  if (a.write_scaled) store_group<kVec>(out, v);
  return acc;
}

// A task's rows of x into a lane's registers (zeros past the row's groups and
// past the batch).
template <int kVec, int kLanes, int kSlots, int kDepth>
__device__ __forceinline__ void load_task(const Args& a, float (&xv)[kDepth][kSlots][kVec], int row0,
                                          int g, int i) {
  constexpr int kPer = kWarp / kLanes;
#pragma unroll
  for (int r = 0; r < kDepth; ++r) {
    if (r >= a.depth) break;
    const int row = row0 + r * kPer + g;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int group = s * kLanes + i;
      if (row < a.rows && group < a.groups) {
        load_group<kVec>(a.x + static_cast<size_t>(row) * a.d + group * kVec, xv[r][s]);
      } else {
#pragma unroll
        for (int q = 0; q < kVec; ++q) xv[r][s][q] = 0.0f;
      }
    }
  }
}

// The model's groups of a lane (zeros past the row's groups or without the flag).
template <int kVec, int kSlots>
__device__ __forceinline__ void load_model(const float* p, bool on, int groups, int base, int lanes, int i,
                                           float (&v)[kSlots][kVec]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int group = base + s * lanes + i;
    if (on && group < groups) {
      load_group<kVec>(p + group * kVec, v[s]);
    } else {
#pragma unroll
      for (int q = 0; q < kVec; ++q) v[s][q] = 0.0f;
    }
  }
}

template <int kVec, int kLanes, int kSlots, bool kHeld>
__global__ void __launch_bounds__(kWarp * kWarps) scale_logistic_kernel(const Args a) {
  static_assert(kHeld || kLanes == kWarp, "a wide row takes the whole warp");
  constexpr int kPer = kWarp / kLanes;
  constexpr int kDepth = depth_for(kVec, kLanes, kSlots, kHeld);
  const int lane = threadIdx.x % kWarp;
  const int g = lane / kLanes, i = lane % kLanes;
  const int task_rows = kPer * a.depth;
  const int n_tasks = (a.rows + task_rows - 1) / task_rows;
  const int step = gridDim.x * kWarps;
  int task = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (task >= n_tasks) return;  // uniform across the warp

  float xv[kDepth][kSlots][kVec];
  float mv[kSlots][kVec], sv[kSlots][kVec], cv[kSlots][kVec];
  if (kHeld) {
    load_task<kVec, kLanes, kSlots, kDepth>(a, xv, task * task_rows, g, i);
    load_model<kVec, kSlots>(a.mean, a.with_mean, a.groups, 0, kLanes, i, mv);
    load_model<kVec, kSlots>(a.inv_std, a.with_std, a.groups, 0, kLanes, i, sv);
    load_model<kVec, kSlots>(a.coef, true, a.groups, 0, kLanes, i, cv);
  }

  for (; task < n_tasks; task += step) {  // uniform across the warp
    const int row0 = task * task_rows;
    float m[kDepth];
#pragma unroll
    for (int r = 0; r < kDepth; ++r) m[r] = 0.0f;
    if (kHeld) {
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {
        if (r >= a.depth) break;
        const int row = row0 + r * kPer + g;
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int group = s * kLanes + i;
          if (row < a.rows && group < a.groups) {
            acc = scale_fold<kVec>(a, xv[r][s], mv[s], sv[s], cv[s],
                                   a.scaled + static_cast<size_t>(row) * a.d + group * kVec, acc);
          }
        }
        m[r] = acc;
      }
      // the next task's rows in flight while this one's margins close
      if (task + step < n_tasks) load_task<kVec, kLanes, kSlots, kDepth>(a, xv, (task + step) * task_rows, g, i);
    } else {  // the wide path: R == 1 and L == 32, so the task is one row; in chunks of kSlots groups a lane
      const float* xr = a.x + static_cast<size_t>(row0) * a.d;
      float* sr = a.scaled + static_cast<size_t>(row0) * a.d;
      float acc = 0.0f;
      for (int base = 0; base < a.groups; base += kSlots * kLanes) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int group = base + s * kLanes + i;
          if (group < a.groups) load_group<kVec>(xr + group * kVec, xv[0][s]);
        }
        load_model<kVec, kSlots>(a.mean, a.with_mean, a.groups, base, kLanes, i, mv);
        load_model<kVec, kSlots>(a.inv_std, a.with_std, a.groups, base, kLanes, i, sv);
        load_model<kVec, kSlots>(a.coef, true, a.groups, base, kLanes, i, cv);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int group = base + s * kLanes + i;
          if (group < a.groups) acc = scale_fold<kVec>(a, xv[0][s], mv[s], sv[s], cv[s], sr + group * kVec, acc);
        }
      }
      m[0] = acc;
    }

#pragma unroll
    for (int r = 0; r < kDepth; ++r) m[r] = rowlocal::group_sum<kLanes>(m[r]);
    // lane k takes row row0 + k: row group k % P's r-th row, r = k / P
    float margin = 0.0f;
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      const float t = __shfl_sync(0xffffffffu, m[r], (lane % kPer) * kLanes);
      if (lane / kPer == r) margin = t;
    }
    const int row = row0 + lane;
    if (lane < task_rows && row < a.rows) {
      const float p = 1.0f / (1.0f + expf(-margin));
      a.prediction[row] = margin >= 0.0f ? 1.0f : 0.0f;
      reinterpret_cast<float2*>(a.raw)[row] = make_float2(1.0f - p, p);
    }
  }
}

template <int kVec, int kLanes, int kSlots, bool kHeld>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int kPer = kWarp / kLanes;
  constexpr int kDepth = depth_for(kVec, kLanes, kSlots, kHeld);
  constexpr int kThreads = kWarp * kWarps;
  auto kernel = scale_logistic_kernel<kVec, kLanes, kSlots, kHeld>;
  long long resident = 0;
  cudaError_t rc = rowlocal::resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, 0, &resident);
  if (rc != cudaSuccess) return rc;
  rowlocal::DeviceFacts dev;
  rc = rowlocal::device_facts(dev);
  if (rc != cudaSuccess) return rc;
  const long long per_round = static_cast<long long>(kPer) * dev.sms * kWarps;  // a block an SM at R = 1
  const long long depth = (a.rows + per_round - 1) / per_round;
  a.depth = static_cast<int>(depth < kDepth ? depth : kDepth);
  const long long task_rows = static_cast<long long>(kPer) * a.depth;
  const long long tasks = (a.rows + task_rows - 1) / task_rows;
  const long long wanted = (tasks + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(wanted < resident ? wanted : resident));
  kernel<<<grid, kThreads, 0, stream>>>(a);
  return cudaSuccess;
}

template <int kVec>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const int groups = a.groups;
  if (groups <= 1) return launch<kVec, 1, 1, true>(a, s);
  if (groups <= 2) return launch<kVec, 2, 1, true>(a, s);
  if (groups <= 4) return launch<kVec, 4, 1, true>(a, s);
  if (groups <= 8) return launch<kVec, 8, 1, true>(a, s);
  if (groups <= 16) return launch<kVec, 16, 1, true>(a, s);
  if (groups <= kWarp) return launch<kVec, 32, 1, true>(a, s);
  if (groups <= 2 * kWarp) return launch<kVec, 32, 2, true>(a, s);
  if (groups <= 4 * kWarp) return launch<kVec, 32, 4, true>(a, s);
  if constexpr (kVec == 1) {
    if (groups <= 8 * kWarp) return launch<kVec, 32, 8, true>(a, s);
    if (groups <= 16 * kWarp) return launch<kVec, 32, 16, true>(a, s);
  }
  return launch<kVec, 32, kModelFloats / kVec, false>(a, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for d < 1 or rows < 0. The 16-byte path runs when d
// is a multiple of 4 and x, scaled, mean, inv_std and coef (those in use) are
// 16-byte aligned, the scalar path otherwise. mean and inv_std may be null
// when their flag is off; scaled may be null when write_scaled is 0; raw must
// be 8-byte aligned. rows == 0 launches nothing.
int megakernel_scale_logistic(const void* x, const void* mean, const void* inv_std,
                              const void* coef, void* scaled, void* prediction,
                              void* raw, int rows, int d, int with_mean, int with_std,
                              int write_scaled, void* stream) {
  if (d < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(coef) && (!with_mean || aligned16(mean)) &&
                   (!with_std || aligned16(inv_std)) && (!write_scaled || aligned16(scaled));
  if (rows > 0) {
    Args a{static_cast<const float*>(x), static_cast<const float*>(mean),
           static_cast<const float*>(inv_std), static_cast<const float*>(coef),
           static_cast<float*>(scaled), static_cast<float*>(prediction), static_cast<float*>(raw),
           rows, d, vec ? d / 4 : d, 1, with_mean, with_std, write_scaled};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t rc = vec ? dispatch<4>(a, s) : dispatch<1>(a, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
