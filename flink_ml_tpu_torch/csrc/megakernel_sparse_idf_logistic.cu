// The serving megakernel for the sparse IDF -> LogisticRegression chain.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("sparse_idf", "sparse_logistic"),
// ("sparse_logistic",) and, in its head-less mode (with_head 0: tfidf only,
// no coef read and no margin), ("sparse_idf",). Inputs are one sparse column in the padded layout
// of servable/sparse.py: values [rows, K] f32 and ids [rows, K] i32, padding
// slots id 0 / value 0. Per row r it computes
//   tfidf[r,k] = values[r,k] * idf[ids[r,k]]          (with the IDF stage)
//   margin[r]  = (((0 + t[r,0]*coef[ids[r,0]]) + t[r,1]*coef[ids[r,1]]) + ...)
//                over all K slots in slot order, t = tfidf or, without the
//                IDF stage, values
//   prediction = margin >= 0 ? 1 : 0
//   raw        = [1 - sigmoid(margin), sigmoid(margin)]
// and writes tfidf (when asked), margin, prediction and raw (with the head).
// The ids and the
// row counts pass through untouched: the wrapper hands on its input tensors.
//
// Bound: memory. Per row it reads K values and K ids, writes K tfidf values
// and 16 bytes of heads, and gathers idf and coef at each slot's id: at
// d = 2^22 (16 MB per model vector) those gathers are scattered 32-byte
// sectors, most of them missing L2 on a cold call. About 12 MB at 4096 x 64,
// some 3.6 us at the H100's 3.35 TB/s; the arithmetic (two multiplies and an
// add per slot) is negligible. So the kernel's time is the latency of its
// gathers: it keeps as many of them in flight as it can.
//
// Design: a block is one warp and takes a tile of R consecutive rows
// (R * kc <= kTileSlots slots, kc = min(K, kTileSlots) slots a row, R <= 32).
// The tile's values and ids are one contiguous range of the [rows, K]
// arrays, whatever K is: R whole rows when kc == K, else one row's chunk of
// kc slots (R == 1). Lane l takes the range's 16-byte groups ("quads",
// counted from the group holding its first slot) l and l + 32 (l alone
// where 32 quads hold the tile: the kernel's one-quad instance), so loads
// and the tfidf store are coalesced 16-byte accesses at every cap, and a cap
// of 1, 2 or 8 slots idles no lane. A lane loads its quads' values and ids,
// then issues every idf and coef gather of them (8 a quad) before it uses
// any: up to 16 gathers a lane in flight with the head, 8 without. It
// writes tf-idf out and each product into the warp's shared-memory tile
// [R][stride], at the slot's row and column; then lane r folds row r's
// products from shared memory, in slot order (sparse_fold.cuh), and writes
// its row's head, so the heads' stores coalesce too. A K past one tile is
// walked in chunks of kc slots, the row's running sum carried in the
// folding lane's register. The head-less mode runs the same tiles with no
// shared memory and no fold: a streaming gather-multiply. The modes and a
// lane's quads are template arguments, so no lane tests them at run time.
//
// Grid: one warp a tile, no block barrier. R is kTileSlots / kc rows (at
// most 32), cut so that a batch of few rows still gives each SM
// kSpreadTiles tiles: at 4096 x 64 R is 3 (1,366 tiles, 10.3 an SM, all
// resident at once: an SM holds 32 one-warp blocks); at 1024 x 16 R is 4
// (256 tiles of one quad a lane); at 203 x 8 R is 1 (203 tiles).
//
// Numerics: the products use __fmul_rn and the sum __fadd_rn, which the
// compiler never contracts into an FMA, so tfidf and margin are bit-equal to
// the plain PyTorch version; all K slots are added, padding included, and
// no slot beyond K. The sigmoid is 1 / (1 + expf(-m)), the formula of
// torch.sigmoid and of megakernel_scale_logistic.cu. An id outside [0, d) is
// clamped as the JAX package's gather does (sparse_fold::clamp_id). No
// fast-math flags.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sparse_fold.cuh"

namespace {

using sparse_fold::clamp_id;

constexpr int kWarp = 32;      // a block: one warp, one tile
constexpr int kMaxQuads = 2;   // 16-byte groups a lane takes a tile, at most
// A tile's slots: kWarp * kMaxQuads quads cover this many at any alignment.
constexpr int kTileSlots = kWarp * kMaxQuads * 4 - 3;
constexpr int kSpreadTiles = 2;  // tiles an SM aimed at when a batch has few rows

// The shared-memory row stride of a tile of kc-slot rows: kc rounded up to
// whole 16-byte words, an odd count of them, so that the folding lanes'
// 16-byte loads at one column of eight consecutive rows hit eight distinct
// bank groups.
__host__ __device__ inline int tile_stride(int kc) {
  int s = (kc + 3) & ~3;
  if ((s / 4) % 2 == 0) s += 4;
  return s;
}

template <bool kIdf, bool kHead, int kQuads>  // kQuads: 16-byte groups a lane takes, 1 or kMaxQuads
__global__ void __launch_bounds__(kWarp)
sparse_idf_logistic_kernel(const float* __restrict__ values, const int* __restrict__ ids,
                           const float* __restrict__ idf, const float* __restrict__ coef,
                           float* __restrict__ tfidf, float* __restrict__ margin,
                           float* __restrict__ prediction, float* __restrict__ raw, int rows, int K,
                           int kc, int R, int d, bool write_tfidf, bool vec) {
  extern __shared__ __align__(16) float prod[];  // [R][stride]: the tile's products
  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = rows - row0 < R ? static_cast<int>(rows - row0) : R;  // the tile's rows
  const int stride = tile_stride(kc);
  float acc = 0.0f;  // lane r < nr: row row0 + r's sum of the chunks folded so far
  for (int c0 = 0; c0 < K; c0 += kc) {  // one pass unless K > kc (then nr == 1)
    const int w = K - c0 < kc ? K - c0 : kc;  // this chunk's slots a row
    const long long g0 = row0 * K + c0;       // the tile's first slot in the arrays
    const int lead = static_cast<int>(g0 & 3);  // slots of its quad before it
    const int end = lead + nr * w;              // the tile spans [lead, end) from that quad
    const long long base = g0 - lead;           // 16-byte aligned where the arrays are
    const float* const vq = values + base;
    const int* const iq = ids + base;
    float v[kQuads][4], a[kQuads][4], b[kQuads][4];
    int id[kQuads][4];
    // the quads' values and ids: one 16-byte load each where the quad lies
    // inside the tile and the arrays are 16-byte aligned
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int f = 4 * (lane + kWarp * u);
      if (vec && f >= lead && f + 4 <= end) {
        const float4 vv = __ldg(reinterpret_cast<const float4*>(vq + f));
        const int4 ii = __ldg(reinterpret_cast<const int4*>(iq + f));
        v[u][0] = vv.x, v[u][1] = vv.y, v[u][2] = vv.z, v[u][3] = vv.w;
        id[u][0] = ii.x, id[u][1] = ii.y, id[u][2] = ii.z, id[u][3] = ii.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = f + j >= lead && f + j < end;
          v[u][j] = in ? __ldg(vq + f + j) : 0.0f;
          id[u][j] = in ? __ldg(iq + f + j) : 0;
        }
      }
    }
    // every gather of the lane's slots, before any is used
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 4 * (lane + kWarp * u) + j;
        const bool in = f >= lead && f < end;
        const int i = clamp_id(id[u][j], d);
        if (kIdf) a[u][j] = in ? __ldg(idf + i) : 0.0f;
        if (kHead) b[u][j] = in ? __ldg(coef + i) : 0.0f;
      }
    }
    // tf-idf out; each product into the tile at its row and column
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int f = 4 * (lane + kWarp * u);
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = kIdf ? __fmul_rn(v[u][j], a[u][j]) : v[u][j];
      if (kIdf && write_tfidf) {
        float* const tq = tfidf + base;
        if (vec && f >= lead && f + 4 <= end) {
          *reinterpret_cast<float4*>(tq + f) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (f + j >= lead && f + j < end) tq[f + j] = x[j];
          }
        }
      }
      if (kHead) {
        // the quad's first slot at row r, column c of the tile (c < 0: before
        // the tile, lane 0's quad 0 only), then one column a slot
        const int i = f - lead;
        int r = i > 0 ? i / w : 0;
        int c = i - r * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c >= 0 && f + j < end) prod[r * stride + c] = __fmul_rn(x[j], b[u][j]);
          if (++c == w) c = 0, ++r;
        }
      }
    }
    if (kHead) {
      __syncwarp();
      if (lane < nr) acc = sparse_fold::fold(prod + lane * stride, w, acc);
      __syncwarp();  // the next chunk rewrites the tile
    }
  }
  if (kHead && lane < nr) {
    const long long row = row0 + lane;
    const float p = 1.0f / (1.0f + expf(-acc));
    margin[row] = acc;
    prediction[row] = acc >= 0.0f ? 1.0f : 0.0f;
    raw[2 * row] = 1.0f - p;
    raw[2 * row + 1] = p;
  }
}

using Kernel = void (*)(const float*, const int*, const float*, const float*, float*, float*, float*,
                        float*, int, int, int, int, int, bool, bool);

// The kernel's instance for the modes and a lane's quads.
template <bool kIdf, bool kHead>
Kernel instance(int quads) {
  return quads == 1 ? sparse_idf_logistic_kernel<kIdf, kHead, 1> : sparse_idf_logistic_kernel<kIdf, kHead, kMaxQuads>;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head-less launch that would write nothing.
// idf may be null when with_idf is 0; tfidf may be null when write_tfidf is
// 0; coef, margin, prediction and raw may be null when with_head is 0.
// rows == 0 launches nothing.
int megakernel_sparse_idf_logistic(const void* values, const void* ids, const void* idf,
                                   const void* coef, void* tfidf, void* margin,
                                   void* prediction, void* raw, int rows, int K, int d,
                                   int with_idf, int write_tfidf, int with_head, void* stream) {
  if (!with_head && !(with_idf && write_tfidf)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && K > 0) {
    int device = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const int kc = K < kTileSlots ? K : kTileSlots;
    int R = kTileSlots / kc;
    if (R > kWarp) R = kWarp;
    const long long spread = (static_cast<long long>(rows) + kSpreadTiles * sms - 1) / (kSpreadTiles * sms);
    if (spread < R) R = static_cast<int>(spread);
    const bool tfidf_aligned = !(with_idf && write_tfidf) || reinterpret_cast<uintptr_t>(tfidf) % 16 == 0;
    const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                     tfidf_aligned;
    const size_t smem = with_head ? sizeof(float) * static_cast<size_t>(R) * tile_stride(kc) : 0;
    const dim3 grid(static_cast<unsigned>((rows + R - 1) / R));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int quads = R * kc <= 4 * kWarp - 3 ? 1 : kMaxQuads;  // kWarp quads hold it at any alignment
    const Kernel kernel = with_head ? (with_idf ? instance<true, true>(quads) : instance<false, true>(quads))
                                    : instance<true, false>(quads);
    kernel<<<grid, kWarp, smem, s>>>(
        static_cast<const float*>(values), static_cast<const int*>(ids),
        static_cast<const float*>(idf), static_cast<const float*>(coef),
        static_cast<float*>(tfidf), static_cast<float*>(margin),
        static_cast<float*>(prediction), static_cast<float*>(raw), rows, K, kc, R, d, write_tfidf != 0, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
