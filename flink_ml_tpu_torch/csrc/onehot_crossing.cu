// The four row crossings of one-hot sparse SGD (flink_ml_tpu_torch/linalg/
// onehot_sparse.py). Each sub-batch s has a row space of row_hi * 128 rows;
// entry e of the sub-batch belongs to row r = h * 128 + l.
//
// Replaces, in flink_ml_tpu/linalg/onehot_sparse.py:
//   onehot_dot_crossing          dot_crossing_pallas          (pallas_call :542)
//   onehot_mult_crossing         mult_crossing_pallas         (pallas_call :595)
//   onehot_dot_crossing_premat   dot_crossing_premat_pallas   (pallas_call :750)
//   onehot_mult_crossing_premat  mult_crossing_premat_pallas  (pallas_call :799)
//
// The TPU kernels build (or stream) row one-hots and run split-bf16 MXU
// matmuls: dot3[s,h,l] = sum_e oh_hi[e,h] * bf16(oh_lo[e,l] * q_half[e]) over
// the halves q_hi = bf16(q), q_lo = bf16(q - q_hi), in f32; and
// u[s,e] = sum_l oh_lo[e,l] * (oh_hi[e] . m_hi + oh_hi[e] . m_lo)[l].
// These kernels compute the same functions. Values are f32, one-hots bf16
// (read as raw 16-bit words: bf16 -> f32 is a 16-bit shift).
//
// Determinism (no atomics anywhere) and the identity of the two forms:
// both dot kernels sum each output's terms in ascending entry order within
// fixed chunks of `chunk` entries, one f32 accumulator per half, the halves
// added at the chunk's end (as the Pallas kernel adds its two matmuls per
// tile), and the chunk sums in ascending chunk order from 0. The build form
// walks a row-sorted entry list (row_ptr / entry_of, built once per layout);
// the premat form walks the one-hots and skips zero terms, which would add
// only +-0 to a sum that is never -0. So the two give the same bits. Every
// add and multiply is an explicit __fadd_rn / __fmul_rn: nothing is
// contracted into an FMA, and products of two bf16 values are exact in f32.
//
// Bounds on the H100 at the headline unit shape (n_sub 4, row_hi 128,
// ~1.1 M entries per sub-batch):
// - build-form dot: bytes. q (4 B) + entry_of (4 B) per live entry and the
//   1 MB row_ptr / 256 KB output: ~26 MB, ~8 us at 3.35 TB/s. One thread per
//   output row walks its ~39 entries, so no entry is read twice.
// - build-form mult: bytes. rowid (2 B) in, u (4 B) out per entry, mult3
//   (256 KB) from L2: ~26 MB. One thread per entry.
// - premat dot: bytes. q at every slot and the one-hot rows of live entries,
//   (row_hi + 128) * 2 B each (padding slots carry q = 0 and add nothing):
//   ~1.3 GB, ~0.40 ms. This kernel streams every slot's rows, ~2.2 GB, and
//   skips only the padding's arithmetic. One block per (sub-batch, chunk)
//   keeps the chunk's 2 x row_hi x 128 f32 accumulators in shared memory
//   (128 KB at row_hi
//   128); 256 threads own one (half, l) column each, so every output is
//   updated by one thread in entry order. Tiles of kTile entries are staged
//   in shared memory with 16-byte loads (the next tile's loads in flight
//   while the current one is summed). As the words are stored, each oh_lo
//   column gets the bit mask of its nonzero entries, so a thread visits
//   only its own entries, in order, and a one-hot entry costs one update;
//   entries with q = 0 (the layout's padding slots, which all sit on row 0)
//   cost nothing. A second small kernel adds the chunk partials in order.
//   The one-hots are read once.
// - premat mult: bytes, the same ~2.2 GB. One warp per entry reads the
//   entry's two one-hot rows with coalesced loads; for each nonzero oh_lo
//   column the warp sums oh_hi against mult3's column (from L2) and reduces
//   with shuffles. With one-hot rows every sum has one nonzero term, so u is
//   float(bf16(m)) + float(bf16(m - bf16(m))) exactly, as in the build form.
// The premat kernels take the whole [n_win, n_sub, n_pad, w] stacks and the
// window index wi and offset their pointers: no window is copied.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRowLo = 128;
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kTile = 64;     // entries staged in shared memory at a time (premat dot)
constexpr int kHGroup = 128;  // row_hi rows per premat-dot block (accumulators <= 128 KB)
// 16-byte one-hot words each thread stages per tile: kTile rows of 128
// oh_lo columns (and at most kHGroup oh_hi columns) over kThreads threads.
constexpr int kWordsPerThread = kTile * (kRowLo / 8) / kThreads;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_word(uint16_t w) {
  return __uint_as_float(static_cast<uint32_t>(w) << 16);
}

// ---------------------------------------------------------------------------
// Build-form dot: one thread per (s, row).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
dot_crossing_kernel(const float* __restrict__ q, const int* __restrict__ row_ptr,
                    const int* __restrict__ entry_of, float* __restrict__ out,
                    int n_sub, int n, int rows, int chunk) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(n_sub) * rows) return;
  const int s = static_cast<int>(t / rows);
  const int r = static_cast<int>(t % rows);
  const int* rp = row_ptr + static_cast<size_t>(s) * (rows + 1);
  const int* eo = entry_of + static_cast<size_t>(s) * n;
  const float* qs = q + static_cast<size_t>(s) * n;
  float total = 0.0f, acc_hi = 0.0f, acc_lo = 0.0f;
  int cur = -1;
  const int end = rp[r + 1];
  for (int k = rp[r]; k < end; ++k) {
    const int e = eo[k];
    const int c = e / chunk;
    if (c != cur) {
      if (cur >= 0) total = __fadd_rn(total, __fadd_rn(acc_hi, acc_lo));
      acc_hi = 0.0f;
      acc_lo = 0.0f;
      cur = c;
    }
    const float x = qs[e];
    const float xh = bf16_round(x);
    const float xl = bf16_round(__fsub_rn(x, xh));
    acc_hi = __fadd_rn(acc_hi, xh);
    acc_lo = __fadd_rn(acc_lo, xl);
  }
  if (cur >= 0) total = __fadd_rn(total, __fadd_rn(acc_hi, acc_lo));
  out[t] = total;
}

// ---------------------------------------------------------------------------
// Build-form mult: one thread per entry.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mult_crossing_kernel(const float* __restrict__ mult3, const int16_t* __restrict__ rowid,
                     float* __restrict__ out, int n_sub, int n, int row_hi) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n_sub) * n) return;
  const int s = static_cast<int>(i / n);
  const int r = rowid[i];
  float u = 0.0f;  // a row id outside the row space has an all-zero one-hot
  if (r >= 0 && r / kRowLo < row_hi) {
    const float m = mult3[static_cast<size_t>(s) * row_hi * kRowLo + r];
    const float hi = bf16_round(m);
    const float lo = bf16_round(__fsub_rn(m, hi));
    u = __fadd_rn(hi, lo);
  }
  out[i] = u;
}

// ---------------------------------------------------------------------------
// Premat dot, pass 1: chunk partials. Block (chunk c, sub s, h-group g).
// ---------------------------------------------------------------------------

// What a staged tile holds, found while its words are stored: for each
// oh_lo column the bit mask of the entries with a nonzero there (its thread
// walks them in ascending entry order), and per entry the count of nonzero
// oh_hi columns and the first one, so a one-hot entry costs one update.
struct TileIndex {
  unsigned long long col_mask[kRowLo];
  int hi_cnt[kTile];
  int hi_first[kTile];
};

// Records the nonzeros among the 8 bf16 values of `w` (columns col0 ..
// col0 + 7 of entry j's row). Shared-memory integer atomics: the masks and
// counts do not depend on their order.
__device__ __forceinline__ void note_nonzeros(const uint4& w, int j, int col0, int width,
                                              bool is_lo, TileIndex* ix) {
  if ((w.x | w.y | w.z | w.w) == 0u) return;
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  int cnt = 0, first = width;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint16_t bits = static_cast<uint16_t>(words[k / 2] >> (16 * (k % 2)));
    if (col0 + k < width && bf16_word(bits) != 0.0f) {
      if (is_lo) atomicOr(&ix->col_mask[col0 + k], 1ull << j);
      first = min(first, col0 + k);
      ++cnt;
    }
  }
  if (cnt && !is_lo) {
    atomicAdd(&ix->hi_cnt[j], cnt);
    atomicMin(&ix->hi_first[j], first);
  }
}

__global__ void __launch_bounds__(kThreads)
dot_premat_partial_kernel(const float* __restrict__ q, const uint16_t* __restrict__ oh_hi,
                          const uint16_t* __restrict__ oh_lo, float* __restrict__ partial,
                          int wi, int n_sub, int n, int n_pad, int row_hi, int chunk,
                          int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, s = blockIdx.y;
  const int h0 = blockIdx.z * kHGroup;
  const int hw = min(kHGroup, row_hi - h0);
  float* acc = reinterpret_cast<float*>(smem_raw);  // [2][hw][128]
  float* qh = acc + 2 * hw * kRowLo;                 // [2][kTile]: the q halves
  uint32_t* live = reinterpret_cast<uint32_t*>(qh + 2 * kTile);  // [4]: entries with q != 0
  TileIndex* index = reinterpret_cast<TileIndex*>(live + 4);     // [2]: this tile's, the next's
  uint16_t* lo_t = reinterpret_cast<uint16_t*>(index + 2);       // [kTile][128]
  uint16_t* hi_t = lo_t + kTile * kRowLo;                        // [kTile][hw]

  const int tid = threadIdx.x;
  const int half = tid / kRowLo;  // 0: q_hi, 1: q_lo
  const int l = tid % kRowLo;
  for (int i = tid; i < 2 * hw * kRowLo; i += kThreads) acc[i] = 0.0f;
  auto reset = [&](TileIndex* ix) {
    if (tid < kRowLo) ix->col_mask[tid] = 0ull;
    if (tid < kTile) {
      ix->hi_cnt[tid] = 0;
      ix->hi_first[tid] = hw;
    }
  };
  reset(&index[0]);

  const size_t unit = static_cast<size_t>(wi) * n_sub + s;
  const uint16_t* hi_base = oh_hi + unit * n_pad * row_hi;
  const uint16_t* lo_base = oh_lo + unit * n_pad * kRowLo;
  const float* qs = q + static_cast<size_t>(s) * n;
  const bool vec_hi = (hw % 8 == 0) && (row_hi % 8 == 0);
  float* my_acc = acc + half * hw * kRowLo;

  const int e_begin = c * chunk;
  const int e_end = min(e_begin + chunk, n_pad);
  // The next tile's words and q values wait in registers while this tile
  // is summed, so their loads overlap the work.
  const int hi_words = hw / 8;  // per entry, on the 16-byte path
  uint4 lo_r[kWordsPerThread], hi_r[kWordsPerThread];
  float q_r = 0.0f;
  auto fetch = [&](int t0) {
    const int tn = min(kTile, e_end - t0);
    const uint4* ls = reinterpret_cast<const uint4*>(lo_base + static_cast<size_t>(t0) * kRowLo);
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int i = tid + k * kThreads;
      if (i < tn * (kRowLo / 8)) lo_r[k] = ls[i];
    }
    if (vec_hi) {
      const uint16_t* hs = hi_base + static_cast<size_t>(t0) * row_hi + h0;
#pragma unroll
      for (int k = 0; k < kWordsPerThread; ++k) {
        const int i = tid + k * kThreads;
        if (i < tn * hi_words) {
          hi_r[k] = reinterpret_cast<const uint4*>(hs + static_cast<size_t>(i / hi_words) * row_hi)[i % hi_words];
        }
      }
    }
    if (tid < tn) q_r = t0 + tid < n ? qs[t0 + tid] : 0.0f;  // q is zero on padded entries
  };
  if (e_begin < e_end) fetch(e_begin);
  int parity = 0;
  for (int e0 = e_begin; e0 < e_end; e0 += kTile, parity ^= 1) {
    const int te = min(kTile, e_end - e0);
    TileIndex* ix = &index[parity];
    __syncthreads();  // the previous tile is consumed; ix was reset before this point
    reset(&index[parity ^ 1]);  // for the next tile: its last reader has passed the barrier
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int i = tid + k * kThreads;
      if (i < te * (kRowLo / 8)) {
        reinterpret_cast<uint4*>(lo_t)[i] = lo_r[k];
        note_nonzeros(lo_r[k], i / (kRowLo / 8), (i % (kRowLo / 8)) * 8, kRowLo, true, ix);
      }
      if (vec_hi && i < te * hi_words) {
        reinterpret_cast<uint4*>(hi_t)[i] = hi_r[k];
        note_nonzeros(hi_r[k], i / hi_words, (i % hi_words) * 8, hw, false, ix);
      }
    }
    if (!vec_hi) {
      const uint16_t* hsrc = hi_base + static_cast<size_t>(e0) * row_hi + h0;
      for (int i = tid; i < te * hw; i += kThreads) {
        const int j = i / hw, h = i % hw;
        const uint16_t bits = hsrc[static_cast<size_t>(j) * row_hi + h];
        hi_t[i] = bits;
        if (bf16_word(bits) != 0.0f) {
          atomicAdd(&ix->hi_cnt[j], 1);
          atomicMin(&ix->hi_first[j], h);
        }
      }
    }
    if (tid < kTile) {  // warps 0 and 1, whole
      const float x = tid < te ? q_r : 0.0f;
      const float xh = bf16_round(x);
      qh[tid] = xh;
      qh[kTile + tid] = bf16_round(__fsub_rn(x, xh));
      const uint32_t ballot = __ballot_sync(0xffffffffu, x != 0.0f);
      if (tid % kWarp == 0) live[tid / kWarp] = ballot;
    }
    __syncthreads();
    if (e0 + kTile < e_end) fetch(e0 + kTile);
    const float* qhalf = qh + half * kTile;
    // q = 0 entries (the layout's padding slots, all on row 0) are skipped:
    // a zero term leaves every sum unchanged.
    const unsigned long long live_mask =
        (static_cast<unsigned long long>(live[1]) << 32) | live[0];
    for (unsigned long long m = ix->col_mask[l] & live_mask; m; m &= m - 1) {
      const int j = __ffsll(static_cast<long long>(m)) - 1;  // ascending entry order
      const float qv = qhalf[j];
      if (qv == 0.0f) continue;
      const float t = bf16_round(__fmul_rn(bf16_word(lo_t[j * kRowLo + l]), qv));
      const uint16_t* hr = hi_t + j * hw;
      const int nh = ix->hi_cnt[j];
      if (nh == 1) {
        const int h = ix->hi_first[j];
        float* p = my_acc + h * kRowLo + l;
        *p = __fadd_rn(*p, __fmul_rn(bf16_word(hr[h]), t));
      } else if (nh > 1) {
        for (int h = 0; h < hw; ++h) {
          const float a = bf16_word(hr[h]);
          if (a != 0.0f) {
            float* p = my_acc + h * kRowLo + l;
            *p = __fadd_rn(*p, __fmul_rn(a, t));
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = partial + ((static_cast<size_t>(s) * n_chunks + c) * row_hi + h0) * kRowLo;
  for (int i = tid; i < hw * kRowLo; i += kThreads) dst[i] = __fadd_rn(acc[i], acc[hw * kRowLo + i]);
}

// Premat dot, pass 2: out[s, r] = sum of the chunk partials in chunk order.
__global__ void __launch_bounds__(kThreads)
dot_premat_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                         int n_sub, int n_chunks, int rows) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(n_sub) * rows) return;
  const int s = static_cast<int>(t / rows);
  const int r = static_cast<int>(t % rows);
  const float* p = partial + static_cast<size_t>(s) * n_chunks * rows + r;
  float total = 0.0f;
  for (int c = 0; c < n_chunks; ++c) total = __fadd_rn(total, p[static_cast<size_t>(c) * rows]);
  out[t] = total;
}

// ---------------------------------------------------------------------------
// Premat mult: one warp per (s, e).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mult_premat_kernel(const float* __restrict__ mult3, const uint16_t* __restrict__ oh_hi,
                   const uint16_t* __restrict__ oh_lo, float* __restrict__ out, int wi,
                   int n_sub, int n_pad, int row_hi) {
  const size_t warp = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= static_cast<size_t>(n_sub) * n_pad) return;  // uniform across the warp
  const int s = static_cast<int>(warp / n_pad);
  const size_t row = static_cast<size_t>(wi) * n_sub * n_pad + warp;
  const uint16_t* hr = oh_hi + row * row_hi;
  const uint16_t* lr = oh_lo + row * kRowLo;
  const float* m = mult3 + static_cast<size_t>(s) * row_hi * kRowLo;
  float u = 0.0f;
  for (int p0 = 0; p0 < kRowLo; p0 += kWarp) {
    const float v = bf16_word(lr[p0 + lane]);
    unsigned live = __ballot_sync(0xffffffffu, v != 0.0f);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int p = p0 + src;
      const float vl = __shfl_sync(0xffffffffu, v, src);
      float ph = 0.0f, pl = 0.0f;
      for (int h = lane; h < row_hi; h += kWarp) {
        const float a = bf16_word(hr[h]);
        if (a != 0.0f) {
          const float mv = m[static_cast<size_t>(h) * kRowLo + p];
          const float mh = bf16_round(mv);
          const float ml = bf16_round(__fsub_rn(mv, mh));
          ph = __fadd_rn(ph, __fmul_rn(a, mh));
          pl = __fadd_rn(pl, __fmul_rn(a, ml));
        }
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        ph = __fadd_rn(ph, __shfl_xor_sync(0xffffffffu, ph, off));
        pl = __fadd_rn(pl, __shfl_xor_sync(0xffffffffu, pl, off));
      }
      u = __fadd_rn(u, __fmul_rn(__fadd_rn(ph, pl), vl));
    }
  }
  if (lane == 0) out[warp] = u;
}

inline unsigned blocks_for(size_t items, size_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().

int onehot_dot_crossing(const void* q, const void* row_ptr, const void* entry_of, void* out,
                        int n_sub, int n, int row_hi, int chunk, void* stream) {
  const int rows = row_hi * kRowLo;
  const size_t items = static_cast<size_t>(n_sub) * rows;
  if (items > 0) {
    dot_crossing_kernel<<<blocks_for(items, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const int*>(row_ptr),
        static_cast<const int*>(entry_of), static_cast<float*>(out), n_sub, n, rows, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

int onehot_mult_crossing(const void* mult3, const void* rowid, void* out, int n_sub, int n,
                         int row_hi, void* stream) {
  const size_t items = static_cast<size_t>(n_sub) * n;
  if (items > 0) {
    mult_crossing_kernel<<<blocks_for(items, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mult3), static_cast<const int16_t*>(rowid),
        static_cast<float*>(out), n_sub, n, row_hi);
  }
  return static_cast<int>(cudaGetLastError());
}

int onehot_dot_crossing_premat(const void* q, const void* oh_hi, const void* oh_lo,
                               void* partial, void* out, int wi, int n_sub, int n, int n_pad,
                               int row_hi, int chunk, int n_chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = row_hi * kRowLo;
  if (n_sub > 0 && n_chunks > 0 && row_hi > 0) {
    const int hw = row_hi < kHGroup ? row_hi : kHGroup;
    const size_t smem = (2 * static_cast<size_t>(hw) * kRowLo + 2 * kTile) * sizeof(float) +
                        4 * sizeof(uint32_t) + 2 * sizeof(TileIndex) +
                        static_cast<size_t>(kTile) * (kRowLo + hw) * sizeof(uint16_t);
    cudaError_t err = cudaFuncSetAttribute(dot_premat_partial_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(n_chunks, n_sub, (row_hi + kHGroup - 1) / kHGroup);
    dot_premat_partial_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const uint16_t*>(oh_hi),
        static_cast<const uint16_t*>(oh_lo), static_cast<float*>(partial), wi, n_sub, n, n_pad,
        row_hi, chunk, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t items = static_cast<size_t>(n_sub) * rows;
  if (items > 0) {
    dot_premat_reduce_kernel<<<blocks_for(items, kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), n_sub, n_chunks, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int onehot_mult_crossing_premat(const void* mult3, const void* oh_hi, const void* oh_lo,
                                void* out, int wi, int n_sub, int n_pad, int row_hi,
                                void* stream) {
  const size_t items = static_cast<size_t>(n_sub) * n_pad;
  if (items > 0) {
    mult_premat_kernel<<<blocks_for(items, kThreads / kWarp), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mult3), static_cast<const uint16_t*>(oh_hi),
        static_cast<const uint16_t*>(oh_lo), static_cast<float*>(out), wi, n_sub, n_pad,
        row_hi);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
