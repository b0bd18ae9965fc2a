// One ring-attention fold: a Q block against one resident K/V block, folded
// into the streaming-softmax state (m, l, acc).
//
// Replaces: flink_ml_tpu/parallel/flash.py, _fold_pallas (line 127, its
// pallas_call at line 190). For every (batch·head) row of Q it computes
//   s          = (q · kᵀ) * scale, set to -inf where the key is masked
//                (causal: q_pos < k_pos; n_valid: k_pos >= n_valid;
//                 and every key past Tk)
//   new_m      = max(m_in, max over the keys of s)
//   safe_m     = new_m, or 0 where new_m is -inf
//   p          = exp(s - safe_m), exactly 0 where s is -inf
//   correction = exp(m_in - safe_m), exactly 0 where m_in is -inf
//   l_out      = l_in * correction + sum p
//   acc_out    = acc_in * correction + p · v
// with q_pos = q_pos0 + row and k_pos = k_pos0 + key. All float32 in and out.
//
// Bound: operations. The fold does 4·BH·Tq·Tk·D operations (two products)
// against 4·BH·(3·Tq·D + 2·Tk·D + 4·Tq) bytes. Both products run on the
// tensor cores in 3×TF32 (tf32_mma.cuh): each float32 operand is split into
// a TF32 hi and lo, and a product is lo·hi + hi·lo + hi·hi summed in float32,
// so the tensor cores do three TF32 operations for each float32 one. At
// B 1, H 4, T 8192, D 128 that is 412.3 G TF32 operations, 0.833 ms at the
// H100's 495 TFLOP/s of dense TF32 (0.417 ms causal), against 84.4 MB
// (25.2 us at 3.35 TB/s); the same work as float32 FMAs outside the tensor
// cores would take 2.05 ms at 67 TFLOP/s.
//
// Design. The TPU kernel keeps one head's whole K/V block in VMEM and forms a
// [256, Tk] score tile. Here a block of two warpgroups owns kBM = 64 query
// rows of one (batch·head) and streams the K/V block through shared memory
// kBN keys at a time, carrying the running max, sum and accumulator of its
// rows in registers (the online softmax): no score leaves the SM. Both
// products are wgmma (Hopper's warpgroup MMA, the only route to the full
// tensor-core rate) on operands that are split once, where they are
// written to shared memory; nothing is split again at a use.
// - The loader warpgroup (threads 128-255). Where D % 4 == 0 and the
//   pointers are 16-byte aligned, tile t + 1's K and V rows, contiguous in
//   device memory, are two bulk copies (TMA) into a staging buffer, issued
//   as soon as tile t has been read out of it; otherwise a tile is read from
//   device memory with 4-byte loads. The loader splits each tile into hi and
//   lo in registers and writes K hi, K lo, Vᵀ hi and Vᵀ lo into a ring of
//   kStages stages, K as it lies and V transposed, as wgmma reads them
//   (K-major, tf32_mma.cuh's kt_offset). V is read a float at a time, four
//   keys of one column into one 16-byte row of Vᵀ, so that neither side has
//   bank conflicts (LoaderTile). K and Vᵀ are handed over apart, each with a
//   full and an empty mbarrier: the loader fences its writes for the async
//   proxy and arrives on full; the consumer arrives on empty once the last
//   product that reads it is complete, K one tile ahead of Vᵀ.
// - The consumer warpgroup (threads 0-127, one wgmma warpgroup) splits its Q
//   rows once, into shared memory, at the start. Per tile t:
//   1. S = Q·Kᵀ as wgmma m64n{kBN}k8, A (Q hi/lo) and B (K hi/lo) from
//      shared memory, three products a k-step. The tensor cores' float32
//      sum is not specified to round to nearest, so k-steps are summed in
//      the MMA in stretches of kStretch (64 columns of D), then added in
//      float32. Tile t + 1's S is issued before tile t's softmax, so that
//      the tensor cores run it meanwhile;
//   2. mask and scale; the row max over the tile by shuffles across the four
//      threads that share an accumulator row; the correction; p = expf(...);
//   3. O += P·V as wgmma m64n{kNO}k8 with A = P from registers, split from
//      the S accumulator as it stands, and B = Vᵀ hi/lo from shared memory.
//      A thread's S accumulator holds keys 2t and 2t + 1 of each 8-key
//      slice, the register A fragment wants keys t and t + 4: the loader
//      writes the keys of each 8-key slice of Vᵀ in that order (keys 0, 2,
//      4, 6, then 1, 3, 5, 7: quad_key) instead of shuffling P. The product
//      of one tile is summed in a fresh accumulator and added to O in
//      float32 (O = O · correction + P·V, one fmaf), again so that no long
//      sum runs inside the MMA.
// The head dim is padded to the template's kD (32, 64, 128 or 256) with
// zeros, which add exactly 0, so any D <= 256 runs. Shared memory is
// 4·(2·64·kD + kStages·4·kBN·kD + 2·kBN·kD) bytes plus nine mbarriers: at
// kD 128, with 32-key stages, 64 KB of Q hi/lo, two 64 KB stages and a 32 KB
// staging buffer, 224 KB, one block an SM; at kD 256 the key tile shrinks to
// 8. 256 threads a block at one block an SM leave each thread 255 registers,
// so no register transfer between the warpgroups (setmaxnreg) is needed.
// A second consumer warpgroup (128 query rows a block, sharing the stages)
// was measured and not taken: at 384 threads a thread gets 168 registers,
// the consumer spills, and with 16-key stages (what shared memory leaves)
// it ran no faster (PERF.md). Key tiles that the causal or n_valid mask
// covers wholly are never loaded: both warpgroups stop at the block's last
// attendable key. The Q tiles run in reverse order, so under causal the
// longest rows start first.
//
// Exact edges (the JAX fold's own): a row with no attendable key in the
// block keeps m, l and acc bit for bit when m_in is finite (each correction
// is exactly 1, each p exactly 0, so each tile's product is 0 and O · 1 + 0
// is O), and gives m -inf, l 0, acc 0 when m_in is -inf (the state is
// multiplied by 0 once at the start, as the reference's correction 0 does);
// a masked key adds exactly 0, and exp is never taken of -inf - (-inf). The
// products and the softmax sum in another order than the plain version, so
// the rest agrees within a float32 tolerance.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"  // split, the wgmma wrappers and descriptors, mbarriers

namespace {

template <int kD>
struct Fold {
  static constexpr int kBM = 64;                   // query rows a block: one consumer warpgroup
  static constexpr int kBN = kD > 128 ? 8 : 32;    // keys a stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 256;             // the consumer warpgroup, then the loader
  static constexpr int kNO = kD > 128 ? 64 : kD;   // output columns of one P·V product
  static constexpr int kKSteps = kD / 8;           // k-steps of Q·Kᵀ
  static constexpr int kStretch = 8;               // k-steps summed inside the MMA before a float32 add
  static constexpr int kStretches = (kKSteps + kStretch - 1) / kStretch;
  static constexpr int kQ = kBM * kD;              // floats of the Q tile (hi or lo)
  static constexpr int kKV = kBN * kD;             // floats of a K or Vᵀ tile (hi or lo)
  static constexpr int kStage = 4 * kKV;           // K hi, K lo, Vᵀ hi, Vᵀ lo
  static constexpr int kStaging = 2 * kKV;         // the raw K and V rows of the next tile, float32
  static constexpr int kBarriers = 4 * kStages + 1;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * static_cast<size_t>(kQ) + kStages * static_cast<size_t>(kStage) + kStaging) +
      sizeof(uint64_t) * kBarriers;
};
static_assert(Fold<128>::kBytes <= 232448 && Fold<256>::kBytes <= 232448,
              "the largest tile sets fit one block's shared memory");

// Four consecutive floats of row `row` of a [*, D] matrix from column d0,
// zero past n_rows and past D: one 16-byte load where `vec` (D % 4 == 0 and
// a 16-byte aligned base), else four 4-byte ones; from device memory
// (kGlobal) or from shared memory.
template <bool kGlobal>
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int row, int n_rows, int d0, int D,
                                        bool vec) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= n_rows) return x;
  const float* const p = src + static_cast<size_t>(row) * D + d0;
  const auto at = [&](const float* a) { return kGlobal ? __ldg(a) : *a; };
  if (vec) {
    if (d0 < D) x = kGlobal ? __ldg(reinterpret_cast<const float4*>(p)) : *reinterpret_cast<const float4*>(p);
  } else {
    if (d0 < D) x.x = at(p);
    if (d0 + 1 < D) x.y = at(p + 1);
    if (d0 + 2 < D) x.z = at(p + 2);
    if (d0 + 3 < D) x.w = at(p + 3);
  }
  return x;
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split(x.x, h, l);
  hi.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  split(x.y, h, l);
  hi.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  split(x.z, h, l);
  hi.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  split(x.w, h, l);
  hi.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

// Element e of a thread's S accumulator quad is slot a_pos(e) of its A
// fragment of P·V: the keys of an 8-key slice sit at k positions 0-7 in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (LoaderTile::quad_key writes Vᵀ so).
__device__ __forceinline__ constexpr int a_pos(int e) { return e == 1 ? 2 : e == 2 ? 1 : e; }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The loader warpgroup's share of one tile (thread i of its 128).
// - K: blocks of 8 keys x 32 columns, each taken by one warp in two passes
//   h; lane 8q + l holds key l of the block and columns 4·((l + q + 4h) % 8)
//   to + 3. The diagonal keeps both sides free of bank conflicts: the 8
//   lanes of a 16-byte phase read 8 distinct 16-byte slots of the staged
//   rows (D a multiple of 32) and write the 8 rows of one K core matrix.
// - V: item (column d, position quad pq) holds the four keys at k positions
//   4·pq to 4·pq + 3 of Vᵀ (keys 2 apart: a_pos), read one float each, and
//   is written as one 16-byte row of a Vᵀ core matrix; neighbouring threads
//   take neighbouring columns, so reads and writes are free of bank
//   conflicts.
template <int kD>
struct LoaderTile {
  using F = Fold<kD>;
  static constexpr int kKPasses = 2 * (F::kBN / 8) * (kD / 32);
  static_assert(kD % 32 == 0 && kKPasses % 4 == 0, "every loader warp takes as many passes");
  static constexpr int kKPer = kKPasses / 4;
  static constexpr int kVPer = (F::kBN / 4) * kD / 128;
  static_assert((F::kBN / 4) * kD % 128 == 0, "every loader thread takes as many V items");
  float4 k[kKPer], v[kVPer];

  static __device__ __forceinline__ int key(int pass, int lane) {
    return ((pass >> 1) % (F::kBN / 8)) * 8 + (lane & 7);
  }
  static __device__ __forceinline__ int col(int pass, int lane) {
    const int l = lane & 7, q = lane >> 3;
    return ((pass >> 1) / (F::kBN / 8)) * 32 + ((l + q + 4 * (pass & 1)) & 7) * 4;
  }
  // The first key of V item i's position quad (its keys are 2 apart).
  static __device__ __forceinline__ int quad_key(int item) {
    const int pq = item / kD;
    return (pq >> 1) * 8 + (pq & 1);
  }

  // The tile's K and V rows, zero past n_keys and past D: from the staged
  // rows ks / vs (shared memory, row stride D) or, where `staged` is false,
  // from device memory (4-byte loads).
  __device__ __forceinline__ void fetch(const float* ks, const float* vs, int n_keys, int D, bool staged,
                                        int warp, int lane, int tl) {
#pragma unroll
    for (int i = 0; i < kKPer; ++i) {
      const int pass = warp + 4 * i, kk = key(pass, lane), d0 = col(pass, lane);
      k[i] = staged ? load4<false>(ks, kk, n_keys, d0, D, true) : load4<true>(ks, kk, n_keys, d0, D, false);
    }
#pragma unroll
    for (int i = 0; i < kVPer; ++i) {
      const int item = tl + 128 * i, d = item % kD, k0 = quad_key(item);
      float x[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = k0 + 2 * m;
        const float* const p = vs + static_cast<size_t>(kk) * D + d;
        x[m] = kk < n_keys && d < D ? (staged ? *p : __ldg(p)) : 0.0f;
      }
      v[i] = make_float4(x[0], x[1], x[2], x[3]);
    }
  }

  // Splits the K rows and writes K hi and K lo at `kh`.
  __device__ __forceinline__ void put_k(float* kh, int warp, int lane) const {
    float* const kl = kh + F::kKV;
#pragma unroll
    for (int i = 0; i < kKPer; ++i) {
      const int pass = warp + 4 * i;
      float4 hi, lo;
      split4(k[i], hi, lo);
      const int o = kt_offset<F::kBN>(key(pass, lane), col(pass, lane));
      *reinterpret_cast<float4*>(kh + o) = hi;
      *reinterpret_cast<float4*>(kl + o) = lo;
    }
  }

  // Splits the V rows and writes Vᵀ hi and Vᵀ lo at `vh`.
  __device__ __forceinline__ void put_v(float* vh, int tl) const {
    float* const vl = vh + F::kKV;
#pragma unroll
    for (int i = 0; i < kVPer; ++i) {
      const int item = tl + 128 * i;
      float4 hi, lo;
      split4(v[i], hi, lo);
      const int o = kt_offset<kD>(item % kD, 4 * (item / kD));
      *reinterpret_cast<float4*>(vh + o) = hi;
      *reinterpret_cast<float4*>(vl + o) = lo;
    }
  }
};

template <int kD>
__global__ void __launch_bounds__(Fold<kD>::kThreads, 1)
flash_fold_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ m_in,
                  const float* __restrict__ l_in, const float* __restrict__ acc_in,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int BH, int Tq, int Tk, int D, int q_pos0,
                  int k_pos0, int causal, int has_n_valid, int n_valid, float scale) {
  using F = Fold<kD>;
  constexpr int kBM = F::kBM, kBN = F::kBN, kStages = F::kStages, kNO = F::kNO;
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(128) float smem[];
  float* const qh = smem;                   // Q hi, K-major [64 rows][kD]
  float* const ql = qh + F::kQ;             // Q lo
  float* const stages = ql + F::kQ;         // stage s: K hi, K lo [kBN keys][kD]; Vᵀ hi, Vᵀ lo [kD][kBN]
  float* const staging = stages + kStages * F::kStage;  // the next tile's K rows, then its V rows
  // K and Vᵀ of a stage are handed over apart: the consumer reads K a tile
  // ahead of V
  uint64_t* const k_full = reinterpret_cast<uint64_t*>(staging + F::kStaging);
  uint64_t* const k_empty = k_full + kStages;
  uint64_t* const v_full = k_empty + kStages;
  uint64_t* const v_empty = v_full + kStages;
  uint64_t* const staged = v_empty + kStages;  // the staging buffer holds the next tile

  const int n_qt = (Tq + kBM - 1) / kBM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kBM;
  const int tid = threadIdx.x, warp = (tid & 127) >> 5, lane = tid & 31;
  const size_t q_row0 = static_cast<size_t>(bh) * Tq;
  const size_t k_row0 = static_cast<size_t>(bh) * Tk;
  const bool vec = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  // Keys past key_end are masked for every row of the block: their tiles
  // are never loaded.
  long long key_end = Tk;
  if (has_n_valid) key_end = min(key_end, static_cast<long long>(n_valid) - k_pos0);
  const long long mask_end = key_end;  // the row-independent limit
  if (causal) {
    const int last_row = min(q0 + kBM, Tq) - 1;
    key_end = min(key_end, static_cast<long long>(q_pos0) + last_row - k_pos0 + 1);
  }
  const int n_kt = key_end > 0 ? static_cast<int>((key_end + kBN - 1) / kBN) : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 128);  // the loader's threads
      mbar_init(&v_full[s], 128);
      mbar_init(&k_empty[s], 128);  // the consumer's threads
      mbar_init(&v_empty[s], 128);
    }
    mbar_init(staged, 1);         // one loader thread, plus the copies' bytes
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- the loader warpgroup. Where D % 4 == 0 and the pointers are
    // 16-byte aligned, tile t + 1's K and V rows (contiguous in device
    // memory) are two bulk copies into the staging buffer, issued as soon as
    // tile t has been read out of it, and in flight while tile t is split,
    // written and handed over; otherwise each tile is read from device
    // memory with 4-byte loads.
    const int tl = tid - 128, lw = tl >> 5;
    const auto tile_keys = [&](int t) { return min(kBN, Tk - t * kBN); };
    const auto copy = [&](int t) {  // one thread: tile t into the staging buffer
      const size_t row = k_row0 + static_cast<size_t>(t) * kBN;
      const unsigned bytes = static_cast<unsigned>(tile_keys(t) * D) * sizeof(float);
      fence_proxy_async();  // the loader's reads of the buffer, before the copies overwrite it
      mbar_arrive_expect_tx(staged, 2 * bytes);
      bulk_copy(staging, k + row * D, bytes, staged);
      bulk_copy(staging + F::kKV, v + row * D, bytes, staged);
    };
    if (vec && tid == 128 && n_kt > 0) copy(0);
    LoaderTile<kD> tile;
    for (int t = 0; t < n_kt; ++t) {
      if (vec) {
        mbar_wait(staged, t & 1);
        tile.fetch(staging, staging + F::kKV, tile_keys(t), D, true, lw, lane, tl);
        asm volatile("bar.sync 2, 128;\n" ::: "memory");  // every loader thread has read the staging buffer
        if (tid == 128 && t + 1 < n_kt) copy(t + 1);
      } else {
        const size_t row = k_row0 + static_cast<size_t>(t) * kBN;
        tile.fetch(k + row * D, v + row * D, tile_keys(t), D, false, lw, lane, tl);
      }
      const int s = t % kStages;
      const unsigned parity = ((t / kStages) & 1) ^ 1;
      mbar_wait(&k_empty[s], parity);  // the consumer is done with this stage's K
      tile.put_k(stages + s * F::kStage, lw, lane);
      fence_proxy_async();  // the writes, before wgmma reads them
      mbar_arrive(&k_full[s]);
      mbar_wait(&v_empty[s], parity);
      tile.put_v(stages + s * F::kStage + 2 * F::kKV, tl);
      fence_proxy_async();
      mbar_arrive(&v_full[s]);
    }
    return;
  }

  // ---- the consumer warpgroup: thread (warp w, lane 4g + t4) owns rows
  // r0 = 16w + g and r0 + 8 of the block, and in each accumulator columns
  // 8j + 2·t4 and 8j + 2·t4 + 1 (element 4j + e: row r0 + 8·(e / 2), column
  // 8j + 2·t4 + e % 2).
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;
  {  // Q, split once, as wgmma's A operand
    constexpr int kChunks = (kBM / 8) * (kD / 16);
    const float* const qsrc = q + (q_row0 + q0) * D;
    for (int c = warp; c < kChunks; c += 4) {
      const int row = (c % 8) * 8 + (lane & 7), d0 = (c / 8) * 16 + (lane >> 3) * 4;
      float4 hi, lo;
      split4(load4<true>(qsrc, row, Tq - q0, d0, D, vec), hi, lo);
      const int o = kt_offset<kBM>(row, d0);
      *reinterpret_cast<float4*>(qh + o) = hi;
      *reinterpret_cast<float4*>(ql + o) = lo;
    }
    fence_proxy_async();
  }

  // The running state of this thread's rows.
  float m_run[2], l_run[2], o[kD / 2];
  long long last_key[2];  // the last attendable key index of the row under causal
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool valid = row < Tq;
    m_run[r] = valid ? __ldg(m_in + q_row0 + row) : kNegInf;
    l_run[r] = valid ? __ldg(l_in + q_row0 + row) : 0.0f;
    last_key[r] = static_cast<long long>(q_pos0) + row - k_pos0;
  }
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    const int r = (i >> 1) & 1, row = q0 + r0 + 8 * r, col = 8 * (i >> 2) + 2 * t4 + (i & 1);
    o[i] = (row < Tq && col < D) ? __ldg(acc_in + (q_row0 + row) * D + col) : 0.0f;
    if (m_run[r] == kNegInf) o[i] *= 0.0f;  // the reference's correction 0, applied once
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (m_run[r] == kNegInf) l_run[r] *= 0.0f;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // every consumer thread's part of Q is written

  using Scores = float[F::kStretches][kBN / 2];  // S of one tile, summed in stretches
  const uint64_t dqh = gmma_desc<kBM>(qh), dql = gmma_desc<kBM>(ql);
  // 1. S = Q·Kᵀ of tile t in 3×TF32, k-steps summed in the MMA in stretches:
  // issued once the tile's K is written, not waited for
  const auto issue_scores = [&](int t, Scores& sp) {
    const int s = t % kStages;
    const float* const kh = stages + s * F::kStage;
    const uint64_t dkh = gmma_desc<kBN>(kh), dkl = gmma_desc<kBN>(kh + F::kKV);
    mbar_wait(&k_full[s], (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < F::kKSteps; ++j) {
      const int st = j / F::kStretch, more = j % F::kStretch != 0;
      const uint64_t ah = desc_plus(dqh, j * kBM * 8), al = desc_plus(dql, j * kBM * 8);
      const uint64_t bh = desc_plus(dkh, j * kBN * 8), bl = desc_plus(dkl, j * kBN * 8);
      Wgmma<kBN>::ss(sp[st], al, bh, more);
      Wgmma<kBN>::ss(sp[st], ah, bl, 1);
      Wgmma<kBN>::ss(sp[st], ah, bh, 1);
    }
    wgmma_commit();
  };
  // Tile t, whose S is complete in `cur`. The next tile's S is issued into
  // `next` first, so that the tensor cores run it under this tile's softmax.
  const auto fold_tile = [&](int t, Scores& cur, Scores& next) {
    const bool ahead = t + 1 < n_kt;
    if (ahead) issue_scores(t + 1, next);
    const int s = t % kStages;
    const int k0 = t * kBN;
    const float* const vt = stages + s * F::kStage + 2 * F::kKV;
    const uint64_t dvh = gmma_desc<kD>(vt), dvl = gmma_desc<kD>(vt + F::kKV);

    // 2. mask and scale; the streaming-softmax update of each row
    float sv[kBN / 2], tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = cur[0][i];
#pragma unroll
      for (int st = 1; st < F::kStretches; ++st) x += cur[st][i];
      const int r = (i >> 1) & 1;
      const long long key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const bool keep = key < mask_end && (!causal || key <= last_key[r]);
      sv[i] = keep ? x * scale : kNegInf;
      tile_max[r] = fmaxf(tile_max[r], sv[i]);
    }
    float safe_m[2], correction[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float new_m = fmaxf(m_run[r], quad_max(tile_max[r]));
      safe_m[r] = new_m == kNegInf ? 0.0f : new_m;
      // exactly 1 where the max did not move, as exp(0) is in the reference
      correction[r] = m_run[r] == kNegInf ? 0.0f : m_run[r] == safe_m[r] ? 1.0f : expf(m_run[r] - safe_m[r]);
      m_run[r] = new_m;
    }
    uint32_t ph[kBN / 8][4], pl[kBN / 8][4];  // P as A fragments of P·V, split
    float p_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = sv[i] == kNegInf ? 0.0f : expf(sv[i] - safe_m[r]);
      p_sum[r] += p;
      split(p, ph[i >> 2][a_pos(i & 3)], pl[i >> 2][a_pos(i & 3)]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * correction[r] + quad_sum(p_sum[r]);

    // 3. O = O · correction + P·V, the tile's product in its own accumulator
    mbar_wait(&v_full[s], (t / kStages) & 1);
#pragma unroll
    for (int c = 0; c < kD / kNO; ++c) {
      float op[kNO / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int off = j * kD * 8 + c * kNO * 4;  // k-step j, output rows c·kNO.. of Vᵀ
        Wgmma<kNO>::rs(op, pl[j], desc_plus(dvh, off), j != 0);
        Wgmma<kNO>::rs(op, ph[j], desc_plus(dvl, off), 1);
        Wgmma<kNO>::rs(op, ph[j], desc_plus(dvh, off), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // this product, and the next tile's S
      fence_regs(op);
      if (c == kD / kNO - 1) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          fence_regs(ph[j]);
          fence_regs(pl[j]);
        }
        mbar_arrive(&v_empty[s]);  // the stage's Vᵀ is read
        if (t + 1 < n_kt) mbar_arrive(&k_empty[(t + 1) % kStages]);  // and the next tile's K
      }
#pragma unroll
      for (int i = 0; i < kNO / 2; ++i)
        o[c * (kNO / 2) + i] = fmaf(o[c * (kNO / 2) + i], correction[(i >> 1) & 1], op[i]);
    }
#pragma unroll
    for (int st = 0; st < F::kStretches; ++st) fence_regs(next[st]);
  };
  Scores sa, sb;
  if (n_kt > 0) {
    issue_scores(0, sa);
    wgmma_wait<0>();
    mbar_arrive(&k_empty[0]);
#pragma unroll
    for (int st = 0; st < F::kStretches; ++st) fence_regs(sa[st]);
  }
  for (int t = 0; t < n_kt; t += 2) {
    fold_tile(t, sa, sb);
    if (t + 1 < n_kt) fold_tile(t + 1, sb, sa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row < Tq && t4 == 0) {
      m_out[q_row0 + row] = m_run[r];
      l_out[q_row0 + row] = l_run[r];
    }
  }
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    const int row = q0 + r0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t4 + (i & 1);
    if (row < Tq && col < D) acc_out[(q_row0 + row) * D + col] = o[i];
  }
}

template <int kD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* m_in,
                   const float* l_in, const float* acc_in, float* m_out, float* l_out,
                   float* acc_out, int BH, int Tq, int Tk, int D, int q_pos0, int k_pos0,
                   int causal, int has_n_valid, int n_valid, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Fold<kD>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fold_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(BH) * ((Tq + Fold<kD>::kBM - 1) / Fold<kD>::kBM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fold_kernel<kD><<<static_cast<unsigned>(blocks), Fold<kD>::kThreads, bytes, stream>>>(
      q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
      has_n_valid, n_valid, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fold on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim outside 1..256 or a negative size.
// q, acc_in, acc_out: [BH, Tq, D]; k, v: [BH, Tk, D]; m_in, l_in, m_out,
// l_out: [BH, Tq]; all contiguous float32 on the device. n_valid is read
// only when has_n_valid is set. BH == 0 or Tq == 0 launches nothing.
int flash_fold(const void* q, const void* k, const void* v, const void* m_in, const void* l_in,
               const void* acc_in, void* m_out, void* l_out, void* acc_out, int BH, int Tq,
               int Tk, int D, int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid,
               float scale, void* stream) {
  if (BH < 0 || Tq < 0 || Tk < 0 || D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* li = static_cast<const float*>(l_in);
  const auto* ai = static_cast<const float*>(acc_in);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  auto* ao = static_cast<float*>(acc_out);
  cudaError_t err;
  if (D <= 32) {
    err = launch<32>(qf, kf, vf, mi, li, ai, mo, lo, ao, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
                     has_n_valid, n_valid, scale, s);
  } else if (D <= 64) {
    err = launch<64>(qf, kf, vf, mi, li, ai, mo, lo, ao, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
                     has_n_valid, n_valid, scale, s);
  } else if (D <= 128) {
    err = launch<128>(qf, kf, vf, mi, li, ai, mo, lo, ao, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
                      has_n_valid, n_valid, scale, s);
  } else {
    err = launch<256>(qf, kf, vf, mi, li, ai, mo, lo, ao, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
                      has_n_valid, n_valid, scale, s);
  }
  return static_cast<int>(err);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
