// The backward of one ring-attention fold: two kernels, dq and dkv.
//
// Replaces: flink_ml_tpu/parallel/flash.py, _fold_bwd_pallas (line 311): its
// dq kernel (pallas_call at line 463) and its dkv kernel (pallas_call at line
// 499). Both compute the fold's hand-derived VJP, reference_fold_bwd (line
// 268), for every (batch·head) row of Q, with q_pos = q_pos0 + row and
// k_pos = k_pos0 + key:
//   s       = (q · kᵀ) * scale, -inf where the key is masked (causal:
//             q_pos < k_pos; n_valid: k_pos >= n_valid; every key past Tk)
//   B       = max over the keys of s;  new_m = max(m, B)
//   safe    = new_m, or 0 where new_m is -inf
//   P       = exp(s - safe), exactly 0 where s is -inf
//   corr    = exp(m - safe), exactly 0 where m is -inf
//   dP      = dl + dacc · vᵀ
//   dcorr   = dl * l + Σ_d dacc * acc
//   dsafe   = -Σ_k dP * P - dcorr * corr
//   dnew_m  = dm + (new_m is -inf ? 0 : dsafe)
//   take_m  = 1, 0.5 or 0 for m >, ==, < B (jnp.maximum's split)
//   cnt     = max(number of keys with s == B and s > -inf, 1)
//   dbc     = dnew_m * (1 - take_m) / cnt
//   ds      = dP * P + (s == B and s > -inf ? dbc : 0)
//   dq      = (ds · k) * scale          dk = (dsᵀ · q) * scale
//   dv      = Pᵀ · dacc                 dm_in = (m is -inf ? 0 : dcorr * corr) + dnew_m * take_m
//   dl_in   = dl * corr                 dacc_in = dacc * corr
// All float32.
//
// The dq kernel owns query rows, the dkv kernel keys. The TPU dq kernel holds
// a head's whole K/V block and a [64, Tk] score tile in VMEM; a Hopper block
// has 227 KB, so here each kernel streams the other side through shared
// memory a tile at a time. dq needs dsafe = -Σ dP·P before any key's ds is
// known, so it writes dq = scale · (Σ_k dP·P·k + dbc · Σ_{k: s = B} k):
//   pass 1 over the key tiles: the row's block max B and the count of keys
//          equal to it;
//   pass 2 over the same tiles: Σ dP·P, and the two vector sums, the second
//          only over the tiles that hold one of the row's max keys.
// It then writes dq, dm_in, dl_in, dacc_in and each row's safe, B and dbc.
// The dkv kernel stages its key tile once and streams every query tile that
// can attend one of its keys: it recomputes s and dP, forms P and ds from the
// dq kernel's safe, B and dbc, and accumulates dk and dv in registers.
//
// The score is bit-identical in every pass of both kernels, as the dkv
// kernel's s == B needs (a missed max key would lose dB, of the order of the
// whole row on a first fold): one device function, score_tile, computes it as
// one fmaf per d in order 0 … kD-1 from 0.0f, then one __fmul_rn by the scale
// (never contracted). Which thread computes a pair does not change its bits.
//
// Bound: operations. Per attendable (query, key) pair the VJP needs 6·D
// operations for dq (q·kᵀ, dacc·vᵀ, ds·k) and 8·D for dk and dv (q·kᵀ,
// dacc·vᵀ, dsᵀ·q, Pᵀ·dacc), float32 FMAs outside the tensor cores: at B 1,
// H 4, T 8192, D 128 that is 206 G and 275 G operations, 3.08 and 4.10 ms at
// the H100's 67 TFLOP/s (half each under causal). The dq kernel does 8·D (its
// first pass recomputes q·kᵀ), so at best it takes 4/3 of its bound.
//
// Tiles: kBM query rows by kBN keys (64 x 64 up to kD 128, 32 x 32 at kD 256,
// where each thread's two accumulators would otherwise pass 255 registers),
// 256 threads as 16 x 16. In a score tile a thread holds rows ty + 16·i and
// keys tx + 16·j; its accumulators hold rows (dq) or keys (dkv) ty + 16·i and
// the columns out_col(tx, c). Staged tiles are [rows][kD + 4] floats, so the
// float4 reads of 8 lanes fall in 8 distinct bank groups. Shared memory:
// 4·(2·kBM·(kD+4) + 2·kBN·(kD+4) + 2·kBM·kBN) bytes (+ 4·kBM in the dq
// kernel): 167,936 at kD 128 (one block an SM), 102,400 at kD 64 (two),
// 141,312 at kD 256. Tiles that the causal or n_valid mask covers wholly are
// never loaded.
//
// Exact edges: a row with no attendable key gets dq exactly 0, dl_in = dl *
// corr and dacc_in = dacc * corr bit for bit (corr is 1 for a finite m, 0 for
// -inf), and dm_in = dm * 0.5 exactly when m is -inf (jnp.maximum's split of
// -inf against -inf); a key that no query attends gets dk = dv = 0 exactly.
// The rest sums in another order than the plain version and agrees within a
// float32 tolerance.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kLanes = 16;     // threads that share a row of a score tile

template <int kD>
struct Tiles {
  static constexpr int kBM = kD <= 128 ? 64 : 32;  // query rows per tile
  static constexpr int kBN = kD <= 128 ? 64 : 32;  // keys per tile
  static constexpr int kRI = kBM / 16;             // score-tile rows per thread
  static constexpr int kRJ = kBN / 16;             // score-tile keys per thread
  static constexpr int kLd = kD + 4;               // row stride of a staged tile
  static constexpr int kDC = kD / kLanes;          // accumulator columns per thread
  static constexpr size_t kTileBytes =
      sizeof(float) * (2 * static_cast<size_t>(kBM) * kLd + 2 * static_cast<size_t>(kBN) * kLd +
                       2 * static_cast<size_t>(kBM) * kBN);
  static constexpr size_t kDqBytes = kTileBytes + sizeof(int) * kBM;
  static constexpr size_t kDkvBytes = kTileBytes;
};
static_assert(Tiles<128>::kDqBytes <= 232448, "the kD 128 tiles fit one block's shared memory");
static_assert(Tiles<256>::kDqBytes <= 232448, "the kD 256 tiles fit one block's shared memory");

// The output column of a thread's c-th accumulator (as in flash_fold.cu):
// 64-column chunks of one float4 per lane from kD 64 on, neighbours below.
template <int kD>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int kDC = kD / kLanes;
  if constexpr (kDC >= 4) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else {
    return tx * kDC + c;
  }
}

// A thread's kDC columns of one staged row.
template <int kD>
__device__ __forceinline__ void load_cols(float (&out)[kD / kLanes], const float* row, int tx) {
  constexpr int kDC = kD / kLanes;
  if constexpr (kDC >= 4) {
#pragma unroll
    for (int c4 = 0; c4 < kDC / 4; ++c4) {
      const float4 w = *reinterpret_cast<const float4*>(row + c4 * 64 + tx * 4);
      out[c4 * 4 + 0] = w.x;
      out[c4 * 4 + 1] = w.y;
      out[c4 * 4 + 2] = w.z;
      out[c4 * 4 + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kDC; ++c) out[c] = row[tx * kDC + c];
  }
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// rows [0, kRows) of a [*, D] matrix from `src` into a [kRows][kD + 4] tile,
// zero past n_rows and past D.
template <int kRows, int kD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n_rows, int D,
                                      int tid) {
  constexpr int kLd = kD + 4;
  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    dst[r * kLd + d] = (r < n_rows && d < D) ? __ldg(src + static_cast<size_t>(r) * D + d) : 0.0f;
  }
}

// out[i][j] = Σ_d a[ty + 16 i][d] · b[tx + 16 j][d] over staged tiles: one
// fmaf per d, in order 0 … kD-1, from 0.0f. Every caller gets the same bits
// for the same pair of rows, whichever thread computes it.
template <int kD, int kRI, int kRJ>
__device__ __forceinline__ void dot_tile(float (&out)[kRI][kRJ], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int kLd = kD + 4;
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 av[kRI], bv[kRJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < kRJ; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        float acc = out[i][j];
        acc = fmaf(av[i].x, bv[j].x, acc);
        acc = fmaf(av[i].y, bv[j].y, acc);
        acc = fmaf(av[i].z, bv[j].z, acc);
        acc = fmaf(av[i].w, bv[j].w, acc);
        out[i][j] = acc;
      }
  }
}

// The score tile: q·kᵀ by dot_tile, then scaled by one __fmul_rn (which the
// compiler never fuses into a neighbouring add), -inf where masked. Both
// kernels call this, so s == B finds the same keys in each.
template <int kD, int kRI, int kRJ>
__device__ __forceinline__ void score_tile(float (&s)[kRI][kRJ], const float* qs, const float* ks,
                                           int ty, int tx, float scale, const bool (&keep)[kRI][kRJ]) {
  const float kNegInf = __int_as_float(0xff800000);
  dot_tile<kD, kRI, kRJ>(s, qs, ks, ty, tx);
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j) s[i][j] = keep[i][j] ? __fmul_rn(s[i][j], scale) : kNegInf;
}

// Whether (query row, key) attend: both in range, n_valid and causal.
__device__ __forceinline__ bool attends(long long row, long long key, int Tq, long long mask_end,
                                        int causal, int q_pos0, int k_pos0) {
  return row < Tq && key < mask_end &&
         (!causal || static_cast<long long>(q_pos0) + row >= static_cast<long long>(k_pos0) + key);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
fold_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, const float* __restrict__ acc_in,
                   const float* __restrict__ dm, const float* __restrict__ dl,
                   const float* __restrict__ dacc, float* __restrict__ dq_out,
                   float* __restrict__ dm_out, float* __restrict__ dl_out,
                   float* __restrict__ dacc_out, float* __restrict__ safe_out,
                   float* __restrict__ bmax_out, float* __restrict__ dbc_out, int BH, int Tq, int Tk,
                   int D, int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid,
                   float scale) {
  using T = Tiles<kD>;
  constexpr int kBM = T::kBM, kBN = T::kBN, kRI = T::kRI, kRJ = T::kRJ, kLd = T::kLd, kDC = T::kDC;
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;              // [kBM][kLd] Q
  float* const das = qs + kBM * kLd;   // [kBM][kLd] dacc
  float* const ks = das + kBM * kLd;   // [kBN][kLd] K
  float* const vs = ks + kBN * kLd;    // [kBN][kLd] V
  float* const ws = vs + kBN * kLd;    // [kBM][kBN] dP·P
  float* const xs = ws + kBM * kBN;    // [kBM][kBN] 1 where the key is the row's max
  int* const hits = reinterpret_cast<int*>(xs + kBM * kBN);  // [kBM] a max key in this tile

  const int n_qt = (Tq + kBM - 1) / kBM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kBM;  // reverse: causal's longest rows first
  const int tid = threadIdx.x, tx = tid % kLanes, ty = tid / kLanes;
  const size_t q_row0 = static_cast<size_t>(bh) * Tq + q0;
  const size_t k_row0 = static_cast<size_t>(bh) * Tk;
  const int n_rows = min(kBM, Tq - q0);

  stage<kBM, kD>(qs, q + q_row0 * D, n_rows, D, tid);
  stage<kBM, kD>(das, dacc + q_row0 * D, n_rows, D, tid);

  long long mask_end = Tk;  // keys from here on are masked for every row
  if (has_n_valid) mask_end = min(mask_end, static_cast<long long>(n_valid) - k_pos0);
  long long key_end = mask_end;
  if (causal) key_end = min(key_end, static_cast<long long>(q_pos0) + q0 + n_rows - 1 - k_pos0 + 1);
  const int n_kt = key_end > 0 ? static_cast<int>((key_end + kBN - 1) / kBN) : 0;
  __syncthreads();  // Q and dacc staged

  // Row scalars of this thread's rows ty + 16 i, and dcorr = dl·l + Σ dacc·acc.
  float m_r[kRI], dl_r[kRI], dcorr[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const bool valid = r < n_rows;
    m_r[i] = valid ? __ldg(m_in + q_row0 + r) : kNegInf;
    dl_r[i] = valid ? __ldg(dl + q_row0 + r) : 0.0f;
    float part = 0.0f;
    if (valid)
      for (int d = tx; d < D; d += kLanes)
        part = fmaf(das[r * kLd + d], __ldg(acc_in + (q_row0 + r) * D + d), part);
    part = row_sum(part);
    dcorr[i] = valid ? dl_r[i] * __ldg(l_in + q_row0 + r) + part : 0.0f;
  }

  // Pass 1: each row's block max and the count of keys equal to it.
  float bmax[kRI], cnt[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) bmax[i] = kNegInf, cnt[i] = 0.0f;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile is consumed
    stage<kBN, kD>(ks, k + (k_row0 + k0) * D, min(kBN, Tk - k0), D, tid);
    __syncthreads();
    bool keep[kRI][kRJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        keep[i][j] = attends(q0 + ty + 16 * i, k0 + tx + 16 * j, Tq, mask_end, causal, q_pos0, k_pos0);
    float s[kRI][kRJ];
    score_tile<kD, kRI, kRJ>(s, qs, ks, ty, tx, scale, keep);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kRJ; ++j) tmax = fmaxf(tmax, s[i][j]);
      tmax = row_max(tmax);
      float c = 0.0f;
#pragma unroll
      for (int j = 0; j < kRJ; ++j) c += (s[i][j] == tmax && tmax != kNegInf) ? 1.0f : 0.0f;
      c = row_sum(c);
      if (tmax > bmax[i]) {
        bmax[i] = tmax;
        cnt[i] = c;
      } else if (tmax == bmax[i] && tmax != kNegInf) {
        cnt[i] += c;
      }
    }
  }

  float safe[kRI], corr[kRI], take[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const float new_m = fmaxf(m_r[i], bmax[i]);
    safe[i] = new_m == kNegInf ? 0.0f : new_m;
    corr[i] = m_r[i] == kNegInf ? 0.0f : expf(m_r[i] - safe[i]);
    take[i] = m_r[i] > bmax[i] ? 1.0f : m_r[i] == bmax[i] ? 0.5f : 0.0f;
  }

  // Pass 2: Σ dP·P, Σ dP·P·k and Σ_{s = B} k.
  float dpp[kRI], acc1[kRI][kDC], acc2[kRI][kDC];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    dpp[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc1[i][c] = 0.0f, acc2[i][c] = 0.0f;
  }
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile is consumed
    if (tid < kBM) hits[tid] = 0;
    stage<kBN, kD>(ks, k + (k_row0 + k0) * D, min(kBN, Tk - k0), D, tid);
    stage<kBN, kD>(vs, v + (k_row0 + k0) * D, min(kBN, Tk - k0), D, tid);
    __syncthreads();
    bool keep[kRI][kRJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        keep[i][j] = attends(q0 + ty + 16 * i, k0 + tx + 16 * j, Tq, mask_end, causal, q_pos0, k_pos0);
    float s[kRI][kRJ], dpv[kRI][kRJ];
    score_tile<kD, kRI, kRJ>(s, qs, ks, ty, tx, scale, keep);
    dot_tile<kD, kRI, kRJ>(dpv, das, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + 16 * i;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        const float p = s[i][j] == kNegInf ? 0.0f : expf(s[i][j] - safe[i]);
        const float w = (dl_r[i] + dpv[i][j]) * p;
        const bool is_max = s[i][j] == bmax[i] && s[i][j] != kNegInf;
        dpp[i] += w;
        ws[r * kBN + tx + 16 * j] = w;
        xs[r * kBN + tx + 16 * j] = is_max ? 1.0f : 0.0f;
        hit |= is_max;
      }
      if (hit) hits[r] = 1;
    }
    __syncthreads();
    // acc1 += (dP·P) · K over this tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBN; ++kk) {
      float kv[kDC];
      load_cols<kD>(kv, ks + kk * kLd, tx);
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float w = ws[(ty + 16 * i) * kBN + kk];
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc1[i][c] = fmaf(w, kv[c], acc1[i][c]);
      }
    }
    // acc2 += Σ k over the row's max keys, in the tiles that hold one
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + 16 * i;
      if (!hits[r]) continue;
      for (int kk = 0; kk < kBN; ++kk) {
        if (xs[r * kBN + kk] == 0.0f) continue;
        float kv[kDC];
        load_cols<kD>(kv, ks + kk * kLd, tx);
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc2[i][c] += kv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const float dpp_row = row_sum(dpp[i]);
    if (r >= n_rows) continue;
    const bool new_m_inf = fmaxf(m_r[i], bmax[i]) == kNegInf;
    const float dsafe = -dpp_row - dcorr[i] * corr[i];
    const float dnew = __ldg(dm + q_row0 + r) + (new_m_inf ? 0.0f : dsafe);
    const float dbc = dnew * (1.0f - take[i]) / fmaxf(cnt[i], 1.0f);
    if (tx == 0) {
      dm_out[q_row0 + r] = (m_r[i] == kNegInf ? 0.0f : dcorr[i] * corr[i]) + dnew * take[i];
      dl_out[q_row0 + r] = dl_r[i] * corr[i];
      safe_out[q_row0 + r] = safe[i];
      bmax_out[q_row0 + r] = bmax[i];
      dbc_out[q_row0 + r] = dbc;
    }
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = out_col<kD>(tx, c);
      if (col < D) {
        dq_out[(q_row0 + r) * D + col] = (acc1[i][c] + dbc * acc2[i][c]) * scale;
        dacc_out[(q_row0 + r) * D + col] = das[r * kLd + col] * corr[i];
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
fold_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dl,
                    const float* __restrict__ dacc, const float* __restrict__ safe,
                    const float* __restrict__ bmax, const float* __restrict__ dbc,
                    float* __restrict__ dk_out, float* __restrict__ dv_out, int BH, int Tq, int Tk,
                    int D, int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid,
                    float scale) {
  using T = Tiles<kD>;
  constexpr int kBM = T::kBM, kBN = T::kBN, kRI = T::kRI, kRJ = T::kRJ, kLd = T::kLd, kDC = T::kDC;
  constexpr int kKJ = kBN / 16;  // accumulator keys per thread
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;              // [kBN][kLd] K
  float* const vs = ks + kBN * kLd;    // [kBN][kLd] V
  float* const qs = vs + kBN * kLd;    // [kBM][kLd] Q
  float* const das = qs + kBM * kLd;   // [kBM][kLd] dacc
  float* const ps = das + kBM * kLd;   // [kBM][kBN] P
  float* const dss = ps + kBM * kBN;   // [kBM][kBN] ds

  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * kBN;
  const int tid = threadIdx.x, tx = tid % kLanes, ty = tid / kLanes;
  const size_t q_row0 = static_cast<size_t>(bh) * Tq;
  const size_t k_row0 = static_cast<size_t>(bh) * Tk + k0;
  const int n_keys = min(kBN, Tk - k0);

  stage<kBN, kD>(ks, k + k_row0 * D, n_keys, D, tid);
  stage<kBN, kD>(vs, v + k_row0 * D, n_keys, D, tid);

  // The query tiles that can attend a key of this block: none past the
  // n_valid mask; under causal, from the first row at or after the block's
  // first key.
  long long mask_end = Tk;
  if (has_n_valid) mask_end = min(mask_end, static_cast<long long>(n_valid) - k_pos0);
  const int n_qt = (Tq + kBM - 1) / kBM;
  int qt_begin = 0, qt_end = k0 < mask_end ? n_qt : 0;
  if (causal) {
    const long long row_start =
        max(0LL, static_cast<long long>(k_pos0) + k0 - static_cast<long long>(q_pos0));
    qt_begin = row_start >= Tq ? qt_end : static_cast<int>(row_start / kBM);
  }

  float dk[kKJ][kDC], dv[kKJ][kDC];
#pragma unroll
  for (int jj = 0; jj < kKJ; ++jj)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dk[jj][c] = 0.0f, dv[jj][c] = 0.0f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kBM;
    const int n_rows = min(kBM, Tq - q0);
    __syncthreads();  // the previous tile is consumed (and K, V staged)
    stage<kBM, kD>(qs, q + (q_row0 + q0) * D, n_rows, D, tid);
    stage<kBM, kD>(das, dacc + (q_row0 + q0) * D, n_rows, D, tid);
    __syncthreads();
    bool keep[kRI][kRJ];
    float safe_r[kRI], bmax_r[kRI], dbc_r[kRI], dl_r[kRI];
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + 16 * i;
      const bool valid = r < n_rows;
      safe_r[i] = valid ? __ldg(safe + q_row0 + q0 + r) : 0.0f;
      bmax_r[i] = valid ? __ldg(bmax + q_row0 + q0 + r) : kNegInf;
      dbc_r[i] = valid ? __ldg(dbc + q_row0 + q0 + r) : 0.0f;
      dl_r[i] = valid ? __ldg(dl + q_row0 + q0 + r) : 0.0f;
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        keep[i][j] = attends(q0 + r, k0 + tx + 16 * j, Tq, mask_end, causal, q_pos0, k_pos0);
    }
    float s[kRI][kRJ], dpv[kRI][kRJ];
    score_tile<kD, kRI, kRJ>(s, qs, ks, ty, tx, scale, keep);
    dot_tile<kD, kRI, kRJ>(dpv, das, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        const float p = s[i][j] == kNegInf ? 0.0f : expf(s[i][j] - safe_r[i]);
        const bool is_max = s[i][j] == bmax_r[i] && s[i][j] != kNegInf;
        ps[r * kBN + tx + 16 * j] = p;
        dss[r * kBN + tx + 16 * j] = (dl_r[i] + dpv[i][j]) * p + (is_max ? dbc_r[i] : 0.0f);
      }
    }
    __syncthreads();
    // dk += dsᵀ · Q and dv += Pᵀ · dacc over this tile's rows
#pragma unroll 2
    for (int r = 0; r < kBM; ++r) {
      float qv[kDC], dav[kDC];
      load_cols<kD>(qv, qs + r * kLd, tx);
      load_cols<kD>(dav, das + r * kLd, tx);
#pragma unroll
      for (int jj = 0; jj < kKJ; ++jj) {
        const float dsv = dss[r * kBN + ty + 16 * jj];
        const float pv = ps[r * kBN + ty + 16 * jj];
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          dk[jj][c] = fmaf(dsv, qv[c], dk[jj][c]);
          dv[jj][c] = fmaf(pv, dav[c], dv[jj][c]);
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < kKJ; ++jj) {
    const int key = ty + 16 * jj;
    if (key >= n_keys) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = out_col<kD>(tx, c);
      if (col < D) {
        dk_out[(k_row0 + key) * D + col] = dk[jj][c] * scale;
        dv_out[(k_row0 + key) * D + col] = dv[jj][c];
      }
    }
  }
}

template <int kD>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* m_in,
                      const float* l_in, const float* acc_in, const float* dm, const float* dl,
                      const float* dacc, float* dq, float* dm_out, float* dl_out, float* dacc_out,
                      float* safe, float* bmax, float* dbc, int BH, int Tq, int Tk, int D,
                      int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid, float scale,
                      cudaStream_t stream) {
  constexpr size_t bytes = Tiles<kD>::kDqBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      fold_bwd_dq_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(BH) * ((Tq + Tiles<kD>::kBM - 1) / Tiles<kD>::kBM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  fold_bwd_dq_kernel<kD><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      q, k, v, m_in, l_in, acc_in, dm, dl, dacc, dq, dm_out, dl_out, dacc_out, safe, bmax, dbc, BH,
      Tq, Tk, D, q_pos0, k_pos0, causal, has_n_valid, n_valid, scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dl,
                       const float* dacc, const float* safe, const float* bmax, const float* dbc,
                       float* dk, float* dv, int BH, int Tq, int Tk, int D, int q_pos0, int k_pos0,
                       int causal, int has_n_valid, int n_valid, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Tiles<kD>::kDkvBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      fold_bwd_dkv_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(BH) * ((Tk + Tiles<kD>::kBN - 1) / Tiles<kD>::kBN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  fold_bwd_dkv_kernel<kD><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      q, k, v, dl, dacc, safe, bmax, dbc, dk, dv, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
      has_n_valid, n_valid, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dq kernel on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim outside 1..256 or a negative size.
// q, acc, dacc, dq, dacc_out: [BH, Tq, D]; k, v: [BH, Tk, D]; m, l, dm, dl,
// dm_out, dl_out, safe, bmax, dbc: [BH, Tq]; all contiguous float32 on the
// device. n_valid is read only when has_n_valid is set. BH == 0 or Tq == 0
// launches nothing.
int flash_fold_bwd_dq(const void* q, const void* k, const void* v, const void* m, const void* l,
                      const void* acc, const void* dm, const void* dl, const void* dacc, void* dq,
                      void* dm_out, void* dl_out, void* dacc_out, void* safe, void* bmax,
                      void* dbc, int BH, int Tq, int Tk, int D, int q_pos0, int k_pos0, int causal,
                      int has_n_valid, int n_valid, float scale, void* stream) {
  if (BH < 0 || Tq < 0 || Tk < 0 || D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
#define FLASH_BWD_DQ(KD)                                                                         \
  launch_dq<KD>(f(q), f(k), f(v), f(m), f(l), f(acc), f(dm), f(dl), f(dacc), o(dq), o(dm_out),   \
                o(dl_out), o(dacc_out), o(safe), o(bmax), o(dbc), BH, Tq, Tk, D, q_pos0, k_pos0, \
                causal, has_n_valid, n_valid, scale, s)
  cudaError_t err;
  if (D <= 16) {
    err = FLASH_BWD_DQ(16);
  } else if (D <= 32) {
    err = FLASH_BWD_DQ(32);
  } else if (D <= 64) {
    err = FLASH_BWD_DQ(64);
  } else if (D <= 128) {
    err = FLASH_BWD_DQ(128);
  } else {
    err = FLASH_BWD_DQ(256);
  }
#undef FLASH_BWD_DQ
  return static_cast<int>(err);
}

// The dkv kernel on `stream`, after the dq kernel has written safe, bmax and
// dbc; returns as flash_fold_bwd_dq. dk, dv: [BH, Tk, D]. BH == 0 or Tk == 0
// launches nothing; Tq == 0 writes zeros.
int flash_fold_bwd_dkv(const void* q, const void* k, const void* v, const void* dl,
                       const void* dacc, const void* safe, const void* bmax, const void* dbc,
                       void* dk, void* dv, int BH, int Tq, int Tk, int D, int q_pos0, int k_pos0,
                       int causal, int has_n_valid, int n_valid, float scale, void* stream) {
  if (BH < 0 || Tq < 0 || Tk < 0 || D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Tk == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
#define FLASH_BWD_DKV(KD)                                                                      \
  launch_dkv<KD>(f(q), f(k), f(v), f(dl), f(dacc), f(safe), f(bmax), f(dbc), o(dk), o(dv), BH, \
                 Tq, Tk, D, q_pos0, k_pos0, causal, has_n_valid, n_valid, scale, s)
  cudaError_t err;
  if (D <= 16) {
    err = FLASH_BWD_DKV(16);
  } else if (D <= 32) {
    err = FLASH_BWD_DKV(32);
  } else if (D <= 64) {
    err = FLASH_BWD_DKV(64);
  } else if (D <= 128) {
    err = FLASH_BWD_DKV(128);
  } else {
    err = FLASH_BWD_DKV(256);
  }
#undef FLASH_BWD_DKV
  return static_cast<int>(err);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
