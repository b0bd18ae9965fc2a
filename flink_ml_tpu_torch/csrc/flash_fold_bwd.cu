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
// All float32 in and out.
//
// The dq kernel owns query rows, the dkv kernel keys; neither uses atomics,
// so both are bit-stable from run to run. The dq kernel hands each row's
// safe, B and dbc to the dkv kernel. dq needs dsafe = -Σ dP·P before any
// key's ds is known, so it writes dq = scale · (Σ_k dP·P·k + dbc · Σ_{s = B} k)
// from one pass over the key tiles, as an online softmax does: each row keeps
// its running block max b, the count of keys equal to it and their indices
// (both reset when b grows), and a running reference R = max(m, b), seeded
// with the carried m. Σ dP·P (in float64: dsafe is a difference in it) and
// Σ dP·P·k are summed against exp(s - R) and rescaled by exp(R_old - R_new)
// when R grows; where m already bounds the block (a later fold of a ring)
// nothing is rescaled. At the end R is safe, and dbc times the sum of the max
// keys, read back by their indices, is added once. A row with more exact ties
// than its 32 index slots (a token repeated that often) is summed again by a
// second walk of the key tiles that forms ds key by key, as the dkv kernel
// does: where many keys are equal, Σ dP·P·k and dbc · Σ k are each about
// cnt times dq and their roundings would not cancel. Only a block with such
// a row walks again, and only its warps that hold one compute; a token
// repeated a few hundred times (a classifier's signal token) sends about one
// block in eleven there. The dkv kernel stages its key
// tile once and streams every query tile that can attend one of its keys: it
// recomputes s and dP, forms P and ds from the dq kernel's safe, B and dbc,
// and accumulates dk and dv in registers.
//
// Bound: operations. Per attendable (query, key) pair the VJP needs 6·D
// operations for dq (q·kᵀ, dacc·vᵀ, ds·k; a multiply and an add each) and
// 8·D for dk and dv (q·kᵀ, dacc·vᵀ, dsᵀ·q, Pᵀ·dacc). Every product runs on
// the tensor cores as mma.sync.m16n8k8 in 3×TF32: each float32 operand is
// split in registers, at each use, into a TF32 hi and the rest lo, and a
// product is lo·hi + hi·lo + hi·hi, accumulated in float32 (one TF32 pass
// keeps about three decimal digits; three keep about float32's). That is 3×
// the operations at the H100's 495 TFLOP/s dense TF32: at B 1, H 4, T 8192,
// D 128, 618.5 G and 824.6 G TF32 operations, a bound of 1.250 and 1.666 ms
// (half each under causal); the same work as float32 FMAs on the CUDA cores
// would take 3.077 and 4.103 ms at 67 TFLOP/s. The split is made where it is
// used rather than once at staging: hi and lo of every staged tile would
// double the shared memory and leave one block an SM. The tensor cores'
// float32 accumulation is not specified to round to nearest, so sums run in
// short stretches inside the MMA (32 columns of a score, one streamed tile
// of a gradient) that are then added in float32. P is expf (not __expf), as
// in the forward fold.
//
// The score is bit-identical in both kernels, as the dkv kernel's s == B
// needs (a missed max key would lose dB, of the order of the whole row on a
// first fold): one device function, product_tiles, computes it. The dq kernel
// forms S = Q·Kᵀ (queries as the MMA's rows), the dkv kernel Sᵀ = K·Qᵀ (keys
// as rows, so that P and ds are already the A operand of Pᵀ·dacc and
// dsᵀ·q): each element is the same products of the same split operands at
// the same k positions, issued in the same order (the kSwap flag swaps the
// two cross terms with the operands), summed from 0 in the same stretches,
// then one __fmul_rn by the scale (never contracted).
//
// Tiles and what they do about the card: each block owns kOwn = 64 rows (dq:
// queries; dkv: keys) as four warps of 16, holds them in shared memory, and
// streams the other side in tiles of kStream = 16 rows through two stages of
// 16-byte cp.async copies (4-byte ones where D is not a multiple of 4 or a
// pointer is not 16-byte aligned): the next tile is in flight while this one
// computes. Staged rows are [kD + 4] floats, so the eight 16-byte rows of
// each ldmatrix (a score product's fragments) and the scalar loads of rows
// 2t and 2t + 1 at column g (the gradients' B fragments) hit 32 distinct
// banks. A warp's C fragments of S or
// Sᵀ are, with the k index permuted (position t holds element 2t, position
// t + 4 element 2t + 1), the A fragments of the next product, so P, ds and
// dP·P never go through shared memory. Shared memory: 4·(kD + 4)·(2·64 +
// 2·2·16) bytes, + 8,192 for the dq kernel's max-key slots, + 512 for the dkv
// kernel's row quantities: 109,568 / 101,888 at kD 128, two blocks an SM. At
// kD 256 two warps share each 16 rows, each accumulating half of the columns
// (the accumulators would otherwise pass 255 registers): eight warps,
// 207,872 / 200,192 bytes, one block an SM. Tiles that the causal or n_valid
// mask covers wholly are never loaded, and under causal the blocks with the
// longest rows (dq: the last queries; dkv: the first keys) start first.
//
// Exact edges: a row with no attendable key gets dq exactly 0, dl_in = dl *
// corr and dacc_in = dacc * corr bit for bit (corr is 1 for a finite m, 0 for
// -inf), and dm_in = dm * 0.5 exactly when m is -inf (jnp.maximum's split of
// -inf against -inf); a key that no query attends gets dk = dv = 0 exactly
// (its P and ds are exactly 0, and zero-filled padding rows and columns add
// exactly 0). The rest sums in another order than the plain version and
// agrees within a float32 tolerance.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

template <int kD>
struct Tiles {
  static constexpr int kSplit = kD > 128 ? 2 : 1;  // warps that share 16 owned rows
  static constexpr int kOwn = 64;                  // owned rows a block (dq: queries, dkv: keys)
  static constexpr int kStream = 16;               // rows of a streamed tile (dq: keys, dkv: queries)
  static constexpr int kWarps = kOwn / 16 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = kD + 4;          // row stride of a staged tile, in floats
  static constexpr int kNT = kStream / 8;     // 8-wide column tiles of a score tile
  static constexpr int kCols = kD / kSplit;   // output columns a warp accumulates
  static constexpr int kDT = kCols / 8;       // 8-wide column tiles of those
  static constexpr int kMaxKeys = 32;         // dq: slots for the indices of a row's max keys
  static constexpr size_t kRowBytes = sizeof(float) * kLd;
  static constexpr size_t kTileBytes = kRowBytes * (2 * kOwn + 2 * 2 * kStream);
  static constexpr size_t kDqBytes = kTileBytes + sizeof(int) * kOwn * kMaxKeys;
  static constexpr size_t kDkvBytes = kTileBytes + sizeof(float) * 2 * 4 * kStream;
};
static_assert(Tiles<128>::kDqBytes <= 113 * 1024 && Tiles<128>::kDkvBytes <= 113 * 1024,
              "two blocks an SM at kD 128");
static_assert(Tiles<256>::kDqBytes <= 232448 && Tiles<256>::kDkvBytes <= 232448,
              "the kD 256 tiles fit one block's shared memory");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// rows [0, kRows) of a [*, D] matrix from `src` into a staged [kRows][kD + 4]
// tile, zero past n_rows and past D, by cp.async (not waited for here).
template <int kRows, int kD, int kThreads>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n_rows, int D,
                                      bool vec, int tid) {
  constexpr int kLd = kD + 4;
  if (vec) {  // D % 4 == 0 and 16-byte aligned rows: each thread one 16-byte column chunk, every kStep rows
    constexpr int kChunks = kD / 4;
    static_assert(kThreads % kChunks == 0, "a thread keeps its column chunk");
    constexpr int kStep = kThreads / kChunks;
    const int c = tid % kChunks * 4, r0 = tid / kChunks;
#pragma unroll
    for (int m = 0; m < (kRows + kStep - 1) / kStep; ++m) {
      const int r = r0 + m * kStep;
      if (r < kRows) {
        const bool in = r < n_rows && c < D;
        cp_async16(dst + r * kLd + c, in ? src + static_cast<size_t>(r) * D + c : src, in ? 16 : 0);
      }
    }
  } else {
    for (int i = tid; i < kRows * kD; i += kThreads) {
      const int r = i / kD, c = i % kD;
      const bool in = r < n_rows && c < D;
      cp_async4(dst + r * kLd + c, in ? src + static_cast<size_t>(r) * D + c : src, in ? 4 : 0);
    }
  }
}

// x = hi + lo to about float32's precision, each a TF32 operand: hi is x
// with its low 13 mantissa bits cleared (a TF32 value), lo = x - hi exactly;
// the tensor cores read lo's top 11 significant bits. Two instructions,
// where cvt.rna for both halves takes more: the split is most of the ALU
// work of these kernels (PERF.md).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x as the tensor cores read it after split(): hi plus lo without its low
// 13 bits (exact in float32: 22 significant bits at most).
__device__ __forceinline__ float as_split(float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  return __uint_as_float(hi) + __uint_as_float(lo & 0xffffe000u);
}

// c += a · b on the tensor cores: a 16 x 8 A fragment, an 8 x 8 B fragment.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b in 3×TF32 (lo·hi, hi·lo, hi·hi).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, each lane
// giving the address of one row (lane i: row i % 8 of matrix i / 8): for
// 32-bit data, register m of lane (g, t) holds float t of row g of matrix m,
// an MMA fragment's layout.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc[p][j] = the 16 x 8 tile a[p][0..16) · b[p][8j..8j+8)ᵀ over kD columns
// of staged rows, for kN products at once, as C fragments: element e of
// lane (g, t) is row g + 8·(e / 2), column 2t + e % 2. Per 8-column k-step,
// one ldmatrix.x4 loads a product's A fragment and one the B fragments of
// two column tiles; the next k-step's fragments are loaded before this
// one's MMAs issue, and the kN products' MMAs interleave, so the tensor
// cores have independent work while the loads are in flight. 3×TF32 per
// k-step: lo·hi, hi·lo, hi·hi of the (a, b) pair; with kSwap, a holds the
// keys and b the queries, and the two cross terms go in the other order, so
// that S and Sᵀ add the same products in the same order. Sums run inside
// the MMA over 32 columns at a time and are added in float32. A product's
// bits do not depend on kN or on what it is computed beside.
template <int kD, int kNT, bool kSwap, int kN>
__device__ __forceinline__ void product_tiles(float (&acc)[kN][kNT][4], const float* const (&a)[kN],
                                              const float* const (&b)[kN], int lane) {
  constexpr int kLd = kD + 4, kSteps = kD / 8, kPairs = kNT / 2;
  static_assert(kNT % 2 == 0, "B fragments load two column tiles at a time");
  const int m = lane >> 3, r = lane & 7;
  const int a_off = (r + 8 * (m & 1)) * kLd + 4 * (m >> 1);  // a0: rows 0-7, a1: rows 8-15; a2, a3: +4 columns
  const int b_off = (r + 8 * (m >> 1)) * kLd + 4 * (m & 1);  // b0, b1 of tile 2jj; then those of 2jj + 1
  uint32_t ar[2][kN][4], br[2][kN][kPairs][4];  // [k-step parity]: this k-step's and the next one's
  const auto load = [&](int step, int buf) {
#pragma unroll
    for (int p = 0; p < kN; ++p) {
      ldsm4(ar[buf][p], a[p] + a_off + 8 * step);
#pragma unroll
      for (int jj = 0; jj < kPairs; ++jj) ldsm4(br[buf][p][jj], b[p] + b_off + 16 * jj * kLd + 8 * step);
    }
  };
  float part[kN][kNT][4];
#pragma unroll
  for (int p = 0; p < kN; ++p)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.0f;
  load(0, 0);
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int cur = step & 1;
    if (step + 1 < kSteps) load(step + 1, cur ^ 1);
    if (step % 4 == 0) {
#pragma unroll
      for (int p = 0; p < kN; ++p)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[p][j][e] = 0.0f;
    }
#pragma unroll
    for (int p = 0; p < kN; ++p) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) split(__uint_as_float(ar[cur][p][x]), ah[x], al[x]);
#pragma unroll
      for (int jj = 0; jj < kPairs; ++jj) {
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(__uint_as_float(br[cur][p][jj][x]), bh[x], bl[x]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float (&c)[4] = part[p][2 * jj + h];
          if (kSwap) {
            mma(c, ah, bl[2 * h], bl[2 * h + 1]);  // = lo(b)·hi(a): the dq kernel's first term
            mma(c, al, bh[2 * h], bh[2 * h + 1]);
          } else {
            mma(c, al, bh[2 * h], bh[2 * h + 1]);
            mma(c, ah, bl[2 * h], bl[2 * h + 1]);
          }
          mma(c, ah, bh[2 * h], bh[2 * h + 1]);
        }
      }
    }
    if (step % 4 == 3 || step + 1 == kSteps) {
#pragma unroll
      for (int p = 0; p < kN; ++p)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][j][e] += part[p][j][e];
    }
  }
}

// acc += w · B for the warp's output columns [c0, c0 + kDT·8): w as A
// fragments over the kNT·8 rows of a streamed tile (k position t is row
// 8j + 2t, t + 4 row 8j + 2t + 1), B those staged rows (rows 2t and 2t + 1
// at column g: 32 distinct banks). Each column tile's sum over this
// streamed tile is added in float32; element e of lane (g, t) in tile n is
// column c0 + 8n + 2t + e % 2.
template <int kD, int kNT, int kDT>
__device__ __forceinline__ void add_product(float (&acc)[kDT][4], const uint32_t (&wh)[kNT][4],
                                            const uint32_t (&wl)[kNT][4], const float* b, int c0, int g,
                                            int t) {
  constexpr int kLd = kD + 4;
  const float* const bp = b + 2 * t * kLd + c0 + g;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t h0, l0, h1, l1;
      split(bp[8 * j * kLd + 8 * n], h0, l0);
      split(bp[(8 * j + 1) * kLd + 8 * n], h1, l1);
      mma3(part, wh[j], wl[j], h0, h1, l0, l1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// A lane's two neighbouring output columns of column tile n (from
// add_product), and its two values there in row i (0: g, 1: g + 8).
__device__ __forceinline__ int col2(int c0, int n, int t) { return c0 + 8 * n + 2 * t; }

template <int kDT>
__device__ __forceinline__ float2 row2(const float (&acc)[kDT][4], int n, int i) {
  return make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
}

__device__ __forceinline__ float2 scaled(float2 v, float f) { return make_float2(v.x * f, v.y * f); }

// Two neighbouring columns of a [*, D] row from `col` on, those below D.
__device__ __forceinline__ void store2(float* row, int col, float2 v, int D, bool vec) {
  if (vec) {  // D % 4 == 0 and aligned rows: both or neither lie below D
    if (col < D) *reinterpret_cast<float2*>(row + col) = v;
  } else {
    if (col < D) row[col] = v.x;
    if (col + 1 < D) row[col + 1] = v.y;
  }
}

__device__ __forceinline__ float2 load2(const float* __restrict__ row, int col, int D, bool vec) {
  if (vec) return col < D ? __ldg(reinterpret_cast<const float2*>(row + col)) : make_float2(0.0f, 0.0f);
  return make_float2(col < D ? __ldg(row + col) : 0.0f, col + 1 < D ? __ldg(row + col + 1) : 0.0f);
}

// The A fragment position of C fragment element e when the C tile's columns
// become the next product's k index: column 2t at position t, 2t + 1 at t + 4.
__device__ __forceinline__ constexpr int a_pos(int e) { return e == 1 ? 2 : e == 2 ? 1 : e; }

// Max and sum over the four lanes of a quad (the lanes that share a row of
// a C fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Whether (query row, key) attend: both in range, n_valid and causal.
__device__ __forceinline__ bool attends(long long row, long long key, int Tq, long long mask_end,
                                        int causal, int q_pos0, int k_pos0) {
  return row < Tq && key < mask_end &&
         (!causal || static_cast<long long>(q_pos0) + row >= static_cast<long long>(k_pos0) + key);
}

template <int kD>
__global__ void __launch_bounds__(Tiles<kD>::kThreads)
fold_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, const float* __restrict__ acc_in,
                   const float* __restrict__ dm, const float* __restrict__ dl,
                   const float* __restrict__ dacc, float* __restrict__ dq_out,
                   float* __restrict__ dm_out, float* __restrict__ dl_out,
                   float* __restrict__ dacc_out, float* __restrict__ safe_out,
                   float* __restrict__ bmax_out, float* __restrict__ dbc_out, int BH, int Tq, int Tk,
                   int D, int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid,
                   float scale, bool vec) {
  using T = Tiles<kD>;
  constexpr int kBM = T::kOwn, kBN = T::kStream, kLd = T::kLd, kNT = T::kNT, kDT = T::kDT;
  constexpr int kThreads = T::kThreads, kCap = T::kMaxKeys;
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;              // [kBM][kLd] Q
  float* const das = qs + kBM * kLd;   // [kBM][kLd] dacc
  float* const kvs = das + kBM * kLd;  // [2 stages][K, V][kBN][kLd]
  int* const max_keys = reinterpret_cast<int*>(kvs + 2 * 2 * kBN * kLd);  // [kBM][kCap]

  const int n_qt = (Tq + kBM - 1) / kBM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kBM;  // causal's longest rows first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = warp / T::kSplit * 16;        // the warp's first row in the block
  const int c0 = warp % T::kSplit * T::kCols;  // its first output column
  const size_t q_row0 = static_cast<size_t>(bh) * Tq + q0;
  const size_t k_row0 = static_cast<size_t>(bh) * Tk;
  const int n_rows = min(kBM, Tq - q0);

  stage<kBM, kD, kThreads>(qs, q + q_row0 * D, n_rows, D, vec, tid);
  stage<kBM, kD, kThreads>(das, dacc + q_row0 * D, n_rows, D, vec, tid);
  cp_async_commit();

  long long mask_end = Tk;  // keys from here on are masked for every row
  if (has_n_valid) mask_end = min(mask_end, static_cast<long long>(n_valid) - k_pos0);
  long long key_end = mask_end;
  if (causal) key_end = min(key_end, static_cast<long long>(q_pos0) + q0 + n_rows - 1 - k_pos0 + 1);
  const int n_kt = key_end > 0 ? static_cast<int>((key_end + kBN - 1) / kBN) : 0;
  const auto stage_kv = [&](int tile, int buf) {
    const int k0 = tile * kBN, n = min(kBN, Tk - k0);
    float* const dst = kvs + buf * 2 * kBN * kLd;
    stage<kBN, kD, kThreads>(dst, k + (k_row0 + k0) * D, n, D, vec, tid);
    stage<kBN, kD, kThreads>(dst + kBN * kLd, v + (k_row0 + k0) * D, n, D, vec, tid);
    cp_async_commit();
  };
  // The score tile of key tile `it` for the warp's 16 rows from Q·Kᵀ:
  // scaled, -inf where masked.
  const auto mask_scores = [&](float (&s)[kNT][4], int it) {
    const int key0 = it * kBN;
    const bool whole = r0 + 16 <= n_rows && key0 + kBN <= mask_end &&
                       (!causal || static_cast<long long>(q_pos0) + q0 + r0 >=
                                       static_cast<long long>(k_pos0) + key0 + kBN - 1);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = whole || attends(q0 + r0 + g + 8 * (e >> 1), key0 + 8 * j + 2 * t + (e & 1), Tq, mask_end,
                                   causal, q_pos0, k_pos0)
                      ? __fmul_rn(s[j][e], scale)
                      : kNegInf;
  };
  if (n_kt > 0) stage_kv(0, 0);

  // Each lane keeps the state of rows r0 + g (i = 0) and r0 + g + 8 (i = 1),
  // as the three other lanes of its quad do.
  float m_r[2], dl_r[2], run[2], bmax[2], cnt[2];
  double sumw[2];  // this lane's part of Σ dP·P, against exp(s - R): float64, as dsafe cancels in it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    const bool valid = r < n_rows;
    m_r[i] = valid ? __ldg(m_in + q_row0 + r) : kNegInf;
    dl_r[i] = valid ? __ldg(dl + q_row0 + r) : 0.0f;
    run[i] = m_r[i];  // R = max(m, b), seeded with the carried m
    bmax[i] = kNegInf;
    cnt[i] = 0.0f;
    sumw[i] = 0.0;
  }
  float acc1[kDT][4];  // Σ dP·P·k against exp(s - R)
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    if (it + 1 < n_kt) {
      stage_kv(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and Q, dacc) landed for every thread
    const float* const ks = kvs + (it & 1) * 2 * kBN * kLd;
    const float* const vs = ks + kBN * kLd;
    float sw[2][kNT][4];  // Q·Kᵀ, then the scores; dacc·vᵀ
    product_tiles<kD, kNT, false, 2>(sw, {qs + r0 * kLd, das + r0 * kLd}, {ks, vs}, lane);
    float (&s)[kNT][4] = sw[0];
    float (&w)[kNT][4] = sw[1];
    mask_scores(s, it);
    float safe_now[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      tmax = quad_max(tmax);
      const bool reset = tmax > bmax[i];  // a new block max: its count and keys start again
      const bool hit = reset || (tmax == bmax[i] && tmax != kNegInf);
      if (reset) bmax[i] = tmax;
      // this lane's keys equal to the block max, and those of the quad's lanes before it
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) mine += (hit && s[j][e] == bmax[i]) ? 1 : 0;
      const int up1 = __shfl_up_sync(0xffffffffu, mine, 1), up2 = __shfl_up_sync(0xffffffffu, mine, 2),
                up3 = __shfl_up_sync(0xffffffffu, mine, 3);
      const int before = (t >= 1 ? up1 : 0) + (t >= 2 ? up2 : 0) + (t >= 3 ? up3 : 0);
      const int here = static_cast<int>(quad_sum(static_cast<float>(mine)));
      if (hit) {
        // the row's max keys, while they fit in its kCap slots (past that the
        // walk after the loop recomputes the row)
        int pos = (reset ? 0 : static_cast<int>(cnt[i])) + before;
        int* const slots = max_keys + (r0 + g + 8 * i) * kCap;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e)
            if (s[j][e] == bmax[i]) {
              if (pos < kCap) slots[pos] = it * kBN + 8 * j + 2 * t + (e & 1);
              ++pos;
            }
        cnt[i] = (reset ? 0.0f : cnt[i]) + static_cast<float>(here);
      }
      const float grown = fmaxf(m_r[i], bmax[i]);
      if (grown > run[i]) {  // R grows: rescale what was summed against the old R
        const float f = run[i] == kNegInf ? 0.0f : expf(run[i] - grown);
        sumw[i] *= f;
#pragma unroll
        for (int n = 0; n < kDT; ++n) acc1[n][2 * i] *= f, acc1[n][2 * i + 1] *= f;
        run[i] = grown;
      }
      safe_now[i] = run[i] == kNegInf ? 0.0f : run[i];
    }
    // w = dP·P as the A fragments of w · K
    uint32_t wh[kNT][4], wl[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = s[j][e] == kNegInf ? 0.0f : expf(s[j][e] - safe_now[i]);
        const float wv = (dl_r[i] + w[j][e]) * p;
        sumw[i] += wv;
        split(wv, wh[j][a_pos(e)], wl[j][a_pos(e)]);
      }
    add_product<kD, kNT, kDT>(acc1, wh, wl, ks, c0, g, t);
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
  cp_async_wait<0>();
  __syncthreads();  // Q and dacc landed even where no key tile was staged

  // The row quantities. dq = scale · (Σ dP·P·k + dbc · Σ_{s = B} k).
  float safe_r[2], corr_r[2], dbc_r[2], dm_r[2];
  bool past_cap = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    const bool valid = r < n_rows;
    const double dpp_row = quad_sum(sumw[i]);
    float part = 0.0f;  // Σ_d dacc·acc, lane t over the columns t, t + 4, ...
    if (valid)
      for (int d = t; d < D; d += 4) part = fmaf(das[r * kLd + d], __ldg(acc_in + (q_row0 + r) * D + d), part);
    part = quad_sum(part);
    const float dcorr = valid ? dl_r[i] * __ldg(l_in + q_row0 + r) + part : 0.0f;
    const bool new_m_inf = run[i] == kNegInf;
    safe_r[i] = new_m_inf ? 0.0f : run[i];
    corr_r[i] = m_r[i] == kNegInf ? 0.0f : expf(m_r[i] - safe_r[i]);
    const float take = m_r[i] > bmax[i] ? 1.0f : m_r[i] == bmax[i] ? 0.5f : 0.0f;
    const float dsafe = static_cast<float>(-dpp_row - static_cast<double>(dcorr * corr_r[i]));
    const float dnew = (valid ? __ldg(dm + q_row0 + r) : 0.0f) + (new_m_inf ? 0.0f : dsafe);
    dbc_r[i] = dnew * (1.0f - take) / fmaxf(cnt[i], 1.0f);
    dm_r[i] = (m_r[i] == kNegInf ? 0.0f : dcorr * corr_r[i]) + dnew * take;
    past_cap |= valid && cnt[i] > kCap;
  }
  __syncwarp();  // the quads' max-key slots
  // dbc · Σ k over a row's max keys (as the tensor cores read k, so that it
  // cancels against Σ dP·P·k where the keys are equal), added once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n_keys = cnt[i] > kCap ? 0 : static_cast<int>(cnt[i]);  // past kCap: the walk below
    float2 ksum[kDT];
#pragma unroll
    for (int n = 0; n < kDT; ++n) ksum[n] = make_float2(0.0f, 0.0f);
    for (int a = 0; a < n_keys; ++a) {
      const float* const krow = k + (k_row0 + max_keys[(r0 + g + 8 * i) * kCap + a]) * D;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const float2 kv = load2(krow, col2(c0, n, t), D, vec);
        ksum[n].x += as_split(kv.x);
        ksum[n].y += as_split(kv.y);
      }
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      acc1[n][2 * i] = fmaf(dbc_r[i], ksum[n].x, acc1[n][2 * i]);
      acc1[n][2 * i + 1] = fmaf(dbc_r[i], ksum[n].y, acc1[n][2 * i + 1]);
    }
  }
  // Rows with more max keys than slots (exact ties, as a token repeated
  // more than kCap times gives): their one-pass sum is dropped and a second
  // walk of the key tiles sums dq again from ds formed key by key, as the
  // dkv kernel forms it: ds = dP·P + dbc at each max key, P = exp(s - safe).
  // Where many keys are equal, Σ dP·P·k and dbc · Σ_{s = B} k are each about
  // cnt times dq, and their float32 roundings would not cancel. Warps
  // without such a row only stage tiles.
  if (__syncthreads_or(past_cap)) {
    bool redo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      redo[i] = cnt[i] > kCap;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
        if (redo[i]) acc1[n][2 * i] = 0.0f, acc1[n][2 * i + 1] = 0.0f;
    }
    const bool warp_redo = __any_sync(0xffffffffu, redo[0] || redo[1]);
    if (n_kt > 0) stage_kv(0, 0);
    for (int it = 0; it < n_kt; ++it) {
      if (it + 1 < n_kt) {
        stage_kv(it + 1, (it + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp_redo) {
        const float* const ks = kvs + (it & 1) * 2 * kBN * kLd;
        const float* const vs = ks + kBN * kLd;
        float sw[2][kNT][4];
        product_tiles<kD, kNT, false, 2>(sw, {qs + r0 * kLd, das + r0 * kLd}, {ks, vs}, lane);
        float (&s)[kNT][4] = sw[0];
        const float (&w)[kNT][4] = sw[1];
        mask_scores(s, it);
        uint32_t xh[kNT][4], xl[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float ds = 0.0f;
            if (redo[i] && s[j][e] != kNegInf)
              ds = (dl_r[i] + w[j][e]) * expf(s[j][e] - safe_r[i]) + (s[j][e] == bmax[i] ? dbc_r[i] : 0.0f);
            split(ds, xh[j][a_pos(e)], xl[j][a_pos(e)]);
          }
        add_product<kD, kNT, kDT>(acc1, xh, xl, ks, c0, g, t);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= n_rows) continue;
    if (c0 == 0 && t == 0) {
      dm_out[q_row0 + r] = dm_r[i];
      dl_out[q_row0 + r] = dl_r[i] * corr_r[i];
      safe_out[q_row0 + r] = safe_r[i];
      bmax_out[q_row0 + r] = bmax[i];
      dbc_out[q_row0 + r] = dbc_r[i];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int col = col2(c0, n, t);
      store2(dq_out + (q_row0 + r) * D, col, scaled(row2(acc1, n, i), scale), D, vec);
      store2(dacc_out + (q_row0 + r) * D, col,
             scaled(*reinterpret_cast<const float2*>(das + r * kLd + col), corr_r[i]), D, vec);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(Tiles<kD>::kThreads)
fold_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dl,
                    const float* __restrict__ dacc, const float* __restrict__ safe,
                    const float* __restrict__ bmax, const float* __restrict__ dbc,
                    float* __restrict__ dk_out, float* __restrict__ dv_out, int BH, int Tq, int Tk,
                    int D, int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid,
                    float scale, bool vec) {
  using T = Tiles<kD>;
  constexpr int kBN = T::kOwn, kBM = T::kStream, kLd = T::kLd, kNT = T::kNT, kDT = T::kDT;
  constexpr int kThreads = T::kThreads;
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;                   // [kBN][kLd] K
  float* const vs = ks + kBN * kLd;         // [kBN][kLd] V
  float* const qds = vs + kBN * kLd;        // [2 stages][Q, dacc][kBM][kLd]
  float* const rows = qds + 4 * kBM * kLd;  // [2 stages][safe, bmax, dbc, dl][kBM]

  const int bh = blockIdx.x % BH;
  const int k0 = static_cast<int>(blockIdx.x) / BH * kBN;  // causal: the first keys have the most queries
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int kr0 = warp / T::kSplit * 16;       // the warp's first key in the block
  const int c0 = warp % T::kSplit * T::kCols;  // its first output column
  const size_t q_row0 = static_cast<size_t>(bh) * Tq;
  const size_t k_row0 = static_cast<size_t>(bh) * Tk + k0;
  const int n_keys = min(kBN, Tk - k0);

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
  const auto stage_q = [&](int qt, int buf) {
    const int qq0 = qt * kBM, n = min(kBM, Tq - qq0);
    float* const dst = qds + buf * 2 * kBM * kLd;
    stage<kBM, kD, kThreads>(dst, q + (q_row0 + qq0) * D, n, D, vec, tid);
    stage<kBM, kD, kThreads>(dst + kBM * kLd, dacc + (q_row0 + qq0) * D, n, D, vec, tid);
    if (tid < 4 * kBM) {
      const int a = tid / kBM, r = tid % kBM;
      const float* const src = (a == 0 ? safe : a == 1 ? bmax : a == 2 ? dbc : dl) + q_row0 + qq0;
      cp_async4(rows + buf * 4 * kBM + tid, r < n ? src + r : src, r < n ? 4 : 0);
    }
    cp_async_commit();
  };
  if (qt_begin < qt_end) {
    stage<kBN, kD, kThreads>(ks, k + k_row0 * D, n_keys, D, vec, tid);
    stage<kBN, kD, kThreads>(vs, v + k_row0 * D, n_keys, D, vec, tid);
    cp_async_commit();
    stage_q(qt_begin, 0);
  }

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f, dv[n][e] = 0.0f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int it = qt - qt_begin;
    if (qt + 1 < qt_end) {
      stage_q(qt + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt (and K, V) landed for every thread
    const float* const qs = qds + (it & 1) * 2 * kBM * kLd;
    const float* const das = qs + kBM * kLd;
    const float* const rs = rows + (it & 1) * 4 * kBM;
    const int qq0 = qt * kBM;
    // Sᵀ = K·Qᵀ and dacc·vᵀ transposed, keys as rows
    float sd[2][kNT][4];
    product_tiles<kD, kNT, true, 2>(sd, {ks + kr0 * kLd, vs + kr0 * kLd}, {qs, das}, lane);
    const float (&s)[kNT][4] = sd[0];
    const float (&dpv)[kNT][4] = sd[1];
    uint32_t ph[kNT][4], pl[kNT][4], dh[kNT][4], dlo[kNT][4];
    const bool whole = qq0 + kBM <= Tq && k0 + kr0 + 16 <= mask_end &&
                       (!causal || static_cast<long long>(q_pos0) + qq0 >=
                                       static_cast<long long>(k_pos0) + k0 + kr0 + 15);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);  // the query in this tile
        const bool keep =
            whole || attends(qq0 + qi, k0 + kr0 + g + 8 * (e >> 1), Tq, mask_end, causal, q_pos0, k_pos0);
        const float sv = keep ? __fmul_rn(s[j][e], scale) : kNegInf;
        const float p = sv == kNegInf ? 0.0f : expf(sv - rs[qi]);
        const bool is_max = sv == rs[kBM + qi] && sv != kNegInf;
        const float ds = (rs[3 * kBM + qi] + dpv[j][e]) * p + (is_max ? rs[2 * kBM + qi] : 0.0f);
        split(p, ph[j][a_pos(e)], pl[j][a_pos(e)]);
        split(ds, dh[j][a_pos(e)], dlo[j][a_pos(e)]);
      }
    // dv += Pᵀ · dacc and dk += dsᵀ · Q over this tile's queries
    add_product<kD, kNT, kDT>(dv, ph, pl, das, c0, g, t);
    add_product<kD, kNT, kDT>(dk, dh, dlo, qs, c0, g, t);
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + g + 8 * i;
    if (key >= n_keys) continue;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int col = col2(c0, n, t);
      store2(dk_out + (k_row0 + key) * D, col, scaled(row2(dk, n, i), scale), D, vec);
      store2(dv_out + (k_row0 + key) * D, col, row2(dv, n, i), D, vec);
    }
  }
}

// Whether every matrix a kernel moves in 16-byte pieces can: D a multiple of
// 4 and every base pointer 16-byte aligned (rows are then aligned too).
bool vec_rows(int D, std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return D % 4 == 0;
}

template <int kD>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* m_in,
                      const float* l_in, const float* acc_in, const float* dm, const float* dl,
                      const float* dacc, float* dq, float* dm_out, float* dl_out, float* dacc_out,
                      float* safe, float* bmax, float* dbc, int BH, int Tq, int Tk, int D,
                      int q_pos0, int k_pos0, int causal, int has_n_valid, int n_valid, float scale,
                      cudaStream_t stream) {
  using T = Tiles<kD>;
  constexpr size_t bytes = T::kDqBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      fold_bwd_dq_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(BH) * ((Tq + T::kOwn - 1) / T::kOwn);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  fold_bwd_dq_kernel<kD><<<static_cast<unsigned>(blocks), T::kThreads, bytes, stream>>>(
      q, k, v, m_in, l_in, acc_in, dm, dl, dacc, dq, dm_out, dl_out, dacc_out, safe, bmax, dbc, BH,
      Tq, Tk, D, q_pos0, k_pos0, causal, has_n_valid, n_valid, scale,
      vec_rows(D, {q, k, v, dacc, dq, dacc_out}));
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dl,
                       const float* dacc, const float* safe, const float* bmax, const float* dbc,
                       float* dk, float* dv, int BH, int Tq, int Tk, int D, int q_pos0, int k_pos0,
                       int causal, int has_n_valid, int n_valid, float scale, cudaStream_t stream) {
  using T = Tiles<kD>;
  constexpr size_t bytes = T::kDkvBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      fold_bwd_dkv_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(BH) * ((Tk + T::kOwn - 1) / T::kOwn);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  fold_bwd_dkv_kernel<kD><<<static_cast<unsigned>(blocks), T::kThreads, bytes, stream>>>(
      q, k, v, dl, dacc, safe, bmax, dbc, dk, dv, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
      has_n_valid, n_valid, scale, vec_rows(D, {q, k, v, dacc, dk, dv}));
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
