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
// Determinism (no atomics on a float anywhere) and the identity of the two
// forms: both dot kernels sum each output's terms in ascending entry order
// within fixed chunks of `chunk` entries, one f32 accumulator per half, the
// halves added at the chunk's end (as the Pallas kernel adds its two
// matmuls per tile), and the chunk sums in ascending chunk order from 0. The
// build form walks a row-sorted entry list (row_ptr / entry_of, built once
// per layout); the premat form walks the one-hots and skips zero terms,
// which would add only +-0 to a sum that is never -0. So the two give the
// same bits. Every add and multiply is an explicit __fadd_rn / __fmul_rn:
// nothing is contracted into an FMA, and products of two bf16 values are
// exact in f32.
//
// Bounds on the H100 at the headline unit shape (n_sub 4, row_hi 128,
// ~1.1 M entries per sub-batch):
// - build-form dot: bytes. q (4 B) + entry_of (4 B) per live entry and the
//   row_ptr / output: ~21 MB, ~6.3 us at 3.35 TB/s. But each q is a gather
//   at a random place in its sub-batch: 2.56 M live entries touch a 32-byte
//   sector each (~82 MB from L2 to the SMs), and the rate of those random
//   sector reads, not HBM, is the floor (one torch.take of the same q alone
//   runs about as long). A warp takes a tile of kDotRows consecutive rows of
//   one sub-batch (the sub-batch from the grid); the tile's entries are one
//   contiguous range of entry_of, whose ids it stages in shared memory with
//   16-byte cp.async copies (4-byte ones at the ends), kDotStage at a time.
//   Lane i then walks row r0 + i from the stage, kDotBatch entries at a
//   time: their q gathered together (kDotBatch in flight a lane, 256 a
//   warp), then folded in today's order, so the bits are the thread-per-row
//   walk's and the premat dot's. A range past the stage is walked in pieces,
//   each lane carrying (total, acc_hi, acc_lo, chunk). (Staging every q of a
//   piece in shared memory first, then folding, ran level with the old
//   thread-per-row kernel or slower on the H100.)
// - build-form mult: bytes. rowid (2 B) in, u (4 B) out per entry, mult3
//   (256 KB) once: ~27 MB, ~8 us. A thread takes 8-slot groups (one 16-byte
//   load of ids, two 16-byte stores), kMultInFlight of them in flight, from
//   a grid that persists over each sub-batch (blockIdx.y); a scalar head and
//   tail where the sub-batch's ids start or end off a 16-byte word. It
//   reads mult3 through L1, which keeps a sub-batch's 64 KB after the first
//   misses, and crosses it at each slot. (Staging the crossed row table once
//   a block in shared memory instead cost a 64 KB read and a barrier before
//   any slot and ran slower.)
// - premat dot: bytes. q at every slot and the one-hot rows of live entries,
//   (row_hi + 128) * 2 B each (padding slots carry q = 0 and add nothing):
//   ~1.3 GB, ~0.40 ms. The kernel reads just that. A persistent block per
//   SM walks its work units (sub-batch, chunk, h-group) as tasks of 32
//   slots. Each of kGatherWarps gather warps takes a task, ballots its q
//   (loaded a task ahead) for the live entries and loads their two rows
//   as 16-byte words, kBatch entries in flight at a time: lanes 0-15 hold
//   the oh_hi row's words, lanes 16-31 the oh_lo row's, so one branch-free
//   scan and two ballots give each row's count of nonzeros (0, 1, several)
//   and its nonzero's column and value. A lane per live entry then writes
//   the task's records, in slot order, to a ring in shared memory handed
//   over by mbarriers: a simple entry (one nonzero in each row) becomes
//   (row, a * bf16(v * q_hi), a * bf16(v * q_lo)); any other is general.
//   One accumulator warp applies the tasks in order to the unit's
//   2 x hw x 128 f32 accumulators in shared memory (128 KB at row_hi 128):
//   one read-modify-write pair a simple entry, __match_any_sync ordering
//   the entries of a task that share a row, a general entry's every
//   nonzero pair (its rows read again) at its own place in that order. At
//   a unit's end it writes the halves' sum to the unit's chunk partial and
//   clears the accumulators; a second small kernel adds the chunk partials
//   in order. (A loader warp that staged the live rows into a cp.async or
//   bulk-copy ring for decoder warps was slower: that one warp's chain of
//   dependent steps an entry, not the copies, bounded it.)
// - premat mult: bytes. Every slot's two rows are read (a padding slot's
//   output is defined by its rows), u written, mult3 once: ~2.3 GB,
//   ~0.68 ms. Each block holds its sub-batch's mult3 in shared memory,
//   split once into packed bf16 (hi, lo); each warp takes kMultUnroll
//   consecutive entries at a time, loads all their rows as 16-byte words
//   (lanes 0-15 oh_hi, 16-31 oh_lo, none waiting on another load) while
//   the previous group is decoded, and finds (h, l) as the dot does. A
//   simple entry's output is (a * m_hi + a * m_lo) * v, rounded as the
//   plain version rounds it; a general one sums its terms in a stated order.
// The premat kernels take the whole [n_win, n_sub, n_pad, w] stacks and the
// window index wi and offset their pointers: no window is copied. An oh_hi
// row whose width is not a multiple of 8 (no 16-byte words) is read with
// 2-byte loads instead; so is any row of the mult past 128 columns.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"  // the mbarrier hand-over

namespace {

constexpr int kRowLo = 128;
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kHGroup = 128;  // row_hi rows per premat-dot unit (accumulators <= 128 KB)
constexpr unsigned kFull = 0xffffffffu;

// Build-form dot: a warp's tile of rows (a lane a row), the entry ids it
// stages at a time (12 KB a warp), and the entries whose q a lane has in
// flight at a time.
constexpr int kDotRows = kWarp;
constexpr int kDotWarps = 8;
constexpr int kDotStage = 3072;
constexpr int kDotBatch = 8;

// Build-form mult: a block's threads (eight slots each) and the 8-slot
// groups a thread has in flight.
constexpr int kMultBuildThreads = 1024;
constexpr int kMultInFlight = 2;

// Premat dot: the block's warps and its record ring.
constexpr int kGatherWarps = 16;  // each gathers and decodes 32-slot groups of entries
constexpr int kDotThreads = (kGatherWarps + 1) * kWarp;  // and the accumulator warp, the last
constexpr int kBatch = 8;   // live entries whose rows a gather warp has in flight (4 KB)
constexpr int kTasks = 32;  // record ring: decoded groups between the gatherers and the accumulator
// A record's key: the row (h - h0) * 128 + l of a simple entry, or one of
constexpr int kSkip = -1;     // the entry adds nothing (a row without a nonzero)
constexpr int kGeneral = -2;  // several nonzeros: every pair, in the slow path

// Premat mult.
constexpr int kMultThreads = 256;
constexpr int kMultUnroll = 4;  // entries a warp has in flight (2 KB), beside the next group's

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_word(uint16_t w) {
  return __uint_as_float(static_cast<uint32_t>(w) << 16);
}

// ---------------------------------------------------------------------------
// Build-form dot: a warp a tile of kDotRows consecutive rows of one
// sub-batch, whose entries are one contiguous range of entry_of.
// ---------------------------------------------------------------------------

// The range [g0 + lo, g0 + hi) of entry_of into stage positions [lo, hi):
// 16-byte copies where a whole word lies inside, 4-byte ones at the ends.
// g0 sits 16-byte aligned in eo, and the stage is 16-byte aligned.
__device__ __forceinline__ void stage_ids(int* ids, const int* eo, int g0, int lo, int hi, int lane) {
  for (int p = (lo & ~3) + 4 * lane; p < hi; p += 4 * kWarp) {
    if (p >= lo && p + 4 <= hi) {
      cp_async16(reinterpret_cast<float*>(ids + p), reinterpret_cast<const float*>(eo + g0 + p), 16);
    } else {
      for (int j = max(p, lo); j < min(p + 4, hi); ++j)
        cp_async4(reinterpret_cast<float*>(ids + j), reinterpret_cast<const float*>(eo + g0 + j), 4);
    }
  }
}

__global__ void __launch_bounds__(kDotWarps * kWarp)
dot_crossing_kernel(const float* __restrict__ q, const int* __restrict__ row_ptr,
                    const int* __restrict__ entry_of, float* __restrict__ out,
                    int n, int rows, int chunk_shift) {
  extern __shared__ __align__(16) int dot_stage[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int s = blockIdx.y;
  const int r0 = (blockIdx.x * kDotWarps + warp) * kDotRows;
  if (r0 >= rows) return;  // rows is a multiple of 128: a tile is whole or absent
  int* ids = dot_stage + warp * kDotStage;
  const int* eo = entry_of + static_cast<size_t>(s) * n;
  const float* qs = q + static_cast<size_t>(s) * n;
  const int* rp = row_ptr + static_cast<size_t>(s) * (rows + 1) + r0;
  const int rs = rp[lane], re = rp[lane + 1];  // lane's row: entries [rs, re)
  const int b = __shfl_sync(kFull, rs, 0), e = __shfl_sync(kFull, re, kWarp - 1);
  // Pieces of kDotStage entries from the 16-byte word holding b, so that
  // words of entry_of land on words of the stage (eo may sit off a word:
  // n not a multiple of 4, or a window's view).
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(eo) >> 2) & 3);
  float total = 0.0f, acc_hi = 0.0f, acc_lo = 0.0f;
  int cur = -1;
  for (int g0 = ((b + mis) & ~3) - mis; g0 < e; g0 += kDotStage) {
    const int lo = max(b - g0, 0), hi = min(e - g0, kDotStage);
    stage_ids(ids, eo, g0, lo, hi, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    // lane's row in this piece, kDotBatch entries at a time: their q all in
    // flight, then today's fold over them in entry order
    const int z = min(re - g0, hi);
    for (int p0 = max(rs - g0, lo); p0 < z; p0 += kDotBatch) {
      float x[kDotBatch];
      int c[kDotBatch];
#pragma unroll
      for (int j = 0; j < kDotBatch; ++j) {
        const bool in = p0 + j < z;
        const int id = in ? ids[p0 + j] : 0;
        c[j] = id >> chunk_shift;
        x[j] = in ? __ldg(qs + id) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kDotBatch; ++j) {
        if (p0 + j < z) {
          if (c[j] != cur) {
            if (cur >= 0) total = __fadd_rn(total, __fadd_rn(acc_hi, acc_lo));
            acc_hi = 0.0f;
            acc_lo = 0.0f;
            cur = c[j];
          }
          const float xh = bf16_round(x[j]);
          const float xl = bf16_round(__fsub_rn(x[j], xh));
          acc_hi = __fadd_rn(acc_hi, xh);
          acc_lo = __fadd_rn(acc_lo, xl);
        }
      }
    }
    __syncwarp();  // the stage is read before the next piece lands on it
  }
  if (cur >= 0) total = __fadd_rn(total, __fadd_rn(acc_hi, acc_lo));
  out[static_cast<size_t>(s) * rows + r0 + lane] = total;
}

// ---------------------------------------------------------------------------
// Build-form mult: a block over one sub-batch's slots, eight a thread.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float crossed(float m) {  // bf16(m) + bf16(m - bf16(m))
  const float hi = bf16_round(m);
  return __fadd_rn(hi, bf16_round(__fsub_rn(m, hi)));
}

// 16 bytes of the id stream; not kept in L1, which holds the sub-batch's mult3.
__device__ __forceinline__ int4 ld_stream16(const int16_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float mult_at(const float* m, int r, int rows) {
  if (static_cast<unsigned>(r) >= static_cast<unsigned>(rows)) return 0.0f;  // an all-zero one-hot
  return crossed(__ldg(m + r));
}

__device__ __forceinline__ void mult_group(const int4& w, const float* m, int rows, float* o, bool vec_out) {
  const int ws[4] = {w.x, w.y, w.z, w.w};
  float u[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // little-endian: the even slot in the low half
    u[2 * j] = mult_at(m, static_cast<int16_t>(ws[j] & 0xffff), rows);
    u[2 * j + 1] = mult_at(m, ws[j] >> 16, rows);
  }
  if (vec_out) {
    reinterpret_cast<float4*>(o)[0] = make_float4(u[0], u[1], u[2], u[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(u[4], u[5], u[6], u[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = u[j];
  }
}

__global__ void __launch_bounds__(kMultBuildThreads, 1)
mult_crossing_kernel(const float* __restrict__ mult3, const int16_t* __restrict__ rowid,
                     float* __restrict__ out, int n, int rows) {
  const int s = blockIdx.y;
  const int16_t* rid = rowid + static_cast<size_t>(s) * n;
  float* o = out + static_cast<size_t>(s) * n;
  const float* m = mult3 + static_cast<size_t>(s) * rows;
  // slots [0, head) and [tail, n) one at a time; between them 8-slot groups
  // read as 16-byte words of rowid (head: up to the first word boundary)
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(rid) >> 1) & 7);
  const int head = min(n, (8 - mis) & 7);
  const int groups = (n - head) / 8;
  const int tail = head + 8 * groups;
  const bool vec_out = (reinterpret_cast<uintptr_t>(o + head) & 15) == 0;
  const int16_t* grid_ids = rid + head;
  const int stride = gridDim.x * blockDim.x;
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  // groups g, g + stride, ...: kMultInFlight of them loaded at a time
  int4 w[kMultInFlight];
#pragma unroll
  for (int k = 0; k < kMultInFlight; ++k) {
    const int gk = g + k * stride;
    w[k] = gk < groups ? ld_stream16(grid_ids + 8 * gk) : make_int4(0, 0, 0, 0);
  }
  if (blockIdx.x == 0 && threadIdx.x < 16) {  // threads 0-7 the head, 8-15 the tail
    const int i = threadIdx.x < 8 ? threadIdx.x : tail + threadIdx.x - 8;
    if (i < (threadIdx.x < 8 ? head : n)) o[i] = mult_at(m, rid[i], rows);
  }
  while (g < groups) {
#pragma unroll
    for (int k = 0; k < kMultInFlight; ++k) {
      const int gk = g + k * stride;
      if (gk < groups) mult_group(w[k], m, rows, o + head + 8 * gk, vec_out);
    }
    g += kMultInFlight * stride;
#pragma unroll
    for (int k = 0; k < kMultInFlight; ++k) {
      const int gk = g + k * stride;
      w[k] = gk < groups ? ld_stream16(grid_ids + 8 * gk) : make_int4(0, 0, 0, 0);
    }
  }
}

// ---------------------------------------------------------------------------
// Decoding a one-hot row a warp at a time
// ---------------------------------------------------------------------------

// Bit 15 (31) set where the low (high) bf16 of x is nonzero: each 15-bit
// magnitude plus 0x7fff carries into its half's top bit unless it is 0, and
// never past it. A -0 counts as zero, as the plain version's products with
// it add nothing.
__device__ __forceinline__ uint32_t nonzero_halves(uint32_t x) {
  return ((x & 0x7fff7fffu) + 0x7fff7fffu) & 0x80008000u;
}

// The nonzeros among the 8 bf16 values of w (columns pos0 .. pos0 + 7): how
// many, and one of them as (column << 16 | bits), ~0u when there is none
// (the only one when there is one). Branch-free, so a warp whose lanes hold
// words of two rows scans them all in one pass.
__device__ __forceinline__ void scan_word(const uint4& w, int pos0, int& cnt, unsigned& key) {
  // one bit a nonzero value: word i's low half at bit 2i, its high half at 2i + 16
  const uint32_t p = (nonzero_halves(w.x) >> 15) | (nonzero_halves(w.y) >> 13) |
                     (nonzero_halves(w.z) >> 11) | (nonzero_halves(w.w) >> 9);
  cnt += __popc(p);
  const int b = p ? __ffs(p) - 1 : 0;
  const int wi = (b & 15) >> 1, half = b >> 4;
  const uint32_t x = wi & 2 ? (wi & 1 ? w.w : w.z) : (wi & 1 ? w.y : w.x);
  const unsigned found = (static_cast<unsigned>(pos0 + 2 * wi + half) << 16) | ((x >> (16 * half)) & 0xffffu);
  key = min(key, p ? found : ~0u);
}

// The same for one value at column pos.
__device__ __forceinline__ void scan_value(uint16_t bits, int pos, int& cnt, unsigned& key) {
  if (bits & 0x7fffu) {
    ++cnt;
    key = min(key, (static_cast<unsigned>(pos) << 16) | bits);
  }
}

// A warp's view of one entry, from every lane's share: for each row, none,
// one or several nonzeros (0, 1, 2), and the key of the lowest lane holding
// a nonzero, which is the row's only nonzero when it has one. Ballots and
// shuffles, no reduction instructions.
struct Decoded {
  int hi_cnt, lo_cnt;
  unsigned hi_key, lo_key;
};

__device__ __forceinline__ int nonzeros(unsigned any, unsigned several) {
  return any == 0u ? 0 : (several == 0u && (any & (any - 1u)) == 0u) ? 1 : 2;
}

// Each lane's share of both rows (any lanes: the 2-byte path).
__device__ __forceinline__ Decoded warp_decode(int hc, unsigned hk, int lc, unsigned lk) {
  const unsigned hn = __ballot_sync(kFull, hc > 0), hm = __ballot_sync(kFull, hc > 1);
  const unsigned ln = __ballot_sync(kFull, lc > 0), lm = __ballot_sync(kFull, lc > 1);
  return {nonzeros(hn, hm), nonzeros(ln, lm), __shfl_sync(kFull, hk, hn ? __ffs(hn) - 1 : 0),
          __shfl_sync(kFull, lk, ln ? __ffs(ln) - 1 : 0)};
}

// Lanes 0-15 hold the oh_hi row's words, lanes 16-31 the oh_lo row's (the
// 16-byte path): two ballots cover both rows.
__device__ __forceinline__ Decoded warp_decode_words(int cnt, unsigned key) {
  const unsigned any = __ballot_sync(kFull, cnt > 0), several = __ballot_sync(kFull, cnt > 1);
  const unsigned hn = any & 0xffffu, ln = any >> 16;
  return {nonzeros(hn, several & 0xffffu), nonzeros(ln, several >> 16),
          __shfl_sync(kFull, key, hn ? __ffs(hn) - 1 : 0), __shfl_sync(kFull, key, ln ? __ffs(ln) + 15 : 16)};
}

__device__ __forceinline__ int key_col(unsigned key) { return static_cast<int>(key >> 16); }
__device__ __forceinline__ float key_val(unsigned key) { return bf16_word(static_cast<uint16_t>(key)); }

// ---------------------------------------------------------------------------
// Premat dot, pass 1: chunk partials. Persistent blocks, each over its work
// units (sub-batch s, chunk c, h-group g) u = blockIdx.x + i * gridDim.x.
// ---------------------------------------------------------------------------

struct Record {  // one decoded entry
  int key;       // (h - h0) * 128 + l, kSkip or kGeneral
  float th, tl;  // a * bf16(v * q_hi), a * bf16(v * q_lo); a general entry: q_hi, q_lo
  int entry;     // its slot in the sub-batch (the general path reads its rows again)
};

struct GroupRecords {  // the live entries of one 32-slot group, in slot order
  int count, pad[3];
  Record rec[kWarp];
};

struct DotUnit {
  int s, c, h0, hw;
};

struct DotShape {
  int n, n_pad, row_hi, chunk, n_chunks, n_units;
};

__device__ __forceinline__ DotUnit dot_unit(int u, const DotShape& sh) {
  const int n_groups = (sh.row_hi + kHGroup - 1) / kHGroup;
  const int g = u % n_groups, t = u / n_groups;
  return {t / sh.n_chunks, t % sh.n_chunks, g * kHGroup, min(kHGroup, sh.row_hi - g * kHGroup)};
}

// The block's tasks: the 32-slot groups of its units in order, numbered
// across units (a unit whose chunk lies past q's n has one empty group). A
// cursor holds the unit of one task; tasks are visited in increasing order.
struct TaskCursor {
  int u, t0, groups;  // unit, its first task, its groups
  DotUnit du;
  int e_begin, q_end;  // its slots with q: [e_begin, q_end)

  __device__ void open(int unit, int first, const DotShape& sh) {
    u = unit;
    t0 = first;
    du = dot_unit(unit, sh);
    e_begin = du.c * sh.chunk;
    q_end = min(min(e_begin + sh.chunk, sh.n_pad), sh.n);
    groups = max(1, (q_end - e_begin + kWarp - 1) / kWarp);
  }
  // Moves to the unit of task t; false past the block's last unit.
  __device__ bool seek(int t, const DotShape& sh) {
    while (t >= t0 + groups) {
      if (u + static_cast<int>(gridDim.x) >= sh.n_units) return false;
      open(u + gridDim.x, t0 + groups, sh);
    }
    return true;
  }
  __device__ int first_slot(int t) const { return e_begin + kWarp * (t - t0); }
};

// Every nonzero pair of a general entry, a lane per oh_lo column (distinct
// outputs, so in any order within the entry).
__device__ void general_dot(float* acc_h, float* acc_l, const uint16_t* hi, const uint16_t* lo,
                            int hw, float qh, float ql, int lane) {
  float v[4], th[4], tl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = bf16_word(lo[lane + kWarp * i]);
    th[i] = bf16_round(__fmul_rn(v[i], qh));
    tl[i] = bf16_round(__fmul_rn(v[i], ql));
  }
  for (int h = 0; h < hw; ++h) {
    const float a = bf16_word(hi[h]);
    if (a == 0.0f) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (v[i] == 0.0f) continue;
      const int idx = h * kRowLo + lane + kWarp * i;
      acc_h[idx] = __fadd_rn(acc_h[idx], __fmul_rn(a, th[i]));
      acc_l[idx] = __fadd_rn(acc_l[idx], __fmul_rn(a, tl[i]));
    }
  }
}

__global__ void __launch_bounds__(kDotThreads, 1)
dot_premat_partial_kernel(const float* __restrict__ q, const uint16_t* __restrict__ oh_hi,
                          const uint16_t* __restrict__ oh_lo, float* __restrict__ partial, int wi,
                          int n_sub, DotShape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_hi = sh.row_hi, hw_max = min(row_hi, kHGroup);
  float* acc_h = reinterpret_cast<float*>(smem_raw);  // [hw][128]: the q_hi half
  float* acc_l = acc_h + hw_max * kRowLo;              // [hw][128]: the q_lo half
  GroupRecords* ring = reinterpret_cast<GroupRecords*>(acc_l + hw_max * kRowLo);  // [kTasks]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTasks);  // a group's records written
  uint64_t* empty = full + kTasks;                              // a group's records applied

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const bool vec_hi = row_hi % 8 == 0;  // the oh_hi rows are 16-byte words
  const size_t unit0 = static_cast<size_t>(wi) * n_sub;  // the window's first sub-batch of rows
  for (int i = tid; i < 2 * hw_max * kRowLo; i += kDotThreads) acc_h[i] = 0.0f;
  if (tid == 0) {
    for (int k = 0; k < kTasks; ++k) {
      mbar_init(&full[k], 1);  // lane 0 of a warp, after __syncwarp orders its lanes' stores
      mbar_init(&empty[k], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  TaskCursor cur;
  cur.open(blockIdx.x, 0, sh);

  if (warp < kGatherWarps) {
    // Gather warp: tasks warp, warp + kGatherWarps, ... Lane < 16 loads
    // word `lane` of a live entry's oh_hi row (when it has one), lane >= 16
    // word lane - 16 of its oh_lo row; a group's q is loaded a task ahead.
    auto group_q = [&](const TaskCursor& c, int t) {
      const int e = c.first_slot(t) + lane;
      return e < c.q_end ? __ldg(q + static_cast<size_t>(c.du.s) * sh.n + e) : 0.0f;
    };
    TaskCursor ahead = cur;
    float q_next = ahead.seek(warp, sh) ? group_q(ahead, warp) : 0.0f;
    for (int t = warp; cur.seek(t, sh); t += kGatherWarps) {
      const float qv = q_next;
      q_next = ahead.seek(t + kGatherWarps, sh) ? group_q(ahead, t + kGatherWarps) : 0.0f;
      const DotUnit& du = cur.du;
      const int g0 = cur.first_slot(t);
      const size_t row0 = (unit0 + du.s) * sh.n_pad;
      const bool loads = lane >= 16 || (vec_hi && lane < du.hw / 8);
      const uint16_t* src = lane >= 16 ? oh_lo + row0 * kRowLo + (lane - 16) * 8
                                       : oh_hi + row0 * row_hi + du.h0 + lane * 8;
      const size_t stride = lane >= 16 ? kRowLo : row_hi;
      unsigned live = __ballot_sync(kFull, qv != 0.0f);
      const int n_live = __popc(live);
      // lane j ends up holding live entry j's slot and decoded rows
      int my_src = 0, my_hc = 0, my_lc = 0;
      unsigned my_hk = ~0u, my_lk = ~0u;
      for (int j0 = 0; j0 < n_live; j0 += kBatch) {
        uint4 w[kBatch];
        int srcs[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          w[b] = make_uint4(0u, 0u, 0u, 0u);
          srcs[b] = 0;
          if (j0 + b < n_live) {  // uniform across the warp
            srcs[b] = __ffs(live) - 1;
            live &= live - 1;
            if (loads) w[b] = __ldcs(reinterpret_cast<const uint4*>(src + (g0 + srcs[b]) * stride));
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (j0 + b >= n_live) break;  // uniform across the warp
          int cnt = 0;
          unsigned key = ~0u;
          scan_word(w[b], 8 * (lane % 16), cnt, key);
          Decoded d;
          if (vec_hi) {
            d = warp_decode_words(cnt, key);
          } else {
            int hc = 0;
            unsigned hk = ~0u;
            const uint16_t* hr = oh_hi + (row0 + g0 + srcs[b]) * row_hi + du.h0;
            for (int h = lane; h < du.hw; h += kWarp) scan_value(hr[h], h, hc, hk);
            d = warp_decode(hc, hk, lane >= 16 ? cnt : 0, lane >= 16 ? key : ~0u);
          }
          if (lane == j0 + b) {
            my_src = srcs[b];
            my_hc = d.hi_cnt;
            my_lc = d.lo_cnt;
            my_hk = d.hi_key;
            my_lk = d.lo_key;
          }
        }
      }
      // the group's records, a lane per live entry
      const float x = __shfl_sync(kFull, qv, my_src);
      const int slot = t % kTasks;
      mbar_wait(&empty[slot], ((t / kTasks) & 1) ^ 1);
      if (lane < n_live) {
        const float qh = bf16_round(x), ql = bf16_round(__fsub_rn(x, qh));
        Record r{kSkip, 0.0f, 0.0f, g0 + my_src};
        if (my_hc == 1 && my_lc == 1) {
          const float a = key_val(my_hk), v = key_val(my_lk);
          r.key = key_col(my_hk) * kRowLo + key_col(my_lk);
          r.th = __fmul_rn(a, bf16_round(__fmul_rn(v, qh)));
          r.tl = __fmul_rn(a, bf16_round(__fmul_rn(v, ql)));
        } else if (my_hc > 0 && my_lc > 0) {
          r = Record{kGeneral, qh, ql, g0 + my_src};
        }
        ring[slot].rec[lane] = r;
      }
      if (lane == 0) ring[slot].count = n_live;
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[slot]);
    }
  } else {
    // Accumulator warp: every task in order.
    const unsigned lanes_below = (1u << lane) - 1u;
    for (int t = 0; cur.seek(t, sh); ++t) {
      const int slot = t % kTasks;
      mbar_wait(&full[slot], (t / kTasks) & 1);
      const int count = ring[slot].count;
      const Record r = lane < count ? ring[slot].rec[lane] : Record{kSkip, 0.0f, 0.0f, 0};
      const DotUnit& du = cur.du;
      if (!__any_sync(kFull, r.key == kGeneral)) {
        // Simple entries: one read-modify-write pair each. Entries of the
        // group on the same row go in ascending lane (= entry) order.
        const bool act = r.key >= 0;
        const unsigned peers = __match_any_sync(kFull, act ? r.key : (0x40000000 | lane));
        const int rank = __popc(peers & lanes_below);
        for (int rr = 0; __any_sync(kFull, act && rank >= rr); ++rr) {
          if (act && rank == rr) {
            acc_h[r.key] = __fadd_rn(acc_h[r.key], r.th);
            acc_l[r.key] = __fadd_rn(acc_l[r.key], r.tl);
          }
          __syncwarp();
        }
      } else {
        // A general entry in the group: every entry in turn.
        const size_t row0 = (unit0 + du.s) * sh.n_pad;
        for (int j = 0; j < count; ++j) {
          const int key = __shfl_sync(kFull, r.key, j);
          const float th = __shfl_sync(kFull, r.th, j), tl = __shfl_sync(kFull, r.tl, j);
          if (key >= 0 && lane == 0) {
            acc_h[key] = __fadd_rn(acc_h[key], th);
            acc_l[key] = __fadd_rn(acc_l[key], tl);
          } else if (key == kGeneral) {
            const size_t e = row0 + __shfl_sync(kFull, r.entry, j);
            general_dot(acc_h, acc_l, oh_hi + e * row_hi + du.h0, oh_lo + e * kRowLo, du.hw, th, tl, lane);
          }
          __syncwarp();
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // the group's records are applied
      if (t == cur.t0 + cur.groups - 1) {
        // the unit's last group: its chunk partial, and clear accumulators
        float4* h4 = reinterpret_cast<float4*>(acc_h);
        float4* l4 = reinterpret_cast<float4*>(acc_l);
        float4* dst = reinterpret_cast<float4*>(
            partial + ((static_cast<size_t>(du.s) * sh.n_chunks + du.c) * row_hi + du.h0) * kRowLo);
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int i = lane; i < du.hw * kRowLo / 4; i += kWarp) {
          const float4 a = h4[i], b = l4[i];
          dst[i] = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                               __fadd_rn(a.w, b.w));
          h4[i] = zero;
          l4[i] = zero;
        }
        __syncwarp();
      }
    }
  }
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
// Premat mult: a block per (slice of entries, sub-batch s), a warp per
// kMultUnroll consecutive entries at a time.
// ---------------------------------------------------------------------------

// mult3[s, h, l] split once: bf16(m) in the high half, bf16(m - bf16(m)) in
// the low half.
__device__ __forceinline__ uint32_t split_pack(float m) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(m);
  const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(m, __bfloat162float(hi)));
  return (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16) | __bfloat16_as_ushort(lo);
}

// mult3[s] split: from shared memory (ms), or split here from device
// memory (mg) when the row space does not fit in shared memory.
__device__ __forceinline__ uint32_t m_at(const uint32_t* ms, const float* mg, int i) {
  return ms ? ms[i] : split_pack(mg[i]);
}

// A general entry: for each nonzero oh_lo column l in ascending order,
// ph = sum_h a * m_hi[h, l] and pl = sum_h a * m_lo[h, l] over the nonzero
// oh_hi columns h in ascending order, then u += (ph + pl) * v. A lane per
// column; the columns' terms are added in order through shuffles.
__device__ float general_mult(const uint32_t* ms, const float* mg, const uint16_t* hi,
                              const uint16_t* lo, int row_hi, int lane) {
  float c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = lane + kWarp * i;
    const float v = bf16_word(lo[l]);
    float ph = 0.0f, pl = 0.0f;
    if (v != 0.0f) {
      for (int h = 0; h < row_hi; ++h) {
        const float a = bf16_word(hi[h]);
        if (a == 0.0f) continue;
        const uint32_t mv = m_at(ms, mg, h * kRowLo + l);
        ph = __fadd_rn(ph, __fmul_rn(a, bf16_word(static_cast<uint16_t>(mv >> 16))));
        pl = __fadd_rn(pl, __fmul_rn(a, bf16_word(static_cast<uint16_t>(mv))));
      }
    }
    c[i] = v != 0.0f ? __fmul_rn(__fadd_rn(ph, pl), v) : 0.0f;
  }
  float u = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int src = 0; src < kWarp; ++src) u = __fadd_rn(u, __shfl_sync(kFull, c[i], src));
  }
  return u;
}

// kVec: the oh_hi rows are 16-byte words of at most 128 columns (row_hi a
// multiple of 8, <= 128); else each lane reads its oh_hi columns as 2-byte
// values.
template <bool kVec>
__global__ void __launch_bounds__(kMultThreads)
mult_premat_kernel(const float* __restrict__ mult3, const uint16_t* __restrict__ oh_hi,
                   const uint16_t* __restrict__ oh_lo, float* __restrict__ out, int wi,
                   int n_sub, int n_pad, int row_hi, int m_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int rows = row_hi * kRowLo;
  // mult3[s] split once into shared memory, when it fits
  const float* mg = mult3 + static_cast<size_t>(s) * rows;
  uint32_t* ms = m_in_smem ? reinterpret_cast<uint32_t*>(smem_raw) : nullptr;
  if (ms) {
    for (int i = threadIdx.x; i < rows; i += kMultThreads) ms[i] = split_pack(mg[i]);
    __syncthreads();
  }
  const size_t row0 = (static_cast<size_t>(wi) * n_sub + s) * n_pad;  // the unit's first row
  const uint16_t* hi_rows = oh_hi + row0 * row_hi;
  const uint16_t* lo_rows = oh_lo + row0 * kRowLo;
  float* out_s = out + static_cast<size_t>(s) * n_pad;
  const int hi_words = row_hi / 8;
  const int groups = (n_pad + kMultUnroll - 1) / kMultUnroll;
  const int warps = kMultThreads / kWarp;
  const int stride = gridDim.x * warps;

  // Lane < 16: word `lane` of the entry's oh_hi row (kVec); lane >= 16:
  // word lane - 16 of its oh_lo row. Loads of a group's entries are all
  // issued before any is used.
  auto load = [&](int g, uint4 (&w)[kMultUnroll]) {
#pragma unroll
    for (int i = 0; i < kMultUnroll; ++i) {
      const int e = g * kMultUnroll + i;
      w[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e >= n_pad) continue;
      if (lane >= 16) {
        w[i] = __ldcs(reinterpret_cast<const uint4*>(lo_rows + static_cast<size_t>(e) * kRowLo) + lane - 16);
      } else if (kVec && lane < hi_words) {
        w[i] = __ldcs(reinterpret_cast<const uint4*>(hi_rows + static_cast<size_t>(e) * row_hi) + lane);
      }
    }
  };
  int g = blockIdx.x * warps + threadIdx.x / kWarp;
  uint4 cur[kMultUnroll], nxt[kMultUnroll];
  if (g < groups) load(g, cur);
  for (; g < groups; g += stride) {
    if (g + stride < groups) load(g + stride, nxt);
    float u_mine = 0.0f;
#pragma unroll
    for (int i = 0; i < kMultUnroll; ++i) {
      const int e = g * kMultUnroll + i;
      if (e >= n_pad) break;  // uniform across the warp
      const uint16_t* hr = hi_rows + static_cast<size_t>(e) * row_hi;
      int cnt = 0;
      unsigned key = ~0u;
      scan_word(cur[i], 8 * (lane % 16), cnt, key);  // lanes 0-15 past the words loaded 0
      Decoded d;
      if (kVec) {
        d = warp_decode_words(cnt, key);
      } else {
        int hc = 0;
        unsigned hk = ~0u;
        for (int h = lane; h < row_hi; h += kWarp) scan_value(hr[h], h, hc, hk);
        d = warp_decode(hc, hk, lane >= 16 ? cnt : 0, lane >= 16 ? key : ~0u);
      }
      float u = 0.0f;  // a row without a nonzero: every term is 0
      if (d.hi_cnt == 1 && d.lo_cnt == 1) {
        const float a = key_val(d.hi_key), v = key_val(d.lo_key);
        const uint32_t mv = m_at(ms, mg, key_col(d.hi_key) * kRowLo + key_col(d.lo_key));
        const float ph = __fmul_rn(a, bf16_word(static_cast<uint16_t>(mv >> 16)));
        const float pl = __fmul_rn(a, bf16_word(static_cast<uint16_t>(mv)));
        u = __fadd_rn(0.0f, __fmul_rn(__fadd_rn(ph, pl), v));
      } else if (d.hi_cnt > 0 && d.lo_cnt > 0) {
        u = general_mult(ms, mg, hr, lo_rows + static_cast<size_t>(e) * kRowLo, row_hi, lane);
      }
      if (lane == i) u_mine = u;
    }
    const int e = g * kMultUnroll + lane;
    if (lane < kMultUnroll && e < n_pad) out_s[e] = u_mine;
#pragma unroll
    for (int i = 0; i < kMultUnroll; ++i) cur[i] = nxt[i];
  }
}

inline unsigned blocks_for(size_t items, size_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

inline size_t max_dynamic_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(bytes);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().

int onehot_dot_crossing(const void* q, const void* row_ptr, const void* entry_of, void* out,
                        int n_sub, int n, int row_hi, int chunk, void* stream) {
  if (chunk <= 0 || (chunk & (chunk - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_sub <= 0 || row_hi <= 0) return static_cast<int>(cudaGetLastError());
  const int rows = row_hi * kRowLo;
  const size_t smem = static_cast<size_t>(kDotWarps) * kDotStage * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(dot_crossing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_for(rows / kDotRows, kDotWarps), n_sub);  // the sub-batch from the grid
  dot_crossing_kernel<<<grid, kDotWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(row_ptr), static_cast<const int*>(entry_of),
      static_cast<float*>(out), n, rows, __builtin_ctz(static_cast<unsigned>(chunk)));
  return static_cast<int>(cudaGetLastError());
}

int onehot_mult_crossing(const void* mult3, const void* rowid, void* out, int n_sub, int n,
                         int row_hi, void* stream) {
  if (n_sub <= 0 || n <= 0 || row_hi <= 0) return static_cast<int>(cudaGetLastError());
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mult_crossing_kernel,
                                                                  kMultBuildThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of blocks over the sub-batches, no more than the groups need
  size_t bx = static_cast<size_t>(sm_count()) * (per_sm > 0 ? per_sm : 1) / n_sub;
  const size_t need = blocks_for(static_cast<size_t>(n) / 8 + 1, kMultBuildThreads);
  bx = bx < 1 ? 1 : (bx > need ? need : bx);
  mult_crossing_kernel<<<dim3(static_cast<unsigned>(bx), n_sub), kMultBuildThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mult3), static_cast<const int16_t*>(rowid), static_cast<float*>(out), n,
      row_hi * kRowLo);
  return static_cast<int>(cudaGetLastError());
}

int onehot_dot_crossing_premat(const void* q, const void* oh_hi, const void* oh_lo,
                               void* partial, void* out, int wi, int n_sub, int n, int n_pad,
                               int row_hi, int chunk, int n_chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = row_hi * kRowLo;
  if (n_sub > 0 && n_chunks > 0 && row_hi > 0) {
    const DotShape sh{n, n_pad, row_hi, chunk, n_chunks,
                      n_sub * n_chunks * ((row_hi + kHGroup - 1) / kHGroup)};
    const int hw = row_hi < kHGroup ? row_hi : kHGroup;
    const size_t smem = 2 * static_cast<size_t>(hw) * kRowLo * sizeof(float) +
                        kTasks * (sizeof(GroupRecords) + 2 * sizeof(uint64_t));
    cudaError_t err = cudaFuncSetAttribute(dot_premat_partial_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = sh.n_units < sm_count() ? sh.n_units : sm_count();
    dot_premat_partial_kernel<<<grid, kDotThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const uint16_t*>(oh_hi),
        static_cast<const uint16_t*>(oh_lo), static_cast<float*>(partial), wi, n_sub, sh);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_sub <= 0 || n_pad <= 0 || row_hi <= 0) return static_cast<int>(cudaGetLastError());
  const size_t rows = static_cast<size_t>(row_hi) * kRowLo;
  const int m_in_smem = rows * sizeof(uint32_t) <= max_dynamic_smem();
  const size_t smem = m_in_smem ? rows * sizeof(uint32_t) : 0;
  const bool vec = row_hi % 8 == 0 && row_hi <= kHGroup;
  auto kernel = vec ? mult_premat_kernel<true> : mult_premat_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMultThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of blocks over the sub-batches, no more than the entries need
  const size_t groups = (static_cast<size_t>(n_pad) + kMultUnroll - 1) / kMultUnroll;
  size_t bx = static_cast<size_t>(sm_count()) * (per_sm > 0 ? per_sm : 1) / n_sub;
  const size_t need = blocks_for(groups, kMultThreads / kWarp);
  bx = bx < 1 ? 1 : (bx > need ? need : bx);
  const dim3 grid(static_cast<unsigned>(bx), n_sub);
  kernel<<<grid, kMultThreads, smem, st>>>(
      static_cast<const float*>(mult3), static_cast<const uint16_t*>(oh_hi),
      static_cast<const uint16_t*>(oh_lo), static_cast<float*>(out), wi, n_sub, n_pad, row_hi,
      m_in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
