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
// with q_pos = q_pos0 + row and k_pos = k_pos0 + key. All float32.
//
// Bound: operations. The fold does 4·BH·Tq·Tk·D operations (two products)
// against 4·BH·(3·Tq·D + 2·Tk·D + 4·Tq) bytes: at B 1, H 4, T 8192, D 128
// that is 137.4 G operations (2.05 ms at the H100's 67 TFLOP/s of float32
// outside the tensor cores; 1.03 ms causal) against 84.4 MB (25.2 us at
// 3.35 TB/s). No tensor core and no TF32: the products are float32 FMAs.
//
// Design. The TPU kernel keeps one head's whole K/V block in VMEM and forms a
// [256, Tk] score tile. A Hopper block has at most 227 KB of shared memory,
// and blocks run in parallel in no order, so here one block of kThreads
// threads owns kBM query rows of one (batch·head) and streams the K/V block
// through shared memory kBN keys at a time, carrying the running max, sum and
// accumulator of its rows in registers (the online softmax): no score leaves
// the SM. Per key tile:
//   1. K is staged transposed ([d][key]) and V as it lies ([key][d]);
//   2. S = Q·Kᵀ as a 4 x 4 register tile per thread (rows ty*4.., keys
//      tx*4..), reading the transposed Q and K tiles as float4: Q is a
//      broadcast, K 16 consecutive float4 per half-warp, no bank conflict;
//   3. mask and scale, the row max over the tile by shuffles across the 16
//      lanes that share a row, the correction of the running state, p;
//   4. p goes to shared memory, and O += P·V with each thread holding its 4
//      rows × kD/16 output columns.
// The Q tile is staged once, transposed. The head dim is padded to the
// template's kD (16, 32, 64, 128 or 256) with zeros, so any D <= 256 runs;
// shared memory is 4·(3·64·kD + 64·64) bytes: 112 KB at kD 128 (two blocks
// an SM), 208 KB at kD 256. Key tiles that the causal or n_valid mask covers
// wholly are never loaded: the tile loop stops at the block's last
// attendable key. The Q tiles run in reverse order, so under causal the
// longest rows start first.
//
// Exact edges (the JAX fold's own): a row with no attendable key in the
// block keeps m, l and acc bit for bit when m_in is finite (each correction
// is exp(0) = 1 and each p is 0), and gives m -inf, l 0, acc 0 when m_in is
// -inf (the state is multiplied by 0 once at the start, as the reference's
// correction 0 does); a masked key adds exactly 0, and exp is never taken
// of -inf - (-inf). The products and the softmax sum in another order than
// the plain version, so the rest agrees within a float32 tolerance.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: tx over keys / output columns, ty over rows
constexpr int kLanes = 16;     // threads that share a row

template <int kD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kD) * kBM   // Q, transposed
                          + static_cast<size_t>(kD) * kBN // K, transposed
                          + static_cast<size_t>(kBN) * kD // V
                          + static_cast<size_t>(kBM) * kBN);  // P
}
static_assert(smem_bytes<256>() <= 232448, "the largest tile set fits one block's shared memory");

// The output column of a thread's c-th accumulator: 64-column chunks of one
// float4 per lane from kD 64 on, neighbouring columns below.
template <int kD>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int kDC = kD / kLanes;
  if constexpr (kDC >= 4) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else {
    return tx * kDC + c;
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

template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 128 ? 2 : 1)
flash_fold_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ m_in,
                  const float* __restrict__ l_in, const float* __restrict__ acc_in,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int BH, int Tq, int Tk, int D, int q_pos0,
                  int k_pos0, int causal, int has_n_valid, int n_valid, float scale) {
  constexpr int kDC = kD / kLanes;  // output columns per thread
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;            // [kD][kBM]
  float* const ks = qs + kD * kBM;   // [kD][kBN]
  float* const vs = ks + kD * kBN;   // [kBN][kD]
  float* const ps = vs + kBN * kD;   // [kBM][kBN]

  const int n_qt = (Tq + kBM - 1) / kBM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kBM;
  const int tid = threadIdx.x, tx = tid % kLanes, ty = tid / kLanes;
  const size_t q_row0 = static_cast<size_t>(bh) * Tq;
  const size_t k_row0 = static_cast<size_t>(bh) * Tk;

  // The Q tile, transposed; rows fastest across threads, so the stores hit
  // consecutive banks.
  for (int i = tid; i < kBM * kD; i += kThreads) {
    const int r = i % kBM, d = i / kBM;
    const int row = q0 + r;
    qs[d * kBM + r] = (row < Tq && d < D) ? __ldg(q + (q_row0 + row) * D + d) : 0.0f;
  }

  // The running state of this thread's rows.
  float m_run[4], l_run[4], acc[4][kDC];
  long long last_key[4];  // the last attendable key index of the row under causal
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool valid = row < Tq;
    m_run[i] = valid ? __ldg(m_in + q_row0 + row) : kNegInf;
    l_run[i] = valid ? __ldg(l_in + q_row0 + row) : 0.0f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = out_col<kD>(tx, c);
      acc[i][c] = (valid && col < D) ? __ldg(acc_in + (q_row0 + row) * D + col) : 0.0f;
    }
    if (m_run[i] == kNegInf) {  // the reference's correction 0, applied once
      l_run[i] *= 0.0f;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= 0.0f;
    }
    last_key[i] = static_cast<long long>(q_pos0) + row - k_pos0;
  }

  // Keys past key_end are masked for every row of the block: their tiles
  // are skipped.
  long long key_end = Tk;  // keys past it are masked for every row
  if (has_n_valid) key_end = min(key_end, static_cast<long long>(n_valid) - k_pos0);
  const long long mask_end = key_end;  // the row-independent limit
  if (causal) {
    const int last_row = min(q0 + kBM, Tq) - 1;
    key_end = min(key_end, static_cast<long long>(q_pos0) + last_row - k_pos0 + 1);
  }
  const int n_kt = key_end > 0 ? static_cast<int>((key_end + kBN - 1) / kBN) : 0;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile is consumed (and the Q tile stored)
    for (int i = tid; i < kBN * kD; i += kThreads) {
      const int c = i % kBN, d = i / kBN;
      const int key = k0 + c;
      ks[d * kBN + c] = (key < Tk && d < D) ? __ldg(k + (k_row0 + key) * D + d) : 0.0f;
    }
    for (int i = tid; i < kBN * kD; i += kThreads) {
      const int d = i % kD, c = i / kD;
      const int key = k0 + c;
      vs[c * kD + d] = (key < Tk && d < D) ? __ldg(v + (k_row0 + key) * D + d) : 0.0f;
    }
    __syncthreads();

    // 2. S = Q·Kᵀ: rows ty*4 + i, keys tx*4 + j.
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kBM + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(ks + d * kBN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // 3. mask and scale; the streaming-softmax update of each row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long key = k0 + tx * 4 + j;
        const bool keep = key < mask_end && (!causal || key <= last_key[i]);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float new_m = fmaxf(m_run[i], row_max(tile_max));
      const float safe_m = new_m == kNegInf ? 0.0f : new_m;
      // exactly 1 where the max did not move, as exp(0) is in the reference
      const float correction = m_run[i] == kNegInf ? 0.0f
                               : m_run[i] == safe_m ? 1.0f
                                                    : expf(m_run[i] - safe_m);
      float p[4];
      float p_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = s[i][j] == kNegInf ? 0.0f : expf(s[i][j] - safe_m);
        p_sum += p[j];
      }
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kBN + tx * 4) = make_float4(p[0], p[1], p[2], p[3]);
      l_run[i] = l_run[i] * correction + row_sum(p_sum);
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= correction;
      m_run[i] = new_m;
    }
    __syncthreads();

    // 4. O += P·V for this thread's rows and columns.
#pragma unroll 2
    for (int kk = 0; kk < kBN; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kBN + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (kk + e) * kD;
        float vv[kDC];
        if constexpr (kDC >= 4) {
#pragma unroll
          for (int c4 = 0; c4 < kDC / 4; ++c4) {
            const float4 w = *reinterpret_cast<const float4*>(vrow + c4 * 64 + tx * 4);
            vv[c4 * 4 + 0] = w.x;
            vv[c4 * 4 + 1] = w.y;
            vv[c4 * 4 + 2] = w.z;
            vv[c4 * 4 + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < kDC; ++c) vv[c] = vrow[tx * kDC + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    if (tx == 0) {
      m_out[q_row0 + row] = m_run[i];
      l_out[q_row0 + row] = l_run[i];
    }
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = out_col<kD>(tx, c);
      if (col < D) acc_out[(q_row0 + row) * D + col] = acc[i][c];
    }
  }
}

template <int kD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* m_in,
                   const float* l_in, const float* acc_in, float* m_out, float* l_out,
                   float* acc_out, int BH, int Tq, int Tk, int D, int q_pos0, int k_pos0,
                   int causal, int has_n_valid, int n_valid, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kD>();
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fold_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(BH) * ((Tq + kBM - 1) / kBM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fold_kernel<kD><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
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
  if (D <= 16) {
    err = launch<16>(qf, kf, vf, mi, li, ai, mo, lo, ao, BH, Tq, Tk, D, q_pos0, k_pos0, causal,
                     has_n_valid, n_valid, scale, s);
  } else if (D <= 32) {
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
