// The serving megakernel for every chain with an MLP head in it: the MLP
// alone, StandardScaler -> MLPClassifier, any chain of table ops before it,
// table ops after it, and more than one MLP head.
//
// Replaces: flink_ml_tpu/servable/megakernels.py, build_megakernel_fn (the
// pallas_call at line 180), for the chains ("mlp",), ("scale", "mlp"),
// ("normalize", "mlp"), ("mlp", "scale"), ("normalize", "mlp", "binarize") on
// rawPrediction, ("mlp", "kmeans"), ("mlp", "mlp"), ... : every chain of table
// ops (rowlocal_ops.cuh, sparse ones included) with one or more MLP heads
// anywhere in it. The chain is one op table; an mlp entry marks a head. The
// kernel works through the table in phases: the ops before a head run on each
// row of the tile (its prologue), writing every output they declare, and the
// head's input row goes into the tile's activation buffer; an empty prologue
// stages the head's input slot itself. Per row the head computes
// (flink_ml_tpu/ops/kernels.py mlp_predict_fn)
//   h{l+1}      = relu(h{l} @ W{l} + b{l})   for every hidden layer, h0 the head's input
//   logits      = h{L-1} @ W{L-1} + b{L-1}
//   probability = softmax(logits)
//   prediction  = labels[argmax(logits)]     (the first maximal index; NaN
//                                             counts as the maximum)
// and writes prediction and the probabilities into its two slots, float32.
// Then the next phase: the ops up to the next head, or after the last head
// (the epilogue), a warp per row; they may read the head's outputs or any
// other slot.
//
// Bound: operations. At the serving shape (4096 rows, 256 -> 512 -> 512 -> 8)
// the three products are 3.25 G operations against about 10 MB of inputs,
// outputs and weights (3 us at 3.35 TB/s). They run on the tensor cores in
// 3×TF32 (tf32_mma.cuh): each float32 operand is split into a TF32 hi and
// lo, and a product is lo·hi + hi·lo + hi·hi summed in float32, three TF32
// operations for each float32 one: 9.76 G, 19.7 us at the H100's 495 TFLOP/s
// of dense TF32 (as float32 FMAs outside the tensor cores, 48.6 us at 67
// TFLOP/s). One TF32 product keeps about three decimal digits, three keep
// about float32's, well inside the fast tier's 16,384-ulp envelope.
//
// Design. A cluster of C blocks (2, 4 or 8: cluster_blocks) owns one
// tile of kRows = 64 rows, one wgmma M. Every block of the cluster holds the
// tile's activations, float32, in its own shared memory: one 128 KB buffer
// of 64 x 512, in 64-column blocks, each row XOR-swizzled (act_offset) so
// that the A-fragment loads and the accumulators' stores are free of bank
// conflicts. For each layer, rank c computes its share of the layer's
// 64-column chunks (owned_chunks: at most kMaxChunks = 2, so C >= 4 for a
// layer of 512) for all 64 rows, its accumulators in registers (64 floats a
// thread). A layer of one chunk (N <= 64: a classifier's last layer) is
// split over K instead (layer_plan): kSegments = 4 fixed segments of its
// stages whatever C, each owner's partial sum (from zero) sent to every
// block, which adds the four in order, then the bias, into block 0. The
// products of a block's share:
// - the consumer warpgroup (threads 0-127) walks K in stages of two k-steps
//   of 8: it loads its A fragments (4 floats a thread a k-step) from the
//   activation buffer, splits them in registers and issues, for each chunk,
//   three wgmma m64n64k8 TF32 a k-step (lo·hi, hi·lo, hi·hi), A from
//   registers and B (Wᵀ hi or lo) from shared memory; the stage before
//   completes meanwhile. Splitting A once would take 256 KB for the hi and
//   lo of 64 x 512 floats;
// - the loader warpgroup (threads 128-255) brings the rank's columns of each
//   stage's 16 rows of W (row-major [K, N], as the caller passes it) by
//   cp.async into a raw staging ring three stages ahead (16-byte copies,
//   4-byte ones for rows that are not 16-byte aligned; past K or N they fill
//   zeros), splits each value once and writes Wᵀ hi and lo in the canonical
//   K-major layout (tf32_mma.cuh kt_offset) into a ring of 4 stages of 16 KB,
//   handed over by a full and an empty mbarrier each. Beside the 64 KB of
//   centroid norms of a kmeans prologue there is room for neither the raw
//   ring nor 4 stages: then 2 stages, and the loader reads W into registers
//   kPrefetch stages ahead. K is padded with exact zeros to whole stages. The
//   loader arrives at each cluster barrier early and waits late, and fills
//   the ring with the next layer's first stages before it waits, so the
//   consumer starts each layer on full stages. No packed copy of the weights
//   is kept between calls.
// The activations move between the blocks by the copy engine, one
// mbarrier phase (Exchange) a move: each block posts the bytes it expects,
// one cluster barrier (every rank has read its input), then each rank sends
// its rows (the prologue) or its chunks (a layer: bias added after the K
// loop, as the plain version does, relu on a hidden layer, columns past N
// zero) from its own buffer to every peer's, one cp.async.bulk of a
// contiguous block per peer, completing as transactions on the peer's
// mbarrier. The row phases (prologue, head, epilogue) split the tile's rows
// among the ranks, a warp per row over all 8 warps. The head runs one warp
// per row over the <= 32 logits: shuffle reductions for the max, the sum of
// expf(x - max) and the argmax. One launch per batch: cudaLaunchKernelEx
// with a cluster dimension.
//
// What holds it back (PERF.md, tools/mlp_stamps.py): each stage costs the
// loader about 0.5 us (issuing the next copies, reading the staged rows,
// the handover) against about 0.1-0.16 us for the consumer to issue its
// products, so the layers run loader-bound; and at 4096 rows the 256 blocks
// of clusters of 4 run in three waves. ptxas spills a few hundred bytes a
// thread, mostly around the row phases' calls.
//
// Numerics: the table's ops are as rowlocal_ops.cuh states (a scale is
// bit-identical to the plain version). Every output column is computed by
// the same instructions in the same k order whichever rank owns it, so a
// row's outputs do not depend on C or on the batch it came in (a one-chunk
// layer's fixed K segments and their sum in order included). The products
// sum in another order than cuBLAS or the CPU, and the softmax sums in
// another order than torch.softmax: both stay inside the fast tier's ulp
// envelope. A NaN in a row passes to every logit of its row; an infinity
// splits into a NaN lo and does the same. No fast-math flags.
//
// Limits, mirrored by servable/megakernels.py chain_eligible: at most
// kMaxHeads MLP heads, each of at most kMaxLayers layers, every width at most
// kMaxWidth, at most kMaxClasses classes; the table within rowlocal_ops.cuh's
// limits, with at most kMaxNormFloats centroids over its kmeans ops. The table
// (2.6 KB) and the networks (4 x 168 B) share the 4 KB of kernel parameters.
#include <algorithm>

#include "rowlocal_ops.cuh"
#include "tf32_mma.cuh"  // split, the wgmma wrappers and descriptors, mbarriers

namespace {

constexpr int kMaxHeads = 4;
constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 512;
constexpr int kMaxClasses = 32;
using rowlocal::kWarp;
constexpr int kRows = 64;                 // rows of a tile: one wgmma M
constexpr int kThreads = 256;             // the consumer warpgroup, then the loader
constexpr int kWarps = kThreads / kWarp;  // the row phases' warps
constexpr int kChunk = 64;                // output columns of one wgmma m64n64k8, and a block of the activations
constexpr int kMaxChunks = 2;             // chunks a rank owns in a layer: 64 accumulator floats a thread
constexpr int kStep = 8;                  // k of one wgmma
constexpr int kTile = kChunk * kStep;     // floats of one chunk's Wᵀ hi (or lo) for one k-step
constexpr int kStepFloats = kMaxChunks * 2 * kTile;  // a k-step of a stage: chunk j's hi at 2j·kTile, lo after (8 KB)
constexpr int kStageSteps = 2;            // k-steps a stage holds: a layer's K is padded to whole stages
constexpr int kStageFloats = kStageSteps * kStepFloats;  // 16 KB
constexpr int kRawStages = 4;             // the raw staging ring, where it fits
constexpr int kSegments = 4;              // the K split of a one-chunk layer (blocks 1-4 hold the partials)
constexpr int kRawFloats = kStageSteps * kStep * kMaxChunks * kChunk;  // a stage's rows of W (8 KB)
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kPrefetch = 2;              // the loader's stages of W in flight in registers
constexpr int kMaxNormFloats = 16 * 1024;
constexpr int kBlockFloats = kRows * kChunk;  // one 64-column block of the activations (16 KB)
constexpr size_t kActBytes = sizeof(float) * kRows * kMaxWidth;
constexpr size_t kStripBytes = sizeof(float) * kWarps * kWarp;  // the row phases' sparse folds (static)
constexpr size_t kSmemLimit = 232448 - kStripBytes;  // a block's shared memory on the H100, less the strips

static_assert(kMaxClasses <= kWarp && kMaxClasses <= kChunk, "the head holds one logit per lane, in block 0");
static_assert(kMaxWidth <= 4 * kMaxChunks * kChunk, "four ranks cover the widest layer");
constexpr size_t kStageBytes = sizeof(float) * kStageFloats + 2 * sizeof(uint64_t);  // and its two mbarriers
constexpr size_t kRawBytes = sizeof(float) * kRawFloats;
static_assert(kActBytes + 2 * kStageBytes + sizeof(uint64_t) + sizeof(float) * kMaxNormFloats <= kSmemLimit,
              "two stages fit beside the activations and the most centroid norms");
static_assert(kStageSteps * kStep <= kChunk && kChunk % (kStageSteps * kStep) == 0,
              "a layer's K padded to whole stages stays inside the zero-filled 64-column blocks");

struct MlpLayers {
  const float* W[kMaxLayers];  // [width[l], width[l + 1]] row-major
  const float* b[kMaxLayers];  // [width[l + 1]]
  int width[kMaxLayers + 1];
  int n_layers;
};

// The networks of the table's mlp heads, in the order of their Op.k.
struct MlpNets {
  MlpLayers net[kMaxHeads];
};
static_assert(sizeof(rowlocal::Table) + sizeof(MlpNets) + 16 <= 4096,
              "the table, the networks and the scalars fit the 4 KB of kernel parameters");

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ __forceinline__ int n_chunks(int width) { return (width + kChunk - 1) / kChunk; }

using rowlocal::is_nan;

// The float offset of row r, column c in the activation buffer: 64-column
// blocks of the tile's 64 rows one after the other, so that a rank's chunk
// (or a run of its rows) is one contiguous copy; within a row, the columns
// XOR-swizzled by the row, so that the A-fragment loads (8 rows x 4 columns
// a warp) and the float2 stores of the accumulators are free of bank
// conflicts without padding.
__device__ __forceinline__ int act_offset(int r, int c) {
  return ((c >> 6) * kRows + r) * kChunk + ((c & (kChunk - 1)) ^ ((r & 7) << 2));
}

// ---------------------------------------------------------------------------
// the cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// The cluster barrier: every thread of every block of the cluster arrives
// (release), then waits for all (acquire); the writes before the arrival
// are visible to every thread of the cluster after the wait.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The shared::cluster address, in the block of rank `rank`, of the shared
// memory at this block's shared address `addr`.
__device__ __forceinline__ uint32_t peer_address(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of this block's
// shared memory at `src` to shared::cluster address `dst` in a peer, on the
// copy engine; completes as transactions on the peer's mbarrier `bar`.
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const float* src, unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      "cp.async.bulk.commit_group;\n" ::"r"(dst),
      "r"(shared_address(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits until this thread's bulk copies have read their sources.
__device__ __forceinline__ void copies_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// The consumer warpgroup's own barrier.
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// The chunks of a layer of N columns that rank `rank` of C owns: [first,
// first + count), count <= kMaxChunks when C covers the layer (the host picks
// C so), 0 for a rank left without one.
__device__ __forceinline__ void owned_chunks(int N, int rank, int C, int& first, int& count) {
  const int n = n_chunks(N);
  first = rank * n / C;
  count = (rank + 1) * n / C - first;
}

// The exchanges of the activations between the blocks of a cluster, one
// mbarrier phase each: the prologue's rows, then each layer's chunks. Each
// block posts the bytes it will receive before the cluster barrier that
// opens the exchange, then the peers' copies complete them.
struct Exchange {
  uint64_t* bar;
  int n;  // exchanges begun: the next one's parity is n & 1
};

// ---------------------------------------------------------------------------
// the stage ring, walked in the same order by both warpgroups
// ---------------------------------------------------------------------------

struct Ring {
  float* stages;    // n stages of kStageSteps k-steps (kStepFloats each)
  uint64_t* full;   // n: a lane of each loader warp arrives, after the warp's writes
  uint64_t* empty;  // n: a lane of each consumer warp arrives
  int n;            // a power of two: position p is stage p & (n - 1), its phase (p >> log_n) & 1
  int log_n;
  float* raw;       // raw_n (kRawStages or 0) stages of W's rows as they lie (kRawFloats each)
  int raw_n;
};

// The first stage of K segment s of a layer of `stages` stages.
__device__ __forceinline__ int segment_begin(int s, int stages) { return s * stages / kSegments; }

// What rank `rank` of C does in a layer of K inputs and N outputs: the
// chunks [first, first + count) for all of the layer's stages, K padded with
// exact zeros (the loader's W rows past K, the activations' columns past it)
// to whole stages. A layer of one chunk (N <= 64) is split over K instead:
// its stages in kSegments fixed segments, whatever C, rank r owning
// [seg, seg + segs) (at most 2: C >= 2), the stages [sbegin, send) of them.
struct LayerPlan {
  int first, count;   // owned chunks (a split layer: chunk 0, where the rank owns a segment)
  int sbegin, send;   // the rank's stages of the layer
  int seg, segs;      // a split layer's owned segments
  int stages;         // the layer's stages
  bool split;
};

__device__ __forceinline__ LayerPlan layer_plan(int K, int N, int rank, int C) {
  LayerPlan p;
  p.stages = (K + kStageSteps * kStep - 1) / (kStageSteps * kStep);
  p.split = n_chunks(N) == 1;
  if (p.split) {
    p.seg = rank * kSegments / C;
    p.segs = (rank + 1) * kSegments / C - p.seg;
    p.first = 0;
    p.count = p.segs > 0 ? 1 : 0;
    p.sbegin = segment_begin(p.seg, p.stages);
    p.send = segment_begin(p.seg + p.segs, p.stages);
  } else {
    owned_chunks(N, rank, C, p.first, p.count);
    p.seg = p.segs = 0;
    p.sbegin = 0;
    p.send = p.count > 0 ? p.stages : 0;
  }
  return p;
}

// ---------------------------------------------------------------------------
// the consumer: one layer's products, bias, relu and exchange
// ---------------------------------------------------------------------------

// The end of a layer for a rank whose chunks [first, first + count) of N
// columns are written into its own activation buffer: the bytes it expects
// from the peers, the cluster barrier (every rank has read the layer's
// input), its chunks to every peer, then the peers' chunks in.
__device__ __forceinline__ void exchange_layer(float* act, Exchange& x, int N, int first, int count, int rank,
                                               int C) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_arrive_expect_tx(x.bar, static_cast<unsigned>((n_chunks(N) - count) * kBlockFloats * sizeof(float)));
  }
  cluster_sync();
  if (tid < count * C) {  // one thread a (chunk, peer)
    const int chunk = first + tid / C, p = tid % C;
    if (p != rank) {
      const float* const src = act + chunk * kBlockFloats;
      copy_to_peer(peer_address(shared_address(src), p), src, kBlockFloats * sizeof(float),
                   peer_address(shared_address(x.bar), p));
    }
  }
  mbar_wait(x.bar, x.n & 1);
  ++x.n;
}

// Layer of K inputs and N outputs, of which this rank owns kNC chunks from
// `first`: the products from the ring's stages t, t + 1, ..., then the bias
// and relu into this block's buffer, then the exchange. Returns the ring
// position after the layer.
// The products of the stages [ubegin, uend) of a layer into acc (kNC chunks,
// from zero), the stages taken from the ring at positions t, t + 1, ...
// Returns the ring position after them.
template <int kNC>
__device__ __forceinline__ int products(float (&acc)[kNC][kChunk / 2], const float* act, const Ring& ring, int t,
                                        int ubegin, int uend) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows: r0 and r0 + 8, both swizzled by g
  const float* const a_lo = act + r0 * kChunk;
  const float* const a_hi = a_lo + 8 * kChunk;
  using Frags = uint32_t[kStageSteps][4];
  if (ubegin >= uend) {  // an empty K segment sums to zero
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
#pragma unroll
      for (int e = 0; e < kChunk / 2; ++e) acc[j][e] = 0.0f;
    }
    return t;
  }

  // stage u: the A fragments of its k-steps split into ah / al, the three
  // products of each k-step issued (a chunk's lo·hi, hi·lo, hi·hi in that
  // order, the chunks' chains interleaved); stage u - 1 completes meanwhile
  // and is handed back
  const auto stage = [&](int u, Frags& ah, Frags& al, Frags& ph, Frags& pl) {
#pragma unroll
    for (int q = 0; q < kStageSteps; ++q) {
      const int k = (u * kStageSteps + q) * kStep;
      const int block = (k / kChunk) * kBlockFloats;
      const int c0 = ((k % kChunk) + t4) ^ (g << 2), c1 = ((k % kChunk) + t4 + 4) ^ (g << 2);
      split(a_lo[block + c0], ah[q][0], al[q][0]);
      split(a_hi[block + c0], ah[q][1], al[q][1]);
      split(a_lo[block + c1], ah[q][2], al[q][2]);
      split(a_hi[block + c1], ah[q][3], al[q][3]);
    }
    const int pos = t + (u - ubegin), s = pos & (ring.n - 1);
    mbar_wait(&ring.full[s], (pos >> ring.log_n) & 1);
    const float* const st = ring.stages + s * kStageFloats;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kStageSteps; ++q) {
      const float* const sq = st + q * kStepFloats;
      const int more = u > ubegin || q > 0;
#pragma unroll
      for (int j = 0; j < kNC; ++j) Wgmma<kChunk>::rs(acc[j], al[q], gmma_desc<kChunk>(sq + 2 * j * kTile), more);
#pragma unroll
      for (int j = 0; j < kNC; ++j) Wgmma<kChunk>::rs(acc[j], ah[q], gmma_desc<kChunk>(sq + (2 * j + 1) * kTile), 1);
#pragma unroll
      for (int j = 0; j < kNC; ++j) Wgmma<kChunk>::rs(acc[j], ah[q], gmma_desc<kChunk>(sq + 2 * j * kTile), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage u - 1 is complete: its fragments and its stage are free
    if (u > ubegin) {
#pragma unroll
      for (int q = 0; q < kStageSteps; ++q) {
        fence_regs(ph[q]);
        fence_regs(pl[q]);
      }
      if (lane == 0) mbar_arrive(&ring.empty[(pos - 1) & (ring.n - 1)]);
    }
  };
  Frags xh, xl, yh, yl;
  for (int u = ubegin; u < uend; u += 2) {
    stage(u, xh, xl, yh, yl);
    if (u + 1 < uend) stage(u + 1, yh, yl, xh, xl);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < kStageSteps; ++q) {
    fence_regs(xh[q]);
    fence_regs(xl[q]);
    fence_regs(yh[q]);
    fence_regs(yl[q]);
  }
  t += uend - ubegin;
  if (lane == 0) mbar_arrive(&ring.empty[(t - 1) & (ring.n - 1)]);
#pragma unroll
  for (int j = 0; j < kNC; ++j) fence_regs(acc[j]);
  return t;
}

// Writes a thread's accumulator fragment of a 64-column block (its rows r0
// and r0 + 8, its columns 8i + 2·t4 and + 1) into this block's buffer at the
// block's first column c0.
__device__ __forceinline__ void store_fragment(float* act, const float (&acc)[kChunk / 2], int c0) {
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), t4 = lane & 3;
#pragma unroll
  for (int e = 0; e < kChunk / 2; e += 2) {
    const int row = r0 + 8 * ((e >> 1) & 1), col = c0 + 8 * (e >> 2) + 2 * t4;
    *reinterpret_cast<float2*>(act + act_offset(row, col)) = make_float2(acc[e], acc[e + 1]);
  }
}

// + b, then relu for a hidden layer (NaN passes, as torch.relu lets it), on
// a thread's fragment of the block at column c0; columns past N are zeros
// for the next layer's last k-step.
__device__ __forceinline__ void bias_relu(float (&acc)[kChunk / 2], int c0, int N, const float* __restrict__ bias,
                                          bool hidden) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < kChunk / 2; ++e) {
    const int col = c0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
    float v = 0.0f;
    if (col < N) {
      v = __fadd_rn(acc[e], __ldg(bias + col));
      if (hidden && v < 0.0f) v = 0.0f;
    }
    acc[e] = v;
  }
}

// A layer whose rank owns kNC chunks from `first` (LayerPlan): the
// products, the bias and relu into this block's buffer, then the exchange.
template <int kNC>
__device__ __forceinline__ int consume_layer(float* act, const Ring& ring, int t, Exchange& x, const LayerPlan& p,
                                             int N, const float* __restrict__ bias, bool hidden, int rank, int C) {
  float acc[kNC][kChunk / 2];
  t = products<kNC>(acc, act, ring, t, p.sbegin, p.send);
#pragma unroll
  for (int j = 0; j < kNC; ++j) bias_relu(acc[j], (p.first + j) * kChunk, N, bias, hidden);
  copies_read();  // this thread's copies of the last exchange have read the buffer
  consumer_sync();
#pragma unroll
  for (int j = 0; j < kNC; ++j) store_fragment(act, acc[j], (p.first + j) * kChunk);
  fence_proxy_async();  // the writes, before the copies read them
  consumer_sync();
  exchange_layer(act, x, N, p.first, kNC, rank, C);
  return t;
}

// A one-chunk layer split over K, this rank owning kSegs of its kSegments
// segments from p.seg: each segment's partial sum from zero, kept in
// registers until every rank has read the layer's input (the cluster
// barrier), then written into block 1 + segment of this block's buffer and
// sent to every peer's; once all have landed, every rank adds the
// kSegments partials in order, then the bias and relu, into block 0.
template <int kSegs>
__device__ __forceinline__ int consume_split(float* act, const Ring& ring, int t, Exchange& x, const LayerPlan& p,
                                             int N, const float* __restrict__ bias, bool hidden, int rank, int C) {
  float part[kSegs > 0 ? kSegs : 1][1][kChunk / 2];
#pragma unroll
  for (int i = 0; i < kSegs; ++i) {
    t = products<1>(part[i], act, ring, t, segment_begin(p.seg + i, p.stages), segment_begin(p.seg + i + 1, p.stages));
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_arrive_expect_tx(x.bar, static_cast<unsigned>((kSegments - kSegs) * kBlockFloats * sizeof(float)));
  }
  copies_read();  // this thread's copies of the last exchange have read the buffer
  cluster_sync();  // every rank has read the layer's input
#pragma unroll
  for (int i = 0; i < kSegs; ++i) store_fragment(act, part[i][0], (1 + p.seg + i) * kChunk);
  fence_proxy_async();  // the writes, before the copies read them
  consumer_sync();
  if (tid < kSegs * C) {  // one thread a (segment, peer)
    const int block = 1 + p.seg + tid / C, peer = tid % C;
    if (peer != rank) {
      const float* const src = act + block * kBlockFloats;
      copy_to_peer(peer_address(shared_address(src), peer), src, kBlockFloats * sizeof(float),
                   peer_address(shared_address(x.bar), peer));
    }
  }
  mbar_wait(x.bar, x.n & 1);
  ++x.n;
  const int lane = tid & 31, r0 = 16 * (tid >> 5) + (lane >> 2), t4 = lane & 3;
  float sum[kChunk / 2];
#pragma unroll
  for (int e = 0; e < kChunk / 2; ++e) {
    const int row = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * t4 + (e & 1);
    float v = act[act_offset(row, kChunk + col)];
#pragma unroll
    for (int s = 1; s < kSegments; ++s) v = __fadd_rn(v, act[act_offset(row, (1 + s) * kChunk + col)]);
    sum[e] = v;
  }
  bias_relu(sum, 0, N, bias, hidden);
  store_fragment(act, sum, 0);
  consumer_sync();  // block 0 holds the layer's output for every consumer thread
  return t;
}

// The consumer's part of one head's layers (layer_plan): each layer's owned
// chunks, its K segments, or only the exchange where this rank owns none.
__device__ __forceinline__ int consume_layers(float* act, const Ring& ring, int t, Exchange& x,
                                              const MlpLayers& net, int rank, int C) {
  for (int l = 0; l < net.n_layers; ++l) {
    const int K = net.width[l], N = net.width[l + 1];
    const bool hidden = l + 1 < net.n_layers;
    const LayerPlan p = layer_plan(K, N, rank, C);
    if (p.split) {
      if (p.segs == 2) {
        t = consume_split<2>(act, ring, t, x, p, N, net.b[l], hidden, rank, C);
      } else if (p.segs == 1) {
        t = consume_split<1>(act, ring, t, x, p, N, net.b[l], hidden, rank, C);
      } else {
        t = consume_split<0>(act, ring, t, x, p, N, net.b[l], hidden, rank, C);
      }
    } else if (p.count == 2) {
      t = consume_layer<2>(act, ring, t, x, p, N, net.b[l], hidden, rank, C);
    } else if (p.count == 1) {
      t = consume_layer<1>(act, ring, t, x, p, N, net.b[l], hidden, rank, C);
    } else {
      exchange_layer(act, x, N, p.first, 0, rank, C);
    }
  }
  return t;
}

// ---------------------------------------------------------------------------
// the loader: W split once into the ring
// ---------------------------------------------------------------------------

// Loader thread tl of 128 takes, in each owned chunk and k-step, column n =
// tl % 64 and the four k rows 4 · (tl / 64) .. + 3, and writes them as one
// 16-byte row of a Wᵀ core matrix for hi and one for lo (a warp's 32 rows
// contiguous). It reads them from the raw staging ring, which the loader
// threads fill kRawStages - 1 stages ahead by cp.async (a warp reads 32
// neighbouring columns of a staged row: no bank conflict), or, in a kernel
// whose kmeans norms leave no room for that ring, from device memory,
// kPrefetch stages ahead in registers.
struct LoaderStage {
  float4 w[kStageSteps][kMaxChunks];
};

// The loader's walk through one layer (K inputs, N outputs, `count` chunks
// from `first`).
struct LayerW {
  const float* W;
  int K, N, first, count;
};

// Splits a stage of LoaderStage values and writes Wᵀ hi and lo into the ring
// at position pos, once the consumer is done with that stage.
__device__ __forceinline__ void put_stage(const Ring& ring, int pos, const LoaderStage& x, int count, int o) {
  const int s = pos & (ring.n - 1);
  mbar_wait(&ring.empty[s], ((pos >> ring.log_n) & 1) ^ 1);  // the consumer is done with the stage
  float* const st = ring.stages + s * kStageFloats;
#pragma unroll
  for (int q = 0; q < kStageSteps; ++q) {
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      if (j < count) {
        uint32_t h[4], l[4];
        split(x.w[q][j].x, h[0], l[0]);
        split(x.w[q][j].y, h[1], l[1]);
        split(x.w[q][j].z, h[2], l[2]);
        split(x.w[q][j].w, h[3], l[3]);
        float* const tile = st + q * kStepFloats + 2 * j * kTile + o;
        *reinterpret_cast<uint4*>(tile) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(tile + kTile) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
  fence_proxy_async();  // the writes, before wgmma reads them
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.full[s]);
}

// The stages [begin, end) of layer w into the ring from position t on; the
// raw staging ring's position rt advances by the stages staged. Returns the
// ring position after.
__device__ __forceinline__ int produce_stages(const Ring& ring, int t, int& rt, const LayerW& w, int begin, int end) {
  if (begin >= end) return t;
  const int tl = threadIdx.x - 128;
  const int n = tl % kChunk, kq = tl / kChunk;
  const int o = kt_offset<kChunk>(n, 4 * kq);
  const int col0 = w.first * kChunk;
  if (ring.raw_n > 0) {
    // stage v's rows of W into the raw ring by cp.async, one commit group a
    // stage (an empty one past the layer's end keeps the count): 16-byte
    // copies where the rows are 16-byte aligned, else 4-byte ones. A copy
    // past K or N fills zeros, so the staged rows need no mask. Each
    // thread's copies sit at the same places in every stage: their offsets
    // are computed once for the layer.
    const bool vec = w.N % 4 == 0 && (reinterpret_cast<uintptr_t>(w.W) & 15) == 0;
    const int per_row = w.count * kChunk / (vec ? 4 : 1);  // copies a row of the stage
    const int shift = 31 - __clz(per_row);                  // per_row is a power of two
    const int copies = kStageSteps * kStep * per_row / 128;  // a thread's, a stage: 2, 4, 8 or 16
    const auto stage_rows = [&](int v) {
      if (v < end) {
        float* const dst = ring.raw + ((rt + (v - begin)) & (kRawStages - 1)) * kRawFloats;
        const int k0 = v * kStageSteps * kStep;
        const float* const src = w.W + static_cast<size_t>(k0) * w.N + col0;
        for (int r = 0; r < copies; ++r) {
          const int i = tl + 128 * r, kk = i >> shift, c = (i & (per_row - 1)) * (vec ? 4 : 1);
          const bool in = k0 + kk < w.K && col0 + c < w.N;
          const float* const from = in ? src + kk * w.N + c : w.W;  // nothing is read past K or N
          if (vec) {
            cp_async16(dst + kk * kMaxChunks * kChunk + c, from, in ? 16 : 0);
          } else {
            cp_async4(dst + kk * kMaxChunks * kChunk + c, from, in ? 4 : 0);
          }
        }
      }
      cp_async_commit();
    };
    for (int v = begin; v < begin + kRawStages - 1; ++v) stage_rows(v);
    for (int u = begin; u < end; ++u) {
      cp_async_wait<kRawStages - 2>();  // this thread's copies of stage u have landed
      asm volatile("bar.sync 2, 128;\n" ::: "memory");  // and every loader thread's; stage u - 1 is read
      stage_rows(u + kRawStages - 1);  // into stage u - 1's slot
      const float* const raw = ring.raw + ((rt + (u - begin)) & (kRawStages - 1)) * kRawFloats + 4 * kq * kMaxChunks * kChunk + n;
      LoaderStage x;
#pragma unroll
      for (int q = 0; q < kStageSteps; ++q) {
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {  // past count: whatever the slot holds, never written out
          const float* const p = raw + q * kStep * kMaxChunks * kChunk + j * kChunk;
          x.w[q][j] = make_float4(p[0], p[kMaxChunks * kChunk], p[2 * kMaxChunks * kChunk], p[3 * kMaxChunks * kChunk]);
        }
      }
      put_stage(ring, t + (u - begin), x, w.count, o);
    }
    cp_async_wait<0>();
    asm volatile("bar.sync 2, 128;\n" ::: "memory");  // every slot is read before the next call refills it
    rt += end - begin;
    return t + (end - begin);
  }
  const auto fetch = [&](int u, LoaderStage& x) {
    if (u >= end) return;
#pragma unroll
    for (int q = 0; q < kStageSteps; ++q) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int col = col0 + j * kChunk + n;
        float v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = (u * kStageSteps + q) * kStep + 4 * kq + m;
          v[m] = (j < w.count && k < w.K && col < w.N) ? __ldg(w.W + static_cast<size_t>(k) * w.N + col) : 0.0f;
        }
        x.w[q][j] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  LoaderStage buf[kPrefetch];
#pragma unroll
  for (int d = 0; d < kPrefetch; ++d) fetch(begin + d, buf[d]);
  for (int u = begin; u < end; u += kPrefetch) {
#pragma unroll
    for (int d = 0; d < kPrefetch; ++d) {
      if (u + d < end) {
        put_stage(ring, t + (u + d - begin), buf[d], w.count, o);
        fetch(u + d + kPrefetch, buf[d]);
      }
    }
  }
  return t + (end - begin);
}

// The loader's part of one head's layers (layer_plan), after it arrived at
// the cluster barrier that opens the prologue's exchange: per layer, the
// rank's stages not yet produced, then the next layer's first ones (as many
// as the ring holds: every stage is free once the consumer is done with the
// layer), then the wait for the barrier before and the arrival at the
// layer's own — the loader never holds a barrier up. After the last layer,
// the wait for its exchange.
__device__ __forceinline__ int produce_layers(const Ring& ring, int t, int& rt, Exchange& x, const MlpLayers& net,
                                              int rank, int C) {
  const auto plan = [&](int l, LayerW& w) {
    const LayerPlan p = layer_plan(net.width[l], net.width[l + 1], rank, C);
    w = LayerW{net.W[l], net.width[l], net.width[l + 1], p.first, p.count};
    return p;
  };
  int done = 0;  // the layer's stages produced ahead
  for (int l = 0; l < net.n_layers; ++l) {
    LayerW w;
    const LayerPlan p = plan(l, w);
    t = produce_stages(ring, t, rt, w, p.sbegin + done, p.send);
    done = 0;
    if (l + 1 < net.n_layers) {
      LayerW next;
      const LayerPlan q = plan(l + 1, next);
      done = min(q.send - q.sbegin, ring.n);
      t = produce_stages(ring, t, rt, next, q.sbegin, q.sbegin + done);
    }
    cluster_wait();
    cluster_arrive();
    ++x.n;
  }
  cluster_wait();
  mbar_wait(x.bar, (x.n - 1) & 1);
  return t;
}

// ---------------------------------------------------------------------------
// the row phases
// ---------------------------------------------------------------------------

// Whether (a, ia) comes first in argmax order: NaN above every number, then
// the larger value, then the lower index.
__device__ __forceinline__ bool ranks_first(float a, int ia, float b, int ib) {
  const bool na = is_nan(a), nb = is_nan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// The head of one row r of the tile (uniform across the warp) from its
// logits in the activation buffer: softmax into the probabilities, the first
// maximal logit's label into prediction.
__device__ __forceinline__ void head_row(const float* act, int r, int classes, const float* __restrict__ labels,
                                         float* __restrict__ prediction, float* __restrict__ probabilities,
                                         int row, int lane) {
  const float v = lane < classes ? act[act_offset(r, lane)] : __int_as_float(0xff800000);  // -inf
  float m = v;  // the max, NaN propagating as in torch.softmax
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, m, offset);
    m = (is_nan(o) || o > m) ? o : m;
  }
  const float e = lane < classes ? expf(v - m) : 0.0f;
  float s = e;
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) s += __shfl_xor_sync(0xffffffffu, s, offset);
  if (lane < classes) probabilities[static_cast<size_t>(row) * classes + lane] = e / s;
  float best = v;
  int best_idx = lane;  // lanes past the classes hold -inf at a higher index than any class
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, best, offset);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, offset);
    if (ranks_first(o, oi, best, best_idx)) {
      best = o;
      best_idx = oi;
    }
  }
  if (lane == 0) prediction[row] = __ldg(labels + best_idx);
}

// One phase for one row (uniform across the warp): the table's ops [begin,
// end), then, with `act`, the head's input slot into the tile's row r of
// this block's activation buffer: [0, d0), zeros to the end of its last
// 64-column block. A row past `rows` runs no op and stages zeros. `strip`
// is the warp's shared memory for a sparse head's fold. Not
// inlined: inlined, the kernel spilled at wide slots (PERF.md).
template <int kSlots>
__device__ __noinline__ void phase_row(const rowlocal::Table& table, int begin, int end, int head_src, int row,
                                       int rows, int lane, const float* norms, float* strip, float* act, int r,
                                       int d0) {
  float v[kSlots];
  if (row < rows) {
    const int cur = rowlocal::run_row<kSlots>(table, begin, end, row, lane, v, norms, strip);
    if (act != nullptr && cur != head_src) rowlocal::load_row<kSlots>(table.slots[head_src], row, lane, v);
  }
  if (act == nullptr) return;
  const int d_end = round_up(d0, kChunk);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = s * kWarp + lane;
    if (j < d_end) act[act_offset(r, j)] = (row < rows && j < d0) ? v[s] : 0.0f;
  }
  for (int j = kSlots * kWarp + lane; j < d_end; j += kWarp) act[act_offset(r, j)] = 0.0f;
}

// The table in phases (file comment): for each mlp head, the ops before it
// on this rank's rows of the tile, staged into this block's buffer and sent
// to every peer; its layers (the consumer and the loader warpgroups); its
// head on this rank's rows; after the last head, the epilogue's ops.
template <int kSlots>
__global__ void __launch_bounds__(kThreads, 1)
rowlocal_mlp_kernel(const __grid_constant__ rowlocal::Table table,
                    const __grid_constant__ MlpNets nets, int rows, int n_stages, int raw_stages, int with_norms) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(16) float strips[kWarps][kWarp];  // kStripBytes
  float* const act = smem;  // kMaxWidth / kChunk blocks of [kRows][kChunk] (act_offset)
  Ring ring;
  ring.n = n_stages;
  ring.log_n = 31 - __clz(n_stages);
  ring.stages = act + kRows * kMaxWidth;
  ring.raw_n = raw_stages;
  ring.raw = ring.stages + n_stages * kStageFloats;
  ring.full = reinterpret_cast<uint64_t*>(ring.raw + raw_stages * kRawFloats);
  ring.empty = ring.full + n_stages;
  Exchange x{ring.empty + n_stages, 0};
  float* const norms = reinterpret_cast<float*>(x.bar + 1);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int rank = cluster_rank(), C = cluster_size();
  const int row0 = static_cast<int>(blockIdx.x / C) * kRows;
  // this rank's rows of the tile in the row phases
  const int r_begin = rank * kRows / C, r_end = (rank + 1) * kRows / C;
  const bool loader = tid >= 128;
  if (with_norms) rowlocal::table_norms(table, norms, warp, kWarps, lane);
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&ring.full[s], 4);   // a lane of each loader warp
      mbar_init(&ring.empty[s], 4);  // a lane of each consumer warp
    }
    mbar_init(x.bar, 1);  // the local arrive that posts the bytes, then the peers' copies
    mbar_init_fence();
  }
  __syncthreads();
  int t = 0;   // the ring position, the same in both warpgroups
  int rt = 0;  // the raw ring's position (the loader's)
  int begin = 0;
  while (begin <= table.n_ops) {  // uniform: the table decides every branch
    int end = begin;
    while (end < table.n_ops && table.ops[end].op != rowlocal::kMlp) ++end;
    if (end == table.n_ops) {  // the epilogue
      if (begin < end) {
        for (int r = r_begin + warp; r < r_end; r += kWarps) {
          phase_row<kSlots>(table, begin, end, -1, row0 + r, rows, lane, norms, strips[warp], nullptr, r, 0);
        }
      }
      break;
    }
    const rowlocal::Op& head = table.ops[end];
    const MlpLayers& net = nets.net[head.k];
    const int d0 = net.width[0];
    if (!loader) copies_read();  // the last exchange's copies have read this block's buffer
    __syncthreads();
    for (int r = r_begin + warp; r < r_end; r += kWarps) {
      phase_row<kSlots>(table, begin, end, head.src, row0 + r, rows, lane, norms, strips[warp], act, r, d0);
    }
    fence_proxy_async();  // the staged rows, before the copies read them
    __syncthreads();
    if (tid == 0) {
      mbar_arrive_expect_tx(x.bar, static_cast<unsigned>(n_chunks(d0) * (kRows - (r_end - r_begin)) * kChunk *
                                                         sizeof(float)));
    }
    // every block of the cluster has started, has read its buffer for the
    // previous head and expects its bytes: the rows go to every peer
    cluster_arrive();
    if (loader) {
      ++x.n;
      t = produce_layers(ring, t, rt, x, net, rank, C);
    } else {
      cluster_wait();
      if (tid < n_chunks(d0) * C) {  // one thread a (block, peer)
        const int chunk = tid / C, p = tid % C;
        if (p != rank) {
          const float* const src = act + chunk * kBlockFloats + r_begin * kChunk;
          copy_to_peer(peer_address(shared_address(src), p), src,
                       static_cast<unsigned>((r_end - r_begin) * kChunk * sizeof(float)),
                       peer_address(shared_address(x.bar), p));
        }
      }
      mbar_wait(x.bar, x.n & 1);
      ++x.n;
      t = consume_layers(act, ring, t, x, net, rank, C);
    }
    __syncthreads();  // the logits (a split last layer's, summed by the consumer) for every warp
    const int classes = net.width[net.n_layers];
    for (int r = r_begin + warp; r < r_end; r += kWarps) {
      if (row0 + r < rows) {
        head_row(act, r, classes, head.a, table.slots[head.dst].ptr, table.slots[head.dst2].ptr, row0 + r, lane);
      }
    }
    __syncthreads();  // the head's outputs are in device memory for the next phase
    begin = end + 1;
  }
}

// Blocks of one cluster: the most (up to kMaxCluster) whose clusters all run
// at once, one for each tile, so that a batch is one wave on the card; where
// no size does, the fewest that cover the widest layer with kMaxChunks
// chunks a rank, and at least 2 (more blocks would not shorten a block's
// chain of products, only add waves). The card's room for clusters of each size is asked once
// per kernel instance (cudaOccupancyMaxActiveClusters: a block takes most of
// an SM's shared memory, and a cluster's blocks share a GPC).
template <int kSlots>
int cluster_blocks(const MlpNets& nets, int n_heads, int tiles, cudaLaunchConfig_t config) {
  int widest = 1;
  for (int h = 0; h < n_heads; ++h) {
    for (int l = 1; l <= nets.net[h].n_layers; ++l) widest = std::max(widest, n_chunks(nets.net[h].width[l]));
  }
  int least = 2;  // a one-chunk layer's kSegments K segments, at most 2 a rank
  while (least * kMaxChunks < widest) least *= 2;
  static int active[kMaxCluster + 1] = {};  // clusters of each size that fit at once (0: not asked, -1: refused)
  for (int C = kMaxCluster; C > least; C /= 2) {
    if (active[C] == 0) {
      cudaLaunchAttribute cluster[1];
      cluster[0].id = cudaLaunchAttributeClusterDimension;
      cluster[0].val.clusterDim.x = static_cast<unsigned>(C);
      cluster[0].val.clusterDim.y = 1;
      cluster[0].val.clusterDim.z = 1;
      config.gridDim = dim3(static_cast<unsigned>(C));
      config.attrs = cluster;
      config.numAttrs = 1;
      int n = 0;
      active[C] = cudaOccupancyMaxActiveClusters(&n, rowlocal_mlp_kernel<kSlots>, &config) == cudaSuccess ? n : -1;
      cudaGetLastError();  // a refused query leaves no error behind for the launch
    }
    if (active[C] > 0 && tiles <= active[C]) return C;
  }
  return least;
}

template <int kSlots>
cudaError_t launch_rowlocal_mlp(const rowlocal::Table& table, const MlpNets& nets, int n_heads, int rows,
                                int norm_floats, cudaStream_t stream) {
  // the stages that fit beside the activations and the centroid norms: four
  // and the raw staging ring, or without it as many as fit
  const size_t norm_bytes = sizeof(float) * static_cast<size_t>(norm_floats);
  const size_t room = kSmemLimit - kActBytes - sizeof(uint64_t) - norm_bytes;
  int n_stages = 4, raw_stages = kRawStages;  // powers of two
  if (n_stages * kStageBytes + raw_stages * kRawBytes > room) {
    raw_stages = 0;
    n_stages = room >= 4 * kStageBytes ? 4 : 2;
  }
  if (n_stages * kStageBytes > room) return cudaErrorInvalidValue;
  const size_t smem = kActBytes + n_stages * kStageBytes + raw_stages * kRawBytes + sizeof(uint64_t) + norm_bytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      rowlocal_mlp_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int tiles = (rows + kRows - 1) / kRows;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  const int C = cluster_blocks<kSlots>(nets, n_heads, tiles, config);
  config.gridDim = dim3(static_cast<unsigned>(tiles * C));
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(C);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, rowlocal_mlp_kernel<kSlots>, table, nets, rows, n_stages, raw_stages,
                            static_cast<int>(norm_floats > 0));
}

// The network of n_layers layers from host arrays, or false past the limits.
bool load_net(MlpLayers& net, const void* const* weights, const void* const* biases,
              const int* widths, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  net = {};
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1 || widths[i] > kMaxWidth) return false;
    net.width[i] = widths[i];
  }
  if (widths[n_layers] > kMaxClasses) return false;
  for (int l = 0; l < n_layers; ++l) {
    net.W[l] = static_cast<const float*>(weights[l]);
    net.b[l] = static_cast<const float*>(biases[l]);
  }
  return true;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table or a network past the limits, a table
// load_table refuses, or an mlp head whose slots do not fit its network (its
// input slot of another width than the network's input, its prediction slot
// not [rows], its probabilities slot not [rows, classes], float32). ops and
// slots are the table (rowlocal_ops.cuh) with n_heads >= 1 mlp entries, the
// i-th of them with Op.k == i. The networks come as host arrays: n_layers
// [n_heads] layer counts, and weights, biases (device pointers) and widths
// ([d_in, hidden..., classes]) of every head one after the other. rows == 0
// launches nothing.
int megakernel_rowlocal_mlp(const void* ops, int n_ops, const void* slots, int n_slots,
                            const void* const* weights, const void* const* biases,
                            const int* widths, const int* n_layers, int n_heads, int rows,
                            void* stream) {
  if (n_heads < 1 || n_heads > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  rowlocal::Table table;
  int widest = 1, norm_floats = 0;
  cudaError_t rc = rowlocal::load_table(table, ops, n_ops, slots, n_slots, n_heads, &widest,
                                        &norm_floats);
  if (rc != cudaSuccess || norm_floats > kMaxNormFloats) return static_cast<int>(cudaErrorInvalidValue);
  MlpNets nets = {};
  for (int h = 0, layer = 0, width = 0; h < n_heads; ++h) {
    if (!load_net(nets.net[h], weights + layer, biases + layer, widths + width, n_layers[h])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    layer += n_layers[h];
    width += n_layers[h] + 1;
  }
  int seen = 0;
  for (int i = 0; i < n_ops; ++i) {
    const rowlocal::Op& op = table.ops[i];
    if (op.op != rowlocal::kMlp) continue;
    const MlpLayers& net = nets.net[op.k];
    const rowlocal::Slot& probs = table.slots[op.dst2];
    if (op.k != seen++ || op.a == nullptr || table.slots[op.src].width != net.width[0] ||
        probs.width != net.width[net.n_layers]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (seen != n_heads) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (widest <= kWarp) {
      rc = launch_rowlocal_mlp<1>(table, nets, n_heads, rows, norm_floats, s);
    } else if (widest <= 2 * kWarp) {
      rc = launch_rowlocal_mlp<2>(table, nets, n_heads, rows, norm_floats, s);
    } else if (widest <= 4 * kWarp) {
      rc = launch_rowlocal_mlp<4>(table, nets, n_heads, rows, norm_floats, s);
    } else if (widest <= 8 * kWarp) {
      rc = launch_rowlocal_mlp<8>(table, nets, n_heads, rows, norm_floats, s);
    } else if (widest <= 16 * kWarp) {
      rc = launch_rowlocal_mlp<16>(table, nets, n_heads, rows, norm_floats, s);
    } else {
      rc = launch_rowlocal_mlp<32>(table, nets, n_heads, rows, norm_floats, s);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
