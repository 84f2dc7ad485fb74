// Cluster-block scorers of the tiered IVF store for Hopper (sm_90a), plain C
// interface.
//
// Replaces three XLA-jitted functions of the reference (none is a Pallas
// kernel):
//   pathway_tpu/ops/knn_quant.py::quant_score_block_kernel -> pw_quant_score_blocks
//   pathway_tpu/ops/knn_tiers.py::_score_block_kernel      -> pw_score_blocks (fp32)
//   pathway_tpu/ops/knn_quant.py::quant_probe_kernel       -> pw_quant_probe
//
// Both block scorers score one search batch in one launch. The wrapper
// (ops/score_blocks.py) hands each a work list: for every probed cluster
// block the device pointers of its payload (int8 codes with per-row scales,
// or fp32 rows) with its exact norms and additive 0 / -inf mask, the queries
// that probe it and, for each of them, the column of the (nq, W) output
// where the block's scores start:
//   out[q, col + r] = epilogue(<query q, row r>) + mask[r]
// Cells no block writes keep the -inf the wrapper filled. Epilogues, in the
// reference's order of operations (knn_quant.approx_scores and the inlined
// l2sq body of knn_tiers.search_batch for int8, knn_quant.host_metric_scores
// plus the mask add for fp32):
//   int8 l2sq: dot * ((2 * qs) * s_r) + (mask_r - |d_r|^2)
//   int8 cos : (dot * (qs * s_r)) / max(sqrt(|q|^2) * sqrt(|d_r|^2), 1e-30) + mask_r
//   int8 ip  : dot * (qs * s_r) + mask_r
//   fp32 l2sq: ((2 * dot) - |d_r|^2) - |q|^2 + mask_r
//   fp32 cos : dot / max(sqrt(|q|^2) * sqrt(|d_r|^2), 1e-30) + mask_r
//   fp32 ip  : dot + mask_r
// Every multiply, add, divide and root is written with a round-to-nearest
// intrinsic, so nvcc cannot contract a multiply and an add into one FMA, and
// one thread computes each score's epilogue: the int8 scores are bitwise the
// reference's host arithmetic, and no bit depends on the block's capacity,
// the batch size or the query's row in the batch.
//
// pw_quant_score_blocks (int8). What bounds it: device-memory bytes. Each
// probed block's codes, scales, norms and mask are read once per batch, and
// a row meets the 1-2 queries that probe its block (1-16 in a concurrent
// commit) in d multiply-adds each: about 2 int8 operations per byte per
// query, against a ridge of hundreds. The card needs about 18 KB in flight
// per SM to stream at its rate (3.35 TB/s times ~0.7 us of latency, over 132
// SMs), more under load; a kernel that copies a tile synchronously, then
// computes, keeps a fraction of that in flight. Design:
// - Tiles of R rows (R = 128 up to d = 384; fewer for wider rows, so a tile
//   stays near 48 KB). A block's codes are one contiguous (n, d) array, so a
//   tile is one run of R * d bytes, 16-byte aligned (d % 16 == 0): one
//   cp.async.bulk (1-D TMA, no tensor map, so nothing is encoded on the host
//   per block) brings it into shared memory, and three more its scales,
//   norms and mask; completion is counted on an mbarrier. cp.async.bulk was
//   taken over 16-byte cp.async because one thread issues a whole tile and
//   no register or instruction of the consumers is spent on the copy.
// - A ring of up to 4 such stages in dynamic shared memory (about 214 KB at
//   d = 384: 3-4 tiles, 144-192 KB, in flight per SM) on a persistent grid:
//   as many blocks as fit on the card (one per SM at d = 384) walk the
//   batch's tiles with a stride. One producer warp finds each tile's
//   cluster block by a binary search over the per-block prefix of tile
//   counts (read into shared memory once; searched in device memory for a
//   batch of more than 4,096 blocks, or where it would cost the ring a
//   stage), issues its copies and stages the tile's (query, column)
//   entries; eight consumer warps score it.
// - Bank conflicts: rows sit unpadded at a stride of d bytes, so a consumer
//   maps the 8 lanes of a quarter-warp across one row's columns (lane k reads
//   16-byte chunks k, k + 8, ...): each quarter-warp reads 128 contiguous
//   bytes, conflict-free for any d. The int32 dot of a row is then summed
//   across the 8 lanes with __shfl_xor_sync in a reduce-scatter, so lane j
//   ends with the whole dot of the pass's query j; int32 addition is exact
//   and associative, so the order cannot change a bit.
// - A block's queries go in passes of up to 8 (1, 2, 4 or 8 wide, by what
//   is left) over the tile while it sits in shared memory, so a tile is read
//   from device memory once whatever the number of queries. The codes of
//   its first pass (up to 8 queries at d <= 512) are bulk-copied into the
//   stage with the tile and read as broadcasts (the 4 quarter-warps of a
//   warp read the same chunk); later passes, rare outside concurrent
//   commits, read them from device memory, where a batch's few KB stay in
//   L1.
// - Nothing is kept from one launch to the next: the work list is built and
//   copied by the wrapper for every call.
//
// pw_score_blocks (fp32): one thread block of 128 threads per 128-row tile
// (the wrapper's list holds one word per tile), the block's rows staged
// through shared memory 256 bytes of every row at a time in 16-byte loads
// (row stride padded by 16 B so 8 threads' reads hit distinct bank groups),
// one thread per (query, row) over the columns in ascending order with a
// chain of fmaf (it agrees with a BLAS product to rounding, not bitwise),
// QT queries per pass.
//
// pw_quant_probe: the int8 coarse affinity 2 * (dot * (qs * cs)) - |c|^2 of
// every (query, centroid), pad centroids (|c|^2 = +inf) scoring -inf. What
// bounds it: neither bytes nor operations (a 48 KB table against 8-32 query
// rows is well under a microsecond of either) but latency: the launch, one
// round trip to memory, the writes. One thread per (query, centroid) walking
// its row in 96 serial 4-byte loads, the lanes of a warp 384 B apart, on 4
// thread blocks, took ~14 us at 128 x 8 (18x an empty launch). Design:
// - One warp per centroid row, against the 8 query rows of its thread block
//   (4 warps; one block per 4 centroids and 8 query rows, up to 8 blocks per
//   SM: 32 blocks at 128 x 8, 128 at 128 x 32). Lane l reads the row's words
//   l, l + 32, ..., so every load of a warp is one 128-byte request, and
//   keeps up to 512 columns of the row in registers while it meets the 8
//   rows. Each warp loads its first row while its block stages the
//   queries, and its next row's first columns while it reduces one.
// - The block's 8 query rows (3 KB at d = 384) go into shared memory by
//   cp.async, every copy in flight at once (16 bytes where the rows allow,
//   else 4; rows wider than 6,144 columns are read from device memory).
//   Consecutive lanes read consecutive words of a row: no bank conflicts.
// - A reduce-scatter of __shfl_xor_sync (the block scorer's idiom, over the
//   whole warp) leaves each query's int32 dot in one lane, which runs the
//   epilogue with the scales and |c|^2 loaded before the dot: int32
//   addition is exact in any order and the epilogue is one thread per score,
//   as before, so every bit is the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float epilogue_int8(int acc, float qs, float sr, float nr, float mr,
                                               float qn, int metric) {
  const float dot = __int2float_rn(acc);
  if (metric == 0) {
    return __fadd_rn(__fmul_rn(dot, __fmul_rn(__fmul_rn(2.0f, qs), sr)), __fsub_rn(mr, nr));
  }
  float s = __fmul_rn(dot, __fmul_rn(qs, sr));
  if (metric == 1) {
    s = __fdiv_rn(s, fmaxf(__fmul_rn(__fsqrt_rn(qn), __fsqrt_rn(nr)), 1e-30f));
  }
  return __fadd_rn(s, mr);
}

__device__ __forceinline__ float epilogue_f32(float dot, float nr, float mr, float qn,
                                              int metric) {
  float s = dot;
  if (metric == 0) {
    s = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, dot), nr), qn);
  } else if (metric == 1) {
    s = __fdiv_rn(dot, fmaxf(__fmul_rn(__fsqrt_rn(qn), __fsqrt_rn(nr)), 1e-30f));
  }
  return __fadd_rn(s, mr);
}

// ---------------------------------------------------------------------------
// int8: whole tiles by bulk asynchronous copy on a persistent grid
// ---------------------------------------------------------------------------

constexpr int Q_WARPS = 8;                    // consumer warps
constexpr int Q_THREADS = (Q_WARPS + 1) * 32;  // and one producer warp
constexpr int Q_SLOTS = Q_WARPS * 4;           // row slots: one quarter-warp each
constexpr int Q_MAX_TILE = 128;                // rows per tile, at most
constexpr int Q_ROUNDS = Q_MAX_TILE / Q_SLOTS; // rows per slot per tile, at most
constexpr int Q_MAX_STAGES = 4;
constexpr int ECAP = 64;          // (query, column) entries staged with a tile
constexpr int HEAD_BYTES = 128;   // the ring's mbarriers
constexpr int PREFIX_SMEM_MAX = 4096;  // blocks whose tile prefix is staged in shared memory
constexpr unsigned FULL_MASK = 0xffffffffu;

struct QArgs {
  const int64_t* blocks;  // (n_blocks, 6): codes, scales, norms, mask pointers; n rows; first tile
  const int64_t* goff;    // (n_blocks + 1,): the entries of block b are goff[b] .. goff[b+1]-1
  const int64_t* gq;      // (n_entries,): query of each entry
  const int64_t* gcol;    // (n_entries,): output column of row 0 for that query
  const int8_t* queries;  // (nq, d) int8 codes
  const float* q_scales;  // (nq,)
  const float* qn;        // (nq,) |q|^2 from the host
  float* out;             // (nq, out_stride)
  int64_t out_stride;
  int n_blocks;
  int n_tiles;
  int tile_rows;  // R, a multiple of 8, at most Q_MAX_TILE
  int d;          // a multiple of 16
  int metric;     // 0 l2sq, 1 cos, 2 ip
  int stages;
  int stage_bytes;
  int prefix_in_smem;
};

// Query rows staged with a tile: the codes of its block's first entries,
// one pass of 8 up to d = 512, fewer (at least one) for wider rows.
__host__ __device__ inline int staged_queries(int d) {
  const int q = 4096 / d;
  return q < 1 ? 1 : q > 8 ? 8 : q;
}

// Offsets inside one stage: codes (R * d), scales, norms, mask (R floats
// each), entry queries (ECAP int), entry columns (ECAP int64), the header,
// the codes of the first staged_queries(d) entries' queries (d each).
struct StageLayout {
  int scales, norms, mask, eq, ecol, head, qcodes, bytes;
  __host__ __device__ explicit StageLayout(int r, int d) {
    scales = r * d;
    norms = scales + 4 * r;
    mask = norms + 4 * r;
    eq = mask + 4 * r;
    ecol = eq + 4 * ECAP;
    head = ecol + 8 * ECAP;
    qcodes = head + 32;
    bytes = (qcodes + staged_queries(d) * d + 127) / 128 * 128;
  }
};

struct StageHead {
  int64_t row0;  // first row of the tile in its block
  int64_t g0;    // first entry of its block
  int rows;      // rows of the tile
  int g;         // entries of its block
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, counted on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// N values per lane -> N / 2: the lanes with bit ``m`` set keep the upper
// half, the others the lower, each adding its partner's copy of the half it
// keeps.
template <int N>
__device__ __forceinline__ void halve(int* v, int lane, int m) {
  const bool up = (lane & m) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int send = up ? v[i] : v[i + N / 2];
    const int keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, m);
  }
}

// Sum QP int32 values over the 8 lanes of a quarter-warp: afterwards lane k
// holds the whole sum of value k >> (3 - log2 QP). Every lane of the warp
// takes part.
template <int QP>
__device__ __forceinline__ int quarter_reduce(int (&v)[QP], int lane) {
  int m = 4;
  if constexpr (QP >= 8) {
    halve<8>(v, lane, m);
    m >>= 1;
  }
  if constexpr (QP >= 4) {
    halve<4>(v, lane, m);
    m >>= 1;
  }
  if constexpr (QP >= 2) {
    halve<2>(v, lane, m);
    m >>= 1;
  }
  for (; m > 0; m >>= 1) v[0] += __shfl_xor_sync(FULL_MASK, v[0], m);
  return v[0];
}

// One pass of up to QP queries (entries p0 .. p0 + np - 1 of the tile's
// block) over the tile in stage ``st``: this quarter-warp's rows slot,
// slot + 32, ...; lane k of the quarter takes 16-byte column chunks k, k + 8, ...
template <int QP>
__device__ __forceinline__ void score_pass(const QArgs& a, const unsigned char* st,
                                           const StageLayout& L, const StageHead& h, int p0,
                                           int np, int slot, int lane) {
  constexpr int SHIFT = QP == 8 ? 0 : QP == 4 ? 1 : QP == 2 ? 2 : 3;
  const int* eq = reinterpret_cast<const int*>(st + L.eq);
  const int64_t* ecol = reinterpret_cast<const int64_t*>(st + L.ecol);
  const int k = lane & 7;
  const int chunks = a.d >> 4;
  const int staged = staged_queries(a.d);
  int qi[QP];
  const int8_t* qrow[QP];  // in the stage, else in device memory (generic loads)
#pragma unroll
  for (int j = 0; j < QP; ++j) {  // pad rows repeat the last entry; never written
    const int e = p0 + min(j, np - 1);
    qi[j] = e < ECAP ? eq[e] : static_cast<int>(a.gq[h.g0 + e]);
    qrow[j] = e < staged ? reinterpret_cast<const int8_t*>(st + L.qcodes) + e * a.d
                         : a.queries + static_cast<int64_t>(qi[j]) * a.d;
  }
  int acc[Q_ROUNDS][QP];
#pragma unroll
  for (int i = 0; i < Q_ROUNDS; ++i) {
#pragma unroll
    for (int j = 0; j < QP; ++j) acc[i][j] = 0;
  }
  for (int c = k; c < chunks; c += 8) {
    int4 qv[QP];
#pragma unroll
    for (int j = 0; j < QP; ++j) {
      qv[j] = reinterpret_cast<const int4*>(qrow[j])[c];
    }
#pragma unroll
    for (int i = 0; i < Q_ROUNDS; ++i) {
      const int r = slot + Q_SLOTS * i;
      if (r < h.rows) {
        const int4 pv = *reinterpret_cast<const int4*>(st + r * a.d + c * 16);
#pragma unroll
        for (int j = 0; j < QP; ++j) {
          acc[i][j] = __dp4a(pv.x, qv[j].x, acc[i][j]);
          acc[i][j] = __dp4a(pv.y, qv[j].y, acc[i][j]);
          acc[i][j] = __dp4a(pv.z, qv[j].z, acc[i][j]);
          acc[i][j] = __dp4a(pv.w, qv[j].w, acc[i][j]);
        }
      }
    }
  }
  const float* s_scales = reinterpret_cast<const float*>(st + L.scales);
  const float* s_norms = reinterpret_cast<const float*>(st + L.norms);
  const float* s_mask = reinterpret_cast<const float*>(st + L.mask);
  const int j = k >> SHIFT;  // this lane's query of the pass after the reduction
  int q = qi[0];
#pragma unroll
  for (int jj = 1; jj < QP; ++jj) q = j == jj ? qi[jj] : q;
#pragma unroll
  for (int i = 0; i < Q_ROUNDS; ++i) {
    if (Q_SLOTS * i >= h.rows) break;  // the same for the whole warp
    const int dot = quarter_reduce<QP>(acc[i], lane);
    const int r = slot + Q_SLOTS * i;
    if ((k & ((1 << SHIFT) - 1)) == 0 && j < np && r < h.rows) {
      const int e = p0 + j;
      const int64_t col = e < ECAP ? ecol[e] : a.gcol[h.g0 + e];
      a.out[q * a.out_stride + col + h.row0 + r] = epilogue_int8(
          dot, a.q_scales[q], s_scales[r], s_norms[r], s_mask[r], a.qn[q], a.metric);
    }
  }
}

__global__ void __launch_bounds__(Q_THREADS, 1) quant_score_blocks_kernel(QArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + Q_MAX_STAGES;
  int* s_prefix = reinterpret_cast<int*>(smem + HEAD_BYTES);
  unsigned char* ring =
      smem + HEAD_BYTES + (a.prefix_in_smem ? (a.n_blocks * 4 + 127) / 128 * 128 : 0);
  const StageLayout L(a.tile_rows, a.d);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 33);  // the producer's 32 lanes and its expect_tx
      mbar_init(&empty[s], Q_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (a.prefix_in_smem) {
    for (int b = t; b < a.n_blocks; b += Q_THREADS) {
      s_prefix[b] = static_cast<int>(a.blocks[6 * b + 5]);
    }
  }
  __syncthreads();

  if (warp == Q_WARPS) {  // producer: stage tiles blockIdx.x, + gridDim.x, ...
    int s = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x, k = 0; i < a.n_tiles; i += gridDim.x, ++k) {
      if (k >= a.stages) mbar_wait(&empty[s], phase ^ 1);
      int lo = 0, hi = a.n_blocks - 1;  // the last block whose first tile is <= i
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        const int tile0 =
            a.prefix_in_smem ? s_prefix[mid] : static_cast<int>(a.blocks[6 * mid + 5]);
        if (tile0 <= i) lo = mid; else hi = mid - 1;
      }
      const int b = lo;
      // lane w < 6 holds word w of the block's descriptor, lanes 6-7 its entry range
      const int64_t word =
          lane < 6 ? a.blocks[6 * b + lane] : lane < 8 ? a.goff[b + lane - 6] : 0;
      const int8_t* codes = reinterpret_cast<const int8_t*>(__shfl_sync(FULL_MASK, word, 0));
      const int64_t n = __shfl_sync(FULL_MASK, word, 4);
      const int64_t first = __shfl_sync(FULL_MASK, word, 5);
      const int64_t g0 = __shfl_sync(FULL_MASK, word, 6);
      const int64_t g1 = __shfl_sync(FULL_MASK, word, 7);
      const int64_t row0 = (i - first) * a.tile_rows;
      const int rows = static_cast<int>(min64(a.tile_rows, n - row0));
      const int body = rows & ~3;  // rows whose scales, norms and mask go by bulk copy
      const int qrows = static_cast<int>(min64(g1 - g0, staged_queries(a.d)));
      unsigned char* st = ring + s * a.stage_bytes;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s],
                              static_cast<uint32_t>((rows + qrows) * a.d + 12 * body));
        bulk_load(st, codes + row0 * a.d, static_cast<uint32_t>(rows * a.d), &full[s]);
      }
      // lanes 1-3: the tile's scales, norms and mask (payload words 1-3),
      // stored at L.scales, L.norms, L.mask; the 0-3 rows past the body by
      // plain loads
      if (lane >= 1 && lane <= 3) {
        const float* vals = reinterpret_cast<const float*>(word) + row0;
        float* dst = reinterpret_cast<float*>(st + L.scales + 4 * a.tile_rows * (lane - 1));
        if (body > 0) bulk_load(dst, vals, static_cast<uint32_t>(4 * body), &full[s]);
        for (int r = body; r < rows; ++r) dst[r] = vals[r];
      }
      if (lane == 0) {
        StageHead* h = reinterpret_cast<StageHead*>(st + L.head);
        h->row0 = row0;
        h->g0 = g0;
        h->rows = rows;
        h->g = static_cast<int>(g1 - g0);
      }
      const int64_t staged = min64(g1 - g0, ECAP);
      for (int e = lane; e < staged; e += 32) {
        const int q = static_cast<int>(a.gq[g0 + e]);
        reinterpret_cast<int*>(st + L.eq)[e] = q;
        reinterpret_cast<int64_t*>(st + L.ecol)[e] = a.gcol[g0 + e];
        if (e < qrows) {
          bulk_load(st + L.qcodes + e * a.d, a.queries + static_cast<int64_t>(q) * a.d,
                    static_cast<uint32_t>(a.d), &full[s]);
        }
      }
      mbar_arrive(&full[s]);
      if (++s == a.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int slot = warp * 4 + (lane >> 3);
  int s = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < a.n_tiles; i += gridDim.x) {
    mbar_wait(&full[s], phase);
    const unsigned char* st = ring + s * a.stage_bytes;
    const StageHead h = *reinterpret_cast<const StageHead*>(st + L.head);
    for (int p0 = 0; p0 < h.g; p0 += 8) {
      const int np = min(8, h.g - p0);
      if (np == 1) {
        score_pass<1>(a, st, L, h, p0, np, slot, lane);
      } else if (np == 2) {
        score_pass<2>(a, st, L, h, p0, np, slot, lane);
      } else if (np <= 4) {
        score_pass<4>(a, st, L, h, p0, np, slot, lane);
      } else {
        score_pass<8>(a, st, L, h, p0, np, slot, lane);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == a.stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one thread block per 128-row tile
// ---------------------------------------------------------------------------

constexpr int TILE = 128;                    // rows per thread block = threads
constexpr int QT = 8;                        // queries per pass over a tile
constexpr int ROW_BYTES = 256;               // bytes of each row per stage
constexpr int ROW_STRIDE = ROW_BYTES + 16;   // padded row stride in shared memory
constexpr int SEGS = ROW_BYTES / 16;         // 16-byte segments per staged row

struct Args {
  const int64_t* blocks;  // (n_blocks, 6): rows, unused, norms, mask pointers; n rows; unused
  const int64_t* goff;    // (n_blocks + 1,): the group of block b is entries goff[b] .. goff[b+1]-1
  const int64_t* tiles;   // (n_tiles,): (block << 32) | first row
  const int64_t* gq;      // (n_entries,): query of each group entry
  const int64_t* gcol;    // (n_entries,): output column of row 0 for that query
  const float* queries;   // (nq, d)
  const float* qn;        // (nq,): |q|^2 from the host
  float* out;             // (nq, out_stride)
  int64_t out_stride;
  int d;
  int metric;             // 0 l2sq, 1 cos, 2 ip
};

__global__ void __launch_bounds__(TILE) score_blocks_kernel(Args a) {
  constexpr int COLS = ROW_BYTES / sizeof(float);  // columns per stage
  __shared__ __align__(16) unsigned char rows_s[TILE * ROW_STRIDE];
  __shared__ __align__(16) unsigned char q_s[QT * ROW_BYTES];
  __shared__ int qidx_s[QT];
  __shared__ int64_t qcol_s[QT];

  const int t = threadIdx.x;
  const int64_t tile = a.tiles[blockIdx.x];
  const int64_t b = tile >> 32;
  const int64_t row0 = tile & 0xffffffffLL;
  const int64_t* bd = a.blocks + 6 * b;
  const float* rows = reinterpret_cast<const float*>(bd[0]);
  const float* norms = reinterpret_cast<const float*>(bd[2]);
  const float* mask = reinterpret_cast<const float*>(bd[3]);
  const int64_t n = bd[4];
  const int64_t g0 = a.goff[b], g1 = a.goff[b + 1];
  const int64_t r = row0 + t;
  const bool live = r < n;
  const int tile_rows = static_cast<int>(min64(TILE, n - row0));
  const float nr = live ? norms[r] : 0.f;
  const float mr = live ? mask[r] : 0.f;
  const int d = a.d;
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(float);
  const unsigned char* tile_base =
      reinterpret_cast<const unsigned char*>(rows) + row0 * row_bytes;
  const unsigned char* qbase = reinterpret_cast<const unsigned char*>(a.queries);

  for (int64_t p0 = g0; p0 < g1; p0 += QT) {
    const int nq = static_cast<int>(min64(QT, g1 - p0));
    if (t < QT) {
      qidx_s[t] = t < nq ? static_cast<int>(a.gq[p0 + t]) : 0;
      qcol_s[t] = t < nq ? a.gcol[p0 + t] : 0;
    }
    float facc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) facc[j] = 0.f;
    __syncthreads();
    for (int c0 = 0; c0 < d; c0 += COLS) {
      const int width = min(COLS, d - c0);               // columns this stage
      const int segs = width * (int)sizeof(float) / 16;  // 16-byte segments per row
      for (int i = t; i < tile_rows * SEGS; i += TILE) {
        const int rr = i / SEGS, sg = i % SEGS;
        if (sg < segs) {
          *reinterpret_cast<uint4*>(rows_s + rr * ROW_STRIDE + sg * 16) =
              *reinterpret_cast<const uint4*>(tile_base + rr * row_bytes +
                                              c0 * (int64_t)sizeof(float) + sg * 16);
        }
      }
      for (int i = t; i < nq * SEGS; i += TILE) {
        const int j = i / SEGS, sg = i % SEGS;
        if (sg < segs) {
          *reinterpret_cast<uint4*>(q_s + j * ROW_BYTES + sg * 16) =
              *reinterpret_cast<const uint4*>(qbase + qidx_s[j] * row_bytes +
                                              c0 * (int64_t)sizeof(float) + sg * 16);
        }
      }
      __syncthreads();
      if (live) {
        const unsigned char* row = rows_s + t * ROW_STRIDE;
        for (int sg = 0; sg < segs; ++sg) {
          const uint4 pv = *reinterpret_cast<const uint4*>(row + sg * 16);
          const float p[4] = {__uint_as_float(pv.x), __uint_as_float(pv.y),
                              __uint_as_float(pv.z), __uint_as_float(pv.w)};
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            if (j < nq) {
              const float4 qv = *reinterpret_cast<const float4*>(q_s + j * ROW_BYTES + sg * 16);
              facc[j] = fmaf(qv.x, p[0], facc[j]);
              facc[j] = fmaf(qv.y, p[1], facc[j]);
              facc[j] = fmaf(qv.z, p[2], facc[j]);
              facc[j] = fmaf(qv.w, p[3], facc[j]);
            }
          }
        }
      }
      __syncthreads();  // the next stage rewrites rows_s and q_s
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (j < nq) {
          const int qi = qidx_s[j];
          a.out[qi * a.out_stride + qcol_s[j] + r] =
              epilogue_f32(facc[j], nr, mr, a.qn[qi], a.metric);
        }
      }
    }
    __syncthreads();  // the next pass rewrites qidx_s and qcol_s
  }
}

// ---------------------------------------------------------------------------
// int8 coarse probe: one warp per centroid row against 8 staged query rows
// ---------------------------------------------------------------------------

constexpr int P_WARPS = 4;                 // warps per thread block
constexpr int P_THREADS = P_WARPS * 32;
constexpr int P_QROWS = 8;                 // query rows per thread block
constexpr int P_SEG = 4;                   // words of a row per lane in registers: 512 columns
constexpr int P_SMEM = 48 * 1024;          // staged query codes, at most (d <= 6144)
constexpr int P_BLOCKS_PER_SM = 8;

struct PArgs {
  const int8_t* qcents;  // (c_pad, d)
  const float* cscales;  // (c_pad,)
  const float* cn;       // (c_pad,)
  const int8_t* q_codes; // (q_pad, d)
  const float* q_scales; // (q_pad,)
  float* out;            // (q_pad, c_pad)
  int c_pad;
  int q_pad;
  int d;  // a multiple of 4
};

// Words w0 + lane, w0 + lane + 32, ... (P_SEG of them, 0 past the row) of a
// centroid row into registers.
__device__ __forceinline__ void load_segment(int (&cw)[P_SEG], const int* row, int w0,
                                             int words, int lane) {
#pragma unroll
  for (int s = 0; s < P_SEG; ++s) {
    const int w = w0 + s * 32 + lane;
    cw[s] = w < words ? row[w] : 0;
  }
}

// The ``bytes`` (a multiple of 4) of query codes at ``src`` into shared
// memory by the whole block, every copy in flight at once (cp.async: 16
// bytes where both ends allow it, else 4), then waited for.
__device__ __forceinline__ void stage_codes(int4* dst, const int8_t* src, int bytes) {
  if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes)) & 15) == 0) {
    for (int i = threadIdx.x; i < bytes / 16; i += P_THREADS) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + i)),
                   "l"(src + 16 * i)
                   : "memory");
    }
  } else {
    int* t = reinterpret_cast<int*>(dst);
    for (int i = threadIdx.x; i < bytes / 4; i += P_THREADS) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(t + i)),
                   "l"(src + 4 * i)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// Block (x, y) stages query rows 8y .. 8y + 7 (and y + gridDim.y, ... for
// very large batches); its warp w scores centroids x * P_WARPS + w, +
// gridDim.x * P_WARPS, ... against them: lane l reads the row's words l,
// l + 32, ... (one 128-byte request per 32 words), holds up to 512 columns
// in registers while it meets the 8 rows (rows past the batch repeat its
// last; never written), then a reduce-scatter over the warp leaves query
// row l / 4's whole int32 dot in lanes 4 (l / 4) .. + 3, and the first of
// them runs the epilogue. STAGED: the rows are read from shared memory
// (else from device memory, for rows wider than P_SMEM / 8).
template <bool STAGED>
__global__ void __launch_bounds__(P_THREADS) quant_probe_kernel(PArgs a) {
  extern __shared__ int4 q_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = a.d >> 2;
  const int first = blockIdx.x * P_WARPS + warp, stride = gridDim.x * P_WARPS;
  const int groups = (a.q_pad + P_QROWS - 1) / P_QROWS;
  const int* table = reinterpret_cast<const int*>(a.qcents);
  int cw[P_SEG];  // the segment of the row being scored (next: loaded ahead)
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    // the warp's first row is on its way while the block stages the queries
    if (first < a.c_pad) {
      load_segment(cw, table + static_cast<int64_t>(first) * words, 0, words, lane);
    }
    const int q0 = g * P_QROWS, nq = min(P_QROWS, a.q_pad - q0);
    const int8_t* src = a.q_codes + static_cast<int64_t>(q0) * a.d;
    const int* qrows = reinterpret_cast<const int*>(src);
    if constexpr (STAGED) {
      if (g != static_cast<int>(blockIdx.y)) __syncthreads();  // done with the last rows
      stage_codes(q_smem, src, nq * a.d);
      __syncthreads();
      qrows = reinterpret_cast<const int*>(q_smem);
    }
    const int j = lane >> 2;  // this lane's query row after the reduction
    const float qs = j < nq ? a.q_scales[q0 + j] : 0.f;
    for (int c = first; c < a.c_pad; c += stride) {
      const int* crow = table + static_cast<int64_t>(c) * words;
      const float cs = a.cscales[c], cn = a.cn[c];
      int acc[P_QROWS];
#pragma unroll
      for (int r = 0; r < P_QROWS; ++r) acc[r] = 0;
      for (int w0 = 0; w0 < words; w0 += 32 * P_SEG) {
        if (w0 > 0) load_segment(cw, crow, w0, words, lane);
#pragma unroll
        for (int r = 0; r < P_QROWS; ++r) {
          const int* qr = qrows + min(r, nq - 1) * words;
#pragma unroll
          for (int s = 0; s < P_SEG; ++s) {
            const int w = w0 + s * 32 + lane;
            if (w < words) acc[r] = __dp4a(cw[s], qr[w], acc[r]);
          }
        }
      }
      // the next row's first segment loads while this one is reduced
      if (c + stride < a.c_pad) {
        load_segment(cw, crow + static_cast<int64_t>(stride) * words, 0, words, lane);
      }
      halve<8>(acc, lane, 16);
      halve<4>(acc, lane, 8);
      halve<2>(acc, lane, 4);
      int dot = acc[0];
      dot += __shfl_xor_sync(FULL_MASK, dot, 2);
      dot += __shfl_xor_sync(FULL_MASK, dot, 1);
      if ((lane & 3) == 0 && j < nq) {
        const float s = __fmul_rn(__int2float_rn(dot), __fmul_rn(qs, cs));
        a.out[static_cast<int64_t>(q0 + j) * a.c_pad + c] = __fsub_rn(__fmul_rn(2.0f, s), cn);
      }
    }
  }
}

// Does nothing: the launch floor that a kernel of this file pays on the
// path it is launched by.
__global__ void empty_kernel() {}

// Per device: the opt-in shared memory of a block and the SM count, read
// once, with the int8 kernel's dynamic shared memory limit raised to it.
struct DeviceInfo {
  int smem_optin = 0;
  int sms = 0;
};

std::mutex info_lock;
DeviceInfo infos[64];

cudaError_t device_info(int device, DeviceInfo* out) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(info_lock);
  DeviceInfo& info = infos[device];
  if (info.sms == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&info.smem_optin,
                                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(quant_score_blocks_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    }
    if (err != cudaSuccess) {
      info.sms = 0;
      return err;
    }
  }
  *out = info;
  return cudaSuccess;
}

// Makes ``device`` the calling thread's current device for its scope.
class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    if (cudaGetDevice(&prev_) == cudaSuccess && prev_ != device_) cudaSetDevice(device_);
  }
  ~DeviceScope() {
    if (prev_ >= 0 && prev_ != device_) cudaSetDevice(prev_);
  }

 private:
  int device_;
  int prev_ = -1;
};

}  // namespace

// int8 blocks. blocks .. gcol: the work list (see QArgs), on the device;
// every block's codes, scales, norms and mask and the query codes start on a
// 16-byte boundary, d is a multiple of 16, tile_rows a multiple of 8 of at
// most 128, and block b's tiles are tiles blocks[6b+5] .. of n_tiles in all
// (ceil(n / tile_rows) for a probed block with rows, else none). out: (nq,
// out_stride) f32, its unscored cells left as the caller filled them.
// device: the index of the device every pointer and the stream belong to.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue when two
// stages of the ring do not fit.
extern "C" int pw_quant_score_blocks(const int64_t* blocks, const int64_t* goff, const int64_t* gq,
                                     const int64_t* gcol, const int8_t* queries,
                                     const float* q_scales, const float* qn, float* out,
                                     int64_t out_stride, int n_blocks, int n_tiles, int tile_rows,
                                     int d, int metric, int device, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_rows <= 0 || tile_rows > Q_MAX_TILE || tile_rows % 8 || d <= 0 || d % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  DeviceInfo info;
  cudaError_t err = device_info(device, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StageLayout L(tile_rows, d);
  const int prefix_bytes = (n_blocks * 4 + 127) / 128 * 128;
  // the tile prefix goes to shared memory unless it would cost the ring a stage
  const int most = std::min(Q_MAX_STAGES, (info.smem_optin - HEAD_BYTES) / L.bytes);
  const int prefix_in_smem = n_blocks <= PREFIX_SMEM_MAX &&
                             (info.smem_optin - HEAD_BYTES - prefix_bytes) / L.bytes >= most;
  const int fixed = HEAD_BYTES + (prefix_in_smem ? prefix_bytes : 0);
  const int stages = std::min(Q_MAX_STAGES, (info.smem_optin - fixed) / L.bytes);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fixed + stages * L.bytes;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quant_score_blocks_kernel,
                                                      Q_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::min(n_tiles, std::max(1, per_sm) * info.sms);
  const QArgs a{blocks, goff,     gq,       gcol,      queries, q_scales,
                qn,     out,      out_stride, n_blocks, n_tiles, tile_rows,
                d,      metric,   stages,   L.bytes,   prefix_in_smem};
  quant_score_blocks_kernel<<<grid, Q_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// fp32 blocks. blocks .. gcol: the work list (see Args), on the device. Every
// row of every block and every query row must start on a 16-byte boundary
// (d a multiple of 4). out: (nq, out_stride) f32, its unscored cells left as
// the caller filled them. device: as for pw_quant_score_blocks. Returns the
// cudaError_t of the launch.
extern "C" int pw_score_blocks(const int64_t* blocks, const int64_t* goff, const int64_t* tiles,
                               const int64_t* gq, const int64_t* gcol, const float* queries,
                               const float* qn, float* out, int64_t out_stride, int n_tiles,
                               int d, int metric, int device, void* stream) {
  if (n_tiles <= 0) return 0;
  DeviceScope scope(device);
  const Args a{blocks, goff, tiles, gq, gcol, queries, qn, out, out_stride, d, metric};
  score_blocks_kernel<<<n_tiles, TILE, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// qcents: (c_pad, d) int8; cscales, cn: (c_pad,); q_codes: (q_pad, d) int8;
// q_scales: (q_pad,); out: (q_pad, c_pad) f32. d must be a multiple of 4 and
// qcents and q_codes must start on a 4-byte boundary. device: as for
// pw_quant_score_blocks. Returns the cudaError_t of the launch.
extern "C" int pw_quant_probe(const int8_t* qcents, const float* cscales, const float* cn,
                              const int8_t* q_codes, const float* q_scales, float* out,
                              int c_pad, int q_pad, int d, int device, void* stream) {
  if (static_cast<int64_t>(c_pad) * q_pad <= 0) return 0;
  if (d <= 0 || d % 4) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  DeviceInfo info;
  cudaError_t err = device_info(device, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool staged = d <= P_SMEM / P_QROWS;
  const PArgs a{qcents, cscales, cn, q_codes, q_scales, out, c_pad, q_pad, d};
  const int groups = (q_pad + P_QROWS - 1) / P_QROWS;
  const int gy = std::min(groups, 65535);
  const int gx = std::max(1, std::min((c_pad + P_WARPS - 1) / P_WARPS,
                                      P_BLOCKS_PER_SM * info.sms / gy));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (staged) {
    quant_probe_kernel<true><<<dim3(gx, gy), P_THREADS, std::min(q_pad, P_QROWS) * d, s>>>(a);
  } else {
    quant_probe_kernel<false><<<dim3(gx, gy), P_THREADS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// One block of one warp of empty_kernel on ``stream`` of ``device``.
extern "C" int pw_empty(int device, void* stream) {
  DeviceScope scope(device);
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
