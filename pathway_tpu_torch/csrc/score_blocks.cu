// Cluster-block scorers of the tiered IVF store for Hopper (sm_90a), plain C
// interface.
//
// Replaces three XLA-jitted functions of the reference (none is a Pallas
// kernel):
//   pathway_tpu/ops/knn_tiers.py::_score_block_kernel      -> mode 0 of pw_score_blocks
//   pathway_tpu/ops/knn_quant.py::quant_score_block_kernel -> mode 1 of pw_score_blocks
//   pathway_tpu/ops/knn_quant.py::quant_probe_kernel       -> pw_quant_probe
//
// pw_score_blocks scores one search batch in one launch. The wrapper
// (ops/score_blocks.py) hands it a work list: for every probed cluster block
// the device pointers of its payload (fp32 rows, or int8 codes with per-row
// scales) with its exact norms and additive 0 / -inf mask, the queries that
// probe it and, for each of them, the column of the (nq, W) output where the
// block's scores start. Rows are cut into tiles of 128; one thread block
// scores one tile against every query of its group, QT queries per pass:
//   out[q, col + r] = epilogue(<query q, row r>) + mask[r]
// Epilogues, in the reference's order of operations (knn_quant.approx_scores
// and the inlined l2sq body of knn_tiers.search_batch for int8,
// knn_quant.host_metric_scores plus the mask add for fp32):
//   int8 l2sq: dot * ((2 * qs) * s_r) + (mask_r - |d_r|^2)
//   int8 cos : (dot * (qs * s_r)) / max(sqrt(|q|^2) * sqrt(|d_r|^2), 1e-30) + mask_r
//   int8 ip  : dot * (qs * s_r) + mask_r
//   fp32 l2sq: ((2 * dot) - |d_r|^2) - |q|^2 + mask_r
//   fp32 cos : dot / max(sqrt(|q|^2) * sqrt(|d_r|^2), 1e-30) + mask_r
//   fp32 ip  : dot + mask_r
// Every multiply, add, divide and root is written with a round-to-nearest
// intrinsic, so nvcc cannot contract a multiply and an add into one FMA: the
// int8 epilogue is then bitwise the reference's host arithmetic.
//
// Per-score order is fixed: one thread computes one (query, row) score, over
// the columns in ascending order, with no split-K and no atomics; nothing
// depends on the block's capacity, the batch size or the query's row in the
// batch. The int8 dot accumulates in int32 with __dp4a, which is exact, so
// it equals the reference's f32 dot of the cast codes for dim <= 1040 and its
// int32 dot (rounded once to f32) beyond. The fp32 dot is a chain of fmaf in
// ascending column order; it agrees with a BLAS product to rounding, not
// bitwise.
//
// What bounds it on this card: device-memory bytes. A probed block is read
// once per pass of QT queries (once for a solo query) and each of its rows
// meets a query in dim multiply-adds: about 2 int8 ops per byte per query,
// or 0.5 f32 FLOP per byte, far below the card's ridge. Design: the block's
// rows stream through shared memory 256 bytes of every row at a time, in
// 16-byte loads (row stride padded by 16 B so 8 threads' 16-byte reads hit
// distinct bank groups), the pass's query columns beside them, read as
// broadcasts. A simple kernel: no cp.async ring, no TMA, no wgmma yet.
//
// pw_quant_probe: the int8 coarse affinity 2 * (dot * (qs * cs)) - |c|^2, one
// thread per (query, centroid), an int32 __dp4a dot read straight from device
// memory (the centroid table is a few hundred KB). Pad centroids carry
// |c|^2 = +inf and score -inf.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;                    // rows per thread block = threads
constexpr int QT = 8;                        // queries per pass over a tile
constexpr int ROW_BYTES = 256;               // bytes of each row per stage
constexpr int ROW_STRIDE = ROW_BYTES + 16;   // padded row stride in shared memory
constexpr int SEGS = ROW_BYTES / 16;         // 16-byte segments per staged row

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

struct Args {
  const int64_t* blocks;  // (n_blocks, 6): rows, srow, norms, mask pointers; n rows; unused
  const int64_t* goff;    // (n_blocks + 1,): the group of block b is entries goff[b] .. goff[b+1]-1
  const int64_t* tiles;   // (n_tiles,): (block << 32) | first row
  const int64_t* gq;      // (n_entries,): query of each group entry
  const int64_t* gcol;    // (n_entries,): output column of row 0 for that query
  const void* queries;    // (nq, d): f32 queries or int8 codes
  const float* q_scales;  // (nq,): int8 query scales (mode 1)
  const float* qn;        // (nq,): |q|^2 from the host
  float* out;             // (nq, out_stride)
  int64_t out_stride;
  int d;
  int metric;             // 0 l2sq, 1 cos, 2 ip
};

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

// MODE 0: fp32 rows (T = float); MODE 1: int8 codes (T = int8_t).
template <int MODE>
__global__ void __launch_bounds__(TILE) score_blocks_kernel(Args a) {
  using T = typename std::conditional<MODE == 0, float, int8_t>::type;
  constexpr int COLS = ROW_BYTES / sizeof(T);  // columns per stage
  __shared__ __align__(16) unsigned char rows_s[TILE * ROW_STRIDE];
  __shared__ __align__(16) unsigned char q_s[QT * ROW_BYTES];
  __shared__ int qidx_s[QT];
  __shared__ int64_t qcol_s[QT];

  const int t = threadIdx.x;
  const int64_t tile = a.tiles[blockIdx.x];
  const int64_t b = tile >> 32;
  const int64_t row0 = tile & 0xffffffffLL;
  const int64_t* bd = a.blocks + 6 * b;
  const T* rows = reinterpret_cast<const T*>(bd[0]);
  const float* srow = reinterpret_cast<const float*>(bd[1]);
  const float* norms = reinterpret_cast<const float*>(bd[2]);
  const float* mask = reinterpret_cast<const float*>(bd[3]);
  const int64_t n = bd[4];
  const int64_t g0 = a.goff[b], g1 = a.goff[b + 1];
  const int64_t r = row0 + t;
  const bool live = r < n;
  const int tile_rows = static_cast<int>(min64(TILE, n - row0));
  const float nr = live ? norms[r] : 0.f;
  const float mr = live ? mask[r] : 0.f;
  const float sr = (MODE == 1 && live) ? srow[r] : 0.f;
  const int d = a.d;
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  const unsigned char* tile_base =
      reinterpret_cast<const unsigned char*>(rows) + row0 * row_bytes;
  const unsigned char* qbase = reinterpret_cast<const unsigned char*>(a.queries);

  for (int64_t p0 = g0; p0 < g1; p0 += QT) {
    const int nq = static_cast<int>(min64(QT, g1 - p0));
    if (t < QT) {
      qidx_s[t] = t < nq ? static_cast<int>(a.gq[p0 + t]) : 0;
      qcol_s[t] = t < nq ? a.gcol[p0 + t] : 0;
    }
    int iacc[QT];
    float facc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      iacc[j] = 0;
      facc[j] = 0.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < d; c0 += COLS) {
      const int width = min(COLS, d - c0);          // columns this stage
      const int segs = width * (int)sizeof(T) / 16;  // 16-byte segments per row
      for (int i = t; i < tile_rows * SEGS; i += TILE) {
        const int rr = i / SEGS, sg = i % SEGS;
        if (sg < segs) {
          *reinterpret_cast<uint4*>(rows_s + rr * ROW_STRIDE + sg * 16) =
              *reinterpret_cast<const uint4*>(tile_base + rr * row_bytes +
                                              c0 * (int64_t)sizeof(T) + sg * 16);
        }
      }
      for (int i = t; i < nq * SEGS; i += TILE) {
        const int j = i / SEGS, sg = i % SEGS;
        if (sg < segs) {
          *reinterpret_cast<uint4*>(q_s + j * ROW_BYTES + sg * 16) =
              *reinterpret_cast<const uint4*>(qbase + qidx_s[j] * row_bytes +
                                              c0 * (int64_t)sizeof(T) + sg * 16);
        }
      }
      __syncthreads();
      if (live) {
        const unsigned char* row = rows_s + t * ROW_STRIDE;
        for (int sg = 0; sg < segs; ++sg) {
          const uint4 pv = *reinterpret_cast<const uint4*>(row + sg * 16);
          if (MODE == 1) {
            const int p[4] = {(int)pv.x, (int)pv.y, (int)pv.z, (int)pv.w};
#pragma unroll
            for (int j = 0; j < QT; ++j) {
              if (j < nq) {
                const int4 qv = *reinterpret_cast<const int4*>(q_s + j * ROW_BYTES + sg * 16);
                iacc[j] = __dp4a(p[0], qv.x, iacc[j]);
                iacc[j] = __dp4a(p[1], qv.y, iacc[j]);
                iacc[j] = __dp4a(p[2], qv.z, iacc[j]);
                iacc[j] = __dp4a(p[3], qv.w, iacc[j]);
              }
            }
          } else {
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
      }
      __syncthreads();  // the next stage rewrites rows_s and q_s
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (j < nq) {
          const int qi = qidx_s[j];
          const float s = MODE == 1
                              ? epilogue_int8(iacc[j], a.q_scales[qi], sr, nr, mr, a.qn[qi], a.metric)
                              : epilogue_f32(facc[j], nr, mr, a.qn[qi], a.metric);
          a.out[qi * a.out_stride + qcol_s[j] + r] = s;
        }
      }
    }
    __syncthreads();  // the next pass rewrites qidx_s and qcol_s
  }
}

__global__ void quant_probe_kernel(const int8_t* __restrict__ qcents,
                                   const float* __restrict__ cscales,
                                   const float* __restrict__ cn,
                                   const int8_t* __restrict__ q_codes,
                                   const float* __restrict__ q_scales, float* __restrict__ out,
                                   int c_pad, int q_pad, int d) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)c_pad * q_pad) return;
  const int qi = static_cast<int>(e / c_pad), c = static_cast<int>(e % c_pad);
  const int* qw = reinterpret_cast<const int*>(q_codes + (int64_t)qi * d);
  const int* cw = reinterpret_cast<const int*>(qcents + (int64_t)c * d);
  int acc = 0;
  for (int w = 0; w < d / 4; ++w) acc = __dp4a(qw[w], cw[w], acc);
  const float dot = __fmul_rn(__int2float_rn(acc), __fmul_rn(q_scales[qi], cscales[c]));
  out[e] = __fsub_rn(__fmul_rn(2.0f, dot), cn[c]);
}

}  // namespace

// mode: 0 = fp32 rows, 1 = int8 codes. metric: 0 = l2sq, 1 = cos, 2 = ip.
// blocks .. gcol: the work list (see Args), on the device. Every row of every
// block and every query row must start on a 16-byte boundary (d * element
// size a multiple of 16). out: (nq, out_stride) f32, its unscored cells left
// as the caller filled them. Returns the cudaError_t of the launch.
extern "C" int pw_score_blocks(int mode, const int64_t* blocks, const int64_t* goff,
                               const int64_t* tiles, const int64_t* gq, const int64_t* gcol,
                               const void* queries, const float* q_scales, const float* qn,
                               float* out, int64_t out_stride, int n_tiles, int d, int metric,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  const Args a{blocks, goff, tiles, gq, gcol, queries, q_scales, qn, out, out_stride, d, metric};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 1) {
    score_blocks_kernel<1><<<n_tiles, TILE, 0, s>>>(a);
  } else {
    score_blocks_kernel<0><<<n_tiles, TILE, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// qcents: (c_pad, d) int8; cscales, cn: (c_pad,); q_codes: (q_pad, d) int8;
// q_scales: (q_pad,); out: (q_pad, c_pad) f32. d must be a multiple of 4.
extern "C" int pw_quant_probe(const int8_t* qcents, const float* cscales, const float* cn,
                              const int8_t* q_codes, const float* q_scales, float* out,
                              int c_pad, int q_pad, int d, void* stream) {
  const int64_t n = (int64_t)c_pad * q_pad;
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  quant_probe_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      qcents, cscales, cn, q_codes, q_scales, out, c_pad, q_pad, d);
  return static_cast<int>(cudaGetLastError());
}
