// IVF candidate-page scorer for Hopper (sm_90a), plain C interface.
//
// Replaces pathway_tpu/ops/knn_ivf.py::_score_pages_pallas (the TPU kernel
// that the fused IVF query runs between the centroid probe and the top-k).
//
// What it computes, for every (query i, page slot j):
//   page  = page_ids[i, j]
//   dot_r = <queries[i], packed[page * 128 + r]>      r = 0..127, in f32
//   s_r   = l2sq: 2 * dot_r - pn[page, r] - |q_i|^2
//           cos : dot_r / max(sqrt(pn[page, r] * |q_i|^2), 1e-30)
//           ip  : dot_r
//   out[i, j * 128 + r] = s_r + pm[page, r]            (pm is 0 or -inf)
// The page is upcast to f32 before the dot, as the Pallas kernel does, and
// the products are plain f32 FMAs in ascending column order (no TF32), so
// integer corpora score exactly and float corpora agree with the f32
// reference to rounding. No sum uses atomics: a (page, query) score does
// not depend on which block or pass computed it.
//
// What bounds it on this card: device-memory bytes. A page is 128 x d
// values (196,608 B in f32 at d = 384) and each of its rows meets a query in
// d FMAs: about 0.5 FLOP per byte per query, far below the card's ridge.
// The Pallas grid walks (query, slot) and DMAs the page of every slot; on
// Hopper that re-reads a page once per query that probes it and the all-pad
// sentinel page once per empty slot.
//
// Design: one pass over each distinct page per batch, in two launches.
// The wrapper (ops/knn_ivf.py::group_page_work) marks on the device which
// (page, query) pairs the batch holds and numbers them by a running count
// over the (n_pages x q) table, page-major: `rank`. A page's pairs are then
// consecutive numbers, and a slot finds its pair's number in one read.
// 1. score_pages_kernel: blocks of 128 threads, as many as the card holds
//    at once (found once per device and page type) or fewer, walk the
//    probed pages (a list the wrapper also builds; how many there are only
//    the device knows) round robin from the highest id down, so the all-pad sentinel page (the last, with the most
//    slots) starts first. Thread t owns page row t. In passes of up to QT
//    pairs the block streams the page once through a double-buffered ring
//    of shared memory, 256 bytes of every row per stage (16-B cp.async;
//    rows padded by 16 B so the 16-B reads of 8 threads land in 8 distinct
//    bank groups), with the pass's query columns beside them, read as
//    broadcasts; stage k + 1 lands while stage k is computed. Runs of 256 B
//    per row keep device-memory reads near their streaming rate (on an
//    H100, 128-B runs streamed up to 5% slower, 64-B runs 40% slower). The
//    block writes its 128 scores of each pair once, to the pair's tile of
//    the scratch `tiles`; |q|^2 comes from a launch before it, one warp per
//    query.
// 2. scatter_tiles_kernel: one warp per (query, slot) copies its pair's tile
//    to the slot, 512 contiguous bytes as 32 float4. A pair with thousands of
//    slots (the sentinel page) is written by the whole card, not by the one
//    block that scored it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int PAGE = 128;                   // rows per page = threads per scoring block
constexpr int QT = 8;                       // pairs (queries) per pass over a page
constexpr int STAGES = 2;                   // depth of the shared-memory ring
constexpr int ROW_BYTES = 256;              // bytes of each page row per stage
constexpr int ROW_STRIDE = ROW_BYTES + 16;  // padded row stride in shared memory
constexpr int PAGE_STAGE_BYTES = PAGE * ROW_STRIDE;
constexpr int MAX_COLS = ROW_BYTES / 2;     // columns per stage for 2-byte pages
constexpr int Q_STRIDE = MAX_COLS + 4;      // padded query row in shared memory (f32)
constexpr int STAGE_BYTES = PAGE_STAGE_BYTES + QT * Q_STRIDE * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
constexpr int BLOCKS_PER_SM = 2;
constexpr int SCATTER_WARPS = 8;            // entries per scatter block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of a staged page row as f32 columns (bf16 -> f32 is exact).
__device__ __forceinline__ void unpack16(const unsigned char* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void unpack16(const unsigned char* src, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    v[2 * h] = __uint_as_float(w[h] << 16);
    v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ float epilogue(float dot, float p, float qn, int metric) {
  if (metric == 0) return 2.0f * dot - p - qn;
  if (metric == 1) return dot / fmaxf(sqrtf(p * qn), 1e-30f);
  return dot;
}

struct Work {
  const float* pn;
  const float* pm;
  const float* queries;
  const float* qn;      // (q,) |query|^2
  const int64_t* rank;  // (n_pages * q + 1): pairs before table entry k = page * q + query
  float* tiles;         // (n_pairs, PAGE): pair number p scores at row p - 1
  int q;
  int d;
  int metric;
};

// One pass over the page for its pairs p0 + 1 .. p0 + nq, whose queries are
// found from table column `from` on. Returns the column after the last one.
template <typename T, int NQ>
__device__ int score_pass(const Work& w, const T* page_base, const int64_t* page_rank,
                          float pnr, float pmr, int64_t p0, int nq,
                          int from, unsigned char* smem, int* qidx_s, float* qn_s) {
  constexpr int COLS = ROW_BYTES / sizeof(T);  // page columns per stage
  constexpr int VW = 16 / sizeof(T);           // columns per 16-B read
  const int t = threadIdx.x;
  const int d = w.d;
  if (t < NQ) qidx_s[t] = 0;  // a valid row for the unused places of a short pass
  __syncthreads();
  for (int j0 = from;; j0 += PAGE) {  // column j holds pair rank[j + 1] if rank steps there
    const int j = j0 + t;
    if (j < w.q) {
      const int64_t pair = page_rank[j + 1];
      if (pair > page_rank[j] && pair > p0 && pair <= p0 + nq)
        qidx_s[pair - p0 - 1] = j;
    }
    const int end = min(j0 + PAGE, w.q);
    if (end == w.q || page_rank[end] >= p0 + nq) break;  // the pass's pairs are all seen
  }
  __syncthreads();
  const int next = qidx_s[nq - 1] + 1;
  if (t < NQ) qn_s[t] = w.qn[qidx_s[t]];  // read by the epilogue, after the ring's barriers

  const int nk = (d + COLS - 1) / COLS;
  auto load = [&](int k) {
    unsigned char* st = smem + (k % STAGES) * STAGE_BYTES;
    const int c0 = k * COLS;
    const int width = min(COLS, d - c0);
    const int segs = width * (int)sizeof(T) / 16;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(page_base + c0);
    const int64_t row_bytes = (int64_t)d * sizeof(T);
#pragma unroll
    for (int i = t; i < PAGE * (ROW_BYTES / 16); i += PAGE) {
      const int r = i / (ROW_BYTES / 16), sg = i % (ROW_BYTES / 16);
      if (sg < segs) cp_async16(st + r * ROW_STRIDE + sg * 16, src + r * row_bytes + sg * 16);
    }
    float* qs = reinterpret_cast<float*>(st + PAGE_STAGE_BYTES);
    for (int i = t; i < NQ * (COLS / 4); i += PAGE) {
      const int j = i / (COLS / 4), sg = i % (COLS / 4);
      if (sg < width / 4)
        cp_async16(qs + j * Q_STRIDE + sg * 4, w.queries + (int64_t)qidx_s[j] * d + c0 + sg * 4);
    }
  };

  float acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nk) load(k);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (k + STAGES - 1 < nk) load(k + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (k % STAGES) * STAGE_BYTES;
    const unsigned char* row = st + t * ROW_STRIDE;
    const float* qs = reinterpret_cast<const float*>(st + PAGE_STAGE_BYTES);
    const int width = min(COLS, d - k * COLS);
    auto step = [&](int c) {  // columns c .. c + VW - 1 of every row and query
      float p[VW];
      unpack16(row + c * sizeof(T), p);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4* qv = reinterpret_cast<const float4*>(qs + j * Q_STRIDE + c);
#pragma unroll
        for (int h = 0; h < VW / 4; ++h) {
          const float4 a = qv[h];  // a broadcast: every thread reads the same query
          acc[j] = fmaf(a.x, p[4 * h], acc[j]);
          acc[j] = fmaf(a.y, p[4 * h + 1], acc[j]);
          acc[j] = fmaf(a.z, p[4 * h + 2], acc[j]);
          acc[j] = fmaf(a.w, p[4 * h + 3], acc[j]);
        }
      }
    };
    if (width == COLS) {
#pragma unroll
      for (int c = 0; c < COLS; c += VW) step(c);
    } else {  // the ragged last stage
      for (int c = 0; c < width; c += VW) step(c);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j < nq) {
      w.tiles[(p0 + j) * PAGE + t] = epilogue(acc[j], pnr, qn_s[j], w.metric) + pmr;
    }
  }
  __syncthreads();  // the next pass rewrites qidx_s, qn_s and the ring
  return next;
}

template <typename T>
__global__ void __launch_bounds__(PAGE, BLOCKS_PER_SM) score_pages_kernel(
    Work w, const T* __restrict__ packed, const int64_t* __restrict__ pages,
    const int64_t* __restrict__ n_probed) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qidx_s[QT];
  __shared__ float qn_s[QT];
  const int t = threadIdx.x;
  // the probed pages round robin, from the highest id down: the sentinel
  // page (the last, with the most slots) starts first
  for (int64_t k = *n_probed - 1 - blockIdx.x; k >= 0; k -= gridDim.x) {
    const int64_t page = pages[k];
    const int64_t* page_rank = w.rank + page * w.q;
    const int64_t P0 = page_rank[0], P1 = page_rank[w.q];  // pairs P0 + 1 .. P1
    const int64_t row0 = page * PAGE;
    const float pnr = w.pn[row0 + t], pmr = w.pm[row0 + t];
    const T* base = packed + row0 * w.d;
    int from = 0;
    for (int64_t p0 = P0; p0 < P1; p0 += QT) {
      const int nq = P1 - p0 < QT ? static_cast<int>(P1 - p0) : QT;
      if (nq == 1) {
        from = score_pass<T, 1>(w, base, page_rank, pnr, pmr, p0, nq, from, smem, qidx_s,
                                qn_s);
      } else if (nq == 2) {
        from = score_pass<T, 2>(w, base, page_rank, pnr, pmr, p0, nq, from, smem, qidx_s,
                                qn_s);
      } else if (nq <= 4) {
        from = score_pass<T, 4>(w, base, page_rank, pnr, pmr, p0, nq, from, smem, qidx_s,
                                qn_s);
      } else {
        from = score_pass<T, QT>(w, base, page_rank, pnr, pmr, p0, nq, from, smem, qidx_s,
                                 qn_s);
      }
    }
  }
}

// |q|^2 of every query, one warp each: lanes take every 32nd column, then a
// fixed shuffle tree.
__global__ void query_norms_kernel(const float* __restrict__ queries, float* __restrict__ qn,
                                   int q, int d) {
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= q) return;
  const int lane = threadIdx.x & 31;
  const float* row = queries + (int64_t)i * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(row[c], row[c], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) qn[i] = s;
}

// Slot e = query * n_slots + slot gets the tile of its pair.
__global__ void __launch_bounds__(SCATTER_WARPS * 32) scatter_tiles_kernel(
    const float* __restrict__ tiles, const int32_t* __restrict__ page_ids,
    const int64_t* __restrict__ rank, float* __restrict__ out, int q, int n_slots) {
  const int64_t e = (int64_t)blockIdx.x * SCATTER_WARPS + (threadIdx.x >> 5);
  if (e >= (int64_t)q * n_slots) return;
  const int lane = threadIdx.x & 31;
  const int64_t pair = rank[(int64_t)page_ids[e] * q + e / n_slots + 1];
  reinterpret_cast<float4*>(out + e * PAGE)[lane] =
      reinterpret_cast<const float4*>(tiles + (pair - 1) * PAGE)[lane];
}

// Resident blocks of score_pages_kernel<T> on each device, found on its
// first launch there (0 until then): the grid depends only on the device and
// the page type, so later launches make no runtime queries for it.
constexpr int MAX_DEVICES = 64;
std::atomic<int> resident_grid[2][MAX_DEVICES];

template <typename T>
int launch(const Work& w, const void* packed, const int64_t* pages, const int64_t* n_probed,
           int n_pages, int page_dtype, int dev, cudaStream_t s) {
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  int grid = resident_grid[page_dtype][dev].load(std::memory_order_relaxed);
  if (grid == 0) {  // the caller made `dev` the current device
    cudaError_t e = cudaFuncSetAttribute(
        score_pages_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_pages_kernel<T>, PAGE,
                                                        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = sms * per_sm;  // all resident at once
    resident_grid[page_dtype][dev].store(grid, std::memory_order_relaxed);
  }
  if (n_pages < grid) grid = n_pages;
  score_pages_kernel<T><<<grid, PAGE, SMEM_BYTES, s>>>(w, static_cast<const T*>(packed),
                                                           pages, n_probed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// page_dtype: 0 = float32 pages, 1 = bfloat16 pages.
// metric:     0 = l2sq, 1 = cos, 2 = ip.
// page_ids: (q, n_slots); rank, pages, n_probed: the work list of
// group_page_work; tiles: (q * n_slots * 128 + q) f32 scratch, a 128-score
// tile per pair (at most one per slot), then |q|^2 of every query.
// device: the current CUDA device, on which `stream` lives.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int pw_score_pages(const void* packed, int page_dtype, const float* pn,
                              const float* pm, const float* queries, const int32_t* page_ids,
                              const int64_t* rank, const int64_t* pages, const int64_t* n_probed,
                              float* tiles, float* out, int n_pages, int q, int n_slots, int d,
                              int metric, int device, void* stream) {
  const int64_t n = (int64_t)q * n_slots;
  float* qn = tiles + n * PAGE;
  const Work w{pn, pm, queries, qn, rank, tiles, q, d, metric};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  query_norms_kernel<<<(q + 7) / 8, 256, 0, s>>>(queries, qn, q, d);
  const int rc =
      page_dtype == 0
          ? launch<float>(w, packed, pages, n_probed, n_pages, page_dtype, device, s)
          : launch<uint16_t>(w, packed, pages, n_probed, n_pages, page_dtype, device, s);
  if (rc != 0) return rc;
  scatter_tiles_kernel<<<(n + SCATTER_WARPS - 1) / SCATTER_WARPS, SCATTER_WARPS * 32, 0, s>>>(
      tiles, page_ids, rank, out, q, n_slots);
  return static_cast<int>(cudaGetLastError());
}
