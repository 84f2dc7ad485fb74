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
// the products are plain f32 FMAs (no TF32), so integer corpora score
// exactly and float corpora agree with the f32 reference to rounding.
//
// Design (simple and correct first): one block of 128 threads per
// (query, page slot); the block reads its own page id, stages the query row
// and 32-column chunks of the (128, d) page through shared memory with
// coalesced loads (rows padded by one float so that thread r reading row r
// hits bank (r + c) % 32), and thread r keeps candidate r's dot in a
// register. |q|^2 is reduced once per block by warp 0. The 128 scores leave
// in one coalesced store.
//
// Bound: device-memory reads. Every (query, slot) pair re-reads its page, so
// q queries probing the same cluster read its pages q times; the arithmetic
// is 1 FMA per 4 bytes of an f32 page. What later work changes: blocks that
// serve every query probing a page (read each page once per batch), and
// tensor-core tiles (wgmma over bf16 pages) once pages are shared.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAGE = 128;                // rows per page (knn_ivf.PAGE)
constexpr int DCHUNK = 32;               // page columns staged per step
constexpr int TILE_STRIDE = DCHUNK + 1;  // padded row stride in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(PAGE) score_pages_kernel(
    const T* __restrict__ packed, const float* __restrict__ pn,
    const float* __restrict__ pm, const float* __restrict__ queries,
    const int32_t* __restrict__ page_ids, float* __restrict__ out,
    int n_slots, int d, int metric) {
  extern __shared__ float q_s[];  // (d,) query row
  __shared__ float tile[PAGE * TILE_STRIDE];
  __shared__ float qn_s;

  const int slot = blockIdx.x;
  const int qi = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t page = page_ids[(int64_t)qi * n_slots + slot];

  const float* qrow = queries + (int64_t)qi * d;
  for (int c = t; c < d; c += PAGE) q_s[c] = qrow[c];
  __syncthreads();
  if (t < 32) {
    float s = 0.f;
    for (int c = t; c < d; c += 32) s = fmaf(q_s[c], q_s[c], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (t == 0) qn_s = s;
  }

  const T* base = packed + page * PAGE * (int64_t)d;
  float acc = 0.f;
  for (int c0 = 0; c0 < d; c0 += DCHUNK) {
    const int w = min(DCHUNK, d - c0);
    // consecutive threads read consecutive columns of one page row
    for (int i = t; i < PAGE * DCHUNK; i += PAGE) {
      const int r = i / DCHUNK;
      const int c = i % DCHUNK;
      tile[r * TILE_STRIDE + c] = (c < w) ? to_f32(base[(int64_t)r * d + c0 + c]) : 0.f;
    }
    __syncthreads();
    const float* row = tile + t * TILE_STRIDE;
#pragma unroll 8
    for (int c = 0; c < w; ++c) acc = fmaf(q_s[c0 + c], row[c], acc);
    __syncthreads();
  }

  const int64_t prow = page * PAGE + t;
  const float p = pn[prow];
  float s;
  if (metric == 0) {
    s = 2.0f * acc - p - qn_s;
  } else if (metric == 1) {
    s = acc / fmaxf(sqrtf(p * qn_s), 1e-30f);
  } else {
    s = acc;
  }
  out[((int64_t)qi * n_slots + slot) * PAGE + t] = s + pm[prow];
}

}  // namespace

// page_dtype: 0 = float32 pages, 1 = bfloat16 pages.
// metric:     0 = l2sq, 1 = cos, 2 = ip.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pw_score_pages(const void* packed, int page_dtype, const float* pn,
                              const float* pm, const float* queries,
                              const int32_t* page_ids, float* out, int q, int n_slots,
                              int d, int metric, void* stream) {
  const dim3 grid(n_slots, q);
  const size_t smem = (size_t)d * sizeof(float);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (page_dtype == 0) {
    score_pages_kernel<float><<<grid, PAGE, smem, s>>>(
        static_cast<const float*>(packed), pn, pm, queries, page_ids, out, n_slots, d,
        metric);
  } else {
    score_pages_kernel<__nv_bfloat16><<<grid, PAGE, smem, s>>>(
        static_cast<const __nv_bfloat16*>(packed), pn, pm, queries, page_ids, out,
        n_slots, d, metric);
  }
  return static_cast<int>(cudaGetLastError());
}
