// Top-k squared ED with the norms summed in the kernel, and the k = 1 scan,
// by hand for Hopper.
//
// Replaces the Pallas kernels topk_ed_pallas (f32 candidates, norms computed
// in the kernel) and min_ed_pallas (the running min and argmin) of
// src/repro/kernels/ed_scan_kernel.py (bodies _topk_ed_body and
// _ed_scan_body, running merge _merge_topk_tile). The screens over tables
// with cached norms (screen_select_pallas, screen_select_quant_pallas) have
// a design of their own, in screen_fused.cu.
//
// What it computes, per query i and candidate row j:
//
//     d2[i, j] = (qn2[i] + xn2[j]) - 2 * g,   g = <q_i, x_j>
//
// xn2[j] is summed in the tile from the same f32 values that feed the dot
// product (one FMA chain over d per candidate), as the Pallas body's
// _tile_d2 computes |x|^2 per tile, with every product and sum in true f32
// on the CUDA cores (no TF32 or tensor-core product). The output is the
// top-s slate per query in lexicographic (d2, j) order, empty slots (inf,
// INT32_MAX), plus qn2 = |q_i|^2. min_ed returns the first entry of that
// order: the same d2 arithmetic, so its answer is topk_ed's at k = 1.
//
// What bounds it on the H100: 2 m flops per candidate value for the
// products, against the 3.35 TB/s of device memory and the 67 TFLOP/s of
// f32 FMA on the CUDA cores. Every warp of a block squares the tile's
// candidates for itself (the same FMA chain, so the same value in each
// warp), half again as many FMAs as the products alone; at topk_ed's path
// shape (m <= 16, one pass of a few thousand rows) it stays bound by bytes.
//
// Design. The TPU kernel walks the candidate axis in order inside one grid
// and carries the running top-k in VMEM; on the H100 that would leave m/bm
// blocks, one block at m = 16. So the candidate axis is split over blocks:
//
//   screen_partial_kernel  grid (n_splits, ceil(m / BM)), 256 threads. A block
//     streams its candidate slice in tiles of TN rows: the tile is staged in
//     shared memory in DK-wide slices of the contraction, and each thread
//     accumulates a 2 x 4 register tile of dot products, so one shared-memory
//     read of a table value feeds two FMAs. The finished d2 tile
//     goes through shared memory to the selection: each warp owns two queries
//     and keeps their slates sorted in shared memory. A candidate is tested
//     against the slate's worst entry (nearly all fail once the slate is
//     full) and the few that pass are inserted by the whole warp at once.
//   slate_merge_kernel     one block per query merges the n_splits partial
//     slates of s entries with the same warp insertion, eight warps in
//     parallel and then warp 0 over their eight slates.
//   min_ed_kernel          the same grid and tile pipeline with a min
//     epilogue: each lane keeps a running 64-bit key (order-preserving d2
//     bits << 32 | id) per query, the warp reduces it by shuffles, and one
//     atomicMin per (block, query) folds it into the answer, so there is no
//     merge and the result does not depend on block order. A query equal to
//     a row can give a slightly negative d2 (|q|^2 and |x|^2 are summed in
//     other orders than the cross term); the key map orders negative floats,
//     and -0.0 is made +0.0 first so that equal distances keep the lower id.
//
// A slate holds at most PASS_SLATE entries in shared memory. A longer slate
// is taken in passes (ops._launch_topk): each pass gets the previous pass's last
// entry as a per-query floor and admits only candidates lexicographically
// after it. A candidate's d2 does not depend on the split of the candidate
// axis (each is one FMA chain over d in a fixed order, and |q|^2 one fixed
// reduction), so the passes together give the one-shot slate exactly.
//
// Candidate ids are unique within a launch, so the lexicographic order is a
// strict total order on real entries and the slate does not depend on the
// order in which blocks or lanes offer candidates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // queries per block (two per warp)
constexpr int TN = 128;       // candidates per tile (four per lane)
constexpr int DK = 32;        // contraction slice staged in shared memory
constexpr int NTHREADS = 256;
constexpr int MERGE_WARPS = 8;
constexpr int PASS_SLATE = 128;  // the most slate entries one pass holds
constexpr int EMPTY_ID = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Insert (v, id) into the sorted slate sv/si of length s; the caller has
// checked that it beats the slate's last entry. All 32 lanes take part.
template <int SMAX>
__device__ __forceinline__ void slate_insert(float* sv, int* si, int s, float v, int id,
                                             int lane) {
  constexpr int PER = (SMAX + 31) / 32;
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    if (j < s) cnt += lex_less(sv[j], si[j], v, id) ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  const int pos = cnt;  // entries strictly ahead of the newcomer
  float ov[PER];
  int oi[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    if (j < s && j > pos) {
      ov[t] = sv[j - 1];
      oi[t] = si[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    if (j < s && j > pos) {
      sv[j] = ov[t];
      si[j] = oi[t];
    } else if (j == pos) {
      sv[j] = v;
      si[j] = id;
    }
  }
  __syncwarp();
}

// Each lane offers one candidate (valid lanes only); the warp inserts those
// that beat the slate's current worst entry, one at a time.
template <int SMAX>
__device__ __forceinline__ void warp_offer(float* sv, int* si, int s, float v, int id,
                                           bool valid, int lane) {
  bool want = valid && lex_less(v, id, sv[s - 1], si[s - 1]);
  unsigned mask = __ballot_sync(FULL, want);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, id, src);
    slate_insert<SMAX>(sv, si, s, cv, ci, lane);
    if (lane == src) want = false;
    want = want && lex_less(v, id, sv[s - 1], si[s - 1]);
    mask = __ballot_sync(FULL, want);
  }
}

// |q|^2 of the block's BM queries into qn2s, one warp per two queries.
__device__ __forceinline__ void block_qn2(const float* __restrict__ q, int m, int m0, int d,
                                          float* qn2s, int lane, int warp) {
  for (int t = 0; t < 2; ++t) {
    const int qi = 2 * warp + t;
    const int gq = m0 + qi;
    float acc = 0.f;
    if (gq < m) {
      for (int k = lane; k < d; k += 32) {
        const float a = q[(size_t)gq * d + k];
        acc = fmaf(a, a, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) qn2s[qi] = acc;
  }
}

// The warp's 2 x 4 register tile of one candidate tile: acc[i][j] = <q, x>
// of the warp's query 2 warp + i and the lane's candidate lane + 32 j (row
// rowid[.], none where it is < 0), and xacc[j] = |x|^2 of that candidate
// from the same staged values. The tile is staged in shared memory DK
// columns at a time; every thread of the block takes part.
__device__ __forceinline__ void tile_dots(const float* __restrict__ q, int m, int m0, int d,
                                          const float* __restrict__ x, const int* rowid,
                                          float (*qs)[DK], float (*xs)[DK + 1], int tid,
                                          int lane, int warp, float (&acc)[2][4],
                                          float (&xacc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[0][j] = acc[1][j] = 0.f;
    xacc[j] = 0.f;
  }
  for (int k0 = 0; k0 < d; k0 += DK) {
    __syncthreads();  // rowid is written; the previous slice is consumed
    for (int e = tid; e < BM * DK; e += NTHREADS) {
      const int qi = e / DK, kk = e % DK;
      const int gq = m0 + qi, k = k0 + kk;
      qs[qi][kk] = (gq < m && k < d) ? q[(size_t)gq * d + k] : 0.f;
    }
    for (int e = tid; e < TN * DK; e += NTHREADS) {
      const int cc = e / DK, kk = e % DK;
      const int r = rowid[cc];
      const int k = k0 + kk;
      xs[cc][kk] = (r >= 0 && k < d) ? x[(size_t)r * d + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      const float a0 = qs[2 * warp][kk];
      const float a1 = qs[2 * warp + 1][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = xs[lane + 32 * j][kk];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
        xacc[j] = fmaf(b, b, xacc[j]);
      }
    }
  }
}

// The screened distance, rounded step by step in one fixed order.
__device__ __forceinline__ float screen_d2(float qn2, float xn2, float g) {
  return __fsub_rn(__fadd_rn(qn2, xn2), __fmul_rn(2.f, g));
}

// floor_v/floor_i (m,) may be null; where given, only candidates
// lexicographically after (floor_v[i], floor_i[i]) enter query i's slate.
template <int SMAX>
__global__ void __launch_bounds__(NTHREADS)
screen_partial_kernel(const float* __restrict__ q, int m, int d, const float* __restrict__ x,
                      int n, int s, int chunk, int n_splits,
                      const float* __restrict__ floor_v, const int* __restrict__ floor_i,
                      float* __restrict__ part_v, int* __restrict__ part_i,
                      float* __restrict__ qn2_out) {
  __shared__ float qs[BM][DK];
  __shared__ float xs[TN][DK + 1];  // +1: lanes on neighbouring rows hit distinct banks
  __shared__ float dt[BM][TN];
  __shared__ float sv[BM][SMAX];
  __shared__ int si[BM][SMAX];
  __shared__ float qn2s[BM];
  __shared__ int rowid[TN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int c_begin = split * chunk;
  const int c_end = min(n, c_begin + chunk);

  for (int e = tid; e < BM * SMAX; e += NTHREADS) {
    sv[e / SMAX][e % SMAX] = INFINITY;
    si[e / SMAX][e % SMAX] = EMPTY_ID;
  }
  block_qn2(q, m, m0, d, qn2s, lane, warp);
  __syncthreads();
  if (split == 0 && tid < BM && m0 + tid < m) qn2_out[m0 + tid] = qn2s[tid];

  for (int c0 = c_begin; c0 < c_end; c0 += TN) {
    __syncthreads();  // the previous tile's selection is done with dt and rowid
    if (tid < TN) {
      const int c = c0 + tid;
      rowid[tid] = (c < c_end) ? c : -1;
    }
    float acc[2][4];
    float xacc[4];  // |x|^2 of the lane's candidates
    tile_dots(q, m, m0, d, x, rowid, qs, xs, tid, lane, warp, acc, xacc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = 2 * warp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = lane + 32 * j;
        const int r = rowid[cc];
        float v = INFINITY;
        if (r >= 0) v = screen_d2(qn2s[qi], xacc[j], acc[i][j]);
        dt[qi][cc] = v;
      }
    }
    __syncthreads();
    for (int t = 0; t < 2; ++t) {
      const int qi = 2 * warp + t;
      if (m0 + qi >= m) continue;  // warp-uniform
      // the query's floor; (-inf, -1) admits every candidate
      const float fv = floor_v != nullptr ? floor_v[m0 + qi] : -INFINITY;
      const int fi = floor_v != nullptr ? floor_i[m0 + qi] : -1;
      for (int g = 0; g < TN; g += 32) {
        const int cc = g + lane;
        const float v = dt[qi][cc];
        const bool valid = rowid[cc] >= 0 && lex_less(fv, fi, v, c0 + cc);
        warp_offer<SMAX>(sv[qi], si[qi], s, v, c0 + cc, valid, lane);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * s; e += NTHREADS) {
    const int qi = e / s, j = e % s;
    const int gq = m0 + qi;
    if (gq < m) {
      const size_t o = ((size_t)gq * n_splits + split) * s + j;
      part_v[o] = sv[qi][j];
      part_i[o] = si[qi][j];
    }
  }
}

template <int SMAX>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
slate_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                   int n_splits, int s, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float sv[MERGE_WARPS][SMAX];
  __shared__ int si[MERGE_WARPS][SMAX];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = lane; j < s; j += 32) {
    sv[warp][j] = INFINITY;
    si[warp][j] = EMPTY_ID;
  }
  __syncwarp();
  const size_t total = (size_t)n_splits * s;
  const float* pv = part_v + (size_t)qi * total;
  const int* pi = part_i + (size_t)qi * total;
  for (size_t base = (size_t)warp * 32; base < total; base += MERGE_WARPS * 32) {
    const size_t e = base + lane;
    const bool valid = e < total;
    warp_offer<SMAX>(sv[warp], si[warp], s, valid ? pv[e] : INFINITY,
                     valid ? pi[e] : EMPTY_ID, valid, lane);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < MERGE_WARPS; ++w) {
    for (int base = 0; base < s; base += 32) {
      const int e = base + lane;
      const bool valid = e < s;
      warp_offer<SMAX>(sv[0], si[0], s, valid ? sv[w][e] : INFINITY,
                       valid ? si[w][e] : EMPTY_ID, valid, lane);
    }
  }
  for (int j = lane; j < s; j += 32) {
    out_v[(size_t)qi * s + j] = sv[0][j];
    out_i[(size_t)qi * s + j] = si[0][j];
  }
}

template <int SMAX>
int launch_t(const float* q, int m, int d, const float* x, int n, int s, int chunk,
             int n_splits, const float* floor_v, const int* floor_i, float* part_v,
             int* part_i, float* qn2, float* out_v, int* out_i, cudaStream_t stream) {
  dim3 grid(n_splits, (m + BM - 1) / BM);
  screen_partial_kernel<SMAX><<<grid, NTHREADS, 0, stream>>>(
      q, m, d, x, n, s, chunk, n_splits, floor_v, floor_i, part_v, part_i, qn2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slate_merge_kernel<SMAX><<<m, MERGE_WARPS * 32, 0, stream>>>(part_v, part_i, n_splits, s,
                                                                out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* q, int m, int d, const float* x, int n, int s, int chunk,
           int n_splits, const float* floor_v, const int* floor_i, float* part_v,
           int* part_i, float* qn2, float* out_v, int* out_i, cudaStream_t stream) {
#define COCONUT_LAUNCH(SMAX)                                                            \
  return launch_t<SMAX>(q, m, d, x, n, s, chunk, n_splits, floor_v, floor_i, part_v,   \
                        part_i, qn2, out_v, out_i, stream)
  if (s <= 16) COCONUT_LAUNCH(16);
  if (s <= 32) COCONUT_LAUNCH(32);
  if (s <= 64) COCONUT_LAUNCH(64);
  if (s <= PASS_SLATE) COCONUT_LAUNCH(PASS_SLATE);
#undef COCONUT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ min_ed
constexpr unsigned long long NO_KEY = ~0ull;

// (d2, id) -> a 64-bit key whose unsigned order is the lexicographic order:
// the f32 bits made order-preserving (negatives flipped whole, positives
// with the sign bit set), -0.0 first made +0.0, then the id below them.
__device__ __forceinline__ unsigned long long min_key(float v, int id) {
  unsigned b = __float_as_uint(__fadd_rn(v, 0.f));  // -0.0 + 0.0 = +0.0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(id);
}

__global__ void __launch_bounds__(NTHREADS)
min_ed_kernel(const float* __restrict__ q, int m, int d, const float* __restrict__ x, int n,
              int chunk, unsigned long long* __restrict__ best) {
  __shared__ float qs[BM][DK];
  __shared__ float xs[TN][DK + 1];
  __shared__ float qn2s[BM];
  __shared__ int rowid[TN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int c_begin = blockIdx.x * chunk;
  const int c_end = min(n, c_begin + chunk);

  block_qn2(q, m, m0, d, qn2s, lane, warp);
  __syncthreads();
  unsigned long long key[2] = {NO_KEY, NO_KEY};
  for (int c0 = c_begin; c0 < c_end; c0 += TN) {
    __syncthreads();  // the previous tile's epilogue is done with rowid
    if (tid < TN) {
      const int c = c0 + tid;
      rowid[tid] = (c < c_end) ? c : -1;
    }
    float acc[2][4];
    float xacc[4];
    tile_dots(q, m, m0, d, x, rowid, qs, xs, tid, lane, warp, acc, xacc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rowid[lane + 32 * j];
        if (r >= 0) {
          const float v = screen_d2(qn2s[2 * warp + i], xacc[j], acc[i][j]);
          key[i] = min(key[i], min_key(v, r));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) key[i] = min(key[i], __shfl_xor_sync(FULL, key[i], o));
    const int gq = m0 + 2 * warp + i;
    if (lane == 0 && gq < m && key[i] != NO_KEY) atomicMin(best + gq, key[i]);
  }
}

__global__ void min_ed_unpack_kernel(const unsigned long long* __restrict__ best, int m,
                                     float* __restrict__ out_v, int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long k = best[i];
  if (k == NO_KEY) {  // no candidate entered (none, or every d2 NaN)
    out_v[i] = INFINITY;
    out_i[i] = -1;
    return;
  }
  unsigned b = static_cast<unsigned>(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  out_v[i] = __uint_as_float(b);
  out_i[i] = static_cast<int>(k & 0xffffffffu);
}

}  // namespace

extern "C" {

// The layout the host wrapper plans launches by: out[0] the most slate
// entries one pass holds (a longer slate takes several passes), out[1]
// queries per block, out[2] candidates per tile (a split of the candidate
// axis is a whole number of tiles).
void coconut_layout(int* out) {
  out[0] = PASS_SLATE;
  out[1] = BM;
  out[2] = TN;
}

// topk_ed: f32 candidates x (n, d) taken in order (no row list), |x|^2
// summed in the tile. qn2 receives |q|^2 as a by-product.
int coconut_topk_ed(const void* q, int m, int d, const void* x, int n, int s, int chunk,
                    int n_splits, const void* floor_v, const void* floor_i, void* part_v,
                    void* part_i, void* qn2, void* out_v, void* out_i, void* stream) {
  return launch(static_cast<const float*>(q), m, d, static_cast<const float*>(x), n, s, chunk,
                n_splits, static_cast<const float*>(floor_v), static_cast<const int*>(floor_i),
                static_cast<float*>(part_v), static_cast<int*>(part_i),
                static_cast<float*>(qn2), static_cast<float*>(out_v), static_cast<int*>(out_i),
                static_cast<cudaStream_t>(stream));
}

// min_ed: per query the lexicographic (d2, row) minimum over x (n, d) f32,
// n >= 1, m >= 1. best (m,) uint64 is scratch; out_v (m,) f32, out_i (m,)
// int32. A memset, the scan and an m-thread unpack on one stream.
int coconut_min_ed(const void* q, int m, int d, const void* x, int n, int chunk, int n_splits,
                   void* best, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned long long*>(best);
  cudaError_t err = cudaMemsetAsync(b, 0xff, sizeof(unsigned long long) * (size_t)m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_splits, (m + BM - 1) / BM);
  min_ed_kernel<<<grid, NTHREADS, 0, st>>>(static_cast<const float*>(q), m, d,
                                           static_cast<const float*>(x), n, chunk, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  min_ed_unpack_kernel<<<(m + 255) / 256, 256, 0, st>>>(b, m, static_cast<float*>(out_v),
                                                        static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
