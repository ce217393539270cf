// The k = 1 scan of squared ED with the norms summed in the kernel, by hand
// for Hopper.
//
// Replaces the Pallas kernel min_ed_pallas (the running min and argmin) of
// src/repro/kernels/ed_scan_kernel.py (body _ed_scan_body). The top-k scan
// with the norms in the tile (topk_ed_pallas) and the screens over tables
// with cached norms have a design of their own, in screen_fused.cu.
//
// What it computes, per query i and candidate row j:
//
//     d2[i, j] = (qn2[i] + xn2[j]) - 2 * g,   g = <q_i, x_j>
//
// xn2[j] is summed in the tile from the same f32 values that feed the dot
// product (one FMA chain over d per candidate), as the Pallas body's
// _tile_d2 computes |x|^2 per tile, with every product and sum in true f32
// on the CUDA cores (no TF32 or tensor-core product). The answer is the
// first entry of the lexicographic (d2, j) order. The d2 arithmetic is
// topk_ed's (screen_fused.cu: one FMA chain per pair and per norm in k
// order from 0, the same |q|^2 reduction and rounding order), so the answer
// is topk_ed's at k = 1 bit for bit.
//
// What bounds it on the H100: 2 m flops per candidate value for the
// products, against the 3.35 TB/s of device memory and the 67 TFLOP/s of
// f32 FMA on the CUDA cores. Every warp of a block squares the tile's
// candidates for itself (the same FMA chain, so the same value in each
// warp), half again as many FMAs as the products alone.
//
// Design. The TPU kernel walks the candidate axis in order inside one grid
// and carries the running minimum in VMEM; on the H100 that would leave m/bm
// blocks, one block at m = 16. So the candidate axis is split over blocks,
// grid (n_splits, ceil(m / BM)), 256 threads. A block streams its candidate
// slice in tiles of TN rows: the tile is staged in shared memory in DK-wide
// slices of the contraction, and each thread accumulates a 2 x 4 register
// tile of dot products, so one shared-memory read of a table value feeds
// two FMAs. Each lane keeps a running 64-bit key (order-preserving d2 bits
// << 32 | id) per query, the warp reduces it by shuffles, and one atomicMin
// per (block, query) folds it into the answer, so there is no merge and the
// result does not depend on block order. A query equal to a row can give a
// slightly negative d2 (|q|^2 and |x|^2 are summed in other orders than the
// cross term); the key map orders negative floats, and -0.0 is made +0.0
// first so that equal distances keep the lower id.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // queries per block (two per warp)
constexpr int TN = 128;       // candidates per tile (four per lane)
constexpr int DK = 32;        // contraction slice staged in shared memory
constexpr int NTHREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

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

// The layout the host wrapper plans min_ed's launches by: out[0] queries per
// block, out[1] candidates per tile (a split of the candidate axis is a
// whole number of tiles).
void coconut_layout(int* out) {
  out[0] = BM;
  out[1] = TN;
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
