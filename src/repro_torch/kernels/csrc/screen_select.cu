// Fused screen + top-s select for the verification engine, by hand for Hopper.
//
// Replaces the Pallas kernels screen_select_pallas (f32 and bf16 tables) and
// screen_select_quant_pallas (int8 tables with per-row scales) of
// src/repro/kernels/ed_scan_kernel.py (bodies _screen_select_body and
// _screen_select_quant_body, running merge _merge_topk_tile).
//
// What it computes, per query i and candidate j (table row r = rows[j], or
// r = j when no row list is given):
//
//     d2[i, j] = (qn2[i] + xn2[r]) - 2 * g,   g = <q_i, x_r>            (f32, bf16)
//                                             g = scale[r] * <q_i, v_r> (int8)
//
// with every product and sum in true f32 on the CUDA cores: the table values
// are upcast in registers, and there is no TF32 or tensor-core product, so the
// engine's certificate 4 d u32 |q| |x|max holds for the screen. The output is
// the top-s slate per query in lexicographic (d2, j) order, empty slots
// (inf, INT32_MAX), plus qn2 = |q_i|^2.
//
// What bounds it on the H100: at the engine's batch buckets (m = 16..64
// queries, d = 128..256) the screen does 2 m flops per table byte read at f32,
// so a small batch is bound by the 3.35 TB/s of device memory and a large
// batch, or an int8 table, by the 67 TFLOP/s of f32 FMA on the CUDA cores.
//
// Design. The TPU kernel walks the candidate axis in order inside one grid
// and carries the running top-k in VMEM; on the H100 that would leave m/bm
// blocks, one block at m = 16. So the candidate axis is split over blocks:
//
//   screen_partial_kernel  grid (n_splits, ceil(m / BM)), 256 threads. A block
//     streams its candidate slice in tiles of TN rows: the row list is read by
//     the block itself (the gather never materialises a (B, d) copy), the
//     tile is staged in shared memory in DK-wide slices of the contraction, and
//     each thread accumulates a 2 x 4 register tile of dot products, so one
//     shared-memory read of a table value feeds two FMAs. The finished d2 tile
//     goes through shared memory to the selection: each warp owns two queries
//     and keeps their slates sorted in shared memory. A candidate is tested
//     against the slate's worst entry (nearly all fail once the slate is
//     full) and the few that pass are inserted by the whole warp at once.
//   slate_merge_kernel     one block per query merges the n_splits partial
//     slates of s entries with the same warp insertion, eight warps in
//     parallel and then warp 0 over their eight slates.
//
// Candidate ids are unique within a launch, so the lexicographic order is a
// strict total order on real entries and the slate does not depend on the
// order in which blocks or lanes offer candidates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // queries per block (two per warp)
constexpr int TN = 128;       // candidates per tile (four per lane)
constexpr int DK = 32;        // contraction slice staged in shared memory
constexpr int NTHREADS = 256;
constexpr int MERGE_WARPS = 8;
constexpr int MAX_SLATE = 128;  // the largest slate a launch holds
constexpr int EMPTY_ID = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

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

template <typename T, int SMAX>
__global__ void __launch_bounds__(NTHREADS)
screen_partial_kernel(const float* __restrict__ q, int m, int d, const T* __restrict__ x,
                      const float* __restrict__ xn2, const float* __restrict__ scale,
                      const int* __restrict__ rows, int n, int s, int chunk, int n_splits,
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
  // |q|^2, one warp per two queries
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
  __syncthreads();
  if (split == 0 && tid < BM && m0 + tid < m) qn2_out[m0 + tid] = qn2s[tid];

  for (int c0 = c_begin; c0 < c_end; c0 += TN) {
    __syncthreads();  // the previous tile's selection is done with dt and rowid
    if (tid < TN) {
      const int c = c0 + tid;
      rowid[tid] = (c < c_end) ? (rows != nullptr ? rows[c] : c) : -1;
    }
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
        xs[cc][kk] = (r >= 0 && k < d) ? to_f32(x[(size_t)r * d + k]) : 0.f;
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
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = 2 * warp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = lane + 32 * j;
        const int r = rowid[cc];
        float v = INFINITY;
        if (r >= 0) {
          float g = acc[i][j];
          if (scale != nullptr) g = __fmul_rn(g, scale[r]);  // dequantise the cross term
          v = __fsub_rn(__fadd_rn(qn2s[qi], xn2[r]), __fmul_rn(2.f, g));
        }
        dt[qi][cc] = v;
      }
    }
    __syncthreads();
    for (int t = 0; t < 2; ++t) {
      const int qi = 2 * warp + t;
      if (m0 + qi >= m) continue;  // warp-uniform
      for (int g = 0; g < TN; g += 32) {
        const int cc = g + lane;
        warp_offer<SMAX>(sv[qi], si[qi], s, dt[qi][cc], c0 + cc, rowid[cc] >= 0, lane);
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

template <typename T, int SMAX>
int launch_t(const float* q, int m, int d, const T* x, const float* xn2, const float* scale,
             const int* rows, int n, int s, int chunk, int n_splits, float* part_v,
             int* part_i, float* qn2, float* out_v, int* out_i, cudaStream_t stream) {
  dim3 grid(n_splits, (m + BM - 1) / BM);
  screen_partial_kernel<T, SMAX><<<grid, NTHREADS, 0, stream>>>(
      q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, part_v, part_i, qn2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slate_merge_kernel<SMAX><<<m, MERGE_WARPS * 32, 0, stream>>>(part_v, part_i, n_splits, s,
                                                                out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* q, int m, int d, const T* x, const float* xn2, const float* scale,
           const int* rows, int n, int s, int chunk, int n_splits, float* part_v, int* part_i,
           float* qn2, float* out_v, int* out_i, cudaStream_t stream) {
  if (s <= 16)
    return launch_t<T, 16>(q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, part_v,
                           part_i, qn2, out_v, out_i, stream);
  if (s <= 32)
    return launch_t<T, 32>(q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, part_v,
                           part_i, qn2, out_v, out_i, stream);
  if (s <= 64)
    return launch_t<T, 64>(q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, part_v,
                           part_i, qn2, out_v, out_i, stream);
  if (s <= MAX_SLATE)
    return launch_t<T, MAX_SLATE>(q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits,
                                  part_v, part_i, qn2, out_v, out_i, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The layout the host wrapper plans launches by: out[0] the largest slate
// (the wrapper refuses more), out[1] queries per block, out[2] candidates per
// tile (a split of the candidate axis is a whole number of tiles).
void coconut_layout(int* out) {
  out[0] = MAX_SLATE;
  out[1] = BM;
  out[2] = TN;
}

// f32 (dtype 0) or bf16 (dtype 1) table. rows may be null (candidates are
// the table rows 0..n-1). Returns the CUDA error code of the launches.
int coconut_screen_select(int dtype, const void* q, int m, int d, const void* x,
                          const void* xn2, const void* rows, int n, int s, int chunk,
                          int n_splits, void* part_v, void* part_i, void* qn2, void* out_v,
                          void* out_i, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* n2 = static_cast<const float*>(xn2);
  const int* r = static_cast<const int*>(rows);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* qn = static_cast<float*>(qn2);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(qf, m, d, static_cast<const float*>(x), n2, nullptr, r, n, s, chunk,
                         n_splits, pv, pi, qn, ov, oi, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qf, m, d, static_cast<const __nv_bfloat16*>(x), n2, nullptr,
                                 r, n, s, chunk, n_splits, pv, pi, qn, ov, oi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 table with per-row f32 scales applied to the contraction.
int coconut_screen_select_quant(const void* q, int m, int d, const void* x, const void* scale,
                                const void* xn2, const void* rows, int n, int s, int chunk,
                                int n_splits, void* part_v, void* part_i, void* qn2,
                                void* out_v, void* out_i, void* stream) {
  return launch<int8_t>(static_cast<const float*>(q), m, d, static_cast<const int8_t*>(x),
                        static_cast<const float*>(xn2), static_cast<const float*>(scale),
                        static_cast<const int*>(rows), n, s, chunk, n_splits,
                        static_cast<float*>(part_v), static_cast<int*>(part_i),
                        static_cast<float*>(qn2), static_cast<float*>(out_v),
                        static_cast<int*>(out_i), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
