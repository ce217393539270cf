// Fused screen + top-s select over an int8 table, by hand for Hopper.
//
// Replaces the Pallas kernel screen_select_quant_pallas of
// src/repro/kernels/ed_scan_kernel.py (body _screen_select_quant_body,
// running merge _merge_topk_tile). For each query i and candidate j (table
// row r = rows[j], or r = j when no row list is given):
//
//     d2[i, j] = (qn2[i] + xn2[r]) - 2 * (scale[r] * <q_i, v_r>)
//
// with <q_i, v_r> one FMA chain in f32 over k = 0..d-1 on the CUDA cores (the
// int8 values are exact in f32; no TF32 or tensor-core product, so the
// engine's certificate holds). The output is the top-s slate per query in
// lexicographic (d2, j) order, empty slots (inf, INT32_MAX), plus |q_i|^2.
// An optional per-query floor admits only candidates lexicographically after
// it, for slates longer than one pass (ops.slate_in_passes).
//
// What bounds it on the H100: 2 m flops per table byte, so at the engine's
// batch of 16 queries and more it is bound by the 67 TFLOP/s of f32 FMA on
// the CUDA cores, not by the 3.35 TB/s of device memory; at the serving pass
// (16 queries, 16,384 gathered rows) a block has one tile, and latency
// (one launch, the staging of one tile, the merge) is what is left.
//
// Design. One launch per pass, grid (n_splits, ceil(m / BM)), NTHREADS
// threads a block:
//   - Staging. The block stages its BM queries once as f32 and streams its
//     split of the candidate axis in tiles of TN rows, each cut into slices
//     of up to KS values: the int8 bytes go to shared memory raw (a quarter
//     of the f32 footprint), by 16-byte cp.async where the table's base and
//     row length allow it (4-byte or 1-byte copies otherwise, a template
//     parameter), double-buffered so the next slice arrives while this one
//     computes. The row list is read once per tile.
//   - Products. Each thread holds a QT x CT = 4 x 2 register tile (queries
//     4 qg.., candidates c, c + 32): one 16-byte shared load brings 16 values of a
//     candidate, converted in registers (__byte_perm under the exponent of
//     2^23, exact), and each float4 broadcast of a query feeds 8 FMAs: 128
//     FMAs per 18 shared loads, against 8 per 6 in the f32 screen's tile.
//     Every (query, candidate) is one FMA chain in k order, then the scale
//     and the d2 in the f32 screens' rounding order, so the d2 values are
//     those of the earlier two-launch kernel bit for bit.
//   - Selection. A warp keeps two queries' top-s slates as 64-bit keys
//     (order-preserving d2 bits << 32 | position) in shared memory. The
//     lanes of a group of 32 candidates that beat the slate's worst entry
//     enter at once: a few by single inserts, more by a bitonic sort in
//     shuffles and a merge by ranks.
//   - Merge, in the same launch. A block writes its sorted partial slate to
//     scratch, folds its s-th key into a per-query threshold T with
//     atomicMin, fences, and takes a ticket on its query block's counter.
//     The block that takes the last ticket merges, a warp per query: it
//     offers every split's least entry (at or below T), then walks, in
//     order, the splits whose least entry made the slate, while their
//     entries beat the slate's worst entry and lie at or below T. Exact: T
//     is at or above the global s-th entry (the split that holds T has s
//     entries at or below it); an entry of the global top-s is in its
//     split's slate (fewer than s entries of its split are ahead of it),
//     and so is its split's least entry, which is then among the s least
//     split minima and made the slate. Reading every entry at or below T
//     instead left ~700 of 1,664 entries a query at the serving pass.
//     The thresholds and counters are reset by the C entry on the call's
//     stream: no state outlives a call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // queries per block
constexpr int TN = 128;       // candidates per tile
constexpr int KS = 256;       // contraction values staged per stage (bytes of a row)
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds at once (registers and shared memory)
constexpr int MAX_D = 2048;   // the widest rows whose queries fit in shared memory
constexpr int NTHREADS = 256;
// the register tile of a thread: QT queries x CT candidates (BM x TN over
// the block's threads)
constexpr int QT = 4;
constexpr int CT = BM * TN / NTHREADS / QT;
constexpr int PASS_SLATE = 128;  // the most slate entries one pass holds
constexpr unsigned FULL = 0xffffffffu;
// the key of an empty slot, (inf, EMPTY_ID)
constexpr unsigned long long EMPTY_KEY = 0xff8000007fffffffull;
constexpr unsigned long long NO_KEY = ~0ull;  // above every key
// newcomers up to this many enter a slate one at a time, more by a sort
constexpr int SERIAL_INSERTS = 3;

// (d2, id) -> a 64-bit key whose unsigned order is the lexicographic order:
// the f32 bits made order-preserving (negatives flipped whole, positives
// with the sign bit set), -0.0 first made +0.0, then the id below them.
__device__ __forceinline__ unsigned long long lex_key(float v, int id) {
  unsigned b = __float_as_uint(__fadd_rn(v, 0.f));  // -0.0 + 0.0 = +0.0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(id);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  unsigned b = static_cast<unsigned>(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

// The warp's 32 keys sorted ascending across its lanes (bitonic, by
// shuffles).
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long other = __shfl_xor_sync(FULL, key, j);
      // the lower lane of a pair keeps the smaller key in an ascending run
      const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
      key = keep_min ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// Insert key into the sorted slate sk of length s; the caller has checked
// that it beats the slate's last entry. All 32 lanes take part.
template <int SMAX>
__device__ __forceinline__ void slate_insert(unsigned long long* sk, int s,
                                             unsigned long long key, int lane) {
  constexpr int PER = (SMAX + 31) / 32;
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    if (j < s) cnt += sk[j] < key ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  const int pos = cnt;  // entries strictly ahead of the newcomer
  unsigned long long old[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    if (j < s && j > pos) old[t] = sk[j - 1];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    if (j < s && j > pos) sk[j] = old[t];
    else if (j == pos) sk[j] = key;
  }
  __syncwarp();
}

// Each lane offers one key (where want); those that beat the slate's worst
// entry enter the sorted slate sk of length s. A few are inserted one at a
// time; more are merged in one step: the warp sorts them, and each entry of
// either list moves to its own index plus the number of entries of the
// other list ahead of it (keys are distinct, so the places are too);
// entries placed at s or beyond fall off.
template <int SMAX>
__device__ __forceinline__ void warp_offer(unsigned long long* sk, int s,
                                           unsigned long long key, bool want, int lane) {
  constexpr int PER = (SMAX + 31) / 32;
  want = want && key < sk[s - 1];
  const unsigned mask = __ballot_sync(FULL, want);
  if (mask == 0) return;
  const int cnt = __popc(mask);
  if (cnt <= SERIAL_INSERTS) {
    for (unsigned left = mask; left; left &= left - 1) {
      const unsigned long long k = __shfl_sync(FULL, key, __ffs(left) - 1);
      if (k < sk[s - 1]) slate_insert<SMAX>(sk, s, k, lane);  // warp-uniform
    }
    return;
  }
  const unsigned long long run = warp_sort(want ? key : NO_KEY, lane);  // cnt in front
  int place = s;
  if (lane < cnt) {  // slate entries ahead of the newcomer: binary search
    int lo = 0, hi = s;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sk[mid] < run) lo = mid + 1;
      else hi = mid;
    }
    place = lane + lo;
  }
  unsigned long long old[PER];
  int moved[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = lane + 32 * t;
    old[t] = j < s ? sk[j] : NO_KEY;
    int lo = 0, hi = cnt;  // newcomers ahead of it: binary search over the lanes
#pragma unroll
    for (int step = 0; step < 6; ++step) {
      const int mid = (lo + hi) >> 1;
      const unsigned long long r = __shfl_sync(FULL, run, mid & 31);
      if (lo < hi) {
        if (r < old[t]) lo = mid + 1;
        else hi = mid;
      }
    }
    moved[t] = j + lo;
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < PER; ++t)
    if (lane + 32 * t < s && moved[t] < s) sk[moved[t]] = old[t];
  if (place < s) sk[place] = run;
  __syncwarp();
}

// |q|^2 of the block's BM queries into qn2s, one warp per two queries (the
// same reduction as the f32 screens').
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

// Byte offset of value kk of tile row `row` in a staged slice whose rows are
// ksp bytes apart (a multiple of 128): the 16-byte chunks of a row are
// permuted by the row's low three bits, so the eight lanes of a quarter warp,
// which read one chunk of eight neighbouring rows, hit eight distinct
// 16-byte bank groups.
__device__ __forceinline__ int xs_off(int row, int kk, int ksp) {
  return row * ksp + ((((kk >> 4) ^ row) & 7 | (kk >> 4) & ~7) << 4) + (kk & 15);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy w bytes of each of the tile's TN rows, from column kbase of the table,
// into a slice buffer: 16-byte or 4-byte cp.async where the table's base and
// row length allow it (VEC), plain byte loads otherwise. Rows < 0 are not
// copied (their values are never read).
template <int VEC>
__device__ __forceinline__ void stage_copy(uint8_t* buf, const int8_t* __restrict__ x, int d,
                                           const int* rowid, int kbase, int w, int ksp,
                                           int tid) {
  const int per_row = (w + VEC - 1) / VEC;
  for (int e = tid; e < TN * per_row; e += NTHREADS) {
    const int row = e / per_row;
    const int kk = (e - row * per_row) * VEC;
    const int r = rowid[row];
    if (r < 0) continue;
    const int8_t* src = x + (size_t)r * d + kbase + kk;
    uint8_t* dst = buf + xs_off(row, kk, ksp);
    if constexpr (VEC == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                   "l"(src));
    } else if constexpr (VEC == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                   "l"(src));
    } else {
      *dst = static_cast<uint8_t>(*src);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The four int8 values of a word as exact f32, lowest byte first: biased to
// unsigned, placed under the exponent of 2^23 (0x4b0000uu is 2^23 + uu), and
// 2^23 + 128 taken off.
__device__ __forceinline__ void unpack4(unsigned word, float (&f)[4]) {
  const unsigned u = word ^ 0x80808080u;
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b00u, 0x5440)), 8388736.f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b00u, 0x5441)), 8388736.f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b00u, 0x5442)), 8388736.f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b00u, 0x5443)), 8388736.f);
}

// acc[i][j] += <q, v> over one staged slice (w values from column kbase) for
// the thread's queries QT qg + i and candidates c + 32 j, one FMA chain per
// pair in k order. Per 16 values: CT 16-byte loads of int8 rows and 4 QT
// float4 broadcasts of the queries feed 16 QT CT FMAs.
__device__ __forceinline__ void stage_dots(const uint8_t* buf, const float* qs, int dq,
                                           int kbase, int w, int ksp, int qg, int c,
                                           float (&acc)[QT][CT]) {
  const uint8_t* row[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) row[j] = buf + (c + 32 * j) * ksp;
  const int sw = c & 7;  // the same for c + 32 j
  const float* qb = qs + QT * qg * dq + kbase;
  const int full = w >> 4;
#pragma unroll 2
  for (int kc = 0; kc < full; ++kc) {
    const int chunk = ((kc ^ sw) & 7 | kc & ~7) << 4;
    uint4 v[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) v[j] = *reinterpret_cast<const uint4*>(row[j] + chunk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float f[CT][4];
#pragma unroll
      for (int j = 0; j < CT; ++j)
        unpack4(t == 0 ? v[j].x : t == 1 ? v[j].y : t == 2 ? v[j].z : v[j].w, f[j]);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qb + i * dq + 16 * kc + 4 * t);
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          acc[i][j] = fmaf(a.x, f[j][0], acc[i][j]);
          acc[i][j] = fmaf(a.y, f[j][1], acc[i][j]);
          acc[i][j] = fmaf(a.z, f[j][2], acc[i][j]);
          acc[i][j] = fmaf(a.w, f[j][3], acc[i][j]);
        }
      }
    }
  }
  for (int kk = full << 4; kk < w; ++kk) {  // d % 16 values, one at a time
    const int o = xs_off(0, kk, ksp) ^ (sw << 4);
    float f[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) f[j] = static_cast<float>(static_cast<int8_t>(row[j][o]));
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float a = qb[i * dq + kk];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a, f[j], acc[i][j]);
    }
  }
}

// The screened distance, rounded step by step in one fixed order.
__device__ __forceinline__ float screen_d2(float qn2, float xn2, float g) {
  return __fsub_rn(__fadd_rn(qn2, xn2), __fmul_rn(2.f, g));
}

// Dynamic shared memory of a block: the slates (BM x SMAX keys), the
// queries (BM x dq f32, dq = d rounded up to 16), two slice buffers of TN
// rows x ksp int8 bytes, the d2 tile (BM x TN), |q|^2 and two row lists.
__host__ __device__ constexpr int query_stride(int d) { return (d + 15) & ~15; }
__host__ __device__ constexpr int slice_stride(int d) {
  return ((d < KS ? d : KS) + 127) & ~127;
}
__host__ __device__ constexpr size_t smem_bytes(int smax, int d) {
  return 8 * (size_t)BM * smax + 4 * (size_t)BM * query_stride(d) +
         2 * (size_t)TN * slice_stride(d) + 4 * (size_t)BM * TN + 4 * BM + 8 * TN;
}

// floor_v/floor_i (m,) may be null; where given, only candidates
// lexicographically after (floor_v[i], floor_i[i]) enter query i's slate.
// part (m, n_splits, s), thresh (m,) and tickets (ceil(m / BM),) are
// scratch; thresh and tickets start as all ones (tickets at -1).
template <int SMAX, int VEC>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
screen_quant_kernel(const float* __restrict__ q, int m, int d, const int8_t* __restrict__ x,
                    const float* __restrict__ xn2, const float* __restrict__ scale,
                    const int* __restrict__ rows, int n, int s, int chunk, int n_splits,
                    const float* __restrict__ floor_v, const int* __restrict__ floor_i,
                    unsigned long long* __restrict__ part, unsigned long long* thresh,
                    int* tickets, float* __restrict__ qn2_out, float* __restrict__ out_v,
                    int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int dq = query_stride(d);
  const int ksp = slice_stride(d);
  auto* sk = reinterpret_cast<unsigned long long*>(smem);  // [BM][SMAX]
  float* qs = reinterpret_cast<float*>(sk + BM * SMAX);     // [BM][dq]
  uint8_t* xs = reinterpret_cast<uint8_t*>(qs + BM * dq);  // [2][TN][ksp]
  float* dt = reinterpret_cast<float*>(xs + 2 * TN * ksp);  // [BM][TN]
  float* qn2s = dt + BM * TN;                                // [BM]
  int* rowid = reinterpret_cast<int*>(qn2s + BM);            // [2][TN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int c_begin = split * chunk;
  const int c_end = min(n, c_begin + chunk);
  // the register tile: queries QT qg + i, candidates c + 32 j
  const int qg = warp % (BM / QT);
  const int c = warp / (BM / QT) * 32 * CT + lane;

  for (int e = tid; e < BM * SMAX; e += NTHREADS) sk[e] = EMPTY_KEY;
  for (int e = tid; e < BM * dq; e += NTHREADS) {  // the queries, once
    const int qi = e / dq, k = e - qi * dq;
    qs[e] = (m0 + qi < m && k < d) ? q[(size_t)(m0 + qi) * d + k] : 0.f;
  }
  if (tid < TN) {
    const int cc = c_begin + tid;
    rowid[tid] = cc < c_end ? (rows != nullptr ? rows[cc] : cc) : -1;
  }
  block_qn2(q, m, m0, d, qn2s, lane, warp);
  __syncthreads();
  if (split == 0 && tid < BM && m0 + tid < m) qn2_out[m0 + tid] = qn2s[tid];

  // stages g = (tile, slice of KS values), double-buffered: stage g + 1 is
  // in flight while stage g computes
  const int ns = (d + KS - 1) / KS;
  const int n_stages = (c_end - c_begin + TN - 1) / TN * ns;
  stage_copy<VEC>(xs, x, d, rowid, 0, min(d, KS), ksp, tid);
  cp_async_commit();
  float acc[QT][CT];
  float xr[CT], sr[CT];  // the candidates' norms and scales, fetched early
  for (int g = 0; g < n_stages; ++g) {
    const int tile = g / ns, sl = g - tile * ns;
    const int c0 = c_begin + tile * TN;
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < QT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int r = rowid[(tile & 1) * TN + c + 32 * j];
        xr[j] = r >= 0 ? xn2[r] : 0.f;
        sr[j] = r >= 0 ? scale[r] : 0.f;
      }
      if (tid < TN) {  // the next tile's rows; that buffer's last reader is done
        const int cc = c0 + TN + tid;
        rowid[((tile + 1) & 1) * TN + tid] =
            cc < c_end ? (rows != nullptr ? rows[cc] : cc) : -1;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // stage g landed; the previous stage's readers are done
    if (g + 1 < n_stages) {
      const int t1 = (g + 1) / ns, s1 = g + 1 - t1 * ns;
      stage_copy<VEC>(xs + ((g + 1) & 1) * TN * ksp, x, d, rowid + (t1 & 1) * TN, s1 * KS,
                      min(d - s1 * KS, KS), ksp, tid);
    }
    cp_async_commit();
    stage_dots(xs + (g & 1) * TN * ksp, qs, dq, sl * KS, min(d - sl * KS, KS), ksp, qg, c,
               acc);
    if (sl != ns - 1) continue;

    const int* rid = rowid + (tile & 1) * TN;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int cc = c + 32 * j;
      const int r = rid[cc];
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const int qi = QT * qg + i;
        dt[qi * TN + cc] =
            r >= 0 ? screen_d2(qn2s[qi], xr[j], __fmul_rn(acc[i][j], sr[j])) : INFINITY;
      }
    }
    __syncthreads();
    for (int t = 0; t < 2; ++t) {
      const int qi = 2 * warp + t;
      if (m0 + qi >= m) continue;  // warp-uniform
      const bool has_floor = floor_v != nullptr;
      const unsigned long long fk =
          has_floor ? lex_key(floor_v[m0 + qi], floor_i[m0 + qi]) : 0ull;
      for (int g0 = 0; g0 < TN; g0 += 32) {
        const int cc = g0 + lane;
        const float v = dt[qi * TN + cc];
        const unsigned long long key = lex_key(v, c0 + cc);
        const bool valid = c0 + cc < c_end && !isnan(v) && (!has_floor || fk < key);
        warp_offer<SMAX>(sk + qi * SMAX, s, key, valid, lane);
      }
    }
  }
  __syncthreads();

  // the sorted partial slate to scratch, its s-th key into the threshold
  for (int e = tid; e < BM * s; e += NTHREADS) {
    const int qi = e / s, j = e % s;
    const int gq = m0 + qi;
    if (gq < m) part[((size_t)gq * n_splits + split) * s + j] = sk[qi * SMAX + j];
  }
  if (tid < BM && m0 + tid < m) atomicMin(thresh + m0 + tid, sk[tid * SMAX + s - 1]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.y, 1) == n_splits - 2;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of this query block merges, a warp per query: first the
  // splits' least entries, then, from the splits whose least entry made the
  // slate, their further entries in order while they beat the slate's worst
  // entry and lie at or below the threshold
  constexpr int PER = (SMAX + 31) / 32;
  for (int t = 0; t < 2; ++t) {
    const int qi = 2 * warp + t;
    const int gq = m0 + qi;
    if (gq >= m) continue;  // warp-uniform
    unsigned long long* slate = sk + qi * SMAX;
    for (int j = lane; j < s; j += 32) slate[j] = EMPTY_KEY;
    __syncwarp();
    const unsigned long long T = __ldcg(thresh + gq);
    const unsigned long long* pq = part + (size_t)gq * n_splits * s;
    for (int p0 = 0; p0 < n_splits; p0 += 4 * 32) {
      unsigned long long key[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = p0 + 32 * u + lane;
        key[u] = p < n_splits ? __ldcg(pq + (size_t)p * s) : EMPTY_KEY;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        warp_offer<SMAX>(slate, s, key[u], key[u] <= T && key[u] != EMPTY_KEY, lane);
    }
    int src[PER];  // a split to walk (the split of a slate entry), or -1
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int j = lane + 32 * u;
      const unsigned long long key = j < s ? slate[j] : EMPTY_KEY;
      src[u] = key != EMPTY_KEY ? static_cast<int>(key & 0xffffffffu) / chunk : -1;
    }
    for (int next = 1; next < s; next += 4) {
      bool walking = false;
#pragma unroll
      for (int u = 0; u < PER; ++u) walking |= src[u] >= 0;
      if (!__any_sync(FULL, walking)) break;
      unsigned long long key[PER][4];
#pragma unroll
      for (int u = 0; u < PER; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          key[u][v] = src[u] >= 0 && next + v < s
                          ? __ldcg(pq + (size_t)src[u] * s + next + v) : EMPTY_KEY;
#pragma unroll
      for (int u = 0; u < PER; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          warp_offer<SMAX>(slate, s, key[u][v], key[u][v] <= T && key[u][v] != EMPTY_KEY,
                           lane);
      // a split goes on only while its last entry read made the slate
      const unsigned long long worst = slate[s - 1];
#pragma unroll
      for (int u = 0; u < PER; ++u)
        if (!(key[u][3] < worst && key[u][3] <= T)) src[u] = -1;
    }
    for (int j = lane; j < s; j += 32) {
      const unsigned long long key = slate[j];
      out_v[(size_t)gq * s + j] = key_value(key);
      out_i[(size_t)gq * s + j] = static_cast<int>(key & 0xffffffffu);
    }
  }
}

template <int SMAX, int VEC>
int launch_t(const float* q, int m, int d, const int8_t* x, const float* xn2,
             const float* scale, const int* rows, int n, int s, int chunk, int n_splits,
             const float* floor_v, const int* floor_i, void* scratch, float* qn2, float* out_v,
             int* out_i, cudaStream_t stream) {
  const int m_blocks = (m + BM - 1) / BM;
  auto* part = static_cast<unsigned long long*>(scratch);
  unsigned long long* thresh = part + (size_t)m * n_splits * s;
  int* tickets = reinterpret_cast<int*>(thresh + m);
  const size_t smem = smem_bytes(SMAX, d);
  cudaError_t err = cudaFuncSetAttribute(screen_quant_kernel<SMAX, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // thresholds to all ones (no key), tickets to -1: every byte 0xff
  err = cudaMemsetAsync(thresh, 0xff, 8 * (size_t)m + 4 * (size_t)m_blocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_splits, m_blocks);
  screen_quant_kernel<SMAX, VEC><<<grid, NTHREADS, smem, stream>>>(
      q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, floor_v, floor_i, part, thresh,
      tickets, qn2, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int SMAX>
int launch_vec(const float* q, int m, int d, const int8_t* x, const float* xn2,
               const float* scale, const int* rows, int n, int s, int chunk, int n_splits,
               const float* floor_v, const int* floor_i, void* scratch, float* qn2,
               float* out_v, int* out_i, cudaStream_t stream) {
  // the widest copy unit that every row start of the table is aligned to
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const int vec = (base % 16 == 0 && d % 16 == 0) ? 16 : (base % 4 == 0 && d % 4 == 0) ? 4 : 1;
#define COCONUT_LAUNCH(VEC)                                                                 \
  return launch_t<SMAX, VEC>(q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, floor_v, \
                             floor_i, scratch, qn2, out_v, out_i, stream)
  if (vec == 16) COCONUT_LAUNCH(16);
  if (vec == 4) COCONUT_LAUNCH(4);
  COCONUT_LAUNCH(1);
#undef COCONUT_LAUNCH
}

}  // namespace

extern "C" {

// The layout the host wrapper plans launches by: out[0] the most slate
// entries one pass holds, out[1] queries per block, out[2] candidates per
// tile, out[3] the largest d the kernel stages.
void coconut_quant_layout(int* out) {
  out[0] = PASS_SLATE;
  out[1] = BM;
  out[2] = TN;
  out[3] = MAX_D;
}

// int8 table x (N, d) with per-row f32 scales applied to the contraction.
// rows may be null (candidates are the table rows 0..n-1), floor_v/floor_i
// too (no floor). scratch holds 8 (m n_splits s + m) + 4 ceil(m / 16)
// bytes. out_v/out_i (m, s); qn2 (m,). Returns the CUDA error code of the
// memset and the launch.
int coconut_screen_select_quant(const void* q, int m, int d, const void* x, const void* scale,
                                const void* xn2, const void* rows, int n, int s, int chunk,
                                int n_splits, const void* floor_v, const void* floor_i,
                                void* scratch, void* qn2, void* out_v, void* out_i,
                                void* stream) {
#define COCONUT_LAUNCH(SMAX)                                                               \
  return launch_vec<SMAX>(                                                                 \
      static_cast<const float*>(q), m, d, static_cast<const int8_t*>(x),                   \
      static_cast<const float*>(xn2), static_cast<const float*>(scale),                    \
      static_cast<const int*>(rows), n, s, chunk, n_splits,                                \
      static_cast<const float*>(floor_v), static_cast<const int*>(floor_i), scratch,       \
      static_cast<float*>(qn2), static_cast<float*>(out_v), static_cast<int*>(out_i),      \
      static_cast<cudaStream_t>(stream))
  if (s <= 16) COCONUT_LAUNCH(16);
  if (s <= 32) COCONUT_LAUNCH(32);
  if (s <= 64) COCONUT_LAUNCH(64);
  if (s <= PASS_SLATE) COCONUT_LAUNCH(PASS_SLATE);
#undef COCONUT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
