// Fused screen + top-s select over an f32, bf16 or int8 table, and top-k
// and minimum squared ED with the norms summed in the tile, by hand for
// Hopper.
//
// Replaces the Pallas kernels screen_select_pallas (f32 and bf16 tables),
// screen_select_quant_pallas (int8 tables with per-row f32 scales),
// topk_ed_pallas and min_ed_pallas (f32 candidates, norms computed in the
// kernel) of src/repro/kernels/ed_scan_kernel.py (bodies
// _screen_select_body, _screen_select_quant_body, _topk_ed_body and
// _ed_scan_body, running merge _merge_topk_tile). For each query i and
// candidate j (table row r = rows[j], or r = j when no row list is given, as
// for topk_ed and min_ed):
//
//     d2[i, j] = (qn2[i] + xn2[r]) - 2 * g,  g = <q_i, x_r>              (f32, bf16)
//     d2[i, j] = (qn2[i] + xn2[r]) - 2 * (scale[r] * <q_i, v_r>)         (int8)
//     d2[i, j] = (qn2[i] + |x_r|^2) - 2 * g                              (topk_ed, min_ed)
//
// with the product one FMA chain in f32 over k = 0..d-1 on the CUDA cores
// (bf16 and int8 values are exact in f32; no TF32 or tensor-core product, so
// the engine's certificate holds). The screens read cached norms xn2;
// the norms-in-tile mode (NORMS) of topk_ed and min_ed sums |x_r|^2 as one
// more FMA chain per candidate, in k order from 0, from the same values that
// feed the products, as the Pallas body's _tile_d2 does. The output is the
// top-s slate per query in lexicographic (d2, j) order, empty slots (inf,
// INT32_MAX), plus |q_i|^2; min_ed's is the first entry of that order alone.
// An optional per-query floor admits only candidates lexicographically
// after it, for slates longer than one pass (ops.slate_in_passes).
//
// What bounds it on the H100: 2 m flops per table value against the 67
// TFLOP/s of f32 FMA on the CUDA cores and the 3.35 TB/s of device memory
// (20 flops a byte between the two): at the engine's batch of 16 queries an
// f32 or bf16 table is bound by its bytes, an int8 table by the FMAs, and at
// 64 queries every type by the FMAs. At the serving pass (16 queries, 16,384
// gathered rows) a block has one tile, and latency (one launch, the staging
// of one tile, the merge) is what is left. The norms add 2 flops a value; as
// every query group of a block sums them for itself, a thread issues a
// quarter more FMAs than the products alone, and no more shared loads.
// topk_ed's most frequent pass, 1 query x 32,768 rows, is bound by bytes, as
// is min_ed's, 16 queries x 2^20 rows.
//
// Design. One launch per pass, grid (ceil(m / BQ), n_splits) (the query
// blocks of one split side by side, so that L2 serves their common rows),
// NTHREADS threads a block of BQ queries (BM = 16; BM_WIDE = 32 for an f32
// table at m > 16, the screen's, topk_ed's and min_ed's); one body for the
// three types, the norms-in-tile mode and the min epilogue (ARGMIN), with
// four entry points so that a profile tells them apart (screen_quant_kernel
// for int8, screen_dense_kernel<T> for f32 and bf16, topk_ed_kernel,
// min_ed_kernel):
//   - Staging. The block streams its split of the candidate axis in tiles of
//     TN rows, each cut into stages of KS bytes of a row (256 int8, 128 bf16
//     or 64 f32 values): the row bytes go to shared memory as stored, by
//     16-byte cp.async where the table's base and row length allow it (an
//     instance of its own, V16; else 4-byte cp.async or 1-byte copies, picked
//     in the kernel), double-buffered so the next stage arrives while this
//     one computes. The row list is read once per tile. The block's BQ
//     queries are staged once as f32 while that leaves two blocks an SM;
//     wider rows stage each query slice beside its row slice in the same
//     double buffer, so any d is taken.
//   - Products. Each thread holds a QT x CT register tile (queries 4 qg..,
//     candidates c + 32 j): 4 x 2 at BM queries, 4 x 4 at BM_WIDE. One
//     16-byte shared load brings 16, 8 or 4 values of a candidate, converted
//     in registers where they are not f32 (int8 by __byte_perm under the
//     exponent of 2^23, bf16 by a 16-bit shift; both exact), and each float4
//     broadcast of a query feeds CT x 4 FMAs: for f32, 32 FMAs per 6 shared
//     loads at BM (8 per 6 in the two-launch kernel this replaced) and 64 per
//     8 at BM_WIDE, where the shared-memory loads, not the FMAs, held the
//     f32 screen back; 128 per 18 for int8. Every (query, candidate) is one
//     FMA chain in k order from 0, then (int8) the scale, then the d2 in one
//     fixed rounding order, so the d2 values are those of the earlier
//     two-launch kernels bit for bit. With NORMS each thread also keeps CT
//     norm chains, fed by the values already in registers; the threads of
//     the query groups that share a candidate sum the same chain and get
//     the same value, and |q|^2 is one warp reduction, so min_ed's answer is
//     topk_ed's at k = 1.
//   - Selection. A warp keeps BQ / 8 queries' top-s slates as 64-bit keys
//     (order-preserving d2 bits << 32 | position) in shared memory. The
//     lanes of a group of 32 candidates that beat the slate's worst entry
//     enter at once: a few by single inserts, more by a bitonic sort in
//     shuffles and a merge by ranks. A NaN d2 never enters.
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
//   - Min epilogue (ARGMIN, min_ed). No slate, d2 tile, merge or ticket: at
//     the end of each tile a thread folds its QT x CT d2 values into QT
//     running keys (the same 64-bit keys, so a tie keeps the lower row;
//     registers only, so no barrier), the warp reduces them by shuffles at
//     the end of its split, and one atomicMin per warp and query folds them
//     into the answer: the threshold of a slate of one. The answer does not
//     depend on block order. A NaN d2 is folded too, its key after +inf's,
//     so a query's answer is NaN only where every d2 is. Without the d2
//     tile a 32-query block stages its queries whole at d = 256 (sliced
//     with it: 5% slower at 64 queries over 2^20 rows, PERF.md). A query
//     equal to a row can give a slightly negative d2 (|q|^2 and |x|^2 are
//     summed in other orders than the cross term); the key map orders
//     negative floats, and -0.0 is made +0.0 first so that equal distances
//     keep the lower row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;         // queries per block (the f32 screen at m > BM: BM_WIDE)
constexpr int BM_WIDE = 32;
constexpr int TN = 128;        // candidates per tile
constexpr int KS = 256;        // bytes of a row staged per stage
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds at once (registers and shared memory)
constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;
// the register tile of a thread: QT queries x ct<BQ>() candidates (BQ x TN
// over the block's threads)
constexpr int QT = 4;
template <int BQ>
__host__ __device__ constexpr int ct() { return BQ * TN / NTHREADS / QT; }
constexpr int PASS_SLATE = 128;  // the most slate entries one pass holds
// shared memory of an SM, and the most a block may take for two blocks to
// fit on one (each block keeps 1 KB of its own)
constexpr size_t SM_SMEM = 233472;
constexpr size_t TWO_BLOCK_SMEM = SM_SMEM / 2 - 1024;
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

// |q|^2 of the block's BQ queries into qn2s, BQ / WARPS queries a warp (the
// same reduction as the f32 screens').
template <int BQ>
__device__ __forceinline__ void block_qn2(const float* __restrict__ q, int m, int m0, int d,
                                          float* qn2s, int lane, int warp) {
  for (int t = 0; t < BQ / WARPS; ++t) {
    const int qi = BQ / WARPS * warp + t;
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

// Byte offset of byte kk of tile row `row` in a staged slice whose rows are
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

// Copy per_row units of VEC bytes of each of the tile's TN rows (row_bytes
// apart in the table), from byte kbase of the row, into a slice buffer:
// 16-byte or 4-byte cp.async, or plain byte loads. PER > 0 is per_row known
// at compile time (a whole stage), so the unit's row and column come by
// shifts. ROLLED keeps the loop rolled: an int8 stage holds 4 to 16 times
// the FMAs of a bf16 or f32 one, and there the unrolled copy cost more in
// code than it saved in issue (the serving pass, PERF.md). Rows < 0 are not
// copied (their values are never read).
template <int VEC, int PER, bool ROLLED>
__device__ __forceinline__ void copy_units(uint8_t* buf, const uint8_t* __restrict__ x,
                                           size_t row_bytes, const int* rowid, int kbase,
                                           int per_row, int ksp, int tid) {
  const int pr = PER > 0 ? PER : per_row;
  auto copy = [&](int e) {
    const int row = e / pr;
    const int kk = (e - row * pr) * VEC;
    const int r = rowid[row];
    if (r < 0) return;
    const uint8_t* src = x + (size_t)r * row_bytes + kbase + kk;
    uint8_t* dst = buf + xs_off(row, kk, ksp);
    if constexpr (VEC == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                   "l"(src));
    } else if constexpr (VEC == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                   "l"(src));
    } else {
      *dst = *src;
    }
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int e = tid; e < TN * pr; e += NTHREADS) copy(e);
  } else {
    for (int e = tid; e < TN * pr; e += NTHREADS) copy(e);
  }
}

// Copy wb bytes of each of the tile's TN rows, from byte kbase of the row,
// into a slice buffer, in units of VEC bytes (where the table's base and row
// length allow it).
template <int VEC, bool ROLLED>
__device__ __forceinline__ void stage_copy(uint8_t* buf, const uint8_t* __restrict__ x,
                                           size_t row_bytes, const int* rowid, int kbase,
                                           int wb, int ksp, int tid) {
  if (wb == KS)
    copy_units<VEC, KS / VEC, ROLLED>(buf, x, row_bytes, rowid, kbase, 0, ksp, tid);
  else
    copy_units<VEC, 0, ROLLED>(buf, x, row_bytes, rowid, kbase, (wb + VEC - 1) / VEC, ksp,
                               tid);
}

// stage_copy in 16-byte units (V16, an instance of its own), else in the
// unit picked at launch (uniform over the grid: 4 or 1 bytes).
template <bool V16, bool ROLLED>
__device__ __forceinline__ void stage_rows(int vec, uint8_t* buf, const uint8_t* __restrict__ x,
                                           size_t row_bytes, const int* rowid, int kbase,
                                           int wb, int ksp, int tid) {
  if constexpr (V16) stage_copy<16, ROLLED>(buf, x, row_bytes, rowid, kbase, wb, ksp, tid);
  else if (vec == 4) stage_copy<4, ROLLED>(buf, x, row_bytes, rowid, kbase, wb, ksp, tid);
  else stage_copy<1, ROLLED>(buf, x, row_bytes, rowid, kbase, wb, ksp, tid);
}

// Copy per_row units of UNIT bytes (16 or 4) of each of the block's BQ
// queries, from column kbase, into qbuf (BQ rows of qsv floats) by cp.async;
// PER > 0 is per_row known at compile time (a whole stage). Rows past m
// repeat query m - 1 (their products are never offered).
template <int BQ, int UNIT, int PER>
__device__ __forceinline__ void copy_queries(float* qbuf, const float* __restrict__ q, int m,
                                             int m0, int d, int kbase, int per_row, int qsv,
                                             int tid) {
  const int pr = PER > 0 ? PER : per_row;
  for (int e = tid; e < BQ * pr; e += NTHREADS) {
    const int qi = e / pr, kk = (e - qi * pr) * (UNIT / 4);
    const float* src = q + (size_t)min(m0 + qi, m - 1) * d + kbase + kk;
    const unsigned dst = smem_addr(qbuf + qi * qsv + kk);
    if constexpr (UNIT == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
  }
}

// The stage's query slice, for rows too wide to stage the queries whole: w
// values from column kbase of each query into qbuf, in units of qunit
// bytes (16 where the queries' base and d allow it, else 4). Kept out of
// line: inlined, its code sat in the stage loop of every launch, and the
// serving pass (one tile a block) ran 2-3% slower (PERF.md).
template <int BQ, int KSV>
__device__ __noinline__ void stage_queries(int qunit, float* qbuf, const float* q, int m,
                                              int m0, int d, int kbase, int w, int tid) {
  if (qunit == 16 && w == KSV)
    copy_queries<BQ, 16, KSV / 4>(qbuf, q, m, m0, d, kbase, 0, KSV, tid);
  else if (qunit == 16)
    copy_queries<BQ, 16, 0>(qbuf, q, m, m0, d, kbase, w / 4, KSV, tid);
  else
    copy_queries<BQ, 4, 0>(qbuf, q, m, m0, d, kbase, w, KSV, tid);
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

// Values 4 g .. 4 g + 3 of a 16-byte chunk of T values, as exact f32: a bf16
// is the high half of its f32.
template <typename T>
__device__ __forceinline__ void chunk4(const uint4& v, int g, float (&f)[4]) {
  if constexpr (sizeof(T) == 1) {
    unpack4(g == 0 ? v.x : g == 1 ? v.y : g == 2 ? v.z : v.w, f);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned a = g == 0 ? v.x : v.z, b = g == 0 ? v.y : v.w;
    f[0] = __uint_as_float(a << 16);
    f[1] = __uint_as_float(a & 0xffff0000u);
    f[2] = __uint_as_float(b << 16);
    f[3] = __uint_as_float(b & 0xffff0000u);
  } else {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
}

// One staged T value at p, as exact f32.
template <typename T>
__device__ __forceinline__ float value_at(const uint8_t* p) {
  if constexpr (sizeof(T) == 1) {
    return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
  } else if constexpr (sizeof(T) == 2) {
    return __uint_as_float(static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  } else {
    return *reinterpret_cast<const float*>(p);
  }
}

// acc[i][j] += <q, x> over one staged slice of w values for the thread's
// queries QT qg + i (qb: its first query at the slice's first value, rows dq
// floats apart) and candidates c + 32 j, one FMA chain per pair in k order.
// Per 16-byte chunk: CT loads of rows and 16 / sizeof(T) / 4 QT float4
// broadcasts of the queries feed 16 / sizeof(T) QT CT FMAs. NORMS (f32
// only): also xacc[j] += |x|^2 of candidate c + 32 j, one FMA chain per
// candidate in k order, from the values already in registers.
template <typename T, int CT, bool NORMS>
__device__ __forceinline__ void stage_dots(const uint8_t* buf, const float* qb, int dq, int w,
                                           int ksp, int c, float (&acc)[QT][CT],
                                           float (&xacc)[CT]) {
  constexpr int VPC = 16 / sizeof(T);  // values of a 16-byte chunk
  constexpr int GROUPS = VPC / 4;      // float4s of a query that meet one chunk
  constexpr int UNROLL = 16 / GROUPS / CT;
  const uint8_t* row[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) row[j] = buf + (c + 32 * j) * ksp;
  const int sw = c & 7;  // the same for c + 32 j
  const int full = w / VPC;
#pragma unroll (UNROLL)
  for (int kc = 0; kc < full; ++kc) {
    const int chunk = ((kc ^ sw) & 7 | kc & ~7) << 4;
    uint4 v[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) v[j] = *reinterpret_cast<const uint4*>(row[j] + chunk);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      float f[CT][4];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        chunk4<T>(v[j], g, f[j]);
        if constexpr (NORMS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) xacc[j] = fmaf(f[j][e], f[j][e], xacc[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qb + i * dq + VPC * kc + 4 * g);
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
  for (int kk = full * VPC; kk < w; ++kk) {  // the last w % VPC values, one at a time
    const int o = xs_off(0, kk * static_cast<int>(sizeof(T)), ksp) ^ (sw << 4);
    float f[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      f[j] = value_at<T>(row[j] + o);
      if constexpr (NORMS) xacc[j] = fmaf(f[j], f[j], xacc[j]);
    }
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

// Dynamic shared memory of a block: the slates (BQ x SMAX keys), the
// queries (whole: BQ x dq f32, dq = d rounded up to 16; or sliced: two
// buffers of BQ x stage_values f32), two slice buffers of TN rows x ksp
// bytes, the d2 tile (BQ x TN; none without slates, as for min_ed), |q|^2
// and two row lists.
template <typename T>
__host__ __device__ constexpr int stage_values() { return KS / static_cast<int>(sizeof(T)); }
__host__ __device__ constexpr int query_stride(int d) { return (d + 15) & ~15; }
template <typename T>
__host__ __device__ constexpr int slice_stride(int d) {
  return ((d < stage_values<T>() ? d * static_cast<int>(sizeof(T)) : KS) + 127) & ~127;
}
template <typename T, int BQ>
__host__ __device__ constexpr size_t smem_bytes(int smax, int d, bool qslice) {
  return 8 * (size_t)BQ * smax +
         4 * (size_t)BQ * (qslice ? 2 * stage_values<T>() : query_stride(d)) +
         2 * (size_t)TN * slice_stride<T>(d) + (smax > 0 ? 4 * (size_t)BQ * TN : 0) +
         4 * BQ + 8 * TN;
}

// The body of the four entry points, BQ queries a block. scale is read for
// int8 tables only; xn2 is not read with NORMS (f32 tables: |x|^2 summed in
// the tile instead). vec is the rows' copy unit in bytes (16 where V16, else
// 4 or 1); qunit, where not 0, stages the queries a slice a stage instead of
// whole, in units of qunit bytes. floor_v/floor_i (m,) may be null; where
// given, only candidates lexicographically after (floor_v[i], floor_i[i])
// enter query i's slate. part (m, n_splits, s), thresh (m,) and tickets
// (ceil(m / BQ),) are scratch; thresh and tickets start as all ones
// (tickets at -1). ARGMIN (with NORMS, no row list, floor or slate: SMAX 0)
// writes only thresh, each query's least key, and reads no other scratch.
template <typename T, int SMAX, bool V16, int BQ, bool NORMS, bool ARGMIN = false>
__device__ __forceinline__ void screen_body(
    const float* __restrict__ q, int m, int d, const T* __restrict__ x,
    const float* __restrict__ xn2, const float* __restrict__ scale,
    const int* __restrict__ rows, int n, int s, int chunk, int n_splits, int vec, int qunit,
    const float* __restrict__ floor_v, const int* __restrict__ floor_i,
    unsigned long long* __restrict__ part, unsigned long long* thresh, int* tickets,
    float* __restrict__ qn2_out, float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int KSV = stage_values<T>();  // values of a stage
  constexpr int ES = sizeof(T);
  constexpr int CT = ct<BQ>();
  constexpr int QPW = BQ / WARPS;  // the queries of a warp in the selection and merge
  const bool qslice = qunit != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int dq = query_stride(d);
  const int ksp = slice_stride<T>(d);
  const size_t row_bytes = (size_t)d * sizeof(T);
  const auto* xb = reinterpret_cast<const uint8_t*>(x);
  auto* sk = reinterpret_cast<unsigned long long*>(smem);  // [BQ][SMAX]
  float* qs = reinterpret_cast<float*>(sk + BQ * SMAX);     // [BQ][dq] or [2][BQ][KSV]
  // [2][TN][ksp]
  uint8_t* xs = reinterpret_cast<uint8_t*>(qs + (qslice ? 2 * BQ * KSV : BQ * dq));
  float* dt = reinterpret_cast<float*>(xs + 2 * TN * ksp);  // [BQ][TN], none with ARGMIN
  float* qn2s = dt + (ARGMIN ? 0 : BQ * TN);                 // [BQ]
  int* rowid = reinterpret_cast<int*>(qn2s + BQ);            // [2][TN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mb = blockIdx.x;
  const int split = blockIdx.y;
  const int m0 = mb * BQ;
  const int c_begin = split * chunk;
  const int c_end = min(n, c_begin + chunk);
  // the register tile: queries QT qg + i, candidates c + 32 j
  const int qg = warp % (BQ / QT);
  const int c = warp / (BQ / QT) * 32 * CT + lane;

  for (int e = tid; e < BQ * SMAX; e += NTHREADS) sk[e] = EMPTY_KEY;
  if (!qslice) {
    for (int e = tid; e < BQ * dq; e += NTHREADS) {  // the queries, once
      const int qi = e / dq, k = e - qi * dq;
      qs[e] = (m0 + qi < m && k < d) ? q[(size_t)(m0 + qi) * d + k] : 0.f;
    }
  }
  if (tid < TN) {
    const int cc = c_begin + tid;
    rowid[tid] = cc < c_end ? (rows != nullptr ? rows[cc] : cc) : -1;
  }
  block_qn2<BQ>(q, m, m0, d, qn2s, lane, warp);
  __syncthreads();
  if (!ARGMIN && split == 0 && tid < BQ && m0 + tid < m) qn2_out[m0 + tid] = qn2s[tid];

  // stages g = (tile, slice of KSV values), double-buffered: stage g + 1 is
  // in flight while stage g computes
  const int ns = (d + KSV - 1) / KSV;
  const int n_stages = (c_end - c_begin + TN - 1) / TN * ns;
  stage_rows<V16, QUANT>(vec, xs, xb, row_bytes, rowid, 0, min(d, KSV) * ES, ksp, tid);
  if (qslice) stage_queries<BQ, KSV>(qunit, qs, q, m, m0, d, 0, min(d, KSV), tid);
  cp_async_commit();
  float acc[QT][CT];
  // the candidates' norms (and scales): fetched early, or (NORMS) summed
  // over the tile's slices
  float xr[CT], sr[CT];
  unsigned long long best[QT];  // ARGMIN: the least key of each of the thread's queries
#pragma unroll
  for (int i = 0; i < QT; ++i) best[i] = NO_KEY;
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
        xr[j] = !NORMS && r >= 0 ? xn2[r] : 0.f;
        if constexpr (QUANT) sr[j] = r >= 0 ? scale[r] : 0.f;
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
      const int w1 = min(d - s1 * KSV, KSV);
      stage_rows<V16, QUANT>(vec, xs + ((g + 1) & 1) * TN * ksp, xb, row_bytes,
                      rowid + (t1 & 1) * TN, s1 * KS, w1 * ES, ksp, tid);
      if (qslice)
        stage_queries<BQ, KSV>(qunit, qs + ((g + 1) & 1) * BQ * KSV, q, m, m0, d, s1 * KSV,
                               w1, tid);
    }
    cp_async_commit();
    const float* qb = qslice ? qs + (g & 1) * BQ * KSV + QT * qg * KSV
                             : qs + QT * qg * dq + sl * KSV;
    stage_dots<T, CT, NORMS>(xs + (g & 1) * TN * ksp, qb, qslice ? KSV : dq,
                             min(d - sl * KSV, KSV), ksp, c, acc, xr);
    if (sl != ns - 1) continue;

    if constexpr (ARGMIN) {
      // the tile into the keys: real rows (c0 + cc < c_end, so the row list
      // is not read and needs no barrier) of real queries (m0 + qi < m: the
      // rows past m repeat query m - 1)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int r = c0 + c + 32 * j;
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const int qi = QT * qg + i;
          if (r < c_end && m0 + qi < m)
            best[i] = min(best[i], lex_key(screen_d2(qn2s[qi], xr[j], acc[i][j]), r));
        }
      }
    } else {
      const int* rid = rowid + (tile & 1) * TN;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int cc = c + 32 * j;
        const int r = rid[cc];
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const int qi = QT * qg + i;
          float gv = acc[i][j];
          if constexpr (QUANT) gv = __fmul_rn(gv, sr[j]);
          dt[qi * TN + cc] = r >= 0 ? screen_d2(qn2s[qi], xr[j], gv) : INFINITY;
        }
      }
      __syncthreads();
      for (int t = 0; t < QPW; ++t) {
        const int qi = QPW * warp + t;
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
  }
  if constexpr (ARGMIN) {
    // the warp's least key of each query by shuffles (its lanes share qg),
    // then one atomicMin per warp and query
#pragma unroll
    for (int i = 0; i < QT; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best[i] = min(best[i], __shfl_xor_sync(FULL, best[i], o));
      const int gq = m0 + QT * qg + i;
      if (lane == i && gq < m && best[i] != NO_KEY) atomicMin(thresh + gq, best[i]);
    }
  } else {
    __syncthreads();
    // the sorted partial slate to scratch, its s-th key into the threshold
    for (int e = tid; e < BQ * s; e += NTHREADS) {
      const int qi = e / s, j = e % s;
      const int gq = m0 + qi;
      if (gq < m) part[((size_t)gq * n_splits + split) * s + j] = sk[qi * SMAX + j];
    }
    if (tid < BQ && m0 + tid < m) atomicMin(thresh + m0 + tid, sk[tid * SMAX + s - 1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + mb, 1) == n_splits - 2;
    __syncthreads();
    if (!last) return;
    __threadfence();

    // the last block of this query block merges, a warp per query: first the
    // splits' least entries, then, from the splits whose least entry made the
    // slate, their further entries in order while they beat the slate's worst
    // entry and lie at or below the threshold
    constexpr int PER = (SMAX + 31) / 32;
    for (int t = 0; t < QPW; ++t) {
      const int qi = QPW * warp + t;
      const int gq = m0 + qi;
      if (gq >= m) continue;  // warp-uniform
      unsigned long long* slate = sk + qi * SMAX;
      for (int j = lane; j < s; j += 32) slate[j] = EMPTY_KEY;
      __syncwarp();
      const unsigned long long th = __ldcg(thresh + gq);  // the threshold T
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
          warp_offer<SMAX>(slate, s, key[u], key[u] <= th && key[u] != EMPTY_KEY, lane);
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
            warp_offer<SMAX>(slate, s, key[u][v], key[u][v] <= th && key[u][v] != EMPTY_KEY,
                             lane);
        // a split goes on only while its last entry read made the slate
        const unsigned long long worst = slate[s - 1];
#pragma unroll
        for (int u = 0; u < PER; ++u)
          if (!(key[u][3] < worst && key[u][3] <= th)) src[u] = -1;
      }
      for (int j = lane; j < s; j += 32) {
        const unsigned long long key = slate[j];
        out_v[(size_t)gq * s + j] = key_value(key);
        out_i[(size_t)gq * s + j] = static_cast<int>(key & 0xffffffffu);
      }
    }
  }
}


// The int8 screen (scale applied to each product).
template <int SMAX, bool V16>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
screen_quant_kernel(const float* __restrict__ q, int m, int d, const int8_t* __restrict__ x,
                    const float* __restrict__ xn2, const float* __restrict__ scale,
                    const int* __restrict__ rows, int n, int s, int chunk, int n_splits,
                    int vec, int qunit, const float* __restrict__ floor_v,
                    const int* __restrict__ floor_i, unsigned long long* __restrict__ part,
                    unsigned long long* thresh, int* tickets, float* __restrict__ qn2_out,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  screen_body<int8_t, SMAX, V16, BM, false>(q, m, d, x, xn2, scale, rows, n, s, chunk,
                                            n_splits, vec, qunit, floor_v, floor_i, part,
                                            thresh, tickets, qn2_out, out_v, out_i);
}

// The f32 and bf16 screens, BQ queries a block.
template <typename T, int SMAX, bool V16, int BQ>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
screen_dense_kernel(const float* __restrict__ q, int m, int d, const T* __restrict__ x,
                    const float* __restrict__ xn2, const int* __restrict__ rows, int n, int s,
                    int chunk, int n_splits, int vec, int qunit,
                    const float* __restrict__ floor_v, const int* __restrict__ floor_i,
                    unsigned long long* __restrict__ part, unsigned long long* thresh,
                    int* tickets, float* __restrict__ qn2_out, float* __restrict__ out_v,
                    int* __restrict__ out_i) {
  screen_body<T, SMAX, V16, BQ, false>(q, m, d, x, xn2, nullptr, rows, n, s, chunk, n_splits,
                                       vec, qunit, floor_v, floor_i, part, thresh, tickets,
                                       qn2_out, out_v, out_i);
}

// topk_ed: f32 candidates x (n, d) taken in order (a position is the row),
// |x|^2 summed in the tile, BQ queries a block.
template <int SMAX, bool V16, int BQ>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
topk_ed_kernel(const float* __restrict__ q, int m, int d, const float* __restrict__ x, int n,
               int s, int chunk, int n_splits, int vec, int qunit,
               const float* __restrict__ floor_v, const int* __restrict__ floor_i,
               unsigned long long* __restrict__ part, unsigned long long* thresh, int* tickets,
               float* __restrict__ qn2_out, float* __restrict__ out_v, int* __restrict__ out_i) {
  screen_body<float, SMAX, V16, BQ, true>(q, m, d, x, nullptr, nullptr, nullptr, n, s, chunk,
                                          n_splits, vec, qunit, floor_v, floor_i, part, thresh,
                                          tickets, qn2_out, out_v, out_i);
}

// min_ed: the least (d2, row) of each query over f32 rows x (n, d) taken in
// order, |x|^2 summed in the tile, BQ queries a block; best (m,) starts as
// all ones and ends as each query's least key.
template <bool V16, int BQ>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
min_ed_kernel(const float* __restrict__ q, int m, int d, const float* __restrict__ x, int n,
              int chunk, int n_splits, int vec, int qunit, unsigned long long* best) {
  screen_body<float, 0, V16, BQ, true, true>(q, m, d, x, nullptr, nullptr, nullptr, n, 1,
                                             chunk, n_splits, vec, qunit, nullptr, nullptr,
                                             nullptr, best, nullptr, nullptr, nullptr,
                                             nullptr);
}

__global__ void min_ed_unpack_kernel(const unsigned long long* __restrict__ best, int m,
                                     float* __restrict__ out_v, int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long k = best[i];
  if (k == NO_KEY) {  // no key: only with no rows (a NaN d2 gives a key, after +inf's)
    out_v[i] = INFINITY;
    out_i[i] = -1;
    return;
  }
  out_v[i] = key_value(k);
  out_i[i] = static_cast<int>(k & 0xffffffffu);
}

// The widest copy unit that every row start of a table at x is aligned to.
int copy_unit(const void* x, size_t row_bytes) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  return (base % 16 == 0 && row_bytes % 16 == 0) ? 16
         : (base % 4 == 0 && row_bytes % 4 == 0) ? 4 : 1;
}

// A launch's dynamic shared memory (slates of smax entries) and how it
// stages the queries: whole while that leaves two blocks an SM (or takes no
// more than slices would; qunit 0), else a slice a stage in units of qunit
// bytes.
template <typename T, int BQ>
int query_staging(int smax, const float* q, int d, int* qunit) {
  const size_t whole = smem_bytes<T, BQ>(smax, d, false);
  const size_t sliced = smem_bytes<T, BQ>(smax, d, true);
  const bool qslice = whole > TWO_BLOCK_SMEM && sliced < whole;
  const bool q16 = reinterpret_cast<uintptr_t>(q) % 16 == 0 && d % 4 == 0;
  *qunit = !qslice ? 0 : q16 ? 16 : 4;
  return static_cast<int>(qslice ? sliced : whole);
}

// The launch of the T screen's kernel (topk_ed's with NORMS) over query
// blocks of BQ, with the 16-byte copy unit (V16) or the one the kernel is
// given.
template <typename T, int SMAX, bool V16, int BQ, bool NORMS>
cudaError_t launch_kernel(int n_splits, cudaStream_t stream, const float* q, int m, int d,
                          const T* x, const float* xn2, const float* scale, const int* rows,
                          int n, int s, int chunk, int vec, const float* floor_v,
                          const int* floor_i, unsigned long long* part,
                          unsigned long long* thresh, int* tickets, float* qn2, float* out_v,
                          int* out_i) {
  int qunit;
  const int smem = query_staging<T, BQ>(SMAX, q, d, &qunit);
  // the query blocks of one split side by side, so that they read its rows
  // at about the same time and the second read comes from L2
  const dim3 grid((m + BQ - 1) / BQ, n_splits);
  cudaError_t err;
  if constexpr (NORMS) {
    err = cudaFuncSetAttribute(topk_ed_kernel<SMAX, V16, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    topk_ed_kernel<SMAX, V16, BQ><<<grid, NTHREADS, smem, stream>>>(
        q, m, d, x, n, s, chunk, n_splits, vec, qunit, floor_v, floor_i, part, thresh,
        tickets, qn2, out_v, out_i);
  } else if constexpr (sizeof(T) == 1) {
    err = cudaFuncSetAttribute(screen_quant_kernel<SMAX, V16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    screen_quant_kernel<SMAX, V16><<<grid, NTHREADS, smem, stream>>>(
        q, m, d, x, xn2, scale, rows, n, s, chunk, n_splits, vec, qunit, floor_v, floor_i,
        part, thresh, tickets, qn2, out_v, out_i);
  } else {
    err = cudaFuncSetAttribute(screen_dense_kernel<T, SMAX, V16, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    screen_dense_kernel<T, SMAX, V16, BQ><<<grid, NTHREADS, smem, stream>>>(
        q, m, d, x, xn2, rows, n, s, chunk, n_splits, vec, qunit, floor_v, floor_i, part,
        thresh, tickets, qn2, out_v, out_i);
  }
  return cudaGetLastError();
}

template <typename T, int SMAX, bool NORMS>
int launch_t(const float* q, int m, int d, const T* x, const float* xn2, const float* scale,
             const int* rows, int n, int s, int chunk, int n_splits, const float* floor_v,
             const int* floor_i, void* scratch, float* qn2, float* out_v, int* out_i,
             cudaStream_t stream) {
  auto* part = static_cast<unsigned long long*>(scratch);
  unsigned long long* thresh = part + (size_t)m * n_splits * s;
  int* tickets = reinterpret_cast<int*>(thresh + m);
  // thresholds to all ones (no key), tickets to -1: every byte 0xff (a
  // ticket for each BM queries, enough for blocks of BM_WIDE too)
  cudaError_t err =
      cudaMemsetAsync(thresh, 0xff, 8 * (size_t)m + 4 * (size_t)((m + BM - 1) / BM), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = copy_unit(x, (size_t)d * sizeof(T));
#define COCONUT_LAUNCH(V16, BQ)                                                             \
  return static_cast<int>(launch_kernel<T, SMAX, V16, BQ, NORMS>(                          \
      n_splits, stream, q, m, d, x, xn2, scale, rows, n, s, chunk, vec, floor_v, floor_i,  \
      part, thresh, tickets, qn2, out_v, out_i))
  // an f32 table's products are bound by shared-memory loads at BM queries
  // a block: wider blocks (4 x 4 register tiles) where the batch fills them
  // (and the rows come in 16-byte units, the engine's case)
  if constexpr (sizeof(T) == 4) {
    if (m > BM && vec == 16) COCONUT_LAUNCH(true, BM_WIDE);
  }
  if (vec == 16) COCONUT_LAUNCH(true, BM);
  COCONUT_LAUNCH(false, BM);
#undef COCONUT_LAUNCH
}

template <typename T, bool NORMS = false>
int launch(const void* q, int m, int d, const void* x, const void* scale, const void* xn2,
           const void* rows, int n, int s, int chunk, int n_splits, const void* floor_v,
           const void* floor_i, void* scratch, void* qn2, void* out_v, void* out_i,
           void* stream) {
#define COCONUT_LAUNCH(SMAX)                                                               \
  return launch_t<T, SMAX, NORMS>(                                                         \
      static_cast<const float*>(q), m, d, static_cast<const T*>(x),                        \
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

// The launch of min_ed's kernel over query blocks of BQ: the grid of the
// slate kernels, shared memory with no slate.
template <bool V16, int BQ>
cudaError_t launch_min(const float* q, int m, int d, const float* x, int n, int chunk,
                       int n_splits, int vec, unsigned long long* best, cudaStream_t stream) {
  int qunit;
  const int smem = query_staging<float, BQ>(0, q, d, &qunit);
  const dim3 grid((m + BQ - 1) / BQ, n_splits);
  const cudaError_t err = cudaFuncSetAttribute(
      min_ed_kernel<V16, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  min_ed_kernel<V16, BQ><<<grid, NTHREADS, smem, stream>>>(q, m, d, x, n, chunk, n_splits, vec,
                                                           qunit, best);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The layout the host wrapper plans launches of the three screens, of
// topk_ed and of min_ed by:
// out[0] the most slate entries one pass holds, out[1] queries per block
// (the narrower block; the scratch's tickets count by it), out[2]
// candidates per tile.
void coconut_screen_layout(int* out) {
  out[0] = PASS_SLATE;
  out[1] = BM;
  out[2] = TN;
}

// All three take: floor_v/floor_i may be null (no floor), scratch holds 8
// (m n_splits s + m) + 4 ceil(m / 16) bytes, out_v/out_i (m, s), qn2 (m,)
// (|q|^2 as a by-product). The screens' rows may be null (candidates are
// the table rows 0..n-1). They return the CUDA error code of the memset
// and the launch.

// f32 (dtype 0) or bf16 (dtype 1) table x (N, d).
int coconut_screen_select(int dtype, const void* q, int m, int d, const void* x,
                          const void* xn2, const void* rows, int n, int s, int chunk,
                          int n_splits, const void* floor_v, const void* floor_i,
                          void* scratch, void* qn2, void* out_v, void* out_i, void* stream) {
  if (dtype == 0)
    return launch<float>(q, m, d, x, nullptr, xn2, rows, n, s, chunk, n_splits, floor_v,
                         floor_i, scratch, qn2, out_v, out_i, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, m, d, x, nullptr, xn2, rows, n, s, chunk, n_splits,
                                 floor_v, floor_i, scratch, qn2, out_v, out_i, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 table x (N, d) with per-row f32 scales applied to the contraction.
int coconut_screen_select_quant(const void* q, int m, int d, const void* x, const void* scale,
                                const void* xn2, const void* rows, int n, int s, int chunk,
                                int n_splits, const void* floor_v, const void* floor_i,
                                void* scratch, void* qn2, void* out_v, void* out_i,
                                void* stream) {
  return launch<int8_t>(q, m, d, x, scale, xn2, rows, n, s, chunk, n_splits, floor_v, floor_i,
                        scratch, qn2, out_v, out_i, stream);
}

// topk_ed: f32 candidates x (n, d) taken in order, |x|^2 summed in the tile.
int coconut_topk_ed(const void* q, int m, int d, const void* x, int n, int s, int chunk,
                    int n_splits, const void* floor_v, const void* floor_i, void* scratch,
                    void* qn2, void* out_v, void* out_i, void* stream) {
  return launch<float, true>(q, m, d, x, nullptr, nullptr, nullptr, n, s, chunk, n_splits,
                             floor_v, floor_i, scratch, qn2, out_v, out_i, stream);
}

// min_ed: per query the lexicographic (d2, row) minimum over x (n, d) f32,
// n >= 1, m >= 1, with the splits planned as topk_ed's at s = 1. best (m,)
// uint64 is scratch; out_v (m,) f32, out_i (m,) int32. A memset, the scan
// and an m-thread unpack on one stream.
int coconut_min_ed(const void* q, int m, int d, const void* x, int n, int chunk, int n_splits,
                   void* best, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned long long*>(best);
  cudaError_t err = cudaMemsetAsync(b, 0xff, sizeof(unsigned long long) * (size_t)m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(x);
  const int vec = copy_unit(x, (size_t)d * sizeof(float));
  // the screens' blocks: 32 queries where the batch fills them and the rows
  // come in 16-byte units
  if (m > BM && vec == 16)
    err = launch_min<true, BM_WIDE>(qf, m, d, xf, n, chunk, n_splits, vec, b, st);
  else if (vec == 16)
    err = launch_min<true, BM>(qf, m, d, xf, n, chunk, n_splits, vec, b, st);
  else
    err = launch_min<false, BM>(qf, m, d, xf, n, chunk, n_splits, vec, b, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  min_ed_unpack_kernel<<<(m + 255) / 256, 256, 0, st>>>(b, m, static_cast<float*>(out_v),
                                                        static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
