// The summarize front of the query-key path, by hand for Hopper: PAA segment
// means, then SAX symbols and their bit-interleaved sortable key words.
//
// Replaces the Pallas kernels paa_pallas (src/repro/kernels/paa_kernel.py) and
// sax_pack_pallas (src/repro/kernels/sax_pack_kernel.py).
//
//   paa_kernel       x (B, n) f32 -> (B, w) f32. Segment s of row b is the mean
//                    of x[b, s L .. s L + L - 1], L = n / w, summed left to
//                    right with IEEE adds and divided by L (the plain version,
//                    kernels/ref.py paa_ref, adds in the same order, so the two
//                    agree bit for bit and so do the symbols they give).
//   sax_pack_kernel  p (B, w) f32 -> symbols (B, w) int32 (the count of
//                    breakpoints <= the value) and key words (B, n_words)
//                    int64, each the zero-extended uint32 word: key bit
//                    pos = b w + s (b counted from the MSB of the symbol, s
//                    the segment) is bit 31 - pos % 32 of word pos / 32, so
//                    the words compare as big-endian uint32.
//
// What bounds them on the H100: device memory. PAA reads 4 n bytes and writes
// 4 w bytes a row (a few flops per byte); SAX-pack reads 4 w bytes and writes
// 4 w + 8 n_words. At the 1,024,000 x 256 seismic set that is ~1 GB for PAA,
// ~0.3 ms at 3.35 TB/s, and 164 MB for SAX-pack at w = 16, c = 8, ~0.05 ms.
//
// Design of PAA. The TPU kernel reduces a (block_b, n) VMEM tile with a
// reshape-mean. Here nothing is staged: one thread owns one (row, segment)
// pair e = row w + segment at a time, and since a row's segments lie end to
// end, pair e's values are x[e L .. e L + L - 1], one contiguous run. The
// thread issues PAA_VEC_LOADS 16-byte loads through the read-only path (or
// PAA_SCALAR_LOADS 4-byte ones where L % 4 != 0 or x is not 16-byte aligned)
// before its first add, then adds them in order, so a segment of L = 16 is
// one round trip to device memory. The sum starts from -0.0, the identity of
// IEEE addition, so the first add gives x[e L] exactly: the order and the
// bits are paa_ref's. Longer segments loop over such chunks. The loads of a
// warp are not coalesced one instruction at a time (lane i reads 16 bytes
// of the run 4 L bytes from lane i - 1), but its PAA_VEC_LOADS instructions
// read whole sectors between them, so every byte fetched from device memory
// is used and the reuse is served by L1. Blocks of PAA_THREADS pairs, at
// most PAA_BLOCKS_PER_SM of them an SM, walk the pairs with a grid stride:
// 16 rows of 16 segments spread over 4 SMs, and 1,024,000 rows keep every
// SM at 1,024 threads, each with up to 64 bytes in flight (the card needs
// ~25 KB an SM in flight to run at its memory rate). What bounds it is
// device memory: the stores (4 bytes a pair) and loads are each touched once.
//
// SAX-pack is one thread per (row, segment), so the loads of p and the stores
// of symbols are coalesced, and persistent blocks (SAX_BLOCKS_PER_SM an SM)
// walk tiles of SAX_SUBTILES such elements a thread, loading the next tile's
// while they work on this one. The TPU kernel's compare-and-count becomes a
// fixed-step search down the breakpoints, staged in shared memory in
// breadth-first order (a level's nodes side by side, so the first six levels
// read without bank conflicts) and padded with NaN, which compares false with
// every value: C steps, no data-dependent loop, the same count for NaN (0) and
// +-inf. Step L of the search is bit L (from the MSB) of the symbol, so one
// warp vote (__ballot_sync) of its outcome is the warp's bit plane L; lane 0
// keeps the planes in shared memory. The words are then built without a serial
// chain: after one barrier each thread builds whole words of the tile, ORing
// the pieces of the planes that fall into the word (a plane holds w bits of
// each of the 32 / w rows in the warp, or 32 bits of a row's slice when w >
// 32; bit-reversed, they are in key order), and writes them as int64: the
// tile's words are one contiguous run. What holds it back on the H100 is
// instruction issue, not bytes: every 32 elements take C levels of a dependent
// shared load, a vote and a few ALU operations.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAA_THREADS = 64;             // (row, segment) pairs a block at a time
constexpr int PAA_BLOCKS_PER_SM = 16;       // resident blocks an SM: the grid's cap
constexpr int PAA_VEC_LOADS = 4;            // 16-byte loads in flight a thread
constexpr int PAA_SCALAR_LOADS = 16;        // 4-byte loads in flight a thread
constexpr int SAX_THREADS = 256;            // (row, segment) elements a sub-tile
constexpr int SAX_SUBTILES = 4;             // sub-tiles a tile: loads in flight a thread
constexpr int SAX_BLOCKS_PER_SM = 4;        // resident blocks an SM at 64 registers
constexpr int MAX_BREAKPOINTS = 255;        // 2^8 - 1: card_bits <= 8
constexpr int MAX_WORDS = 8;                // w * card_bits <= 256 key bits
static_assert(SAX_THREADS > MAX_BREAKPOINTS, "one breakpoint a thread is staged");

// One thread a (row, segment) pair at a time, pairs e = blockIdx.x
// PAA_THREADS + threadIdx.x, + gridDim.x PAA_THREADS, ...; pair e's values
// are x[e L .. e L + L - 1]. vec: L % 4 == 0 and x 16-byte aligned, so every
// pair's run starts on a 16-byte boundary and is read as float4s.
__global__ void __launch_bounds__(PAA_THREADS, PAA_BLOCKS_PER_SM)
paa_kernel(const float* __restrict__ x, long long pairs, int L, bool vec,
           float* __restrict__ out) {
  const float len = static_cast<float>(L);
  const long long stride = (long long)gridDim.x * PAA_THREADS;
  for (long long e = (long long)blockIdx.x * PAA_THREADS + threadIdx.x; e < pairs;
       e += stride) {
    float acc = -0.0f;  // -0.0 + v == v for every v: the first add is exact
    if (vec) {
      const float4* seg = reinterpret_cast<const float4*>(x + e * L);
      const int n4 = L >> 2;
      for (int c = 0; c < n4; c += PAA_VEC_LOADS) {
        float4 v[PAA_VEC_LOADS];
#pragma unroll
        for (int k = 0; k < PAA_VEC_LOADS; ++k)
          if (c + k < n4) v[k] = __ldg(seg + c + k);
#pragma unroll
        for (int k = 0; k < PAA_VEC_LOADS; ++k) {
          if (c + k < n4) {
            acc = __fadd_rn(acc, v[k].x);
            acc = __fadd_rn(acc, v[k].y);
            acc = __fadd_rn(acc, v[k].z);
            acc = __fadd_rn(acc, v[k].w);
          }
        }
      }
    } else {
      const float* seg = x + e * L;
      for (int c = 0; c < L; c += PAA_SCALAR_LOADS) {
        float v[PAA_SCALAR_LOADS];
#pragma unroll
        for (int k = 0; k < PAA_SCALAR_LOADS; ++k)
          if (c + k < L) v[k] = __ldg(seg + c + k);
#pragma unroll
        for (int k = 0; k < PAA_SCALAR_LOADS; ++k)
          if (c + k < L) acc = __fadd_rn(acc, v[k]);
      }
    }
    out[e] = __fdiv_rn(acc, len);
  }
}

// A tile: SAX_SUBTILES sub-tiles of SAX_THREADS (row, segment) elements. A
// sub-tile packs 32 / w whole rows into each warp (w <= 32), or gives each
// row ceil(w / 32) warps, one 32-segment slice each (w > 32); rows_per_sub
// is its row count. A block walks tiles blockIdx.x, + gridDim.x, ..., and
// loads the next tile's values while it works on this one. Every lane runs
// to each warp vote (no early exit), so the full mask names exactly the
// lanes that reach it; a lane past the batch or the row holds a NaN and
// votes 0. C is the symbol's bit count.
template <int C>
__global__ void __launch_bounds__(SAX_THREADS)
sax_pack_kernel(const float* __restrict__ p, int b, int w, const float* __restrict__ bps,
                int n_bps, int n_words, int rows_per_sub, int* __restrict__ sym,
                long long* __restrict__ keys) {
  constexpr int NODES = (1 << C) - 1;
  constexpr int WARPS = SAX_THREADS / 32;
  __shared__ float sb[NODES];  // breakpoints in breadth-first order, NaN past n_bps
  // bit planes, two tiles' worth: [tile % 2][sub-tile][warp][b]; bit l of
  // plane b is bit b (from the MSB) of lane l's symbol
  __shared__ __align__(16) unsigned planes[2][SAX_SUBTILES * WARPS][8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_per_block = SAX_SUBTILES * rows_per_sub;
  const int n_tiles = (b + rows_per_block - 1) / rows_per_block;
  const int per_warp = w <= 32 ? 32 / w : 1;            // rows a warp
  const int warps_per_row = w <= 32 ? 1 : (w + 31) >> 5;  // warps a row
  const float nan = __int_as_float(0x7fc00000);
  // this thread's (row in the sub-tile, segment), the same in every sub-tile
  int r, seg;
  bool mine;
  if (w <= 32) {
    const int q = lane / w;
    r = warp * per_warp + q;
    seg = lane - q * w;
    mine = q < per_warp;
  } else {
    r = warp / warps_per_row;
    seg = (warp - r * warps_per_row) * 32 + lane;
    mine = r < rows_per_sub && seg < w;
  }
  const int elem = r * w + seg;           // in the tile, sub-tile 0
  const int sub_elems = rows_per_sub * w;
  // This thread's words of a tile (the same in every tile): word i = tid +
  // m SAX_THREADS of the tile's run, word t of row rb. The key stream is cut
  // into pieces: bit plane b of slice j (j = 0 when w <= 32) covers key bits
  // [b w + 32 j, + width); its bits are the plane's width bits from the
  // row's first lane on, reversed to MSB first. Per word, packed: the first
  // piece's plane (10 bits), the row's first lane (5), where the piece
  // starts against the word, + 32 (6), its slice (3) and the count of
  // pieces (6).
  int task[SAX_SUBTILES];
#pragma unroll
  for (int m = 0; m < SAX_SUBTILES; ++m) {
    const int i = tid + m * SAX_THREADS;
    task[m] = 0;
    if (i >= rows_per_block * n_words) continue;
    const int rb = i / n_words, t = i - rb * n_words;
    int slot, lane0;
    if (w <= 32) {
      slot = rb / per_warp;
      lane0 = (rb - slot * per_warp) * w;
    } else {
      const int k = rb / rows_per_sub;
      slot = k * WARPS + (rb - k * rows_per_sub) * warps_per_row;
      lane0 = 0;
    }
    const int first = 32 * t, end = min(first + 32, C * w);
    const int bit = first / w, j = (first - bit * w) >> 5;
    int pieces = 0;
    for (int at = bit * w + 32 * j, jj = j; at < end; ++pieces) {
      at += min(32, w - 32 * jj);
      jj = jj + 1 == warps_per_row ? 0 : jj + 1;
    }
    task[m] = (((slot + j) * 8 + bit) & 0x3FF) | lane0 << 10 |
              (bit * w + 32 * j - first + 32) << 15 | j << 21 | pieces << 24;
  }
  float v[SAX_SUBTILES];
  {
    const size_t base = (size_t)blockIdx.x * rows_per_block * w + elem;
#pragma unroll
    for (int k = 0; k < SAX_SUBTILES; ++k) {
      const int row = blockIdx.x * rows_per_block + k * rows_per_sub + r;
      v[k] = (mine && row < b) ? p[base + k * sub_elems] : nan;
    }
  }
  // node i of level L (i + 1 = 2^L + pos) is sorted breakpoint (2 pos + 1) 2^(C-1-L) - 1
  if (tid < NODES) {
    const int level = 31 - __clz(tid + 1), pos = tid + 1 - (1 << level);
    const int s = ((2 * pos + 1) << (C - 1 - level)) - 1;
    sb[tid] = s < n_bps ? bps[s] : nan;
  }
  __syncthreads();
  for (int tile = blockIdx.x, buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int row0 = tile * rows_per_block;
    float x[SAX_SUBTILES];
    {
      const size_t base = (size_t)(row0 + gridDim.x * rows_per_block) * w + elem;
#pragma unroll
      for (int k = 0; k < SAX_SUBTILES; ++k) {
        x[k] = v[k];
        const int row = row0 + gridDim.x * rows_per_block + k * rows_per_sub + r;
        v[k] = (mine && row < b) ? p[base + k * sub_elems] : nan;  // the next tile's
      }
    }
    // a fixed-step search down the tree: right where the breakpoint is <=
    // x. Level L's step is bit L (from the MSB) of the count of breakpoints
    // <= x, so its warp vote is bit plane L. NaN compares false: NaN gives 0
    // and the padding never counts. Level L reads 2^L neighbouring words: no
    // bank conflicts up to L = 5.
#pragma unroll
    for (int k = 0; k < SAX_SUBTILES; ++k) {
      if (row0 + k * rows_per_sub >= b) break;  // the same for the whole block
      unsigned pl[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      int node = 0;
#pragma unroll
      for (int level = 0; level < C; ++level) {
        const bool right = sb[node] <= x[k];
        pl[level] = __ballot_sync(0xFFFFFFFFu, right);
        node = 2 * node + (right ? 2 : 1);
      }
      const int row = row0 + k * rows_per_sub + r;
      if (mine && row < b) sym[(size_t)row0 * w + elem + k * sub_elems] = node - NODES;
      if (lane == 0) {
        uint4* dst = reinterpret_cast<uint4*>(planes[buf][k * WARPS + warp]);
        dst[0] = make_uint4(pl[0], pl[1], pl[2], pl[3]);
        if (C > 4) dst[1] = make_uint4(pl[4], pl[5], pl[6], pl[7]);
      }
    }
    // one barrier a tile: the other buffer was last read before it
    __syncthreads();
    // one thread a word; the tile's words are one contiguous run of int64s
    const int n_out = min(rows_per_block, b - row0) * n_words;
    long long* out = keys + (size_t)row0 * n_words + tid;
#pragma unroll
    for (int m = 0; m < SAX_SUBTILES; ++m) {
      if (tid + m * SAX_THREADS >= n_out) break;
      const unsigned* pl = planes[buf][0];
      int plane = task[m] & 0x3FF, at = ((task[m] >> 15) & 0x3F) - 32, j = (task[m] >> 21) & 7;
      const int lane0 = (task[m] >> 10) & 0x1F, pieces = (task[m] >> 24) & 0x3F;
      unsigned word = 0u;
      for (int piece = 0; piece < pieces; ++piece) {
        const int width = min(32, w - 32 * j);
        const unsigned bits = __brev(pl[plane] >> lane0) & (~0u << (32 - width));
        word |= at >= 0 ? bits >> at : bits << -at;
        at += width;
        if (++j == warps_per_row) {
          j = 0;
          plane += 1 - 8 * (warps_per_row - 1);
        } else {
          plane += 8;
        }
      }
      out[m * SAX_THREADS] = static_cast<long long>(word);
    }
  }
}

}  // namespace

extern "C" {

// The limits the host wrapper checks before a sax_pack launch: out[0] the
// most key words, out[1] the most breakpoints.
void coconut_summarize_layout(int* out) {
  out[0] = MAX_WORDS;
  out[1] = MAX_BREAKPOINTS;
}

// x (b, n) f32 -> out (b, w) f32. Returns the CUDA error code of the launch.
int coconut_paa(const void* x, int b, int n, int w, void* out, void* stream) {
  if (b <= 0 || w <= 0 || n <= 0 || n % w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = n / w;
  const long long pairs = (long long)b * w;
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (pairs + PAA_THREADS - 1) / PAA_THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 1) * PAA_BLOCKS_PER_SM;
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  paa_kernel<<<grid, PAA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), pairs, L, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// p (b, w) f32, bps (n_bps,) sorted f32 -> sym (b, w) int32, keys (b, n_words)
// int64 holding the uint32 words.
int coconut_sax_pack(const void* p, int b, int w, const void* bps, int n_bps, int card_bits,
                     int n_words, void* sym, void* keys, void* stream) {
  if (b <= 0 || w <= 0 || card_bits < 1 || card_bits > 8 || n_bps > (1 << card_bits) - 1 ||
      n_words > MAX_WORDS || card_bits * w > 32 * n_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_sub = w <= 32 ? (SAX_THREADS / 32) * (32 / w)
                                   : (SAX_THREADS / 32) / ((w + 31) / 32);
  const int n_tiles = (b + SAX_SUBTILES * rows_per_sub - 1) / (SAX_SUBTILES * rows_per_sub);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = min(n_tiles, max(1, sms) * SAX_BLOCKS_PER_SM);
  const auto* pf = static_cast<const float*>(p);
  const auto* bf = static_cast<const float*>(bps);
  auto* si = static_cast<int*>(sym);
  auto* ki = static_cast<long long*>(keys);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (card_bits) {
#define SAX_CASE(C)                                                                     \
  case C:                                                                               \
    sax_pack_kernel<C><<<grid, SAX_THREADS, 0, st>>>(pf, b, w, bf, n_bps, n_words,      \
                                                     rows_per_sub, si, ki);             \
    break;
    SAX_CASE(1) SAX_CASE(2) SAX_CASE(3) SAX_CASE(4)
    SAX_CASE(5) SAX_CASE(6) SAX_CASE(7) SAX_CASE(8)
#undef SAX_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
