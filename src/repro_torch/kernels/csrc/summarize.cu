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
//                    breakpoints <= the value, found by binary search over the
//                    sorted breakpoints, held in shared memory) and key words
//                    (B, n_words) written as 32-bit values into an int32
//                    tensor: key bit pos = b w + s (b counted from the MSB of
//                    the symbol, s the segment) is bit 31 - pos % 32 of word
//                    pos / 32, so the words compare as big-endian uint32.
//
// What bounds them on the H100: device memory. PAA reads 4 n bytes and writes
// 4 w bytes a row (a few flops per byte); SAX-pack reads 4 w bytes and writes
// 4 w + 4 n_words. At the 1,024,000 x 256 seismic set that is ~1 GB for PAA,
// ~0.3 ms at 3.35 TB/s.
//
// Design. The TPU kernel reduces a (block_b, n) VMEM tile with a reshape-mean.
// Here a block stages R whole rows in shared memory with coalesced loads
// (neighbouring threads on neighbouring addresses), each segment padded by one
// float so the threads that then sum one segment each hit distinct banks; one
// thread per (row, segment) sums its segment. A series whose padded row does
// not fit the block's shared memory (n over about 12,000 values) is summed
// from device memory instead, one thread per (row, segment) in the same
// order, so any length gives the same bits. SAX-pack is one thread per row:
// a symbol per segment, its bits or-ed into the row's words, which stay in
// registers (an unrolled select over at most MAX_WORDS words).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAA_THREADS = 256;
constexpr int PAA_MAX_ROWS = 32;            // rows a block stages at most
constexpr int PAA_SMEM_FLOATS = 48 * 1024 / 4;  // staged floats a block holds at most
constexpr int SAX_THREADS = 256;
constexpr int MAX_BREAKPOINTS = 255;        // 2^8 - 1: card_bits <= 8
constexpr int MAX_WORDS = 8;                // w * card_bits <= 256 key bits

// STAGED: rows_per_block rows a block, staged in shared memory; else one
// thread per (row, segment) over the whole batch, reading device memory.
template <bool STAGED>
__global__ void __launch_bounds__(PAA_THREADS)
paa_kernel(const float* __restrict__ x, int b, int n, int w, int rows_per_block,
           float* __restrict__ out) {
  const int L = n / w;
  if constexpr (!STAGED) {
    const size_t e = (size_t)blockIdx.x * PAA_THREADS + threadIdx.x;
    if (e >= (size_t)b * w) return;
    const float* seg = x + e * L;  // segment e % w of row e / w
    float acc = seg[0];
    for (int j = 1; j < L; ++j) acc = __fadd_rn(acc, seg[j]);
    out[e] = __fdiv_rn(acc, static_cast<float>(L));
    return;
  }
  extern __shared__ float tile[];  // rows_per_block * w * (L + 1)
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, b - row0);
  const float* src = x + (size_t)row0 * n;
  for (int e = threadIdx.x; e < nrows * n; e += PAA_THREADS) {
    const int r = e / n, c = e - r * n;
    const int s = c / L, j = c - s * L;
    tile[(r * w + s) * (L + 1) + j] = src[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * w; e += PAA_THREADS) {
    const float* seg = tile + e * (L + 1);
    float acc = seg[0];
    for (int j = 1; j < L; ++j) acc = __fadd_rn(acc, seg[j]);
    out[(size_t)row0 * w + e] = __fdiv_rn(acc, static_cast<float>(L));
  }
}

__global__ void __launch_bounds__(SAX_THREADS)
sax_pack_kernel(const float* __restrict__ p, int b, int w, const float* __restrict__ bps,
                int n_bps, int card_bits, int n_words, int* __restrict__ sym,
                int* __restrict__ keys) {
  __shared__ float sb[MAX_BREAKPOINTS];
  for (int i = threadIdx.x; i < n_bps; i += SAX_THREADS) sb[i] = bps[i];
  __syncthreads();
  const int row = blockIdx.x * SAX_THREADS + threadIdx.x;
  if (row >= b) return;
  unsigned words[MAX_WORDS];
#pragma unroll
  for (int t = 0; t < MAX_WORDS; ++t) words[t] = 0u;
  for (int s = 0; s < w; ++s) {
    const float v = p[(size_t)row * w + s];
    int lo = 0, hi = n_bps;  // first breakpoint > v = count of those <= v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sb[mid] <= v) lo = mid + 1;
      else hi = mid;
    }
    sym[(size_t)row * w + s] = lo;
    for (int bit = 0; bit < card_bits; ++bit) {
      const int pos = bit * w + s;
      const unsigned val = static_cast<unsigned>((lo >> (card_bits - 1 - bit)) & 1)
                           << (31 - (pos & 31));
#pragma unroll
      for (int t = 0; t < MAX_WORDS; ++t)
        if (t == (pos >> 5)) words[t] |= val;
    }
  }
#pragma unroll
  for (int t = 0; t < MAX_WORDS; ++t)
    if (t < n_words) keys[(size_t)row * n_words + t] = static_cast<int>(words[t]);
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
  if (b <= 0 || w <= 0 || n % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_floats = w * (n / w + 1);
  if (row_floats > PAA_SMEM_FLOATS) {  // too long to stage: from device memory
    const size_t grid = ((size_t)b * w + PAA_THREADS - 1) / PAA_THREADS;
    paa_kernel<false><<<static_cast<unsigned>(grid), PAA_THREADS, 0, st>>>(xf, b, n, w, 0, of);
    return static_cast<int>(cudaGetLastError());
  }
  const int rows = min(PAA_MAX_ROWS, PAA_SMEM_FLOATS / row_floats);
  const int grid = (b + rows - 1) / rows;
  paa_kernel<true><<<grid, PAA_THREADS, rows * row_floats * sizeof(float), st>>>(
      xf, b, n, w, rows, of);
  return static_cast<int>(cudaGetLastError());
}

// p (b, w) f32, bps (n_bps,) sorted f32 -> sym (b, w) int32, keys (b, n_words)
// int32 holding the uint32 words.
int coconut_sax_pack(const void* p, int b, int w, const void* bps, int n_bps, int card_bits,
                     int n_words, void* sym, void* keys, void* stream) {
  if (b <= 0 || n_bps > MAX_BREAKPOINTS || n_words > MAX_WORDS ||
      card_bits * w > 32 * n_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (b + SAX_THREADS - 1) / SAX_THREADS;
  sax_pack_kernel<<<grid, SAX_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), b, w, static_cast<const float*>(bps), n_bps, card_bits,
      n_words, static_cast<int*>(sym), static_cast<int*>(keys));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
