// The MINDIST_PAA_SAX lower bound of exact search, by hand for Hopper.
//
// Replaces the Pallas kernel mindist_pallas of src/repro/kernels/lb_kernel.py
// (body _lb_body): for one query PAA q (w,) and B candidate regions lo/hi
// (B, w), the squared lower bound
//
//     lb[b] = seg_len * sum_s max(lo[b, s] - q[s], q[s] - hi[b, s], 0)^2.
//
// The segments are summed left to right, each square and each sum rounded
// on its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract them into
// an FMA), so the result is bitwise that of the plain version
// (kernels/ref.py: mindist_ref), which adds in the same order.
//
// What bounds it on the H100: 8 w bytes read and 4 written per region for
// 4 w flops, far below the card's flops per byte, so the 3.35 TB/s of
// device memory (B = 1,024,000 regions of w = 16: 135 MB, ~40 us).
//
// Design: one thread a region, lo and hi read as float4 where a row is a
// whole number of 16-byte words (the wrapper says so: w % 4 == 0 and both
// bases aligned), else one float at a time. The query is the same for every
// thread and stays in the cache.
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float add_segment(float acc, float q, float lo, float hi) {
  const float d = fmaxf(fmaxf(__fsub_rn(lo, q), 0.f), fmaxf(__fsub_rn(q, hi), 0.f));
  return __fadd_rn(acc, __fmul_rn(d, d));
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
mindist_kernel(const float* __restrict__ q, const float* __restrict__ lo,
               const float* __restrict__ hi, int b, int w, float seg_len,
               float* __restrict__ out) {
  const int row = blockIdx.x * NTHREADS + threadIdx.x;
  if (row >= b) return;
  const float* l = lo + (size_t)row * w;
  const float* h = hi + (size_t)row * w;
  float acc = 0.f;
  if (VEC) {
    const float4* l4 = reinterpret_cast<const float4*>(l);
    const float4* h4 = reinterpret_cast<const float4*>(h);
    for (int s = 0; s < w / 4; ++s) {
      const float4 a = l4[s];
      const float4 c = h4[s];
      acc = add_segment(acc, __ldg(q + 4 * s), a.x, c.x);
      acc = add_segment(acc, __ldg(q + 4 * s + 1), a.y, c.y);
      acc = add_segment(acc, __ldg(q + 4 * s + 2), a.z, c.z);
      acc = add_segment(acc, __ldg(q + 4 * s + 3), a.w, c.w);
    }
  } else {
    for (int s = 0; s < w; ++s) acc = add_segment(acc, __ldg(q + s), l[s], h[s]);
  }
  out[row] = __fmul_rn(seg_len, acc);
}

}  // namespace

extern "C" {

// q (w,), lo/hi (b, w) f32 contiguous, out (b,) f32; vec != 0 when w % 4 ==
// 0 and lo and hi are 16-byte aligned. Returns the CUDA error of the launch.
int coconut_mindist(const void* q, const void* lo, const void* hi, int b, int w,
                    float seg_len, int vec, void* out, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* l = static_cast<const float*>(lo);
  const float* h = static_cast<const float*>(hi);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (b + NTHREADS - 1) / NTHREADS;
  if (vec)
    mindist_kernel<true><<<blocks, NTHREADS, 0, st>>>(qf, l, h, b, w, seg_len, o);
  else
    mindist_kernel<false><<<blocks, NTHREADS, 0, st>>>(qf, l, h, b, w, seg_len, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
