// The bicubic upsample's 4-tap pass for Hopper (sm_90a): one axis of
// terrain/upsample.py::upsample_bicubic, out[r, c] = the sum over the four
// taps f of kw[r, f] * img[idx[r, f], c], in one launch.
//
// Not a port of a TPU kernel: the JAX package has no Pallas kernel here.
// Its counterpart is the dot of its jitted upsample_bicubic
// (husky_rover_mppi_isaacsim_tpu/terrain/upsample.py:36-58, the einsum
// "nf,nfw->nw"), which XLA's CPU backend emits as a column-major GEMV per
// output row: the output's columns in 8-wide tiles, each a chain of fused
// multiply-adds from zero over the four taps in order; the columns left
// over by a chain from the first product (two or more) or, where one
// column is left, by plain products and sums.
//
// Bit-equality: with the plain version (upsample.py::_tap_sum, elementwise
// torch operations with each fused multiply-add formed exactly), and so
// with the JAX package: the same operations in the same order, each an _rn
// intrinsic (__fmaf_rn where the CPU code fuses). Built with -fmad=false.
//
// Design: one thread an output element, grid-stride, each thread reading
// its row's four weights and four row indices (one 16-byte load each) and
// the four taps of its column; consecutive threads take consecutive
// columns, so the tap rows and the output are read and written coalesced.
// Bound by bytes: the output is written once (13 MB for a 1800^2 block);
// the taps come from a few rows that stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void upsample_taps_kernel(const float* __restrict__ img, int m,
                                     const float4* __restrict__ kw,
                                     const int4* __restrict__ idx, long long total,
                                     float* __restrict__ out) {
  const int fused = 8 * (m / 8);        // the GEMV's 8-wide tiles
  const bool single_tail = m - fused == 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long r = e / m;
    const int c = static_cast<int>(e - r * m);
    const float4 w = kw[r];
    const int4 ix = idx[r];
    const float t0 = __ldg(img + static_cast<long long>(ix.x) * m + c);
    const float t1 = __ldg(img + static_cast<long long>(ix.y) * m + c);
    const float t2 = __ldg(img + static_cast<long long>(ix.z) * m + c);
    const float t3 = __ldg(img + static_cast<long long>(ix.w) * m + c);
    float acc;
    if (c < fused) {
      acc = __fmaf_rn(w.x, t0, 0.0f);
      acc = __fmaf_rn(w.y, t1, acc);
      acc = __fmaf_rn(w.z, t2, acc);
      acc = __fmaf_rn(w.w, t3, acc);
    } else if (single_tail) {
      acc = __fmul_rn(w.x, t0);
      acc = __fadd_rn(acc, __fmul_rn(w.y, t1));
      acc = __fadd_rn(acc, __fmul_rn(w.z, t2));
      acc = __fadd_rn(acc, __fmul_rn(w.w, t3));
    } else {
      acc = __fmul_rn(w.x, t0);
      acc = __fmaf_rn(w.y, t1, acc);
      acc = __fmaf_rn(w.z, t2, acc);
      acc = __fmaf_rn(w.w, t3, acc);
    }
    out[e] = acc;
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. Device pointers to contiguous data:
// img (n, m) float32; kw (rows, 4) float32 and idx (rows, 4) int32 (row
// indices into img), each 16-byte aligned; out (rows, m) float32. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int upsample_taps_f32(const float* img, int m, const float* kw, const int* idx,
                                 int rows, float* out, void* stream) {
  const long long total = static_cast<long long>(rows) * m;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  upsample_taps_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, m, reinterpret_cast<const float4*>(kw), reinterpret_cast<const int4*>(idx), total,
      out);
  return (int)cudaGetLastError();
}
