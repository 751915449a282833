// The bicubic upsample of one streamed block for Hopper (sm_90a): both axis
// passes of terrain/upsample.py::upsample_bicubic in one launch, for the
// output crop [r0, r0 + rows) x [c0, c0 + cols) alone, written row-major in
// the final orientation (upsample.py::upsample_block).
//
// Not a port of a TPU kernel: the JAX package has no Pallas kernel here.
// Its counterpart is the two dots of its jitted upsample_bicubic
// (husky_rover_mppi_isaacsim_tpu/terrain/upsample.py:36-58, the einsum
// "nf,nfw->nw" on each axis), which XLA's CPU backend emits as a
// column-major GEMV per output row: the output's columns in 8-wide tiles,
// each a chain of fused multiply-adds from zero over the four taps in
// order; the columns left over by a chain from the first product (two or
// more) or, where one column is left, by plain products and sums.
//   pass 1: hr[h, c] = sum_f kw_r[h, f] * lr[idx_r[h, f], c], its columns c
//           of the LR patch (width n_c) in that order;
//   pass 2: out[h, w] = sum_f kw_c[w, f] * hr[h, idx_c[w, f]], a GEMV whose
//           columns are the HR rows h (width m2 = n_r * factor).
// Which rule an element takes follows its column in the full pass (c, or
// h), never its place in the crop.
//
// Bit-equality: with the plain version (upsample.py::upsample_block_plain,
// the two passes of _tap_sum then the slice), and so with the JAX package:
// the same operations in the same order, each an _rn intrinsic
// (__fmaf_rn where the CPU code fuses). Built with -fmad=false.
//
// Design: a 2D grid of 32-row x 128-column output tiles, 256 threads a
// tile. The tile first computes the pass-1 values of its rows over the LR
// columns its output columns read (idx_c is nondecreasing in w, so that is
// one span of at most 131 columns; 6 at the streamed factor 200) into
// shared memory. Then each thread holds the pass-2 weights and indices of
// four adjacent output columns in registers and walks the tile's rows
// (a warp a row), writing its four columns with one float4 store where the
// row is 16-byte aligned. No integer division; the output is written once
// (4 MB for a streamed block's kept 1000^2 base), which bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsY = 8;
constexpr int kThreads = 32 * kWarpsY;
constexpr int kColsPerThread = 4;
constexpr int kTileCols = 32 * kColsPerThread;  // 128
constexpr int kTileRows = 32;
constexpr int kSpan = kTileCols + 4;            // LR columns a tile can read, factor >= 1

// sum_f w[f] * t[f] in XLA's order for an element whose column in its pass
// is in the fused tiles (rule 0), the single left-over column (rule 1) or
// a longer tail (rule 2).
__device__ __forceinline__ float tap_sum(int rule, float4 w, float t0, float t1, float t2,
                                         float t3) {
  float acc;
  if (rule == 0) {
    acc = __fmaf_rn(w.x, t0, 0.0f);
    acc = __fmaf_rn(w.y, t1, acc);
    acc = __fmaf_rn(w.z, t2, acc);
    acc = __fmaf_rn(w.w, t3, acc);
  } else if (rule == 1) {
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
  return acc;
}

// The rule of column `col` of a pass `width` columns wide.
__device__ __forceinline__ int rule_of(int col, int width) {
  const int fused = width & ~7;
  return col < fused ? 0 : (width - fused == 1 ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads) upsample_block_kernel(
    const float* __restrict__ lr, int n_c, const float4* __restrict__ kw_r,
    const int4* __restrict__ idx_r, int m2, const float4* __restrict__ kw_c,
    const int4* __restrict__ idx_c, int r0, int c0, int rows, int cols, bool vec4,
    float* __restrict__ out) {
  __shared__ float hr[kTileRows][kSpan];
  const int tile_r = blockIdx.y * kTileRows;
  const int tile_c = blockIdx.x * kTileCols;
  const int rows_here = min(kTileRows, rows - tile_r);
  const int cols_here = min(kTileCols, cols - tile_c);
  const int lo = __ldg(&idx_c[c0 + tile_c].x);
  const int span = __ldg(&idx_c[c0 + tile_c + cols_here - 1].w) - lo + 1;

  // pass 1: hr[i][c - lo] for the tile's rows i and the LR columns c it reads
  for (int i = threadIdx.y; i < rows_here; i += kWarpsY) {
    const int h = r0 + tile_r + i;
    const float4 w = __ldg(kw_r + h);
    const int4 ix = __ldg(idx_r + h);
    for (int k = threadIdx.x; k < span; k += 32) {
      const int c = lo + k;
      hr[i][k] = tap_sum(rule_of(c, n_c), w, __ldg(lr + static_cast<long long>(ix.x) * n_c + c),
                         __ldg(lr + static_cast<long long>(ix.y) * n_c + c),
                         __ldg(lr + static_cast<long long>(ix.z) * n_c + c),
                         __ldg(lr + static_cast<long long>(ix.w) * n_c + c));
    }
  }

  // pass 2: each thread's four columns, their weights and taps in registers
  const int j0 = tile_c + kColsPerThread * threadIdx.x;
  float4 w[kColsPerThread];
  int4 ix[kColsPerThread];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int j = min(j0 + q, cols - 1);  // a column past the crop computes, never stores
    w[q] = __ldg(kw_c + c0 + j);
    const int4 t = __ldg(idx_c + c0 + j);
    ix[q] = make_int4(t.x - lo, t.y - lo, t.z - lo, t.w - lo);
  }
  __syncthreads();
  if (j0 >= cols) return;
  const bool whole = vec4 && j0 + kColsPerThread <= cols;
  for (int i = threadIdx.y; i < rows_here; i += kWarpsY) {
    const int h = r0 + tile_r + i;
    const int rule = rule_of(h, m2);
    const float* row = hr[i];
    float v[kColsPerThread];
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q)
      v[q] = tap_sum(rule, w[q], row[ix[q].x], row[ix[q].y], row[ix[q].z], row[ix[q].w]);
    float* dst = out + static_cast<long long>(tile_r + i) * cols + j0;
    if (whole) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q)
        if (j0 + q < cols) dst[q] = v[q];
    }
  }
}

// The launch floor: the kernel's grid and block, no loads, no stores.
__global__ void __launch_bounds__(kThreads) upsample_block_floor_kernel() {}

dim3 grid_of(int rows, int cols) {
  return dim3((cols + kTileCols - 1) / kTileCols, (rows + kTileRows - 1) / kTileRows);
}

}  // namespace

// Plain C entry, loaded with ctypes. Device pointers to contiguous data:
// lr (n_r, n_c) float32; kw_r (m2, 4) float32 and idx_r (m2, 4) int32, the
// row pass's weights and LR row indices, m2 = n_r * factor; kw_c (n_c *
// factor, 4) float32 and idx_c int32, the column pass's; each table
// 16-byte aligned; out (rows, cols) float32, the crop at (r0, c0), which
// lies inside the upsample. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int upsample_block_f32(const float* lr, int n_c, const float* kw_r, const int* idx_r,
                                  int m2, const float* kw_c, const int* idx_c, int r0, int c0,
                                  int rows, int cols, float* out, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  const bool vec4 = cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  upsample_block_kernel<<<grid_of(rows, cols), dim3(32, kWarpsY), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lr, n_c, reinterpret_cast<const float4*>(kw_r), reinterpret_cast<const int4*>(idx_r), m2,
      reinterpret_cast<const float4*>(kw_c), reinterpret_cast<const int4*>(idx_c), r0, c0, rows,
      cols, vec4, out);
  return (int)cudaGetLastError();
}

// The empty kernel at the launch shape of a (rows, cols) crop, on `stream`.
extern "C" int upsample_block_floor(int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  upsample_block_floor_kernel<<<grid_of(rows, cols), dim3(32, kWarpsY), 0,
                                static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
