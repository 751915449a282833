// K3: per-lane gather out[k] = table[j[k], i[k]] for Hopper (sm_90a).
//
// Replaces the Pallas TPU probe scripts/probe_pallas_gather.py::try_variant
// (kernels k_flat_take, k_getitem, k_take_along), which asks whether Mosaic
// can gather per lane from a VMEM-resident (256, 256) f32 table with
// (1024,) int32 index vectors. On Hopper the question is trivial: each
// thread loads one element.
//
// Design: one thread per lane; the indices and the table element are read
// through the read-only path (__ldg). The 256 KB table is over the 227 KB of
// shared memory a block can take, so it is read from L2 (it stays there
// between launches) and not staged. An index outside the table gives NaN
// instead of reading out of bounds (the JAX jnp.take "fill" mode).
//
// What bounds it: the launch. 1024 lanes are 8 blocks of 128 threads, one
// dependent load chain each (index, then element); the 16 KB the function
// must move take 5 ns at the card's memory rate, far below the time of any
// launch. gather_probe_floor launches a kernel of the same grid and block
// that loads and stores nothing: its replay time is the floor K3's bound is
// restated with, max(bytes / memory rate, floor). With 16 KB of useful bytes
// no staging (shared memory, TMA) or tensor-core form can pay for itself.
//
// Numerics: a gather does no arithmetic, so the result is bit-equal to
// every plain formulation.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) gather_probe_kernel(
    const float* __restrict__ table, int rows, int cols,
    const int* __restrict__ idx_i, const int* __restrict__ idx_j,
    float* __restrict__ out, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = __ldg(idx_i + k);
  const int j = __ldg(idx_j + k);
  const bool inside = i >= 0 && i < cols && j >= 0 && j < rows;
  out[k] = inside ? __ldg(table + (size_t)j * cols + i) : nanf("");
}

// The launch floor: K3's grid and block, no loads, no stores.
__global__ void __launch_bounds__(kThreads) gather_probe_floor_kernel() {}

}  // namespace

// Plain C entry, loaded with ctypes. Device pointers to contiguous data:
// table (rows, cols) float32; idx_i, idx_j (n,) int32 column and row
// indices; out (n,) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gather_probe_f32(const float* table, int rows, int cols,
                                const int* idx_i, const int* idx_j, float* out,
                                int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads);
  gather_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, rows, cols, idx_i, idx_j, out, n);
  return (int)cudaGetLastError();
}

// The empty kernel at K3's launch shape for n lanes, on `stream`; returns
// cudaGetLastError(). It is the yardstick of K3's time, not a part of K3.
extern "C" int gather_probe_floor(int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads);
  gather_probe_floor_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
