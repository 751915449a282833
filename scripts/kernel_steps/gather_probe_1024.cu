// K3 with one block of 1024 threads (one wave, no tail) instead of 8 blocks
// of 128, and its empty kernel. A fragment: scripts/torch_kernel_variants.py
// appends it to csrc/gather_probe.cu and builds the two as one source.

namespace {

__global__ void __launch_bounds__(1024) gather_probe_kernel_1024(
    const float* __restrict__ table, int rows, int cols,
    const int* __restrict__ idx_i, const int* __restrict__ idx_j,
    float* __restrict__ out, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = __ldg(idx_i + k);
    const int j = __ldg(idx_j + k);
    const bool inside = i >= 0 && i < cols && j >= 0 && j < rows;
    out[k] = inside ? __ldg(table + (size_t)j * cols + i) : nanf("");
  }
}

__global__ void __launch_bounds__(1024) gather_probe_floor_kernel_1024() {}

}  // namespace

extern "C" int gather_probe_1024_f32(const float* table, int rows, int cols,
                                     const int* idx_i, const int* idx_j,
                                     float* out, int n, void* stream) {
  gather_probe_kernel_1024<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      table, rows, cols, idx_i, idx_j, out, n);
  return (int)cudaGetLastError();
}

extern "C" int gather_probe_floor_1024(void* stream) {
  gather_probe_floor_kernel_1024<<<1, 1024, 0,
                                   static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
