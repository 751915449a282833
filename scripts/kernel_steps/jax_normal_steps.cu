// Design steps of the jax_normal kernel, appended to csrc/jax_normal.cu by
// scripts/torch_kernel_variants.py: the draw's loop at other values a thread
// a trip (V in {1, 2, 4}) and with the key derived by every warp on its own
// (no barrier) or by warp 0 behind one barrier. One run of counts from 0 (no
// slice, no next key). The entry takes the variant's two numbers, then the
// key, a path of at most one step, the count and the output.

namespace {

template <int V, bool kWarpKey>
__global__ void __launch_bounds__(kThreads) jax_normal_variant_kernel(
    const long long* __restrict__ key, KeyPath path, long long n, float* __restrict__ out) {
  unsigned k1, k2;
  if constexpr (kWarpKey) {
    derive(key, path, nullptr, k1, k2);
  } else {
    __shared__ unsigned sub[2];
    if (threadIdx.x < 32) {
      derive(key, path, nullptr, k1, k2);
      if (threadIdx.x == 0) {
        sub[0] = k1;
        sub[1] = k2;
      }
    }
    __syncthreads();
    k1 = sub[0];
    k2 = sub[1];
  }
  const float lo = __int_as_float(0xBF7FFFFF);
  const long long trip = (long long)gridDim.x * kThreads * V;
  for (long long base = (long long)blockIdx.x * kThreads * V + threadIdx.x; base < n;
       base += trip) {
    unsigned x1[V], x2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const unsigned long long count = (unsigned long long)(base + v * kThreads);
      x1[v] = (unsigned)(count >> 32);
      x2[v] = (unsigned)count;
    }
    threefry2x32<V>(k1, k2, x1, x2);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long t = base + v * kThreads;
      if (t < n) {
        const unsigned bits = x1[v] ^ x2[v];
        const float floats = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
        out[t] = normal_of_uniform(fmaxf(__fmaf_rn(floats, 2.0f, lo), lo));
      }
    }
  }
}

}  // namespace

extern "C" int jax_normal_variant_f32(int values, int warp_key, const long long* key,
                                      int path_len, unsigned p0, long long n, float* out,
                                      void* stream) {
  if (path_len < 0 || path_len > 1) return (int)cudaErrorInvalidValue;
  const KeyPath path = {path_len, -1, {p0, 0u, 0u, 0u}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(n, values);
#define VARIANT(V, W)           \
  if (values == V && warp_key == W) \
    jax_normal_variant_kernel<V, W><<<grid, kThreads, 0, s>>>(key, path, n, out);
  VARIANT(1, false) VARIANT(1, true) VARIANT(2, false) VARIANT(2, true) VARIANT(4, false)
  VARIANT(4, true)
#undef VARIANT
  return (int)cudaGetLastError();
}
