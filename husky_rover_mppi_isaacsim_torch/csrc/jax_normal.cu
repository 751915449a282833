// jax_normal: JAX's standard normals (jax.random.normal, float32) from a key
// held on the card, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package draws its control and wheel-slip
// noise with jax.random.normal inside its jitted loops, where XLA fuses the
// threefry hash, the uniform and erf_inv into the loop's program. Written as
// torch integer ops the same draw is ~150 elementwise launches, which would
// double the launches of a control step (the port replays each step as a
// CUDA graph), so the draw and the derivation of its key are one kernel.
// The plain version is core/jax_random.py::normal (with ::derive for the key);
// the two agree bit for bit, and on the CPU the plain version is JAX's draw
// bit for bit.
//
// One launch:
//   1. derives the draw's key from the key in device memory along a path of
//      at most four steps, each a threefry hash of the count pair (0, v):
//      split(key, num)[v] and fold_in(key, v) are both that hash; one step
//      may take v from an int64 scalar on the card (a loop index in a graph);
//   2. for each output element, hashes its iota count (the 64-bit count
//      offset + o * outer_stride + j, o along the outer axis, j within it:
//      a rank's or a rover's slice of a larger draw), forms the float32
//      uniform on [nextafter(-1, 0), 1) as jax.random.uniform does, and maps
//      it through XLA's erf_inv and the multiply by sqrt(2);
//   3. where asked, writes the key the caller's loop carries on (block 0,
//      warp 0, at its end, into a buffer of its own: `key, sub = split(key)`).
//
// Numerics: every float operation is an _rn intrinsic in the order XLA's CPU
// backend evaluates it (core/jax_random.py's module note): erf_inv is Giles'
// polynomial in w = -log1p(-x^2), log1p XLA's rational form below
// sqrt(2) - 1 and its Cephes log above, with a fused multiply-add wherever
// LLVM contracts one there. The plain version forms those FMAs exactly
// (round to odd in float64) and its square root correctly rounded, so it and
// __fmaf_rn / __fsqrt_rn give the same bits. Built with -fmad=false.
//
// What bounds it: integer operations, or the launch. A draw of n values
// writes 4n bytes (0.8 MB at K=1000 x H=100, 8.4 MB at K=16384 x H=64).
// The function itself needs ~82 integer operations a value (the 20-round
// hash: an add, a funnel shift and a xor a round, 12 key injections; the
// uniform's bits; the log side's exponent bits; the tests) and 34 float
// ones (chip_smoke.py's JAX_NORMAL_OPS), which H100's 64 INT32 lanes per SM
// per clock take 1.0 us for 2 x 10^5 values and 10 us for 2.1 x 10^6; the
// small draw's launch (an empty kernel of its grid) takes longer than that.
// Design: two values a thread a trip (at t and t + 256), their hashes
// interleaved: two independent chains a thread, half the blocks and half
// the loop overhead of one value a thread (one value, or four, ran slower:
// scripts/kernel_steps/jax_normal_steps.cu); the draw's key derived once a
// block by warp 0 into shared memory behind one barrier (each warp deriving
// its own key ran slower: eight hashes a block instead of one). The
// division of a slice's counts is 32-bit below 2^31 values.
// Nothing is staged: no value is read twice.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxPath = 4;

// A key's derivation: `len` hashes of (0, v[i]); step `device_step` (if in
// range) takes its v from the device scalar instead.
struct KeyPath {
  int len;
  int device_step;
  unsigned v[kMaxPath];
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py::_threefry2x32_lowering), on
// V count pairs at once: their rounds interleave (V independent chains).
template <int V>
__device__ __forceinline__ void threefry2x32(unsigned k1, unsigned k2, unsigned (&x1)[V],
                                             unsigned (&x2)[V]) {
  const unsigned ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    x1[v] += ks[0];
    x2[v] += ks[1];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        x1[v] += x2[v];
        x2[v] = rotl(x2[v], rot[i % 2][j]) ^ x1[v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x1[v] += ks[(i + 1) % 3];
      x2[v] += ks[(i + 2) % 3] + (unsigned)(i + 1);
    }
  }
}

__device__ void derive(const long long* key, const KeyPath& path, const long long* data,
                       unsigned& k1, unsigned& k2) {
  k1 = (unsigned)key[0];
  k2 = (unsigned)key[1];
  for (int i = 0; i < path.len; ++i) {
    unsigned x1[1] = {0u};
    unsigned x2[1] = {i == path.device_step ? (unsigned)(*data) : path.v[i]};
    threefry2x32<1>(k1, k2, x1, x2);
    k1 = x1[0];
    k2 = x2[0];
  }
}

// XLA CPU's float32 log (Cephes logf on the mantissa), for t > 0.
__device__ __forceinline__ float log_xla(float t) {
  const float m = fmaxf(t, __int_as_float(0x00800000));
  const int bits = __float_as_int(m);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float f = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = f < __int_as_float(0x3F3504F3);
  const float x = __fadd_rn(__fsub_rn(f, 1.0f), low ? f : 0.0f);
  if (low) e = __fsub_rn(e, 1.0f);
  const float z = __fmul_rn(x, x);
  const float x3 = __fmul_rn(z, x);
  const float p1 = __fmaf_rn(__fmaf_rn(x, __int_as_float(0x3D9021BB), __int_as_float(0xBDEBD1B8)),
                             x, __int_as_float(0x3DEF251A));
  const float p2 = __fmaf_rn(__fmaf_rn(x, __int_as_float(0xBDFE5D4F), __int_as_float(0x3E11E9BF)),
                             x, __int_as_float(0xBE2AAE50));
  const float p3 = __fmaf_rn(__fmaf_rn(x, __int_as_float(0x3E4CCEAC), __int_as_float(0xBE7FFFFC)),
                             x, __int_as_float(0x3EAAAAAA));
  const float q = __fmaf_rn(x3, __fmaf_rn(x3, p1, p2), p3);
  const float r = __fmaf_rn(x3, q, __fmul_rn(e, __int_as_float(0xB95E8083)));
  const float s = __fadd_rn(__fmaf_rn(z, -0.5f, x), r);
  float out = __fmaf_rn(e, __int_as_float(0x3F318000), s);
  if (t <= 0.0f) out = __int_as_float(0x7FC00000);
  if (t == 0.0f) out = -__int_as_float(0x7F800000);
  if (t == __int_as_float(0x7F800000)) out = t;
  return out;
}

// XLA CPU's float32 log1p.
__device__ __forceinline__ float log1p_xla(float y) {
  const float y2 = __fmul_rn(y, y);
  const float base = __fmul_rn(y, 0.0f);
  float q = __fadd_rn(base, 1.0f);
  q = __fmaf_rn(q, y, __int_as_float(0x417101AD));
  q = __fmaf_rn(q, y, __int_as_float(0x42A6185B));
  q = __fmaf_rn(q, y, __int_as_float(0x435DC32D));
  q = __fmaf_rn(q, y, __int_as_float(0x439A8CA3));
  q = __fmaf_rn(q, y, __int_as_float(0x43586D8A));
  q = __fmaf_rn(q, y, __int_as_float(0x42707982));
  float p = __fadd_rn(base, __int_as_float(0x383DE04B));
  p = __fmaf_rn(p, y, __int_as_float(0x3EFF40C5));
  p = __fmaf_rn(p, y, __int_as_float(0x40D284FA));
  p = __fmaf_rn(p, y, __int_as_float(0x41EF4B9C));
  p = __fmaf_rn(p, y, __int_as_float(0x4273CC76));
  p = __fmaf_rn(p, y, __int_as_float(0x426473AD));
  p = __fmaf_rn(p, y, __int_as_float(0x41A05101));
  const float t = __fmaf_rn(y2, -0.5f, __fmul_rn(__fmul_rn(y, y2), __fdiv_rn(p, q)));
  const float small = __fadd_rn(y, t);
  return fabsf(y) < __int_as_float(0x3ED413CD) ? small : log_xla(__fadd_rn(y, 1.0f));
}

// Giles' float32 erf_inv as XLA lowers it, times sqrt(2).
__device__ __forceinline__ float normal_of_uniform(float x) {
  const unsigned lt5c[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
                            0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
  const unsigned ge5c[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
                            0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};
  const float l = log1p_xla(__fmul_rn(x, -x));
  const bool lt5 = l > -5.0f;
  const float w = lt5 ? __fsub_rn(-2.5f, l) : __fadd_rn(__fsqrt_rn(-l), -3.0f);
  // the branch's coefficient picked per term: constant indices after the
  // unroll, so the tables stay immediates (no local-memory pointer)
#define COEF(i) __uint_as_float(lt5 ? lt5c[i] : ge5c[i])
  float p = __fmaf_rn(w, COEF(0), COEF(1));
#pragma unroll
  for (int i = 2; i < 9; ++i) p = __fmaf_rn(w, p, COEF(i));
#undef COEF
  if (fabsf(x) == 1.0f) p = __int_as_float(0x7F800000);
  return __fmul_rn(__fmul_rn(x, p), __int_as_float(0x3FB504F3));
}

// One launch of the draw, kValues values a thread a trip (at t, t + 256,
// interleaved). Warp 0 derives the draw's key into shared memory behind one
// barrier; block 0's warp 0 derives the next key at its end.
constexpr int kValues = 2;

__global__ void __launch_bounds__(kThreads) jax_normal_kernel(
    const long long* __restrict__ key, KeyPath path, KeyPath next_path,
    const long long* __restrict__ data, long long offset, long long outer_stride,
    long long inner, long long n, float* __restrict__ out, long long* __restrict__ next_key) {
  constexpr int V = kValues;
  __shared__ unsigned sub[2];
  unsigned k1, k2;
  if (threadIdx.x < 32) {
    derive(key, path, data, k1, k2);
    if (threadIdx.x == 0) {
      sub[0] = k1;
      sub[1] = k2;
    }
  }
  __syncthreads();
  k1 = sub[0];
  k2 = sub[1];
  // the uniform's bounds: lo = nextafter(-1, 0), hi - lo = 2 in float32
  const float lo = __int_as_float(0xBF7FFFFF);
  const bool one_run = inner == n;          // one run of counts: no division
  const bool narrow = n < (1ll << 31) - kThreads * V;  // 32-bit division
  const long long trip = (long long)gridDim.x * kThreads * V;
  for (long long base = (long long)blockIdx.x * kThreads * V + threadIdx.x; base < n;
       base += trip) {
    unsigned x1[V], x2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long t = base + v * kThreads;
      long long o = 0;
      if (!one_run) o = narrow ? (long long)((unsigned)t / (unsigned)inner) : t / inner;
      const unsigned long long count =
          (unsigned long long)(offset + o * outer_stride + (t - o * inner));
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
        const float u = fmaxf(__fmaf_rn(floats, 2.0f, lo), lo);
        out[t] = normal_of_uniform(u);
      }
    }
  }
  if (next_key != nullptr && blockIdx.x == 0 && threadIdx.x < 32) {
    derive(key, next_path, data, k1, k2);
    if (threadIdx.x == 0) {
      next_key[0] = (long long)k1;
      next_key[1] = (long long)k2;
    }
  }
}

// The launch floor: the kernel's grid and block, no loads, no stores.
__global__ void __launch_bounds__(kThreads) jax_normal_floor_kernel() {}

unsigned grid_of(long long n, int values = kValues) {
  long long blocks = (n + kThreads * values - 1) / (kThreads * values);
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks of 256 on each of 132 SMs
  return (unsigned)blocks;
}

}  // namespace

// Plain C entry, loaded with ctypes (scalars and pointers only). `key` (2,)
// int64 on the card, holding uint32 words; the path `path_len` steps of
// values p0..p3 derives the draw's key from it and, where `next_key` is not
// null, the path `next_len` steps of n0..n3 the key written there ((2,)
// int64, another buffer than `key`); a step numbered `path_dev` (or
// `next_dev`) reads its value from the int64 scalar `data` on the card. The
// n = outer * inner values go to `out` (float32, contiguous) at the counts
// offset + o * outer_stride + j. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int jax_normal_f32(const long long* key, int path_len, int path_dev, unsigned p0,
                              unsigned p1, unsigned p2, unsigned p3, int next_len, int next_dev,
                              unsigned n0, unsigned n1, unsigned n2, unsigned n3,
                              const long long* data, long long offset, long long outer,
                              long long outer_stride, long long inner, float* out,
                              long long* next_key, void* stream) {
  const long long n = outer * inner;
  if (n <= 0 && next_key == nullptr) return (int)cudaSuccess;
  if (path_len < 0 || path_len > kMaxPath || next_len < 0 || next_len > kMaxPath)
    return (int)cudaErrorInvalidValue;
  const KeyPath path = {path_len, path_dev, {p0, p1, p2, p3}};
  const KeyPath next_path = {next_len, next_dev, {n0, n1, n2, n3}};
  jax_normal_kernel<<<grid_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, path, next_path, data, offset, outer_stride, inner > 0 ? inner : 1, n, out,
      next_key);
  return (int)cudaGetLastError();
}

// The empty kernel at the launch shape of an n-value draw, on `stream`.
extern "C" int jax_normal_floor(long long n, void* stream) {
  jax_normal_floor_kernel<<<grid_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
