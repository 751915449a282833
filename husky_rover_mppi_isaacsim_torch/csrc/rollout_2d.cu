// The planar rollout of the 2D projection arm, K samples x H steps, for
// Hopper (sm_90a).
//
// No Pallas kernel stands behind it: it is the port's counterpart of one
// compiled JAX program, the lax.scan of husky_rover_mppi_isaacsim_tpu/mppi/
// rollout.py:254-297 (rollout_2d), which runs inside the jitted goal-seek
// loop. It computes what mppi/rollout.py::rollout_2d computes on a plain
// HeightField, step for step (projection_warp.py:353-383):
//   1. update_position: the 3-vector heading re-normalized (v / sqrt(v.v)),
//      then the Euler step x + hx * (v * dt), y + hy * (v * dt);
//   2. update_orientation_2d: cos / sin of w * dt, the rotated (x, y), the
//      guarded normalization (torch.where: divided where the norm is > 0,
//      kept where it is not), z forced to 0;
//   3. height_at: corner cell i = trunc((x - x_min) / res), j =
//      -trunc((y + y_min) / res) as int64 (true divisions: the window
//      scalars are device tensors), JAX gather semantics (a negative index
//      wraps once, then clamps), the 4 quad corners, bilinear height with
//      trunc fractions and the transposed weights.
// Outputs: the trajectory (x, y, height) and the headings, each (N, K, H, 3)
// contiguous, the layout torch.stack gives the plain version.
//
// What bounds it: not bytes (~2.4 MB of outputs and 0.8 MB of velocities at
// K = 1000 x H = 100, ~1 us at 3.35 TB/s) and not operations (~60 a
// sample-step), but each sample's chain of H dependent steps: a step holds
// a square root and two divisions before the position, two divisions for
// the cell, the corner gathers (L1 or L2: the 1500^2 DEM's 9 MB stay in the
// 50 MB L2), two divisions for the fractions, and a square root and two
// divisions on the heading. Design (a simple kernel that is right): one
// thread per sample, its pose and heading in registers across the H
// steps, 64 samples per block so that K = 1000 spreads over 16 SMs, grid
// (ceil(K / 64), N); cos / sin of w * dt do not depend on the chain, so the
// scheduler overlaps them with it. Both outputs are stored each step.
//
// Numerics: every float operation is an _rn intrinsic in the plain
// version's order, so no FMA contraction can touch it. The source builds
// with -fmad=false like K1 (the package default): the flag then reaches only
// the libdevice cosf / sinf inlined here, the same functions of the same
// arguments K1 computes, which chip_smoke.py's rollout_2d_libm phase holds
// against torch.cos / torch.sin on the run's arguments. A rover's blocks
// run the one-rover code, so rover n of a batched launch equals a one-rover
// launch bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // samples per block
constexpr int kMaxHorizon = 256;
constexpr int kMaxRovers = 65535;  // gridDim.y

struct Params {
  const float* z;
  int rows, cols;
  const float *res, *x_min, *y_min;
  const float* pos;   // ([N,] 2), element strides pos_sn, pos_sc
  const float* head;  // ([N,] 3), the raw start heading
  long long pos_sn, pos_sc, head_sn, head_sc;
  const float *lin, *ang;  // ([N,] K, H), (K, H) contiguous
  long long lin_sn, ang_sn;
  float* out;  // (2, N, K, H, 3): trajectory, then headings
  int N, K, H;
  float dt;
};

// heightfield.wrap_clamp on int64 indices
__device__ __forceinline__ long long wrap_clamp(long long i, long long n) {
  i = (i < 0) ? i + n : i;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// heightfield.grid_lookup: z[wrap_clamp(j), wrap_clamp(i)]
__device__ __forceinline__ float cell(const Params& p, long long i, long long j) {
  return __ldg(p.z + wrap_clamp(j, p.rows) * p.cols + wrap_clamp(i, p.cols));
}

__global__ void __launch_bounds__(kThreads) rollout2d_kernel(const Params p) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (k >= p.K) return;
  const int H = p.H;
  const float res = __ldg(p.res);
  const float x_min = __ldg(p.x_min);
  const float y_min = __ldg(p.y_min);
  const float dt = p.dt;
  const float* pos = p.pos + n * p.pos_sn;
  const float* head = p.head + n * p.head_sn;
  float x = __ldg(pos), y = __ldg(pos + p.pos_sc);
  float hx = __ldg(head), hy = __ldg(head + p.head_sc), hz = __ldg(head + 2 * p.head_sc);
  const float* lin = p.lin + n * p.lin_sn + (size_t)k * H;
  const float* ang = p.ang + n * p.ang_sn + (size_t)k * H;
  const size_t plane = (size_t)p.N * p.K * H * 3;  // trajectory -> headings
  float* traj = p.out + ((size_t)n * p.K + k) * H * 3;

#pragma unroll 1
  for (int t = 0; t < H; ++t) {
    // 1. update_position(x, y, heading, v, dt)
    const float vdt = __fmul_rn(__ldg(lin + t), dt);
    const float nn = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), __fmul_rn(hz, hz)));
    x = __fadd_rn(x, __fmul_rn(__fdiv_rn(hx, nn), vdt));
    y = __fadd_rn(y, __fmul_rn(__fdiv_rn(hy, nn), vdt));

    // 2. update_orientation_2d(heading, w, dt)
    const float theta = __fmul_rn(__ldg(ang + t), dt);
    const float c = cosf(theta);
    const float s = sinf(theta);
    float ox = __fsub_rn(__fmul_rn(c, hx), __fmul_rn(s, hy));
    float oy = __fadd_rn(__fmul_rn(s, hx), __fmul_rn(c, hy));
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)));
    if (norm > 0.0f) {
      ox = __fdiv_rn(ox, norm);
      oy = __fdiv_rn(oy, norm);
    }
    hx = ox;
    hy = oy;
    hz = 0.0f;

    // 3. height_at(x, y): corner cell, the quad's corners, bilinear
    const long long i = (long long)truncf(__fdiv_rn(__fsub_rn(x, x_min), res));
    const long long j = (long long)(-truncf(__fdiv_rn(__fadd_rn(y, y_min), res)));
    const float q00 = cell(p, i, j);  // q[a][b] = z[j + a, i + b]
    const float q01 = cell(p, i + 1, j);
    const float q10 = cell(p, i, j + 1);
    const float q11 = cell(p, i + 1, j + 1);
    const float xn = __fdiv_rn(x, res);
    const float yn = __fdiv_rn(y, res);
    const float x2 = __fsub_rn(xn, truncf(xn));
    const float y2 = __fsub_rn(yn, truncf(yn));
    const float ux = __fsub_rn(1.0f, x2);
    const float uy = __fsub_rn(1.0f, y2);
    float height = __fmul_rn(__fmul_rn(ux, uy), q00);
    height = __fadd_rn(height, __fmul_rn(__fmul_rn(x2, uy), q10));
    height = __fadd_rn(height, __fmul_rn(__fmul_rn(ux, y2), q01));
    height = __fadd_rn(height, __fmul_rn(__fmul_rn(x2, y2), q11));

    float* o = traj + 3 * t;
    o[0] = x;
    o[1] = y;
    o[2] = height;
    o[plane] = ox;
    o[plane + 1] = oy;
    o[plane + 2] = 0.0f;
  }
}

// cosf (op 0) or sinf (op 1) elementwise: the check of this build's
// libdevice functions against torch's.
__global__ void libm_kernel(const float* __restrict__ a, float* __restrict__ out, int n,
                            int op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = op == 0 ? cosf(a[i]) : sinf(a[i]);
}

}  // namespace

// Plain C entry, loaded with ctypes. All pointers are device pointers to
// float32 data: z (rows, cols) contiguous; res, x_min, y_min scalars; for
// each of N rovers (N <= 65535): pos (N, 2) and head (N, 3), the raw start
// heading, at the given element strides (rover, component); lin and ang
// (N, K, H), each rover's (K, H) contiguous, rover strides lin_sn, ang_sn;
// out (2, N, K, H, 3) contiguous. H <= 256. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int rollout2d_f32(const float* z, int rows, int cols, const float* res,
                             const float* x_min, const float* y_min, const float* pos,
                             long long pos_sn, long long pos_sc, const float* head,
                             long long head_sn, long long head_sc, const float* lin,
                             long long lin_sn, const float* ang, long long ang_sn, float* out,
                             int N, int K, int H, float dt, void* stream) {
  if (N <= 0 || K <= 0 || H <= 0) return (int)cudaSuccess;
  if (H > kMaxHorizon || N > kMaxRovers) return (int)cudaErrorInvalidValue;
  const Params p{z,   rows, cols,   res,     x_min,   y_min, pos, head,   pos_sn, pos_sc, head_sn,
                 head_sc, lin, ang, lin_sn, ang_sn, out, N,   K, H,  dt};
  const dim3 grid((K + kThreads - 1) / kThreads, N);
  rollout2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// out[i] = cosf(a[i]) (op 0) or sinf(a[i]) (op 1) for i < n, on `stream`.
extern "C" int rollout2d_libm_f32(const float* a, float* out, int n, int op, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  libm_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, out, n, op);
  return (int)cudaGetLastError();
}
