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
// K = 1000 x H = 100, ~1 us at 3.35 TB/s) and not operations, but each
// sample's chain of H dependent heading steps. The heights never feed back
// into the chain, cos / sin of w * dt depend on no step, and the position
// depends on the heading but the heading not on the position, so the
// serial part of a step is the heading's rotation, its norm, one square
// root and one reciprocal shared by the two divisions: 15 dependent
// operations (chip_smoke.py's ROLLOUT_2D_CHAIN_DEPTH), ~0.03 us a step at 4
// cycles each. On an H100 at 700 W a step costs ~0.11 us and a launch ~3.9
// us besides (scripts/torch_kernel_variants.py's horizon sweep), so the
// chain is ~3/4 of a K = 1000 x H = 100 launch, whatever K is.
//
// Design: one launch per call, S = 16 samples of one rover per block, grid
// (ceil(K / S), N); one chain warp and W = 3 store warps (K1's shape,
// csrc/rollout.cu), each of the 4 warps on a scheduler of its own.
//   * The block stages its samples' (S, H) slices of lin and ang in shared
//     memory with one bulk asynchronous copy each (cp.async.bulk on an
//     mbarrier) where a slice is 16-byte aligned, with coalesced loads where
//     it is not. Meanwhile the chain warp reads the start pose.
//   * A prologue run by all warps turns them into step-major tables of
//     v * dt, cosf(w * dt) and sinf(w * dt): the same functions of the same
//     inputs, so the same bits whichever thread computes them.
//   * Warp 0, the chain warp, runs only the two chains, one lane per sample
//     (lanes 16-31 shadow lanes 0-15), its table entries loaded one step
//     ahead. It hands each chunk of kChunk steps' (x, y, hx, hy) to a ring
//     slot in shared memory (the staging buffers' space, dead by then),
//     guarded by a full and an empty mbarrier. Its divisions and square
//     roots run branch-free (the Fast form of hopper_common.cuh, K1's too:
//     one reciprocal per divisor); a chunk in which any operand would need
//     a slow path is recomputed from its start in the Exact form. Moving update_position to a warp
//     of its own bought nothing on an H100: the heading's latency, not the
//     warp's instruction rate, sets a step.
//   * Store warp w takes chunks w, w + W, ...: the cell index, the four
//     corner gathers, the fractions and the bilinear sum of every (sample,
//     step) of the chunk, independent of each other, so that all their
//     loads are in flight together (the same Fast form and recompute); it
//     then lays the chunk's outputs over its slot as each sample's run of
//     3 * kChunk floats, and writes each run with one coalesced store.
// A rover's blocks run exactly the one-rover code, so rover n of a batched
// launch equals a one-rover launch bit for bit. The earlier version of this
// kernel (one thread per sample walking the H steps, every load, division
// and store inline) read ~0.098 ms at K = 1000 x H = 100 on an H100;
// scripts/torch_kernel_variants.py times it beside this design and its
// other shapes (scripts/kernel_steps/rollout_2d_steps.cu).
//
// Numerics: every float operation of the model is an _rn intrinsic in the
// plain version's order, so no FMA contraction can touch it; the Fast forms'
// own FMAs are written out. The source builds with -fmad=false like K1 (the
// package default): the flag then reaches only the libdevice cosf / sinf
// inlined here, which chip_smoke.py's rollout_2d_libm phase holds against
// torch.cos / torch.sin on the run's arguments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kSamples = 16;     // samples per block (one chain lane each)
constexpr int kStoreWarps = 3;   // store warps per block
constexpr int kChunk = 8;        // steps per ring slot
constexpr int kRun = 3 * kChunk + 1;  // a sample's run of one output in a slot, padded
constexpr int kMaxHorizon = 256;
constexpr int kMaxRovers = 65535;  // gridDim.y
constexpr int kBarBytes = 256;     // load, full[W], empty[W] (W <= 15)

// a ring slot: the chain's (4, kChunk, S) planes, then the outputs' (2, S,
// kRun) runs laid over them
template <int S>
__host__ __device__ constexpr int slot_floats() {
  return 2 * S * kRun > 4 * kChunk * S ? 2 * S * kRun : 4 * kChunk * S;
}

template <int S, int W>
__host__ __device__ constexpr int smem_bytes(int H) {
  // barriers | tables (3, H + 1, S) | staging (2, S * H) or the ring
  return kBarBytes + 3 * (H + 1) * S * 4 +
         (2 * S * H > W * slot_floats<S>() ? 2 * S * H : W * slot_floats<S>()) * 4;
}

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

// Step 1, update_position: (x, y) moved along the heading (hx, hy, hz)
// carried into the step, re-normalized.
template <class A>
__device__ __forceinline__ void move(A& a, float& x, float& y, float hx, float hy, float hz,
                                     float vdt) {
  const float nn = a.root(
      __fadd_rn(__fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), __fmul_rn(hz, hz)));
  const float rn = a.inv(nn);
  x = __fadd_rn(x, __fmul_rn(a.div(hx, nn, rn), vdt));
  y = __fadd_rn(y, __fmul_rn(a.div(hy, nn, rn), vdt));
}

// Step 2, update_orientation_2d: (hx, hy) rotated by (c, s) = (cos, sin)
// of w * dt and normalized where its norm is > 0 (z is 0 afterwards).
template <class A>
__device__ __forceinline__ void turn(A& a, float& hx, float& hy, float c, float s) {
  const float ox = __fsub_rn(__fmul_rn(c, hx), __fmul_rn(s, hy));
  const float oy = __fadd_rn(__fmul_rn(s, hx), __fmul_rn(c, hy));
  const float norm = a.root(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)));
  const float rm = a.inv(norm);
  hx = a.guard(norm, a.div(ox, norm, rm), ox);
  hy = a.guard(norm, a.div(oy, norm, rm), oy);
}

// Step 3: the bilinear height at (x, y). `rres` is a.inv(res).
template <class A>
__device__ __forceinline__ float height_at(A& a, const Params& p, float x, float y, float res,
                                           float rres, float x_min, float y_min) {
  const long long i = (long long)truncf(a.div(__fsub_rn(x, x_min), res, rres));
  const long long j = (long long)(-truncf(a.div(__fadd_rn(y, y_min), res, rres)));
  const float q00 = cell(p, i, j);  // q[a][b] = z[j + a, i + b]
  const float q01 = cell(p, i + 1, j);
  const float q10 = cell(p, i, j + 1);
  const float q11 = cell(p, i + 1, j + 1);
  const float xn = a.div(x, res, rres);
  const float yn = a.div(y, res, rres);
  const float x2 = __fsub_rn(xn, truncf(xn));
  const float y2 = __fsub_rn(yn, truncf(yn));
  const float ux = __fsub_rn(1.0f, x2);
  const float uy = __fsub_rn(1.0f, y2);
  float height = __fmul_rn(__fmul_rn(ux, uy), q00);
  height = __fadd_rn(height, __fmul_rn(__fmul_rn(x2, uy), q10));
  height = __fadd_rn(height, __fmul_rn(__fmul_rn(ux, y2), q01));
  return __fadd_rn(height, __fmul_rn(__fmul_rn(x2, y2), q11));
}

// The exact recompute of one chain chunk, out of line: it runs only for a
// slow-path operand. Both steps of `steps` steps from step t0 of sample s,
// from the pose (x, y) and the heading (hx, hy, hz) carried into t0, each
// pose written to the slot's planes `r` (offset by s) where `writer`.
template <int S>
__device__ __noinline__ float4 chain_exact(float x, float y, float hx, float hy, float hz,
                                           const float* tab, int H, int t0, int steps, int s,
                                           float* r, bool writer) {
  Exact e;
  for (int j = 0; j < steps; ++j) {
    const int t = t0 + j;
    move(e, x, y, hx, hy, hz, tab[t * S + s]);
    turn(e, hx, hy, tab[(H + 1 + t) * S + s], tab[(2 * (H + 1) + t) * S + s]);
    hz = 0.0f;
    if (writer) {
      r[j * S] = x;
      r[(kChunk + j) * S] = y;
      r[(2 * kChunk + j) * S] = hx;
      r[(3 * kChunk + j) * S] = hy;
    }
  }
  return make_float4(x, y, hx, hy);
}

__device__ __noinline__ float height_exact(const Params& p, float x, float y, float res,
                                           float x_min, float y_min) {
  Exact e;
  return height_at(e, p, x, y, res, res, x_min, y_min);
}

// One table entry (step t, sample s): v * dt, cosf(w * dt), sinf(w * dt);
// a dead sample (k >= K) stands still.
template <int S>
__device__ __forceinline__ void table_entry(float* tab, int H, int t, int s, bool live, float v,
                                            float w, float dt) {
  float vdt = 0.0f, c = 1.0f, sn = 0.0f;
  if (live) {
    const float theta = __fmul_rn(w, dt);
    vdt = __fmul_rn(v, dt);
    c = cosf(theta);
    sn = sinf(theta);
  }
  tab[t * S + s] = vdt;
  tab[(H + 1 + t) * S + s] = c;
  tab[(2 * (H + 1) + t) * S + s] = sn;
}

template <int S, int W>
__global__ void __launch_bounds__(32 * (1 + W)) rollout2d_kernel(const Params p) {
  static_assert(S == 16 || S == 32, "one chain lane per sample, S a power of two");
  static_assert(1 + 2 * W <= kBarBytes / 8, "barriers");
  constexpr int kThreads = 32 * (1 + W);
  constexpr int kItems = S * kChunk / 32;  // (sample, step) items of a chunk per store lane
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.H, K = p.K;
  const int n = blockIdx.y;
  const int k0 = blockIdx.x * S;
  const int nb = min(S, K - k0);  // live samples of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  uint64_t* load_bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = load_bar + 1;
  uint64_t* empty = full + W;
  float* tab = reinterpret_cast<float*>(smem + kBarBytes);  // (3, H + 1, S)
  float* area = tab + 3 * (H + 1) * S;                      // staging, then the ring
  const float* lin = p.lin + n * p.lin_sn + (size_t)k0 * H;
  const float* ang = p.ang + n * p.ang_sn + (size_t)k0 * H;
  const int count = nb * H;
  const uint32_t bytes = (uint32_t)count * 4u;
  const bool bulk =
      ((reinterpret_cast<uintptr_t>(lin) | reinterpret_cast<uintptr_t>(ang) | bytes) & 15) == 0;

  if (tid == 0) {
    bar_init(load_bar, 1);
    for (int s = 0; s < W; ++s) {
      bar_init(full + s, 32);
      bar_init(empty + s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (bulk) {
    if (tid == 0) {
      bar_arrive_tx(load_bar, 2 * bytes);
      bulk_load(area, lin, bytes, load_bar);
      bulk_load(area + count, ang, bytes, load_bar);
    }
  } else {
    for (int i = tid; i < count; i += kThreads) {
      area[i] = lin[i];
      area[count + i] = ang[i];
    }
  }

  const float res = __ldg(p.res);
  const float x_min = __ldg(p.x_min);
  const float y_min = __ldg(p.y_min);
  const float dt = p.dt;
  float x = 0.0f, y = 0.0f, hx = 0.0f, hy = 0.0f, hz = 0.0f;
  if (warp == 0) {  // the start pose, while the copy flies
    const float* pos = p.pos + n * p.pos_sn;
    const float* head = p.head + n * p.head_sn;
    x = __ldg(pos);
    y = __ldg(pos + p.pos_sc);
    hx = __ldg(head);
    hy = __ldg(head + p.head_sc);
    hz = __ldg(head + 2 * p.head_sc);
  }

  if (bulk) bar_wait(load_bar, 0);
  __syncthreads();
  // prologue: the step-major tables; where H % 4 == 0 each thread reads four
  // steps of one sample as float4 (conflict-free across the samples' rows)
  if ((H & 3) == 0) {
    for (int i = tid; i < (H / 4) * S; i += kThreads) {
      const int s = i % S, t = 4 * (i / S);
      const bool live = s < nb;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), w = v;
      if (live) {
        v = *reinterpret_cast<const float4*>(area + s * H + t);
        w = *reinterpret_cast<const float4*>(area + count + s * H + t);
      }
      table_entry<S>(tab, H, t, s, live, v.x, w.x, dt);
      table_entry<S>(tab, H, t + 1, s, live, v.y, w.y, dt);
      table_entry<S>(tab, H, t + 2, s, live, v.z, w.z, dt);
      table_entry<S>(tab, H, t + 3, s, live, v.w, w.w, dt);
    }
  } else {
    for (int i = tid; i < H * S; i += kThreads) {
      const int s = i % S, t = i / S;
      const bool live = s < nb;
      table_entry<S>(tab, H, t, s, live, live ? area[s * H + t] : 0.0f,
                     live ? area[count + s * H + t] : 0.0f, dt);
    }
  }
  __syncthreads();

  const int chunks = (H + kChunk - 1) / kChunk;
  float* ring = area;  // (W, slot_floats<S>())
  const float* tv = tab;
  const float* tc = tab + (H + 1) * S;
  const float* ts = tab + 2 * (H + 1) * S;

  if (warp == 0) {
    // the chain warp: lane s runs sample s (lanes >= S shadow lane s - S
    // and write nothing). The step loop stays rolled and the exact
    // recompute out of line, so that the hot loop's code stays small.
    const int s = lane % S;
    const bool writer = lane < S;
    float nv = tv[s], nc = tc[s], ns = ts[s];  // step 0's entries
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % W;
      bar_wait(empty + slot, ((c / W) & 1) ^ 1);
      float* r = ring + slot * slot_floats<S>() + s;
      const int steps = min(kChunk, H - c * kChunk);
      const float x0 = x, y0 = y, hx0 = hx, hy0 = hy, hz0 = hz;
      Fast a;
#pragma unroll 1
      for (int j = 0; j < steps; ++j) {
        const int t = c * kChunk + j;
        const float v_t = nv, c_t = nc, s_t = ns;
        nv = tv[(t + 1) * S + s];  // row H exists: the tables hold H + 1 rows
        nc = tc[(t + 1) * S + s];
        ns = ts[(t + 1) * S + s];
        move(a, x, y, hx, hy, hz, v_t);
        turn(a, hx, hy, c_t, s_t);
        hz = 0.0f;
        if (writer) {
          r[j * S] = x;
          r[(kChunk + j) * S] = y;
          r[(2 * kChunk + j) * S] = hx;
          r[(3 * kChunk + j) * S] = hy;
        }
      }
      if (!a.ok) {  // a slow-path operand: the chunk again, in the exact form
        const float4 q = chain_exact<S>(x0, y0, hx0, hy0, hz0, tab, H, c * kChunk, steps, s, r,
                                        writer);
        x = q.x;
        y = q.y;
        hx = q.z;
        hy = q.w;
        hz = 0.0f;
      }
      bar_arrive(full + slot);
    }
  } else {
    // store warp w: chunks w, w + W, ... in slot w. Item m of lane `lane`
    // is (sample idx % S, step idx / S) of the chunk, idx = lane + 32 m.
    const int w = warp - 1;
    float* r = ring + w * slot_floats<S>();
    float* runs = r;  // the outputs' (2, S, kRun) runs, over the planes
    Fast base;
    const float rres = base.inv(res);
    const size_t plane = (size_t)p.N * K * H * 3;  // trajectory -> headings
    for (int c = w; c < chunks; c += W) {
      bar_wait(full + w, (c / W) & 1);
      const int steps = min(kChunk, H - c * kChunk);
      float xs[kItems], ys[kItems], hs[kItems], oxs[kItems], oys[kItems];
      Fast a = base;
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const int idx = lane + 32 * m;
        const bool live = idx / S < steps;  // a step past H reads as (0, 0)
        xs[m] = live ? r[idx] : 0.0f;
        ys[m] = live ? r[kChunk * S + idx] : 0.0f;
        oxs[m] = r[2 * kChunk * S + idx];
        oys[m] = r[3 * kChunk * S + idx];
      }
#pragma unroll
      for (int m = 0; m < kItems; ++m)
        hs[m] = height_at(a, p, xs[m], ys[m], res, rres, x_min, y_min);
      if (!a.ok) {
#pragma unroll 1
        for (int m = 0; m < kItems; ++m) hs[m] = height_exact(p, xs[m], ys[m], res, x_min, y_min);
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const int idx = lane + 32 * m, s = idx % S, e = 3 * (idx / S);
        float* o = runs + s * kRun + e;
        o[0] = xs[m];
        o[1] = ys[m];
        o[2] = hs[m];
        o[S * kRun] = oxs[m];
        o[S * kRun + 1] = oys[m];
        o[S * kRun + 2] = 0.0f;
      }
      __syncwarp();
      float* dst = p.out + (((size_t)n * K + k0) * H + (size_t)c * kChunk) * 3;
      if (lane < 3 * steps) {
        for (int s = 0; s < nb; ++s) {
          dst[(size_t)s * H * 3 + lane] = runs[s * kRun + lane];
          dst[plane + (size_t)s * H * 3 + lane] = runs[(S + s) * kRun + lane];
        }
      }
      __syncwarp();
      bar_arrive(empty + w);
    }
  }
}

// cosf (op 0) or sinf (op 1) elementwise: the check of this build's
// libdevice functions against torch's.
__global__ void libm_kernel(const float* __restrict__ a, float* __restrict__ out, int n,
                            int op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = op == 0 ? cosf(a[i]) : sinf(a[i]);
}

// Launches rollout2d_kernel<S, W> over grid (ceil(K / S), N). Above
// 48 KB of dynamic shared memory a kernel must opt in, once per device.
template <int S, int W>
int launch(const Params& p, void* stream) {
  static bool opted[64];
  if (p.N <= 0 || p.K <= 0 || p.H <= 0) return (int)cudaSuccess;
  if (p.H > kMaxHorizon || p.N > kMaxRovers) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(rollout2d_kernel<S, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<S, W>(kMaxHorizon));
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const dim3 grid((p.K + S - 1) / S, p.N);
  rollout2d_kernel<S, W><<<grid, 32 * (1 + W), smem_bytes<S, W>(p.H),
                           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
  const Params p{z,   rows, cols,   res,     x_min,   y_min, pos, head,   pos_sn, pos_sc, head_sn,
                 head_sc, lin, ang, lin_sn, ang_sn, out, N,   K, H,  dt};
  return launch<kSamples, kStoreWarps>(p, stream);
}

// out[i] = cosf(a[i]) (op 0) or sinf(a[i]) (op 1) for i < n, on `stream`.
extern "C" int rollout2d_libm_f32(const float* a, float* out, int n, int op, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  libm_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, out, n, op);
  return (int)cudaGetLastError();
}
