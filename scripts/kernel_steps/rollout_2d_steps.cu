// Other shapes and a further step of the planar rollout kernel's design,
// for timing what each choice buys (scripts/torch_kernel_variants.py). Not
// a source on its own: the script appends it to
// husky_rover_mppi_isaacsim_torch/csrc/rollout_2d.cu and builds the two as
// one, so it reuses that file's helpers (Params, move, turn, height_at,
// table_entry, and the Fast and Exact forms and the barriers of
// hopper_common.cuh) and instantiates its kernel template with other
// parameters. No rollout path launches it.
//   variant 1: 32 samples per block, 8 store warps (the first shape tried);
//   variant 2: 16 samples per block, 8 store warps;
//   variant 3: the chain cut in two, 16 samples per block: a heading warp
//              (update_orientation_2d only) hands each chunk's headings to
//              a position warp (update_position from them) through the ring
//              slot, three mbarriers a slot, then 6 store warps.
// Variant 0 is the production kernel (rollout2d_f32): 16 samples per
// block, one chain warp, 3 store warps.

namespace {

// The exact recomputes of one chunk of a chain, out of line: they run
// only for a slow-path operand. `steps` steps from step t0 of sample s,
// written to the slot's planes `r` (offset by s) where `writer`; `cs` and
// `sn` are the cos / sin tables at sample s, `vdt` the v * dt table at it.
template <int S>
__device__ __noinline__ float2 split_turn_exact(float hx, float hy, const float* cs, const float* sn,
                                          int t0, int steps, float* r, bool writer) {
  Exact e;
  for (int j = 0; j < steps; ++j) {
    turn(e, hx, hy, cs[(t0 + j) * S], sn[(t0 + j) * S]);
    if (writer) {
      r[(2 * kChunk + j) * S] = hx;
      r[(3 * kChunk + j) * S] = hy;
    }
  }
  return make_float2(hx, hy);
}

// ... from the heading (hx, hy, hz) carried into step t0; the later steps'
// headings are read from the slot
template <int S>
__device__ __noinline__ float2 split_move_exact(float x, float y, float hx, float hy, float hz,
                                          const float* vdt, int t0, int steps, float* r,
                                          bool writer) {
  Exact e;
  for (int j = 0; j < steps; ++j) {
    move(e, x, y, hx, hy, hz, vdt[(t0 + j) * S]);
    hx = r[(2 * kChunk + j) * S];
    hy = r[(3 * kChunk + j) * S];
    hz = 0.0f;
    if (writer) {
      r[j * S] = x;
      r[(kChunk + j) * S] = y;
    }
  }
  return make_float2(x, y);
}

template <int S, int W>
__global__ void __launch_bounds__(32 * (2 + W)) rollout2d_split_kernel(const Params p) {
  static_assert(S == 16 || S == 32, "one chain lane per sample, S a power of two");
  static_assert(1 + 3 * W <= kBarBytes / 8, "barriers");
  constexpr int kThreads = 32 * (2 + W);
  constexpr int kItems = S * kChunk / 32;  // (sample, step) items of a chunk per store lane
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.H, K = p.K;
  const int n = blockIdx.y;
  const int k0 = blockIdx.x * S;
  const int nb = min(S, K - k0);  // live samples of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  uint64_t* load_bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* turned = load_bar + 1;  // a slot's headings are in
  uint64_t* full = turned + W;      // ... and its positions
  uint64_t* empty = full + W;       // ... and it is free again
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
      bar_init(turned + s, 32);
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
  if (warp < 2) {  // the start pose, while the copy flies
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

  if (warp < 2) {
    // the chain warps: lane s runs sample s (lanes >= S shadow lane s - S
    // and write nothing). The step loops stay rolled and the exact
    // recomputes out of line, so that the hot loops' code stays small.
    const int s = lane % S;
    const bool writer = lane < S;
    const float* cs = tc + s;
    const float* sn = ts + s;
    const float* vdt = tv + s;
    if (warp == 0) {
      // the heading warp: update_orientation_2d, chunk by chunk
      float nc = cs[0], ns = sn[0];  // step 0's entries
      for (int c = 0; c < chunks; ++c) {
        const int slot = c % W;
        bar_wait(empty + slot, ((c / W) & 1) ^ 1);
        float* r = ring + slot * slot_floats<S>() + s;
        const int steps = min(kChunk, H - c * kChunk);
        const float hx0 = hx, hy0 = hy;
        Fast a;
#pragma unroll 1
        for (int j = 0; j < steps; ++j) {
          const int t = c * kChunk + j;
          const float c_t = nc, s_t = ns;
          nc = cs[(t + 1) * S];  // row H exists: the tables hold H + 1 rows
          ns = sn[(t + 1) * S];
          turn(a, hx, hy, c_t, s_t);
          if (writer) {
            r[(2 * kChunk + j) * S] = hx;
            r[(3 * kChunk + j) * S] = hy;
          }
        }
        if (!a.ok) {  // a slow-path operand: the chunk again, in the exact form
          const float2 h = split_turn_exact<S>(hx0, hy0, cs, sn, c * kChunk, steps, r, writer);
          hx = h.x;
          hy = h.y;
        }
        bar_arrive(turned + slot);
      }
    } else {
      // the position warp: update_position from the heading carried into
      // each step (the raw start heading, then the slot's)
      float nv = vdt[0];
      for (int c = 0; c < chunks; ++c) {
        const int slot = c % W;
        bar_wait(turned + slot, (c / W) & 1);
        float* r = ring + slot * slot_floats<S>() + s;
        const int steps = min(kChunk, H - c * kChunk);
        const float x0 = x, y0 = y, hx0 = hx, hy0 = hy, hz0 = hz;
        Fast a;
#pragma unroll 1
        for (int j = 0; j < steps; ++j) {
          const int t = c * kChunk + j;
          const float v_t = nv;
          nv = vdt[(t + 1) * S];
          const float nhx = r[(2 * kChunk + j) * S], nhy = r[(3 * kChunk + j) * S];
          move(a, x, y, hx, hy, hz, v_t);
          hx = nhx;
          hy = nhy;
          hz = 0.0f;
          if (writer) {
            r[j * S] = x;
            r[(kChunk + j) * S] = y;
          }
        }
        if (!a.ok) {
          const float2 q = split_move_exact<S>(x0, y0, hx0, hy0, hz0, vdt, c * kChunk, steps, r, writer);
          x = q.x;
          y = q.y;
        }
        bar_arrive(full + slot);
      }
    }
  } else {
    // store warp w: chunks w, w + W, ... in slot w. Item m of lane `lane`
    // is (sample idx % S, step idx / S) of the chunk, idx = lane + 32 m.
    const int w = warp - 2;
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


template <int S, int W>
int launch_split(const Params& p, void* stream) {
  static bool opted[64];
  if (p.N <= 0 || p.K <= 0 || p.H <= 0) return (int)cudaSuccess;
  if (p.H > kMaxHorizon || p.N > kMaxRovers) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(rollout2d_split_kernel<S, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<S, W>(kMaxHorizon));
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const dim3 grid((p.K + S - 1) / S, p.N);
  rollout2d_split_kernel<S, W><<<grid, 32 * (2 + W), smem_bytes<S, W>(p.H),
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rollout2d_variant_f32(const float* z, int rows, int cols, const float* res,
                                     const float* x_min, const float* y_min, const float* pos,
                                     long long pos_sn, long long pos_sc, const float* head,
                                     long long head_sn, long long head_sc, const float* lin,
                                     long long lin_sn, const float* ang, long long ang_sn,
                                     float* out, int N, int K, int H, float dt, void* stream,
                                     int variant) {
  const Params p{z,   rows, cols,   res,     x_min,   y_min, pos, head,   pos_sn, pos_sc, head_sn,
                 head_sc, lin, ang, lin_sn, ang_sn, out, N,   K, H,  dt};
  switch (variant) {
    case 0: return launch<kSamples, kStoreWarps>(p, stream);
    case 1: return launch<32, 8>(p, stream);
    case 2: return launch<16, 8>(p, stream);
    case 3: return launch_split<16, 6>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
