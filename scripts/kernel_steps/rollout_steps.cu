// The earlier steps of K1's design, for timing what each step buys
// (scripts/torch_kernel_variants.py). Not a source on its own: the script
// appends it to husky_rover_mppi_isaacsim_torch/csrc/rollout.cu and builds
// the two as one, so it reuses the kernel's helpers (Params, advance, emit,
// the barriers, launch). It is K1's kernel with the chain's arithmetic in
// its plain form (`/` and sqrtf) and, at stage 1, no warp split. No rollout
// path launches it.
//   stage 1: the inputs staged in shared memory and the start heading
//            projected in the kernel, one warp running the chain and issuing
//            every gather and store;
//   stage 2: + the chain / store warp split.
// Stage 3 is K1 itself (rollout25d_f32): + the chain's divisions and square
// roots branch-free.

namespace {

template <bool kWheels, bool kSplit>
__global__ void __launch_bounds__(kThreads) rollout25d_step_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.H, K = p.K;
  const int n = blockIdx.y;
  const int k0 = blockIdx.x * kLanes;
  const int nb = min(kLanes, K - k0);  // live samples of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  uint64_t* load_bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = load_bar + 1;
  uint64_t* empty = full + kSlots;
  float* tab = reinterpret_cast<float*>(smem + kBarBytes);  // (3, H, 32)
  float* area = tab + 3 * H * kLanes;  // staging, then the ring

  const float* lin = p.lin + n * p.lin_sn + (size_t)k0 * H;
  const float* ang = p.ang + n * p.ang_sn + (size_t)k0 * H;
  const int count = nb * H;
  const uint32_t bytes = (uint32_t)count * 4u;
  const bool bulk = ((reinterpret_cast<uintptr_t>(lin) |
                      reinterpret_cast<uintptr_t>(ang) | bytes) & 15) == 0;

  if (tid == 0) {
    bar_init(load_bar, 1);
    for (int s = 0; s < kSlots; ++s) {
      bar_init(full + s, kLanes);
      bar_init(empty + s, kStoreWarps * 32);
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
  float x = 0.0f, y = 0.0f, hx = 0.0f, hy = 0.0f, hz = 0.0f;
  if (warp == 0) {
    // 0. start heading, projected on the start cell (while the copy flies)
    const float* pos = p.pos + n * p.pos_sn;
    const float* head = p.head + n * p.head_sn;
    x = __ldg(pos);
    y = __ldg(pos + p.pos_sc);
    hx = __ldg(head);
    hy = __ldg(head + p.head_sc);
    hz = __ldg(head + 2 * p.head_sc);
    Exact a;
    const Quad q = quad_at(a, p, x, y, res, res, x_min, y_min);
    tangent_project(a, hx, hy, hz, q.nx, q.ny, q.nz);
  }

  if (bulk) bar_wait(load_bar, 0);
  __syncthreads();
  // prologue: step-major tables of v*dt, cos(w*dt), sin(w*dt); dead lanes
  // (k >= K) stand still (v*dt = 0, cos = 1, sin = 0)
  for (int i = tid; i < H * kLanes; i += kThreads) {
    const int t = i / kLanes, s = i % kLanes;
    float vdt = 0.0f, c = 1.0f, sn = 0.0f;
    if (s < nb) {
      const float theta = area[count + s * H + t] * p.dt;
      vdt = area[s * H + t] * p.dt;
      c = cosf(theta);
      sn = sinf(theta);
    }
    tab[i] = vdt;
    tab[H * kLanes + i] = c;
    tab[2 * H * kLanes + i] = sn;
  }
  __syncthreads();

  const size_t plane = (size_t)p.N * H * K;  // channel stride of out
  float* out = p.out + (size_t)n * H * K + k0;
  const int chunks = (H + kChunk - 1) / kChunk;
  float* ring = area;  // (kSlots, kFields, kChunk, 32)

  if (warp == 0) {
    // the chain warp. The step loop stays rolled and the exact recompute out
    // of line, so that the hot loop's code (~400 instructions) stays in the
    // instruction cache.
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % kSlots;
      if (kSplit) bar_wait(empty + slot, ((c / kSlots) & 1) ^ 1);
      float* r = ring + slot * (kFields * kChunk * kLanes) + lane;
      const int steps = min(kChunk, H - c * kChunk);
#pragma unroll 1
      for (int j = 0; j < steps; ++j) {
        const int t = c * kChunk + j;
        const float vdt = tab[t * kLanes + lane];
        const float cs = tab[(H + t) * kLanes + lane];
        const float sn = tab[(2 * H + t) * kLanes + lane];
        Exact e;
        const Pose o = advance(e, p, x, y, hx, hy, hz, vdt, cs, sn, res, x_min, y_min);
        if (kSplit) {
          const float f[kFields] = {o.x,  o.y,  o.height, o.ox, o.oy,
                                    o.oz, o.nx, o.ny,     o.nz};
#pragma unroll
          for (int m = 0; m < (kWheels ? kFields : 6); ++m)
            r[(m * kChunk + j) * kLanes] = f[m];
        } else if (lane < nb) {
          emit<kWheels>(p, out, plane, (size_t)t * K + lane, o.x, o.y,
                        o.height, o.ox, o.oy, o.oz, o.nx, o.ny, o.nz, res,
                        x_min, y_min);
        }
        x = o.x;
        y = o.y;
        hx = o.ox;
        hy = o.oy;
        hz = o.oz;
      }
      if (kSplit) bar_arrive(full + slot);
    }
  } else if (kSplit) {
    // a store warp: step `j` of every chunk
    const int j = warp - 1;
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % kSlots;
      const int t = c * kChunk + j;
      bar_wait(full + slot, (c / kSlots) & 1);
      if (t < H && lane < nb) {
        const float* r = ring + slot * (kFields * kChunk * kLanes) + lane;
        float f[kFields];
#pragma unroll
        for (int m = 0; m < (kWheels ? kFields : 6); ++m)
          f[m] = r[(m * kChunk + j) * kLanes];
        if (!kWheels) f[6] = f[7] = f[8] = 0.0f;
        emit<kWheels>(p, out, plane, (size_t)t * K + lane, f[0], f[1], f[2],
                      f[3], f[4], f[5], f[6], f[7], f[8], res, x_min, y_min);
      }
      bar_arrive(empty + slot);
    }
  }
}

}  // namespace

// rollout25d_f32's contract at stage 1 or 2.
extern "C" int rollout25d_stage_f32(
    const float* z, int rows, int cols, const float* res, const float* x_min,
    const float* y_min, const float* pos, long long pos_sn, long long pos_sc,
    const float* head, long long head_sn, long long head_sc, const float* lin,
    long long lin_sn, const float* ang, long long ang_sn, float* out, int N,
    int K, int H, float dt, int wheels, void* stream, int stage) {
  static bool opted[4][64];
  const Params p = params(z, rows, cols, res, x_min, y_min, pos, pos_sn, pos_sc,
                          head, head_sn, head_sc, lin, lin_sn, ang, ang_sn, out,
                          N, K, H, dt);
  if (stage == 1)
    return wheels ? launch(rollout25d_step_kernel<true, false>, opted[0], p, stream)
                  : launch(rollout25d_step_kernel<false, false>, opted[1], p, stream);
  if (stage == 2)
    return wheels ? launch(rollout25d_step_kernel<true, true>, opted[2], p, stream)
                  : launch(rollout25d_step_kernel<false, true>, opted[3], p, stream);
  return (int)cudaErrorInvalidValue;
}
