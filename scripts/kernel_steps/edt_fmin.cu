// K2's design step before the DPX min, for timing what the three-way DPX min
// buys (scripts/torch_kernel_variants.py): K2's kernel with two float mins
// per candidate pair in place of the DPX min. Not a source on its own: the
// script appends it to
// husky_rover_mppi_isaacsim_torch/csrc/edt_minplus.cu and builds the two as
// one. No costmap path launches it.

namespace {

__device__ __forceinline__ void pair_fmin(float (&acc)[ROWS][COLS], const float (&yf)[ROWS],
                                          float ka, float kb, float4 ga, float4 gb) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const float da = yf[r] - ka;
        const float oa = da * da;
        const float db = yf[r] - kb;
        const float ob = db * db;
        acc[r][0] = fminf(fminf(acc[r][0], oa + ga.x), ob + gb.x);
        acc[r][1] = fminf(fminf(acc[r][1], oa + ga.y), ob + gb.y);
        acc[r][2] = fminf(fminf(acc[r][2], oa + ga.z), ob + gb.z);
        acc[r][3] = fminf(fminf(acc[r][3], oa + ga.w), ob + gb.w);
    }
}

__global__ void __launch_bounds__(THREADS)
minplus_fmin_kernel(const float* __restrict__ g2, float* __restrict__ out, int R, int C) {
    __shared__ __align__(128) float ring[STAGES][TILE_K][TILE_X];
    __shared__ uint64_t full[STAGES], empty[STAGES];

    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * TILE_X;
    const int y0 = blockIdx.y * TILE_Y;
    const int tiles = (R + TILE_K - 1) / TILE_K;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            bar_init(full + s, 32);
            bar_init(empty + s, CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // the producer warp: g2[k0 : k0 + kn, x0 : x0 + xn] into stage t % STAGES
        const int lane = tid - CONSUMERS;
        const int xn = min(TILE_X, C - x0);
        // every row slice is 16-byte aligned and sized
        const bool bulk = (C % 4) == 0 && (reinterpret_cast<uintptr_t>(g2) & 15) == 0;
        for (int t = 0; t < tiles; ++t) {
            const int s = t % STAGES;
            const int k0 = t * TILE_K;
            const int kn = min(TILE_K, R - k0);
            bar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
            if (bulk) {
                if (lane == 0) bar_arrive_tx(full + s, (uint32_t)(kn * xn * 4));
                __syncwarp();
                if (lane < kn)
                    bulk_load(&ring[s][lane][0], g2 + (size_t)(k0 + lane) * C + x0,
                              (uint32_t)(xn * 4), full + s);
                if (lane != 0) bar_arrive(full + s);
            } else {
                // rows not 16-byte aligned: coalesced loads, 16 rows in flight
                // per lane, then shared-memory stores
                for (int k = 0; k < kn; k += 16) {
                    float v[16][2];
#pragma unroll
                    for (int q = 0; q < 16; ++q)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int xx = lane + 32 * h;
                            v[q][h] = k + q < kn && xx < xn
                                          ? __ldg(g2 + (size_t)(k0 + k + q) * C + x0 + xx)
                                          : 0.0f;
                        }
#pragma unroll
                    for (int q = 0; q < 16; ++q)
#pragma unroll
                        for (int h = 0; h < 2; ++h) ring[s][k + q][lane + 32 * h] = v[q][h];
                }
                bar_arrive(full + s);
            }
        }
        return;
    }

    // a consumer thread: rows y0 + ry*8 .. +7, columns x0 + cx*4 .. +3
    const int cx = tid % GROUPS_X;
    const int ry = tid / GROUPS_X;
    float yf[ROWS];
    float acc[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        yf[r] = static_cast<float>(y0 + ry * ROWS + r);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = __int_as_float(0x7f800000);  // +inf
    }

    for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        const int k0 = t * TILE_K;
        const int kn = min(TILE_K, R - k0);
        bar_wait(full + s, (t / STAGES) & 1);
        const float4* row = reinterpret_cast<const float4*>(&ring[s][0][cx * COLS]);
        constexpr int kStride = TILE_X / COLS;  // float4s per ring row
        const float kf = static_cast<float>(k0);
        if (kn == TILE_K) {
#pragma unroll 4
            for (int kk = 0; kk < TILE_K; kk += 2)
                pair_fmin(acc, yf, kf + kk, kf + (kk + 1), row[kk * kStride],
                            row[(kk + 1) * kStride]);
        } else {
            // a ragged last tile: an odd row pairs with itself
            for (int kk = 0; kk < kn; kk += 2) {
                const int k1 = min(kk + 1, kn - 1);
                pair_fmin(acc, yf, kf + kk, kf + k1, row[kk * kStride], row[k1 * kStride]);
            }
        }
        bar_arrive(empty + s);
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int y = y0 + ry * ROWS + r;
        if (y >= R) break;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const int x = x0 + cx * COLS + c;
            if (x < C) out[static_cast<size_t>(y) * C + x] = acc[r][c];
        }
    }
}

}  // namespace

// edt_minplus_f32's contract with two float mins per pair.
extern "C" int edt_minplus_fmin_f32(const float* g2, float* out, int R, int C, void* stream) {
    if (R <= 0 || C <= 0) return 0;
    const dim3 grid((C + TILE_X - 1) / TILE_X, (R + TILE_Y - 1) / TILE_Y);
    minplus_fmin_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g2, out, R, C);
    return static_cast<int>(cudaGetLastError());
}
