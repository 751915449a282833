// Kernel K2: the column lower envelope of the exact squared EDT, a min-plus
// product
//
//     out[y, x] = min_{y'} (y - y')^2 + g2[y', x],   g2, out: (R, C) float32.
//
// Replaces the Pallas TPU kernel
// husky_rover_mppi_isaacsim_tpu/ops/edt_pallas.py::_minplus_kernel (launched
// by edt_minplus_pallas). Plain version: minplus_envelope in
// husky_rover_mppi_isaacsim_torch/ops/edt.py, which evaluates the same
// candidates in row blocks through a (block, R, C) float32 temporary.
//
// What bounds it: R * R * C candidates (3.4e9 at 1500^2) against 2 * R * C
// * 4 bytes of data (18 MB at 1500^2): operations. Each candidate needs one
// float32 add (no FMA applies), and one three-way min settles two
// candidates, so the function needs at least 1.5 instructions per
// candidate: ~0.151 ms at 1500^2 at the issue rate of 128 lanes x 132 SMs x
// 1.98 GHz. This kernel issues 2 + 1/32 per candidate (below), ~0.205 ms at
// that rate before loop, barrier and tail costs. The first port spent four
// instructions per candidate (it formed (y - y')^2 once per column) and two
// __syncthreads per 32-row tile of g2.
//
// Design: each block owns a 64 x 64 output tile. Its 4 consumer warps give
// each thread an 8-row x 4-column register micro-tile: the thread forms
// d^2 = (float(y) - float(y'))^2 once per (row, y') and reuses it across its
// 4 columns, and reads the 4 g2 values of a y' row as one 16-byte shared-
// memory load. y' goes in pairs, and the two candidates of a pair meet the
// running minimum in one three-way DPX integer min (__vimin3_s32, Hopper's
// DPX unit) on their float bits, so a candidate costs an add and half a min
// plus 17/32 of an instruction (the offset's subtract and square, shared by
// 4 columns, and 1/32 of the load). A fifth, producer warp streams 32-row
// tiles of g2 through a 3-stage shared-memory ring: one 1-D bulk
// asynchronous copy per tile row (cp.async.bulk, the TMA's 1-D form) where
// rows are 16-byte aligned (C a multiple of 4, g2 16-byte aligned), and
// coalesced loads batched 32 to a lane otherwise; each stage is guarded by
// a full and an empty mbarrier, so no __syncthreads is left in the sweep.
// Ragged edges are bounds checks; nothing is padded. The same kernel with
// two float mins per pair, which scripts/torch_kernel_variants.py times
// against this one, is built from scripts/kernel_steps/edt_fmin.cu.
//
// Exactness: the offset is float(y) - float(y') squared, as the plain
// version forms it, and it is exact while R <= 4096 ((R-1)^2 < 2^24); the
// wrapper refuses larger R. Each candidate is exactly one float32 add of the
// offset and g2 (the build passes -fmad=false, so d * d + g is never fused),
// and a float32 min does not depend on order, so the kernel equals the plain
// version bit for bit, the _BIG sentinel of an obstacle-free map included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 64;           // output columns per block
constexpr int TILE_Y = 64;           // output rows per block
constexpr int COLS = 4;              // columns per thread (one float4)
constexpr int ROWS = 8;              // rows per thread
constexpr int GROUPS_X = TILE_X / COLS;                 // 16
constexpr int CONSUMERS = GROUPS_X * (TILE_Y / ROWS);   // 128 threads
constexpr int THREADS = CONSUMERS + 32;                 // + the producer warp
constexpr int TILE_K = 32;           // y' rows of g2 per stage
constexpr int STAGES = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed. A phase
// that never completes is a fault: trap after ~10 s instead of hanging.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    const long long start = clock64();
    uint32_t done = 0;
    while (true) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (done) return;
        if (clock64() - start > 20000000000LL) __trap();
    }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// The running minimum over candidates c0 = o0 + g0 and c1 = o1 + g1. Every
// candidate is a non-negative, non-NaN float32 (the 1e12 sentinel and the
// +inf start included), so its bits order as int32 and the three-way
// integer min of Hopper's DPX unit gives the float min exactly.
__device__ __forceinline__ float min2(float acc, float c0, float c1) {
    return __int_as_float(__vimin3_s32(__float_as_int(acc), __float_as_int(c0),
                                       __float_as_int(c1)));
}

// One y' pair (ka, kb) of the consumer's sweep: rows yf, g2 rows ga, gb.
__device__ __forceinline__ void pair(float (&acc)[ROWS][COLS], const float (&yf)[ROWS],
                                     float ka, float kb, float4 ga, float4 gb) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const float da = yf[r] - ka;
        const float oa = da * da;
        const float db = yf[r] - kb;
        const float ob = db * db;
        acc[r][0] = min2(acc[r][0], oa + ga.x, ob + gb.x);
        acc[r][1] = min2(acc[r][1], oa + ga.y, ob + gb.y);
        acc[r][2] = min2(acc[r][2], oa + ga.z, ob + gb.z);
        acc[r][3] = min2(acc[r][3], oa + ga.w, ob + gb.w);
    }
}

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ g2, float* __restrict__ out, int R, int C) {
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
                pair(acc, yf, kf + kk, kf + (kk + 1), row[kk * kStride],
                            row[(kk + 1) * kStride]);
        } else {
            // a ragged last tile: an odd row pairs with itself
            for (int kk = 0; kk < kn; kk += 2) {
                const int k1 = min(kk + 1, kn - 1);
                pair(acc, yf, kf + kk, kf + k1, row[kk * kStride], row[k1 * kStride]);
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

// Launch K2 on `stream`: g2 and out are contiguous (R, C) float32 on the
// card, R <= 4096. Returns the launch's cudaError_t (0 on success).
extern "C" int edt_minplus_f32(const float* g2, float* out, int R, int C, void* stream) {
    if (R <= 0 || C <= 0) return 0;
    const dim3 grid((C + TILE_X - 1) / TILE_X, (R + TILE_Y - 1) / TILE_Y);
    minplus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g2, out, R, C);
    return static_cast<int>(cudaGetLastError());
}

