// The crater block kernel for Hopper (sm_90a): every live crater of a radius
// tier rendered and added into a guarded block raster, in slot order, in
// one launch. No patch is ever stored: each covered pixel's height is
// computed in registers and added to the pixel's accumulator.
//
// Not a port of a TPU kernel: the JAX package has no Pallas kernel here.
// Its counterpart is one jitted program,
// husky_rover_mppi_isaacsim_tpu/terrain/craters.py:227-296
// (render_crater_block): a lax.scan over chunks that renders each chunk's
// (P, P) patches (_render_patches, :174-224) and scans
// dynamic_update_slice adds of them into the raster.
//
// Semantics (the plain version, terrain/craters.py::crater_block_plain:
// _render_patches, then stamp_patches): for s = 0 .. slots-1 with mask[s],
// buf[row0[s] + i, col0[s] + j] += h(s, i, j) for 0 <= i, j < P, where h is
// _render_patches' height of slot s at patch pixel (i, j), zero outside the
// crater's square max(|i - P/2|, |j - P/2|) <= half_px. A pixel outside the
// square is skipped instead of adding 0.0 (equal under torch.equal).
//
// Bit-equality: with the plain version, and so with the JAX package. The
// plain version evaluates each operation as XLA's CPU code for the JAX
// package's jitted render does (terrain/craters.py::_render_patches, on
// core/xla_math.py), and this kernel does the same operations in the same
// order: every float operation a _rn intrinsic, with __fmaf_rn where the
// CPU code fuses (ur = fma(sa, v, ca u), vr = fma(ca, v, -(sa u)), theta =
// fma(atan2, 1/(2 pi), 1/2), the three table lookups, ur^2 + q^2, m + marks
// sat); the atan2 arguments fuse only for patches wider than 56 pixels
// (atan2_fused), as XLA's unrolled pixel loop decides. x**2 is x*x, true
// divisions are __fdiv_rn, torch.where's choices are kept (the envelope is
// 1 where mu1 <= m <= mu2; m is half_px outside the rotated square, then
// clamped to it). Scalars arrive as torch rounds them: Python floats cast
// to float32 (the constants below are static_casts of the same doubles).
// cosf, sinf, atan2f and expf are not libdevice's but the device copies of
// glibc's and XLA's in xla_math.cuh. The source builds with -fmad=false
// like the others; its arithmetic is all intrinsics either way.
//
// Design: the host bins the live slots by 32 x 32 tile of the raster
// (ops/crater_block_cuda.py::tile_bins: each slot's nonzero square, not
// its whole patch, listed in every tile it overlaps, each tile's list in
// slot order) and the launch has one thread block per covered tile. A
// block keeps its tile's pixels in registers (256 threads, 4 rows each),
// stages up to 256 of its slots at a time in shared memory with what
// _render_patches computes once per crater (half_px, cos and sin of the
// rotation, the envelope's mu1, mu2 and std, the table rows), and adds the
// slots' heights to its pixels in list order. Each pixel so sums the same
// float32 values in the same order as the plain version's slice adds: no
// atomics, deterministic. A tile no crater covers is not launched.
//
// What bounds it on this card: by count, bytes (a read and a write of
// every covered raster pixel, ~35 MB a streamed block: ~0.01 ms) over its
// arithmetic (~2.9 M (slot, pixel) pairs a block at CRATER_OPS_PER_PAIR
// operations each, counting an IEEE atan2, exp, square root or true
// division as one); in practice the arithmetic binds, since those
// functions (glibc's atan2f alone is a division and ~30 float operations)
// and the three table lookups (through the read-only cache; each table is
// num_profiles x 256 floats) take many instructions each. The design keeps
// both counts at what the function needs: only covered tiles are touched,
// each once, and a tile visits only its own slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

constexpr int kTile = 32;                 // tile side in pixels
constexpr int kRowsPerThread = 4;         // 32 x 8 threads, 4 rows each
constexpr int kThreadRows = kTile / kRowsPerThread;
constexpr int kThreads = kTile * kThreadRows;  // 256: one slot each per staging round
constexpr int kTable = 256;                    // craters.py TABLE_SIZE

// torch's scalars: Python floats cast to float32
constexpr float kDeg2Rad = static_cast<float>(0.017453292519943295769236907684886127134428718885417);
constexpr float kInv2Pi = static_cast<float>(1.0 / (2.0 * 3.141592653589793));
constexpr float kMu1 = static_cast<float>(0.15);
constexpr float kMu2 = static_cast<float>(0.45);
constexpr float kStd = static_cast<float>(0.05);
constexpr float kStdMin = static_cast<float>(1e-6);
constexpr float kHalfNeg = static_cast<float>(-0.5);

// _table_lookup at one point: clamp, scale, floor, then the lerp as XLA
// fuses it: fma(v1, frac, v0 (1 - frac)), or with lead_v0 (the marks
// table's order) fma(v0, 1 - frac, v1 frac)
template <bool lead_v0>
__device__ __forceinline__ float table_lookup(const float* __restrict__ row, float x) {
  const float pos = __fmul_rn(fminf(fmaxf(x, 0.0f), 1.0f), static_cast<float>(kTable - 1));
  const float f0 = floorf(pos);
  const int i0 = static_cast<int>(f0);
  const int i1 = min(i0 + 1, kTable - 1);
  const float frac = __fsub_rn(pos, f0);
  const float v0 = __ldg(row + i0), v1 = __ldg(row + i1);
  return lead_v0 ? __fmaf_rn(v0, __fsub_rn(1.0f, frac), __fmul_rn(v1, frac))
                 : __fmaf_rn(v1, frac, __fmul_rn(v0, __fsub_rn(1.0f, frac)));
}

__global__ void __launch_bounds__(kThreads) crater_block_kernel(
    float* __restrict__ buf, int side, int tiles_x, const int* __restrict__ tile_ids,
    const int* __restrict__ tile_start, const int* __restrict__ tile_slots,
    const float* __restrict__ radius, const float* __restrict__ rotation,
    const float* __restrict__ xy_factor, const float* __restrict__ marks_intensity,
    const int* __restrict__ deformation_id, const int* __restrict__ marks_id,
    const int* __restrict__ profile_id, const int* __restrict__ row0,
    const int* __restrict__ col0, const float* __restrict__ deformation_table,
    const float* __restrict__ marks_table, const float* __restrict__ height_table,
    int patch_px, int atan2_fused, float resolution, float z_scale) {
  // one staging round of slots, in list order
  __shared__ float s_half[kThreads], s_ca[kThreads], s_sa[kThreads], s_mu1[kThreads];
  __shared__ float s_mu2[kThreads], s_std[kThreads], s_hclamp[kThreads], s_xf[kThreads];
  __shared__ float s_mi[kThreads], s_radius[kThreads];
  __shared__ int s_row[kThreads], s_col[kThreads], s_def[kThreads], s_marks[kThreads];
  __shared__ int s_prof[kThreads];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int tile = tile_ids[blockIdx.x];
  const int tile_r = (tile / tiles_x) * kTile, tile_c = (tile % tiles_x) * kTile;
  const int begin = tile_start[blockIdx.x], end = tile_start[blockIdx.x + 1];
  const int col = tile_c + tx;
  const bool col_in = col < side;
  const int center = patch_px / 2;

  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = tile_r + ty + k * kThreadRows;
    acc[k] = (col_in && row < side) ? buf[(size_t)row * side + col] : 0.0f;
  }

  for (int base = begin; base < end; base += kThreads) {
    const int n = min(kThreads, end - base);
    if (tid < n) {
      // what _render_patches computes once per crater, in its order
      const int s = tile_slots[base + tid];
      const float r = radius[s];
      const float half = floorf(__fdiv_rn(r, resolution));
      const float ang = __fmul_rn(rotation[s], kDeg2Rad);
      s_half[tid] = half;
      s_ca[tid] = xla_math::cos_f32(ang);
      s_sa[tid] = xla_math::sin_f32(ang);
      s_mu1[tid] = __fmul_rn(half, kMu1);
      s_mu2[tid] = __fmul_rn(half, kMu2);
      s_std[tid] = fmaxf(__fmul_rn(half, kStd), kStdMin);
      s_hclamp[tid] = fmaxf(half, 1.0f);
      s_xf[tid] = xy_factor[s];
      s_mi[tid] = marks_intensity[s];
      s_radius[tid] = r;
      s_row[tid] = row0[s];
      s_col[tid] = col0[s];
      s_def[tid] = deformation_id[s] * kTable;
      s_marks[tid] = marks_id[s] * kTable;
      s_prof[tid] = profile_id[s] * kTable;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int j = col - s_col[i];  // the pixel's patch column
      const float half = s_half[i];
      const float v = static_cast<float>(j - center);
      if (!col_in || j < 0 || j >= patch_px || fabsf(v) > half) continue;
      const float ca = s_ca[i], sa = s_sa[i];
      const float hclamp = s_hclamp[i];
      const float cav = __fmul_rn(ca, v), sav = __fmul_rn(sa, v);  // the unfused atan2 arguments'
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int row = tile_r + ty + k * kThreadRows;
        const int pi = row - s_row[i];  // the pixel's patch row
        const float u = static_cast<float>(pi - center);
        if (row >= side || pi < 0 || pi >= patch_px || fabsf(u) > half) continue;
        const float cau = __fmul_rn(ca, u), sau = __fmul_rn(sa, u);
        const float ur = __fmaf_rn(sa, v, cau);
        const float vr = __fmaf_rn(ca, v, -sau);
        float m = half;  // outside the rotated square
        if (fmaxf(fabsf(ur), fabsf(vr)) <= half) {
          const float angle = atan2_fused ? xla_math::atan2_f32(ur, vr)
                                          : xla_math::atan2_f32(__fadd_rn(cau, sav),
                                                                __fsub_rn(cav, sau));
          const float theta = __fmaf_rn(angle, kInv2Pi, 0.5f);
          const float fac = table_lookup<false>(deformation_table + s_def[i], theta);
          const float marks = __fmul_rn(
              __fmul_rn(table_lookup<true>(marks_table + s_marks[i], theta), half), s_mi[i]);
          const float q = __fdiv_rn(vr, s_xf[i]);
          m = __fmul_rn(__fsqrt_rn(__fmaf_rn(ur, ur, __fmul_rn(q, q))), fac);
          float sat = 1.0f;
          if (m < s_mu1[i]) {
            const float d = __fdiv_rn(__fsub_rn(m, s_mu1[i]), s_std[i]);
            sat = xla_math::exp_f32(__fmul_rn(__fmul_rn(d, d), kHalfNeg));
          } else if (m > s_mu2[i]) {
            const float d = __fdiv_rn(__fsub_rn(m, s_mu2[i]), s_std[i]);
            sat = xla_math::exp_f32(__fmul_rn(__fmul_rn(d, d), kHalfNeg));
          }
          m = fminf(__fmaf_rn(marks, sat, m), half);
        }
        const float h = __fmul_rn(
            __fmul_rn(table_lookup<false>(height_table + s_prof[i], __fdiv_rn(m, hclamp)),
                      s_radius[i]),
            z_scale);
        acc[k] = __fadd_rn(acc[k], h);
      }
    }
    __syncthreads();  // the staging arrays are rewritten by the next round
  }

#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = tile_r + ty + k * kThreadRows;
    if (col_in && row < side) buf[(size_t)row * side + col] = acc[k];
  }
}

// the kernel's device copies of the XLA / glibc functions, elementwise, for
// the check against their plain versions (core/xla_math.py)
__global__ void xla_math_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ out, int n, int op) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float x = a[k];
  out[k] = op == 0 ? xla_math::atan2_f32(x, b[k])
         : op == 1 ? xla_math::exp_f32(x)
         : op == 2 ? xla_math::cos_f32(x)
         : op == 3 ? xla_math::sin_f32(x)
                   : xla_math::atan_f32(x);
}

}  // namespace

// Plain C entry, loaded with ctypes. Device pointers to contiguous data:
// buf (side, side) float32, read and written in place; the tile lists of
// ops/crater_block_cuda.py::tile_bins, int32: tile_ids (tiles,) raster
// tiles (row-major over tiles_x = ceil(side / 32) columns), tile_start
// (tiles + 1,) offsets into tile_slots (each tile's live slots in slot
// order); the field's per-slot columns (radius, rotation in degrees, xy
// factor, marks intensity float32; deformation, marks and profile ids
// int32); row0, col0 (slots,) int32 patch corners with every patch inside
// buf; the three profile tables (num_profiles, 256) float32; atan2_fused
// 1 where the patch is wider than 56 pixels (the render's atan2 arguments
// fused, as in the plain version). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int crater_block_f32(float* buf, int side, const int* tile_ids, const int* tile_start,
                                const int* tile_slots, int tiles, const float* radius,
                                const float* rotation, const float* xy_factor,
                                const float* marks_intensity, const int* deformation_id,
                                const int* marks_id, const int* profile_id, const int* row0,
                                const int* col0, const float* deformation_table,
                                const float* marks_table, const float* height_table,
                                int patch_px, int atan2_fused, float resolution,
                                float z_scale, void* stream) {
  if (side <= 0 || tiles <= 0) return (int)cudaSuccess;
  const int tiles_x = (side + kTile - 1) / kTile;
  const dim3 block(kTile, kThreadRows);
  crater_block_kernel<<<tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, side, tiles_x, tile_ids, tile_start, tile_slots, radius, rotation, xy_factor,
      marks_intensity, deformation_id, marks_id, profile_id, row0, col0, deformation_table,
      marks_table, height_table, patch_px, atan2_fused, resolution, z_scale);
  return (int)cudaGetLastError();
}

// The check entry: out[k] = atan2_f32(a[k], b[k]) (op 0), exp_f32(a[k]) (1),
// cos_f32 (2), sin_f32 (3) or atan_f32 (4) of xla_math.cuh, n float32 values
// on the card.
extern "C" int crater_block_xla_math_f32(const float* a, const float* b, float* out, int n,
                                         int op, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  xla_math_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n, op);
  return (int)cudaGetLastError();
}
