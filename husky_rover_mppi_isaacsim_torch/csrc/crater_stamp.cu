// The crater stamp for Hopper (sm_90a): every live slot's (P, P) patch
// added into a guarded block raster at its placement, in slot order.
//
// Not a port of a TPU kernel: the JAX package has no Pallas kernel here.
// It stamps a block's craters inside one jitted program
// (husky_rover_mppi_isaacsim_tpu/terrain/craters.py:269-294, render_crater_block):
// a lax.scan over chunks of a lax.scan of dynamic_update_slice adds, over a
// tier padded to a fixed capacity whose masked slots add zero patches. This
// kernel is the port's route to that one program: one launch per radius tier
// instead of one slice add per live crater.
//
// Semantics (the plain version, terrain/craters.py::stamp_patches): for
// s = 0 .. slots-1 with mask[s], buf[row0[s] + i, col0[s] + j] += patch[s, i, j].
// Placements are clamped into the raster by the caller, so every patch fits.
//
// Design: one thread block owns a 32 x 32 tile of the raster and keeps its
// pixels in registers (256 threads, 4 rows each). It walks the slots in
// order, 256 at a time: each thread tests one slot (live, and its patch
// rectangle overlaps the tile), a ballot and a block-wide prefix count
// write the overlapping slots' indices to shared memory in slot order, and
// every thread then adds those slots' patch values to its pixels. Each
// pixel so sums the same float32 values in the same order as the plain
// version's sequential slice adds (which start from the same raster), so
// the result is bit-equal by construction: no atomics, no reordering.
//
// What bounds it on this card: bytes. Each live patch pixel is read once by
// the one tile it lands in, and a tile that some patch covers is read and
// written once (a tile no patch covers is not touched); the work per byte
// is one add. The slot walk costs each block ~10 instructions
// per 256 slots (1600 slots at most per tier), and a tile overlaps a few
// patches, so the launch is far from its compute limit. A patch row is read
// by neighbouring threads at neighbouring addresses (coalesced, though not
// 16-byte aligned where a placement is odd).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // tile side in pixels
constexpr int kRowsPerThread = 4;         // 32 x 8 threads, 4 rows each
constexpr int kThreadRows = kTile / kRowsPerThread;
constexpr int kThreads = kTile * kThreadRows;  // 256: one slot each per round
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) crater_stamp_kernel(
    float* __restrict__ buf, int height, int width,
    const float* __restrict__ patches, const int* __restrict__ row0,
    const int* __restrict__ col0, const uint8_t* __restrict__ mask, int slots,
    int patch_px) {
  __shared__ int s_slot[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int s_col[kThreads];
  __shared__ int s_warp[kWarps];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int tile_r = blockIdx.y * kTile, tile_c = blockIdx.x * kTile;
  const int col = tile_c + tx;
  const bool col_in = col < width;

  // The tile's pixels are loaded at the first round that finds a slot over
  // the tile, and stored only if one did: a tile no patch touches moves no
  // raster bytes. `touched` is the same in every thread of the block.
  float acc[kRowsPerThread];
  bool touched = false;

  const size_t patch_size = (size_t)patch_px * patch_px;
  for (int base = 0; base < slots; base += kThreads) {
    // this round's overlapping live slots, compacted in slot order
    const int s = base + tid;
    int r = 0, c = 0;
    bool hit = false;
    if (s < slots && mask[s]) {
      r = row0[s];
      c = col0[s];
      hit = r < tile_r + kTile && r + patch_px > tile_r && c < tile_c + kTile &&
            c + patch_px > tile_c;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = s_warp[w];
      offset += w < warp ? cnt : 0;
      n += cnt;
    }
    if (hit) {
      const int at = offset + __popc(ballot & ((1u << lane) - 1u));
      s_slot[at] = s;
      s_row[at] = r;
      s_col[at] = c;
    }
    __syncthreads();
    if (n > 0 && !touched) {
      touched = true;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int row = tile_r + ty + k * kThreadRows;
        acc[k] = (col_in && row < height) ? buf[(size_t)row * width + col] : 0.0f;
      }
    }
    for (int i = 0; i < n; ++i) {
      const int pr0 = s_row[i], pc = col - s_col[i];
      if (!col_in || pc < 0 || pc >= patch_px) continue;
      const float* patch = patches + (size_t)s_slot[i] * patch_size + pc;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int pr = tile_r + ty + k * kThreadRows - pr0;
        if (pr >= 0 && pr < patch_px) acc[k] += __ldg(patch + (size_t)pr * patch_px);
      }
    }
    __syncthreads();  // s_slot / s_warp are rewritten by the next round
  }

  if (!touched) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = tile_r + ty + k * kThreadRows;
    if (col_in && row < height) buf[(size_t)row * width + col] = acc[k];
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. Device pointers to contiguous data:
// buf (height, width) float32, read and written in place; patches (slots,
// patch_px, patch_px) float32; row0, col0 (slots,) int32 placements of each
// patch's first row and column in buf, with 0 <= row0 <= height - patch_px
// and 0 <= col0 <= width - patch_px; mask (slots,) bool (one byte each).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int crater_stamp_f32(float* buf, int height, int width, const float* patches,
                                const int* row0, const int* col0, const uint8_t* mask,
                                int slots, int patch_px, void* stream) {
  if (height <= 0 || width <= 0 || slots <= 0) return (int)cudaSuccess;
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  const dim3 block(kTile, kThreadRows);
  crater_stamp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, height, width, patches, row0, col0, mask, slots, patch_px);
  return (int)cudaGetLastError();
}
