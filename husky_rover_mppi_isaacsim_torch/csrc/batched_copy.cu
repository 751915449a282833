// Batched copy: the static inputs of a replayed CUDA graph filled from their
// sources in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel. A jitted JAX loop takes its arguments as the
// program's own buffers; a captured torch.cuda.CUDAGraph reads fixed static
// input buffers, so core/graphs.py::Graphed copies every argument tensor into
// its buffer before each replay. Issued as one eager copy_ a tensor, that
// copy-in was the largest part of the host's work between replays (~11
// copy_ calls a goal-seek replay, ~20 a fleet step, each a dispatch and a
// launch). This kernel does all of them in one launch on the current stream.
//
// Design: the copies come as a kernel parameter (a Batch of at most
// kCapacity Copy records, 4040 bytes, under the 4 KB parameter limit):
// nothing is uploaded and no table is kept on the device. The host entry
// splits a longer list into several launches. Each copy gets its own run of
// blocks (Batch::first); a block finds its copy by a binary search of first[]
// in parameter space (__grid_constant__: read in place, not copied to local
// memory). The destination is dense and walked in its own memory order (the
// wrapper permutes the source's strides into that order and merges the dims
// it can), so the destination is written contiguously:
//   * a source that is contiguous too (rank 1, stride 1) is copied as bytes,
//     16 / 8 / 4 / 2 / 1 at a time, the widest unit that divides both
//     addresses and the length;
//   * a strided source (rank 1 to 4) is read element by element, its offset
//     from the element's index by the walk's sizes and strides, and copied as
//     one load and one store of the element's width (1, 2, 4, 8 or 16 bytes).
// Any dtype copies as its bytes: float32, int64, bool, the keys' uint32 and
// the rest alike. A copy of 0 elements gets no block.
//
// What bounds it: the launch. A goal-seek replay copies ~2 KB, a 64-rover
// fleet step ~60 KB: at the card's 3.35 TB/s that is under 0.02 us, far
// below a launch. batched_copy_floor launches an empty kernel of the same
// grid and block, the yardstick of its time.
//
// Numerics: a copy does no arithmetic; every byte of every destination is
// the source's, as copy_ gives (Graphed falls back to copy_ for a source that
// overlaps a static input, where the order of the copies would matter).

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCapacity = 48;     // copies one launch takes
constexpr int kMaxRank = 4;
constexpr long long kBlockBytes = 16 * kThreads * 4;  // a contiguous copy's bytes a block
constexpr long long kBlockElems = kThreads * 4;       // a strided copy's elements a block
constexpr long long kMaxBlocks = 1024;                // a copy's blocks; they loop beyond

// One copy, as ops/batched_copy_cuda.py packs it (80 bytes, little-endian).
struct Copy {
  long long dst;                // the destination's first byte (dense, walked in memory order)
  long long src;                // the source's first element
  long long numel;              // elements
  int esize;                    // bytes an element: 1, 2, 4, 8 or 16
  int rank;                     // dims of the walk, 1 to kMaxRank
  int size[kMaxRank];           // the walk's sizes, outermost first
  long long stride[kMaxRank];   // the source's strides along the walk, in elements
};
static_assert(sizeof(Copy) == 80, "the wrapper packs 80-byte records");

struct Batch {
  int n;                        // copies
  int first[kCapacity + 1];     // the first block of each copy; first[n] = the grid
  Copy copy[kCapacity];
};
static_assert(sizeof(Batch) <= 4096, "a kernel parameter holds at most 4 KB");

__host__ __device__ inline bool contiguous(const Copy& c) {
  return c.rank == 1 && c.stride[0] == 1;
}

__host__ __device__ inline int unit_of(const Copy& c) {
  const unsigned long long bits = (unsigned long long)c.dst | (unsigned long long)c.src |
                                  (unsigned long long)(c.numel * c.esize);
  for (int u = 16; u > 1; u >>= 1)
    if ((bits & (u - 1)) == 0) return u;
  return 1;
}

template <typename T>
__device__ inline void copy_units(const Copy& c, long long i, long long step) {
  T* __restrict__ dst = reinterpret_cast<T*>(c.dst);
  const T* __restrict__ src = reinterpret_cast<const T*>(c.src);
  const long long n = c.numel * c.esize / (long long)sizeof(T);
  for (; i < n; i += step) dst[i] = src[i];
}

template <typename T>
__device__ inline void copy_elements(const Copy& c, long long i, long long step) {
  T* __restrict__ dst = reinterpret_cast<T*>(c.dst);
  const T* __restrict__ src = reinterpret_cast<const T*>(c.src);
  for (; i < c.numel; i += step) {
    long long rest = i, off = 0;
    for (int d = c.rank - 1; d >= 0; --d) {
      const long long s = c.size[d];
      const long long q = rest / s;
      off += (rest - q * s) * c.stride[d];
      rest = q;
    }
    dst[i] = src[off];
  }
}

__global__ void __launch_bounds__(kThreads) batched_copy_kernel(const __grid_constant__ Batch b) {
  const int block = blockIdx.x;
  int lo = 0, hi = b.n - 1;  // the last copy whose first block is at or before this one
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.first[mid] <= block) lo = mid; else hi = mid - 1;
  }
  const Copy& c = b.copy[lo];
  const long long step = (long long)(b.first[lo + 1] - b.first[lo]) * kThreads;
  const long long i = (long long)(block - b.first[lo]) * kThreads + threadIdx.x;
  if (contiguous(c)) {
    switch (unit_of(c)) {
      case 16: copy_units<uint4>(c, i, step); break;
      case 8: copy_units<unsigned long long>(c, i, step); break;
      case 4: copy_units<unsigned int>(c, i, step); break;
      case 2: copy_units<unsigned short>(c, i, step); break;
      default: copy_units<unsigned char>(c, i, step); break;
    }
    return;
  }
  switch (c.esize) {
    case 16: copy_elements<uint4>(c, i, step); break;
    case 8: copy_elements<unsigned long long>(c, i, step); break;
    case 4: copy_elements<unsigned int>(c, i, step); break;
    case 2: copy_elements<unsigned short>(c, i, step); break;
    default: copy_elements<unsigned char>(c, i, step); break;
  }
}

// The launch floor: the batch's grid and block, no loads, no stores.
__global__ void __launch_bounds__(kThreads) batched_copy_floor_kernel() {}

long long blocks_of(const Copy& c) {
  if (c.numel <= 0) return 0;
  const long long per = contiguous(c) ? kBlockBytes : kBlockElems;
  const long long work = contiguous(c) ? c.numel * c.esize : c.numel;
  const long long blocks = (work + per - 1) / per;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// The batch of records [s, s + n) of `rows` and its grid.
int fill(Batch* b, const char* rows, int s, int n) {
  b->n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    memcpy(&b->copy[i], rows + (size_t)(s + i) * sizeof(Copy), sizeof(Copy));
    b->first[i] = blocks;
    blocks += (int)blocks_of(b->copy[i]);
  }
  b->first[n] = blocks;
  return blocks;
}

}  // namespace

extern "C" int batched_copy_capacity() { return kCapacity; }

// Plain C entry, loaded with ctypes. `rows`: n packed Copy records in host
// memory, their device addresses on `device`. Copies all of them on `stream`,
// kCapacity records a launch, in order; a launch whose copies are all empty
// is not made. Returns the launches made, or -cudaError of the first that
// failed (cudaGetLastError() after each).
extern "C" int batched_copy(const void* rows, int n, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int launches = 0;
  Batch b;
  for (int s = 0; s < n; s += kCapacity) {
    const int blocks = fill(&b, static_cast<const char*>(rows), s, n - s < kCapacity ? n - s : kCapacity);
    if (blocks == 0) continue;
    batched_copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(b);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    ++launches;
  }
  if (current != device) cudaSetDevice(current);
  return err == cudaSuccess ? launches : -(int)err;
}

// The grid of the first launch of `rows` (its first kCapacity records).
extern "C" int batched_copy_blocks(const void* rows, int n) {
  Batch b;
  return fill(&b, static_cast<const char*>(rows), 0, n < kCapacity ? n : kCapacity);
}

// The empty kernel at a batch's launch shape of `blocks` blocks, on `stream`;
// returns cudaGetLastError(). It is the yardstick of the batch's time, not a
// part of it.
extern "C" int batched_copy_floor(int blocks, void* stream) {
  if (blocks <= 0) return (int)cudaSuccess;
  batched_copy_floor_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
