// Record reorder kernels for Hopper (sm_90a): the counterparts of the
// record-DMA probes of benchmarks/probe_dma.py and probe_mosaic.py, which
// move whole records of an HBM array by an index list:
//
//   record_gather   dst record i = src record idx[i]. The gathers of
//                   probe_dma.py (pallas_call at :36, :63 and :104) and
//                   probe_mosaic.py:143; on the SoA pool of the regroup
//                   pipeline it applies a binning permutation to the dense
//                   records of a cut.
//   record_scatter  dst record idx[j] = src record j; records not named keep
//                   what dst held. probe_dma.py:145; it also undoes a
//                   binning permutation.
//   dma_rate        probe_dma_rate (probe_dma.py:165-212, pallas_call at
//                   :199): per tile, 32 whole records picked by a
//                   permutation are copied into shared memory, and the sum of
//                   their component 0 is written, broadcast to (8, 128).
//
// A record is one plane of `width` contiguous values, at i * width (the
// rows of an array [rows, W]: ops/cuda/reorder.py's dim 0), or one value in
// each of `pieces` planes, at c * ld + i (the columns of the SoA pool [16,
// cap]: dim 1).
//
// What bounds them on an H100: memory. Each moves every record byte once in
// and once out and reads the index list; nothing is computed. What each
// design does about it (the times are PERF.md's, tools/reorder_steps.py on
// the binned pool: 1.6 M records of 16 planes, 0.0628 ms at the HBM rate):
//
//   Columns (width 1: gather_cols, scatter_cols, invert). Each value is a
//   random 4-byte access, a whole 32-byte sector at the L2, so the random
//   side runs at the L2's sector rate (the gather's random loads alone,
//   stores dropped: 0.088 ms in the binning order, 0.21 ms in a uniformly
//   random one), and only while the planes it points into stay in the L2
//   (a plane of the binned pool is 6.4 MB, its 16 planes 102 MB against
//   the 50 MB L2). So gather_cols takes a plane a block (blockIdx.y;
//   blocks are dispatched plane after plane, so one or two planes are in
//   flight): two or four planes a thread, each index read once for them,
//   cost more L2 misses than the index reads they save. A thread reads its
//   kColRecords indices (the grid's threads apart, so index loads and
//   stores coalesce), issues all their loads, then stores them: no
//   division, a record being one value a plane. Its stores take 64-bit
//   offsets: with 32-bit ones it needed 38 registers, held 6 blocks an SM
//   in place of 8 and was 1-2% slower. A grid of the card's resident
//   blocks walking the planes in a loop was slower.
//   The scatter's random side is its stores: a 4-byte store is a partial
//   sector the L2 must merge, about twice the gather's cost. Where the list
//   names every record of dst (a permutation: the binned path's undo),
//   record_scatter inverts it first (invert: one int32 plane of random
//   stores) and runs gather_cols through the inverse. A shorter list must
//   leave the records it does not name as they were, so it takes
//   scatter_cols, one value a thread (more records or planes a thread were
//   slower there).
//   Rows (width > 1: reorder_rows). A record is contiguous, so a warp's
//   accesses coalesce on both sides; what a copy needs is bytes in flight.
//   A thread moves kRowVecs vectors a step (16 bytes each where widths and
//   addresses allow, else 4), all loaded before any is stored, on the
//   blocks the card holds at once; where the card's resident threads cover
//   the items, one vector a thread (the probes' shapes, where a launch is
//   the time: 4 vectors a thread there took 0.00008-0.00015 ms more a
//   call). Records of 1 KiB and more moved whole by cp.async.bulk through
//   shared memory were slower at 4 KiB and 16 KiB.
//   dma_rate reads each record once into shared memory with asynchronous
//   16-byte copies (cp.async), all 32 records of a tile in flight together,
//   then reduces 4096 values from shared memory and writes 4 KiB; its tile
//   of 32 x 11 x 128 f32 (176 KiB) leaves room for one block per SM, so a
//   tile's reduction and store are not overlapped with its own loads, only
//   with other SMs'.
//
// The sum order of dma_rate is fixed and the plain version in reorder.py
// repeats it, so the two agree in every bit: thread t adds values
// t, t + 256, t + 512, ... of the tile's 32 x 128 component-0 values in
// turn from 0.0f, each warp halves its 32 partial sums five times, and the
// 8 warp sums are added in warp order. The other kernels move values and
// agree with their plain versions in every bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "card.cuh"

namespace {

constexpr int kThreads = 256;
// The designs' constants (tools/reorder_steps.py builds other values):
constexpr int kColRecords = 4;  // records a column thread moves
constexpr int kRowVecs = 4;     // vectors a row thread has in flight a step
constexpr int kRateRecords = 32;  // records per tile (probe_dma.py:180-194)
constexpr int kRateWarps = kThreads / 32;
constexpr int kOutTile = 8 * 128;  // floats of a tile's (8, 128) output block

// dst[c * dst_ld + i] = src[c * src_ld + idx[i]] for the plane c =
// blockIdx.y and records i < n: a thread's kColRecords records lie the
// grid's threads apart (gridDim.x covers n in kColRecords passes), so each
// pass of the grid reads the index list and writes dst coalesced.
__global__ void __launch_bounds__(kThreads)
    gather_cols(const float* __restrict__ src, float* __restrict__ dst,
                const int* __restrict__ idx, unsigned n, long long src_ld, long long dst_ld) {
  const unsigned threads = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  const float* s = src + blockIdx.y * src_ld;
  float* d = dst + blockIdx.y * dst_ld;
  int at[kColRecords];
#pragma unroll
  for (int u = 0; u < kColRecords; ++u) {
    const unsigned i = first + u * threads;
    at[u] = i < n ? __ldg(idx + i) : -1;
  }
  float v[kColRecords];
#pragma unroll
  for (int u = 0; u < kColRecords; ++u) {
    if (at[u] >= 0) v[u] = __ldg(s + at[u]);
  }
#pragma unroll
  for (int u = 0; u < kColRecords; ++u) {
    if (at[u] >= 0) d[static_cast<long long>(first) + u * threads] = v[u];
  }
}

// dst[c * dst_ld + idx[j]] = src[c * src_ld + j]: one value a thread,
// blockIdx.y its plane (blocks are dispatched plane after plane, so the
// planes in flight are one or two), the stores where the list points.
__global__ void __launch_bounds__(kThreads)
    scatter_cols(const float* __restrict__ src, float* __restrict__ dst,
                 const int* __restrict__ idx, unsigned n, long long src_ld, long long dst_ld) {
  const unsigned j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long c = blockIdx.y;
  dst[c * dst_ld + idx[j]] = src[c * src_ld + j];
}

// inv[idx[j]] = j for j < n: the inverse of a permutation of [0, n), on
// gather_cols' grid.
__global__ void __launch_bounds__(kThreads)
    invert(const int* __restrict__ idx, int* __restrict__ inv, unsigned n) {
  const unsigned threads = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  int at[kColRecords];
#pragma unroll
  for (int u = 0; u < kColRecords; ++u) {
    const unsigned j = first + u * threads;
    at[u] = j < n ? __ldg(idx + j) : -1;
  }
#pragma unroll
  for (int u = 0; u < kColRecords; ++u) {
    if (at[u] >= 0) inv[at[u]] = static_cast<int>(first + u * threads);
  }
}

// Row records of `width` vectors V, items = n * width vectors: the gather
// sets dst[e] = src[idx[e / width] * width + e % width], the scatter
// dst[idx[e / width] * width + e % width] = src[e]. A step of the grid
// moves kVecs * (its threads) vectors, a thread's the grid's threads apart.
template <typename V, bool kScatter, int kVecs>
__global__ void __launch_bounds__(kThreads)
    reorder_rows(const V* __restrict__ src, V* __restrict__ dst, const int* __restrict__ idx,
                 unsigned items, unsigned width) {
  const unsigned threads = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < items;
       base += threads * kVecs) {
    V v[kVecs];
    long long to[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const unsigned e = base + u * threads;
      to[u] = -1;
      if (e < items) {
        const unsigned i = e / width;
        const long long at = static_cast<long long>(__ldg(idx + i)) * width + (e - i * width);
        v[u] = __ldg(src + (kScatter ? static_cast<long long>(e) : at));
        to[u] = kScatter ? at : static_cast<long long>(e);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      if (to[u] >= 0) dst[to[u]] = v[u];
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One block per tile of 32 records. rec4: float4s of a record; comp: values
// of its component 0 (a multiple of 8, so that 32 * comp values split
// evenly over the 256 threads).
__global__ void __launch_bounds__(kThreads)
    dma_rate(const float4* __restrict__ pool, const int* __restrict__ perm,
             float4* __restrict__ out, int rec4, int comp) {
  extern __shared__ float4 tile[];  // kRateRecords * rec4
  __shared__ int rows[kRateRecords];
  __shared__ float warp_sums[kRateWarps];
  const long long t = blockIdx.x;
  if (threadIdx.x < kRateRecords) rows[threadIdx.x] = perm[t * kRateRecords + threadIdx.x];
  __syncthreads();
  for (int e = threadIdx.x; e < kRateRecords * rec4; e += kThreads) {
    const int j = e / rec4;
    cp_async16(&tile[e], pool + static_cast<long long>(rows[j]) * rec4 + (e - j * rec4));
  }
  cp_async_wait_all();
  __syncthreads();

  const float* vals = reinterpret_cast<const float*>(tile);
  const int rec_floats = 4 * rec4;
  float s = 0.0f;
  for (int e = threadIdx.x; e < kRateRecords * comp; e += kThreads) {
    const int j = e / comp;
    s += vals[j * rec_floats + (e - j * comp)];
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = warp_sums[0];
  for (int w = 1; w < kRateWarps; ++w) total += warp_sums[w];
  const float4 v = make_float4(total, total, total, total);
  for (int e = threadIdx.x; e < kOutTile / 4; e += kThreads) out[t * (kOutTile / 4) + e] = v;
}

// The kernels wrt_reorder_attributes reports, in its `which` order; the
// row kernels size their grid by their entry's resident blocks.
const void* const kKernels[] = {
    reinterpret_cast<const void*>(gather_cols),
    reinterpret_cast<const void*>(scatter_cols),
    reinterpret_cast<const void*>(invert),
    reinterpret_cast<const void*>(reorder_rows<float, false, 1>),
    reinterpret_cast<const void*>(reorder_rows<float4, false, 1>),
    reinterpret_cast<const void*>(reorder_rows<float, true, 1>),
    reinterpret_cast<const void*>(reorder_rows<float4, true, 1>),
    reinterpret_cast<const void*>(reorder_rows<float, false, kRowVecs>),
    reinterpret_cast<const void*>(reorder_rows<float4, false, kRowVecs>),
    reinterpret_cast<const void*>(reorder_rows<float, true, kRowVecs>),
    reinterpret_cast<const void*>(reorder_rows<float4, true, kRowVecs>),
    reinterpret_cast<const void*>(dma_rate),
};
constexpr int kNumKernels = sizeof(kKernels) / sizeof(kKernels[0]);
constexpr int kRows = 3;  // the first row kernel

// *blocks = the blocks of kernel `which` the current card holds at once
// (resident blocks an SM times the SMs), read once per kernel and device.
cudaError_t resident_blocks(int which, int* blocks) {
  static int cached[kNumKernels][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* slot = dev >= 0 && dev < kMaxDevices ? &cached[which][dev] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *blocks = *slot;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernels[which], kThreads, 0);
  if (err != cudaSuccess) return err;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (slot != nullptr) *slot = *blocks;
  return cudaSuccess;
}

template <typename V, bool kScatter>
void rows_kernel(unsigned grid, bool one, const V* src, V* dst, const int* idx, unsigned items,
                 unsigned width, cudaStream_t s) {
  if (one) {
    reorder_rows<V, kScatter, 1><<<grid, kThreads, 0, s>>>(src, dst, idx, items, width);
  } else {
    reorder_rows<V, kScatter, kRowVecs><<<grid, kThreads, 0, s>>>(src, dst, idx, items, width);
  }
}

// The row kernels: a vector a thread where the card's resident threads
// cover the items, else kRowVecs vectors a thread on the resident blocks.
int launch_rows(bool scatter, const float* src, float* dst, const int* idx, long long n,
                long long width, cudaStream_t s) {
  const bool aligned =
      width % 4 == 0 &&
      ((reinterpret_cast<std::uintptr_t>(src) | reinterpret_cast<std::uintptr_t>(dst)) % 16) == 0;
  const long long w = aligned ? width / 4 : width;
  const unsigned items = static_cast<unsigned>(n * w);
  const int which = kRows + 4 + (aligned ? 1 : 0) + (scatter ? 2 : 0);
  int blocks = 0;
  const cudaError_t err = resident_blocks(which, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (items + kThreads - 1) / kThreads;
  const bool one = want <= blocks;
  const unsigned grid = static_cast<unsigned>(one ? want : blocks);
  const unsigned uw = static_cast<unsigned>(w);
  if (aligned) {
    const float4* vs = reinterpret_cast<const float4*>(src);
    float4* vd = reinterpret_cast<float4*>(dst);
    if (scatter) {
      rows_kernel<float4, true>(grid, one, vs, vd, idx, items, uw, s);
    } else {
      rows_kernel<float4, false>(grid, one, vs, vd, idx, items, uw, s);
    }
  } else if (scatter) {
    rows_kernel<float, true>(grid, one, src, dst, idx, items, uw, s);
  } else {
    rows_kernel<float, false>(grid, one, src, dst, idx, items, uw, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int reorder(bool scatter, const float* src, float* dst, const int* idx, long long n,
            int pieces, long long width, long long src_ld, long long dst_ld, int* inverse,
            void* stream) {
  if (n < 0 || pieces < 1 || width < 1 || (pieces > 1 && width > 1) ||
      n * width >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr long long kPass = kThreads * kColRecords;  // records a block of gather_cols moves
  const unsigned tiles = static_cast<unsigned>((n + kPass - 1) / kPass);
  if (inverse != nullptr) {  // a scatter by a permutation of dst's n records
    invert<<<tiles, kThreads, 0, s>>>(idx, inverse, static_cast<unsigned>(n));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    idx = inverse;
    scatter = false;
  }
  if (width > 1) return launch_rows(scatter, src, dst, idx, n, width, s);
  if (scatter) {
    const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    static_cast<unsigned>(pieces));
    scatter_cols<<<grid, kThreads, 0, s>>>(src, dst, idx, static_cast<unsigned>(n), src_ld,
                                           dst_ld);
  } else {
    const dim3 grid(tiles, static_cast<unsigned>(pieces));
    gather_cols<<<grid, kThreads, 0, s>>>(src, dst, idx, static_cast<unsigned>(n), src_ld,
                                          dst_ld);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers, and returns cudaGetLastError() after its launches (or
// cudaErrorInvalidValue for a shape it does not take). A record is one
// plane of `width` floats (pieces 1) or one float in each of `pieces`
// planes (width 1), the planes src_ld and dst_ld floats apart; n * width
// must be below 2^31. Widths, strides and pointers of any alignment are
// taken (16-byte accesses where they allow).

// dst record i = src record idx[i], for i < n.
int wrt_record_gather(const float* src, float* dst, const int* idx, long long n, int pieces,
                      long long width, long long src_ld, long long dst_ld, void* stream) {
  return reorder(false, src, dst, idx, n, pieces, width, src_ld, dst_ld, nullptr, stream);
}

// dst record idx[j] = src record j, for j < n; the indices must not repeat.
// With `inverse` (int32 scratch of n values) idx must name every record of
// dst (n of them, a permutation: a repeated index leaves entries of
// `inverse` unwritten, and the gather reads out of bounds): it is inverted
// into `inverse` and dst gathered through it, two launches; with inverse
// null, one launch stores where idx points.
int wrt_record_scatter(const float* src, float* dst, const int* idx, long long n, int pieces,
                       long long width, long long src_ld, long long dst_ld, int* inverse,
                       void* stream) {
  return reorder(true, src, dst, idx, n, pieces, width, src_ld, dst_ld, inverse, stream);
}

// n_tiles tiles of 32 records of rec_floats floats (a multiple of 4, with
// 32 * rec_floats * 4 bytes at most the 227 KiB a block may hold), the
// records picked by perm [n_tiles * 32]; out [n_tiles * 8, 128] gets each
// tile's sum of the first comp floats of its records.
int wrt_dma_rate(const float* pool, const int* perm, float* out, int n_tiles, int rec_floats,
                 int comp, void* stream) {
  const int smem = kRateRecords * rec_floats * static_cast<int>(sizeof(float));
  if (n_tiles <= 0 || rec_floats % 4 || comp % 8 || comp > rec_floats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err =
      cudaFuncSetAttribute(dma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dma_rate<<<n_tiles, kThreads, smem, s>>>(reinterpret_cast<const float4*>(pool), perm,
                                           reinterpret_cast<float4*>(out), rec_floats / 4,
                                           comp);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and the blocks the current card
// holds at once of one kernel; returns a cudaError_t. `which`: 0
// gather_cols, 1 scatter_cols, 2 invert (blocks 0: their grid is their
// tiles), 3-6 the row gather float, float4, the row scatter float, float4,
// one vector a thread, 7-10 the same with kRowVecs, 11 dma_rate (blocks
// 0).
int wrt_reorder_attributes(int which, int* num_regs, int* local_bytes, int* blocks) {
  if (which < 0 || which >= kNumKernels) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kKernels[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *blocks = 0;
  return which < kRows || which == kNumKernels - 1
             ? 0
             : static_cast<int>(resident_blocks(which, blocks));
}

}  // extern "C"
