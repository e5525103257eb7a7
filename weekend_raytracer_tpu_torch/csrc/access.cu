// Indexed-access probes for Hopper (sm_90a): the counterparts of the fifteen
// pallas_calls of benchmarks/probe_gather_cost.py, benchmarks/probe_place.py
// and benchmarks/probe_mosaic.py (all but :143, which reorder.cu's
// record_gather answers). Each asks what a per-lane indexed access costs:
//
//   table_gather   probe_gather_cost.py:66 (make_fn, :20): per lane, 16
//                  fetches from a table of 128-wide rows over the span of
//                  rows its (32, 128) tile touches, through the L1
//                  (kGlobal), from the span staged in shared memory
//                  (kShared), or the same index math with no load
//                  (kArith, the probe's pure-arithmetic baseline).
//   lane_gather    take_along_axis per (rows, 128) tile: along the lanes
//                  (probe_mosaic.py:49, :66, :277, :296; probe_place.py:52,
//                  :126) or the rows of a (32, 128) tile (probe_mosaic.py:33),
//                  by warp shuffles (kShfl), a shared-memory row (kSmem) or
//                  a per-thread array indexed at run time (kLocal).
//   smem_rw        a scratch written and read at dynamic word offsets
//                  (probe_place.py:72; probe_mosaic.py:83, :104, :231, :251),
//                  held in shared memory (kSmem) or across a warp's
//                  registers (kShfl, scratches of at most 1024 words), or
//                  never held at all (kDirect: each output word read from
//                  the base or a write where it lies).
//   row_sort       probe_place.py:104: the probe's bitonic network along the
//                  128 lanes of each row.
//   lane_scan      probe_mosaic.py:213: an inclusive sum along the 128 lanes
//                  of each row.
//
// Every kernel moves 32-bit words or adds floats in a fixed order: no route
// passes a moved value through float arithmetic (a NaN keeps its payload,
// -0.0 its sign), and each plain twin in ops/cuda/access.py repeats the
// kernel's order of operations, so kernel and twin agree in every bit.
// Indices are taken modulo what they index (a lane index modulo 128, a row
// of a tile modulo 32, a scratch offset or a row pick modulo its size, as
// floor modulo), so no input reads or writes out of bounds.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "card.cuh"

namespace {

constexpr int kWidth = 128;  // lanes of a row
constexpr int kTileRows = 32;  // rows of a gather tile
constexpr int kTileLanes = kTileRows * kWidth;  // 4096
constexpr int kGatherThreads = 256;  // table_gather: a tile's threads
constexpr int kGatherLanes = kTileLanes / kGatherThreads;  // its lanes a thread
constexpr int kGatherWarps = kGatherThreads / 32;
// table_gather: a tile's lanes are walked in the order of their offsets
// where the span has kSortMinSpan rows or more and shared memory allows it
constexpr int kSortMinSpan = 4;  // the spans of fewer rows walk in lane order
// table_gather's sort: a bin a thread, keyed by an offset's top kSortBits
// bits; the offsets, lanes and bins it keeps
constexpr int kSortBits = kGatherThreads == 256 ? 8 : kGatherThreads == 512 ? 9 : 10;
static_assert(1 << kSortBits == kGatherThreads, "a bin a thread");
constexpr int kSortBytes = kTileLanes * (4 + 2) + kGatherThreads * 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLocalColThreads = kWidth;  // axis-0 kLocal: a thread per column
constexpr int kMaxSharedBytes = 232448;  // a block's shared memory on an H100
constexpr int kFetchStride = 37;  // probe_gather_cost.py:32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDirectWrites = 1024;  // smem_rw kDirect: write offsets a block stages
constexpr int kMaxDirectReads = 2048;  // smem_rw kDirect: one-word read offsets a block stages
constexpr int kDirectBlocksPerSm = 8;  // smem_rw kDirect: 2048 threads an SM
constexpr int kDirectUnroll = 4;  // smem_rw kDirect: independent items a thread loads at once

enum GatherRoute { kGlobal = 0, kShared = 1, kArith = 2 };
enum Route { kShfl = 0, kSmem = 1, kLocal = 2 };
constexpr int kDirect = 2;  // smem_rw's third route (shfl 0, smem 1)

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// float(at) for 0 <= at < 2^23, exactly, on the FP32 pipe (2^23 + at is a
// float whose mantissa is at); the conversion unit (I2F, a quarter of the
// FP32 rate) elsewhere.
__device__ __forceinline__ float exact_float(int at, bool small) {
  return small ? __int_as_float(at + 0x4B000000) - 8388608.0f : static_cast<float>(at);
}

// The fetches of a thread's lanes from pos on (an address, or for kShared
// a byte offset into the staged span), summed into acc: pos steps by the
// stride and wraps at end by `span` with one compare; kWrap also takes the
// address modulo the table's words (a span that passes the table's last
// row).
template <int kRoute, bool kWrap>
__device__ __forceinline__ void walk(const float* __restrict__ tab, const float* staged,
                                     int (&pos)[kGatherLanes], float (&acc)[kGatherLanes],
                                     int n_fetch, int end, int span, int table_words,
                                     bool small) {
  constexpr int kStep = kRoute == kShared ? 4 * kFetchStride : kFetchStride;
  for (int k = 0; k < n_fetch; ++k) {
#pragma unroll
    for (int q = 0; q < kGatherLanes; ++q) {
      float v;
      if constexpr (kRoute == kShared) {
        v = *reinterpret_cast<const float*>(reinterpret_cast<const char*>(staged) + pos[q]);
      } else {
        int at = pos[q];  // row * 128 + col
        if (kWrap && at >= table_words) at -= table_words;
        if constexpr (kRoute == kGlobal) {
          v = __ldg(tab + at);
        } else {
          v = exact_float(at, small);  // the probe's arange table
        }
      }
      acc[q] = acc[q] + v;
      pos[q] += kStep;
      if (pos[q] >= end) pos[q] -= span;
    }
  }
}

// table_gather<kRoute>: out[lane] = sum over k < n_fetch, in k order from
// 0.0, of tab[(flat >> 7) mod rows, flat & 127], flat = span_base +
// (idx[lane] - span_base + 37 k) mod (span_rows * 128), span_base the
// tile's smallest index rounded down to a row.
//
// Replaces benchmarks/probe_gather_cost.py:20 make_fn (pallas_call at :66).
// Bound on an H100: the probe's bytes (indices in, sums out: 8 B a lane,
// 16.8 MB over 512 tiles, 5 us at 3.35 TB/s) and 16 lookups a lane through
// the L1 or shared memory (128 B a clock an SM: 4 us for 2,097,152 lanes).
// On the TPU a lane gathers only within the 128-lane row held in a vreg, so
// the kernel walks every row of the span; here every thread loads its own
// address, so the span costs nothing in kGlobal while it fits the L1, and
// kShared pays for staging the whole span per tile (span x 512 B, at most
// 453 rows beside the warp minima). Two floor modulos by run-time divisors
// a fetch (software divisions) would cost more than the bytes or the
// lookups, and a warp's 32 random lanes touch up to 32 lines of the L1 (or
// banks of shared memory) a fetch.
// Design: one block per (32, 128) tile, 256 threads of 16 lanes each
// (eight blocks an SM hold the probe's 512 tiles in one wave); the tile
// minimum is a warp reduction (__reduce_min_sync), then each warp reduces
// the 8 warp minima after one barrier.
//  - A lane takes one modulo, its offset off = (idx - span_base) mod W, W =
//    span_rows * 128; walk() then steps it by 37 and wraps it by a compare
//    (37 < W). The row needs no modulo either where span_rows <=
//    table_rows: flat >> 7 is span_base's row plus off >> 7, so the address
//    is the tile's row base (span_base's row mod table_rows, once a thread)
//    times 128 plus off, less the table's words if it passes them, which
//    only a tile whose span passes the table's last row tests. kShared
//    stages its rows the same way, a thread's row stepping by the block's 2
//    rows mod table_rows (a span that passes 2^31 takes the rows of flat's
//    int32 wrap, as the twin does), and walks byte offsets. A tile whose ints could overflow
//    (spread over 2^31), or a span longer than the table, takes the two
//    modulos a fetch in the same int arithmetic.
//  - Spans of kSortMinSpan rows or more, kGlobal and kShared (where it fits
//    beside the span), first sort the tile's lanes by offset (a counting
//    sort on off's top 8 bits, a bin a thread, in 25 KB of shared memory)
//    and give each warp 32 neighbours in that order: a fetch of the warp
//    then touches one or two lines (banks in a row), not up to 32. The sums
//    go back to their lanes through shared memory, so the stores stay
//    coalesced. Shorter spans put a warp's lanes on few lines already.
//  - kArith forms float(address) on the FP32 pipe (exact_float).
template <int kRoute>
__global__ void __launch_bounds__(kGatherThreads)
    table_gather(const float* __restrict__ tab, int table_rows, const int* __restrict__ idx,
                 int span_rows, int n_fetch, int sort, float* __restrict__ out) {
  // kShared's span (span_rows * 128 words), then with `sort` the offsets
  // [4096] (reused for the sums), the lanes [4096] and the bins [a thread]
  extern __shared__ float staged[];
  __shared__ int warp_min[kGatherWarps];
  __shared__ int warp_sum[kGatherWarps];
  const long long tile = blockIdx.x;
  const int* tidx = idx + tile * kTileLanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int base[kGatherLanes];
  int m = INT_MAX;
#pragma unroll
  for (int q = 0; q < kGatherLanes; ++q) {
    base[q] = tidx[threadIdx.x + q * kGatherThreads];
    m = min(m, base[q]);
  }
  m = __reduce_min_sync(kFull, m);
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  m = __reduce_min_sync(kFull, lane < kGatherWarps ? warp_min[lane] : INT_MAX);
  const int span_base = m & ~(kWidth - 1);  // (min >> 7) << 7
  const int span_words = span_rows * kWidth;
  if constexpr (kRoute == kShared) {
    if (span_base <= INT_MAX - span_words) {
      constexpr int kRowsAStep = kGatherThreads / kWidth;
      int row = floor_mod((span_base >> 7) + (threadIdx.x >> 7), table_rows);
      const int row_step = kRowsAStep % table_rows;
      for (int i = threadIdx.x; i < span_words; i += kGatherThreads) {
        staged[i] = tab[static_cast<long long>(row) * kWidth + (i & (kWidth - 1))];
        row += row_step;
        if (row >= table_rows) row -= table_rows;
      }
    } else {  // the span passes 2^31: the rows of flat's int32 wrap, as the twin's
      for (int i = threadIdx.x; i < span_words; i += kGatherThreads) {
        const int flat = static_cast<int>(static_cast<unsigned>(span_base) + i);
        staged[i] = tab[static_cast<long long>(floor_mod(flat >> 7, table_rows)) * kWidth +
                        (i & (kWidth - 1))];
      }
    }
  }
  // a tile steps where no int it would form overflows: idx - span_base +
  // 37 k for every k < n_fetch, span_base + off, the row base + off
  const long long last = static_cast<long long>(kFetchStride) * max(n_fetch - 1, 0);
  bool over = false;
  unsigned d[kGatherLanes];
#pragma unroll
  for (int q = 0; q < kGatherLanes; ++q) {
    d[q] = static_cast<unsigned>(base[q]) - static_cast<unsigned>(span_base);
    over = over || d[q] > INT_MAX - last;
  }
  const bool general = __syncthreads_or(over) ||
                       (kRoute != kShared && (span_rows > table_rows ||
                                              table_rows > INT_MAX / (2 * kWidth) ||
                                              span_base > INT_MAX - span_words));
  const bool small = table_rows <= (1 << 23) / kWidth;
  float acc[kGatherLanes];
#pragma unroll
  for (int q = 0; q < kGatherLanes; ++q) acc[q] = 0.0f;
  if (!general) {
    int off[kGatherLanes];
#pragma unroll
    for (int q = 0; q < kGatherLanes; ++q) {
      off[q] = static_cast<int>(d[q] % static_cast<unsigned>(span_words));
    }
    int* sort_off = reinterpret_cast<int*>(staged + (kRoute == kShared ? span_words : 0));
    uint16_t* sort_lane = reinterpret_cast<uint16_t*>(sort_off + kTileLanes);
    int* bins = reinterpret_cast<int*>(sort_lane + kTileLanes);
    int lanes[kGatherLanes];  // the tile's lane of each of this thread's offsets
    if (kRoute != kArith && sort) {
      // a counting sort of the lanes by off's top kSortBits bits
      const int shift = max(0, 32 - __clz(span_words - 1) - kSortBits);
      bins[threadIdx.x] = 0;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) atomicAdd(&bins[off[q] >> shift], 1);
      __syncthreads();
      const int count = bins[threadIdx.x];
      int incl = count;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      int before = 0;
      for (int w = 0; w < warp; ++w) before += warp_sum[w];
      bins[threadIdx.x] = before + incl - count;  // the bin's first place
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) {
        const int at = atomicAdd(&bins[off[q] >> shift], 1);
        sort_off[at] = off[q];
        sort_lane[at] = static_cast<uint16_t>(threadIdx.x + q * kGatherThreads);
      }
      __syncthreads();
      // a warp takes 256 places in a row, its lanes 32 neighbours a time
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) {
        const int at = warp * (32 * kGatherLanes) + q * 32 + lane;
        off[q] = sort_off[at];
        lanes[q] = sort_lane[at];
      }
    } else if constexpr (kRoute == kShared) {
      __syncthreads();  // the span staged
    }
    const int table_words = table_rows * kWidth;
    if constexpr (kRoute == kShared) {  // staged row off >> 7 is table row (flat >> 7) mod rows
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) off[q] *= 4;
      walk<kRoute, false>(tab, staged, off, acc, n_fetch, 4 * span_words, 4 * span_words,
                          table_words, small);
    } else {
      const int row_base = floor_mod(span_base >> 7, table_rows) * kWidth;
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) off[q] += row_base;
      if (row_base + span_words <= table_words) {
        walk<kRoute, false>(tab, staged, off, acc, n_fetch, row_base + span_words, span_words,
                            table_words, small);
      } else {
        walk<kRoute, true>(tab, staged, off, acc, n_fetch, row_base + span_words, span_words,
                           table_words, small);
      }
    }
    if (kRoute != kArith && sort) {  // each sum back to its lane
      float* sums = reinterpret_cast<float*>(sort_off);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) sums[lanes[q]] = acc[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) acc[q] = sums[threadIdx.x + q * kGatherThreads];
    }
  } else {
    if constexpr (kRoute == kShared) __syncthreads();  // the span staged
    for (int k = 0; k < n_fetch; ++k) {
#pragma unroll
      for (int q = 0; q < kGatherLanes; ++q) {
        const unsigned step = static_cast<unsigned>(kFetchStride) * static_cast<unsigned>(k);
        const int off = floor_mod(static_cast<int>(d[q] + step), span_words);
        float v;
        if constexpr (kRoute == kShared) {
          v = staged[off];
        } else {
          const int flat = span_base + off;
          const int row = floor_mod(flat >> 7, table_rows);
          const int col = flat & (kWidth - 1);
          if constexpr (kRoute == kGlobal) {
            v = __ldg(tab + static_cast<long long>(row) * kWidth + col);
          } else {
            v = exact_float(row * kWidth + col, small);  // the probe's arange table
          }
        }
        acc[q] = acc[q] + v;
      }
    }
  }
  float* tout = out + tile * kTileLanes;
#pragma unroll
  for (int q = 0; q < kGatherLanes; ++q) tout[threadIdx.x + q * kGatherThreads] = acc[q];
}

// The lane of row r that output (r, c) takes: idx[r, c] mod 128, or
// (c - shift[r]) & 127 (probe_place.py p4's rotate).
__device__ __forceinline__ int lane_source(const int* __restrict__ idx,
                                           const int* __restrict__ shift, int r, int c) {
  return idx != nullptr ? (idx[static_cast<long long>(r) * kWidth + c] & (kWidth - 1))
                        : ((c - shift[r]) & (kWidth - 1));
}

// lane_gather_rows<kRoute>: out[r, c] = x[sr, lane_source(r, c)], sr =
// rows[r] mod x_rows (a row picked at run time, probe_place.py p1) or r.
//
// Replaces benchmarks/probe_mosaic.py:49, :66, :277 and :296 (lane
// take_along_axis of (8, 128), (32, 128), of i32 bit patterns, of one
// row) and benchmarks/probe_place.py:52 (p1, x[r, j] at a dynamic (r, j))
// and :126 (p4, each row rotated by its own shift). Bound on an H100 by
// bytes: each word and index read once, each output written once. On the
// TPU a lane gather moves data across a vreg's lanes; here it is a question
// of where the row lives while it is read at run-time lanes. Design: kShfl
// and kSmem give each row a warp that loads it coalesced, four words a
// lane (lanes l, l + 32, l + 64, l + 96); kShfl answers each output with
// four __shfl_sync and a select by j >> 5, kSmem stages the row in the
// warp's 512 B of shared memory (a __syncwarp, then one load at j: lanes
// that read one word are a broadcast, others a bank each). kLocal gives each
// row a thread whose 128 words sit in an array indexed at run time, which
// ptxas places in local memory (512 B a thread, cached in L1).
template <int kRoute>
__global__ void __launch_bounds__(kThreads)
    lane_gather_rows(const uint32_t* __restrict__ x, int x_rows, const int* __restrict__ idx,
                     const int* __restrict__ shift, const int* __restrict__ rows,
                     int out_rows, uint32_t* __restrict__ out) {
  if constexpr (kRoute == kLocal) {
    const int r = blockIdx.x * kThreads + threadIdx.x;  // a thread per row
    if (r >= out_rows) return;
    const int sr = rows != nullptr ? floor_mod(rows[r], x_rows) : r;
    const uint32_t* src = x + static_cast<long long>(sr) * kWidth;
    uint32_t v[kWidth];
#pragma unroll
    for (int c = 0; c < kWidth; ++c) v[c] = src[c];
    uint32_t* dst = out + static_cast<long long>(r) * kWidth;
    for (int c = 0; c < kWidth; ++c) dst[c] = v[lane_source(idx, shift, r, c)];
  } else {
    __shared__ uint32_t rowbuf[kRoute == kSmem ? kWarps : 1][kWidth];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * kWarps + warp;  // a warp per row
    if (r >= out_rows) return;  // the whole warp
    const int sr = rows != nullptr ? floor_mod(rows[r], x_rows) : r;
    const uint32_t* src = x + static_cast<long long>(sr) * kWidth;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = src[lane + 32 * q];
    if constexpr (kRoute == kSmem) {
#pragma unroll
      for (int q = 0; q < 4; ++q) rowbuf[warp][lane + 32 * q] = v[q];
      __syncwarp();
    }
    uint32_t* dst = out + static_cast<long long>(r) * kWidth;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      const int j = lane_source(idx, shift, r, c);
      uint32_t g;
      if constexpr (kRoute == kSmem) {
        g = rowbuf[warp][j];
      } else {
        const uint32_t g0 = __shfl_sync(kFull, v[0], j & 31);
        const uint32_t g1 = __shfl_sync(kFull, v[1], j & 31);
        const uint32_t g2 = __shfl_sync(kFull, v[2], j & 31);
        const uint32_t g3 = __shfl_sync(kFull, v[3], j & 31);
        const int s = j >> 5;
        g = s == 0 ? g0 : s == 1 ? g1 : s == 2 ? g2 : g3;
      }
      dst[c] = g;
    }
  }
}

// lane_gather_cols<kRoute>: per (32, 128) tile t, out[32 t + r, c] =
// x[32 t + (idx[32 t + r, c] mod 32), c].
//
// Replaces benchmarks/probe_mosaic.py:33 (take_along_axis along the
// sublanes of (32, 128)). Bound on an H100 by bytes, as lane_gather_rows.
// Design: kShfl gives a warp four columns of a tile with a lane per row
// (one __shfl_sync an output; the loads are a row apart, 4 B of each 32 B
// sector per load, the rest from L1); kSmem stages the tile's 16 KiB in
// shared memory (coalesced) and reads row idx of the same column; kLocal
// gives a thread a column whose 32 words sit in a run-time-indexed array.
template <int kRoute>
__global__ void __launch_bounds__(kThreads)
    lane_gather_cols(const uint32_t* __restrict__ x, const int* __restrict__ idx, int n_tiles,
                     uint32_t* __restrict__ out) {
  if constexpr (kRoute == kShfl) {
    const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int t = gw >> 5, g = gw & 31;  // tile, group of four columns
    if (t >= n_tiles) return;  // the whole warp
    const long long row = static_cast<long long>(t) * kTileRows + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long at = row * kWidth + 4 * g + q;
      const uint32_t v = x[at];
      out[at] = __shfl_sync(kFull, v, idx[at] & 31);
    }
  } else if constexpr (kRoute == kSmem) {
    __shared__ uint32_t tilebuf[kTileLanes];
    const long long t0 = static_cast<long long>(blockIdx.x) * kTileLanes;
    for (int i = threadIdx.x; i < kTileLanes; i += kThreads) tilebuf[i] = x[t0 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < kTileLanes; i += kThreads) {
      out[t0 + i] = tilebuf[(idx[t0 + i] & 31) * kWidth + (i & (kWidth - 1))];
    }
  } else {
    const long long t0 = static_cast<long long>(blockIdx.x) * kTileLanes;
    const int c = threadIdx.x;  // a thread per column
    uint32_t v[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) v[i] = x[t0 + i * kWidth + c];
    for (int r = 0; r < kTileRows; ++r) {
      const long long at = t0 + r * kWidth + c;
      out[at] = v[idx[at] & 31];
    }
  }
}

// a mod m for 0 <= a, the division only where a >= m.
__device__ __forceinline__ int wrap(int a, int m) { return a < m ? a : a % m; }

// The word of output o of a scratch read: read_idx[o / width] + o % width.
__device__ __forceinline__ int read_offset(const int* __restrict__ read_idx, long long o,
                                           int width) {
  if (width == 1) return read_idx[o];
  const long long m = o / width;
  return read_idx[m] + static_cast<int>(o - m * width);
}

// smem_rw_shared: per scratch b, its `words` words of base, then write k of
// n_writes (in k order) puts vals[k, w] at (write_idx[k] + w) mod words for
// w < write_width, then out[b, m, w] = scratch[(read_idx[m] + w) mod words].
//
// Replaces benchmarks/probe_place.py:72 (p2: four scalars written to an
// SMEM scratch at dynamic indices and read back at others),
// benchmarks/probe_mosaic.py:83 (one value at a traced index), :104 (an
// (8, 128) slice at a traced row), :231 (a row stored at a traced leading
// index) and :251 (a row read at one). Bound on an H100 by bytes (the
// scratches in, the reads out); shared memory serves 32 banks of 4 B a
// clock, so 32 lanes reading one bank at 32 addresses take 32 clocks.
// Design: one block per scratch, staged coalesced; each write is a round
// of threads over its words and a __syncthreads, so a later write wins
// where two overlap, as in the probe's program order; the reads are spread
// over the block, consecutive outputs on consecutive threads.
__global__ void __launch_bounds__(kThreads)
    smem_rw_shared(const uint32_t* __restrict__ base, int words,
                   const uint32_t* __restrict__ vals, const int* __restrict__ write_idx,
                   int n_writes, int write_width, const int* __restrict__ read_idx,
                   int n_reads, int read_width, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t scratch[];  // words
  const long long b = blockIdx.x;
  const uint32_t* src = base + b * words;
  for (int i = threadIdx.x; i < words; i += kThreads) scratch[i] = src[i];
  __syncthreads();
  for (int k = 0; k < n_writes; ++k) {
    for (int w = threadIdx.x; w < write_width; w += kThreads) {
      scratch[floor_mod(write_idx[k] + w, words)] =
          vals[static_cast<long long>(k) * write_width + w];
    }
    __syncthreads();
  }
  const long long total = static_cast<long long>(n_reads) * read_width;
  uint32_t* dst = out + b * total;
  for (long long o = threadIdx.x; o < total; o += kThreads) {
    dst[o] = scratch[floor_mod(read_offset(read_idx, o, read_width), words)];
  }
}

// smem_rw_direct<kVec>: smem_rw_shared's function with no copy of the
// scratch. Output word (b, m, w) is scratch b's word a = (read_idx[m] + w)
// mod words: the value of the last write k whose window (write_idx[k] +
// [0, write_width)) mod words covers a, vals[k, (a - write_idx[k]) mod
// words], or base[b, a] where no write covers it.
//
// Replaces the same pallas_calls as smem_rw_shared (probe_place.py:72;
// probe_mosaic.py:83, :104, :231, :251). Bound on an H100 by bytes: the
// base words the reads return, the writes, the indices and the output
// (probes/place.py rw_case counts them). smem_rw_shared moves every word
// of every scratch whatever the reads ask for (64 MB at probe_mosaic's
// fill, where :83 returns one word a scratch), takes a barrier a write and
// runs a block a scratch. Design: no staging and no barrier but one, which
// follows the block's copy of the write offsets (floor-modded, at most
// kMaxDirectWrites) into shared memory; a write's values are read from
// global memory (the L1) only where a word is covered, the writes walked
// last to first; one-word reads (probe_place.py:72's, :83's) have their
// offsets floor-modded once a block into shared memory too (at most
// kMaxDirectReads), so such an item costs a shared load, a global load
// and a store. The output is flat: consecutive items on consecutive
// threads, an item kVec words (4 where read_width % 4 == 0: a 16-byte
// store, and a 16-byte load where the four words neither wrap nor leave
// 16-byte alignment; else four 4-byte loads), and a grid of
// kDirectBlocksPerSm blocks an SM at most, each thread taking
// kDirectUnroll items a step at a stride of the grid, their loads issued
// together. Items index in 32 bits (the wrapper holds the output under
// 2^31 words); a thread finds its first item's scratch by one division
// and steps to the next by adding the stride's quotient and remainder.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    smem_rw_direct(const uint32_t* __restrict__ base, int words,
                   const uint32_t* __restrict__ vals, const int* __restrict__ write_idx,
                   int n_writes, int write_width, const int* __restrict__ read_idx,
                   int n_reads, int read_width, unsigned items_per_scratch, unsigned items,
                   uint32_t* __restrict__ out) {
  __shared__ int wstart[kMaxDirectWrites];
  __shared__ int rstart[kMaxDirectReads];
  const bool staged_reads = read_width == 1 && n_reads <= kMaxDirectReads;
  for (int k = threadIdx.x; k < n_writes; k += kThreads) {
    wstart[k] = floor_mod(write_idx[k], words);
  }
  if (staged_reads) {
    for (int m = threadIdx.x; m < n_reads; m += kThreads) {
      rstart[m] = floor_mod(read_idx[m], words);
    }
  }
  __syncthreads();
  const unsigned items_per_read = static_cast<unsigned>(read_width / kVec);
  const unsigned stride = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  if (first >= items) return;
  // (scratch, item of the scratch) of this thread's next item, advanced by
  // the grid's stride without a division
  unsigned b = first / items_per_scratch;
  unsigned r = first - b * items_per_scratch;
  const unsigned step_b = stride / items_per_scratch;
  const unsigned step_r = stride - step_b * items_per_scratch;
  for (unsigned i0 = first; i0 < items; i0 += stride * kDirectUnroll) {
    uint32_t v[kDirectUnroll][kVec];
    int at[kDirectUnroll];
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      if (i0 + u * stride < items) {
        int a0;
        if (staged_reads) {
          a0 = rstart[r];
        } else {
          const unsigned m = items_per_read == 1 ? r : r / items_per_read;
          const int w = static_cast<int>(r - m * items_per_read) * kVec;
          // the int32 sum the twin takes modulo words
          a0 = floor_mod(static_cast<int>(static_cast<unsigned>(__ldg(read_idx + m)) +
                                          static_cast<unsigned>(w)),
                         words);
        }
        at[u] = a0;
        const uint32_t* src = base + static_cast<long long>(b) * words;
        if constexpr (kVec == 4) {
          if (a0 <= words - 4 && (reinterpret_cast<uintptr_t>(src + a0) & 15) == 0) {
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + a0));
            v[u][0] = q.x, v[u][1] = q.y, v[u][2] = q.z, v[u][3] = q.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[u][e] = __ldg(src + wrap(a0 + e, words));
          }
        } else {
          v[u][0] = __ldg(src + a0);
        }
      }
      r += step_r;
      b += step_b;
      if (r >= items_per_scratch) {
        r -= items_per_scratch;
        ++b;
      }
    }
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      const unsigned it = i0 + u * stride;
      if (it >= items) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int a = wrap(at[u] + e, words);
        for (int k = n_writes - 1; k >= 0; --k) {
          int d = a - wstart[k];
          d += d < 0 ? words : 0;
          if (d < write_width) {
            v[u][e] = __ldg(vals + static_cast<long long>(k) * write_width + d);
            break;
          }
        }
      }
      if constexpr (kVec == 4) {
        reinterpret_cast<uint4*>(out)[it] = make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
        out[it] = v[u][0];
      }
    }
  }
}

// smem_rw_shfl<kRegs>: smem_rw_shared's function with each scratch of
// 32 kRegs words held in one warp's registers: word a in lane a & 31,
// register a >> 5.
//
// Replaces the same pallas_calls as smem_rw_shared where the scratch fits
// (probe_place.py:72's 128 words). Bound as smem_rw_shared, but each read
// costs kRegs shuffles and a select, and each write word a compare over
// the kRegs registers of its owning lane. Design: the warp walks the writes
// in order (every lane sees every write, so a later one wins), then reads
// 32 outputs a step, each lane shuffling every register from the lane
// that owns its word and keeping register a >> 5.
template <int kRegs>
__global__ void __launch_bounds__(kThreads)
    smem_rw_shfl(const uint32_t* __restrict__ base, int batch,
                 const uint32_t* __restrict__ vals, const int* __restrict__ write_idx,
                 int n_writes, int write_width, const int* __restrict__ read_idx, int n_reads,
                 int read_width, uint32_t* __restrict__ out) {
  constexpr int kWords = 32 * kRegs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= batch) return;  // the whole warp
  const uint32_t* src = base + b * kWords;
  uint32_t reg[kRegs];
#pragma unroll
  for (int q = 0; q < kRegs; ++q) reg[q] = src[lane + 32 * q];
  for (int k = 0; k < n_writes; ++k) {
    for (int w = 0; w < write_width; ++w) {
      const int a = floor_mod(write_idx[k] + w, kWords);
      const uint32_t val = vals[static_cast<long long>(k) * write_width + w];
      if ((a & 31) == lane) {
#pragma unroll
        for (int q = 0; q < kRegs; ++q) reg[q] = q == (a >> 5) ? val : reg[q];
      }
    }
  }
  const long long total = static_cast<long long>(n_reads) * read_width;
  uint32_t* dst = out + b * total;
  for (long long o0 = 0; o0 < total; o0 += 32) {
    const long long o = o0 + lane;
    const bool live = o < total;
    const int a = live ? floor_mod(read_offset(read_idx, o, read_width), kWords) : 0;
    uint32_t g = 0;
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const uint32_t t = __shfl_sync(kFull, reg[q], a & 31);
      g = q == (a >> 5) ? t : g;
    }
    if (live) dst[o] = g;
  }
}

// row_sort: each row of 128 floats through probe_place.py p3's bitonic
// network (:88-99): for k = 2, 4, ..., 128 and j = k / 2, ..., 1, key l
// pairs with l ^ j; the pair is put in ascending order where l & k is 0
// and in descending order elsewhere.
//
// Replaces benchmarks/probe_place.py:104. Bound on an H100 by bytes (a key
// read and written once; the network's 28 compare-exchange stages, 28
// min/max a key, are a sixth of the byte time at the FP32 rate). The
// compare form: the pair's lower-index value lo and higher-index value hi
// swap when hi < lo (ascending) or lo < hi (descending), and both keys of
// a pair take the same decision, so every stage permutes its row: NaN
// never swaps, and -0.0 and +0.0 compare equal and keep their places (the
// probe's jnp.minimum / jnp.maximum would spread NaN, and its min and max
// of two zeros depend on their order; the twin uses this form).
// Design: kSortKeys consecutive keys a thread (key l = kSortKeys t + q, read
// and written as 16-byte words), 128 / kSortKeys threads a row. The stages
// with j < kSortKeys (22 of the 28 at 16 keys) pair a thread's own
// registers; the stages with j >= kSortKeys (j = 16; 32, 16; 64, 32, 16)
// exchange each key with lane ^ (j / kSortKeys) of the row by
// __shfl_xor_sync, the row's lanes sharing one direction, a lane keeping the
// pair's min or max by one per-thread predicate that orders the pair for a
// single compare (a compare each way and a select between them cost a
// quarter more time at the fill). Where a phase k (16 to 64) sorts a
// thread's keys in descending order, the thread holds them in reverse (a
// select per key at a phase's start where its direction changes), so every
// register stage runs ascending: a compare and two selects a pair, the
// direction known at compile time (with the direction taken pair by pair,
// ptxas ran short of predicates and spent about as many instructions again
// moving them to and from registers). A grid of the blocks the card holds at
// once walks the rows, each warp loading its next rows before it sorts the
// ones it holds, so the loads of one group overlap the network of the other
// (one group a warp, the network and the memory took their two times in sum;
// staging a warp's rows through shared memory, to read and write them as
// consecutive words, cost more instructions than the partial sectors it
// saved). The network unrolls fully.
constexpr int kSortKeys = 16;
constexpr int kSortRowThreads = kWidth / kSortKeys;
constexpr int kSortBlocks = 4;  // row_sort's blocks an SM: its register budget and its grid

// lo (the lower index) and hi of a pair in the network's order: swapped
// when hi < lo (ascending) or lo < hi (descending).
__device__ __forceinline__ void order_pair(float& lo, float& hi, bool desc) {
  const bool swap = desc ? lo < hi : hi < lo;
  const float a = lo;
  lo = swap ? hi : lo;
  hi = swap ? a : hi;
}

// The thread's keys in reverse where `flip`.
template <int kKeys>
__device__ __forceinline__ void reverse_if(float (&v)[kKeys], bool flip) {
#pragma unroll
  for (int q = 0; q < kKeys / 2; ++q) {
    const float a = v[q];
    v[q] = flip ? v[kKeys - 1 - q] : a;
    v[kKeys - 1 - q] = flip ? a : v[kKeys - 1 - q];
  }
}

// The network on thread t's keys of a row (the row's other threads hold
// the rest, in lanes of the same warp).
__device__ __forceinline__ void sort_network(float (&v)[kSortKeys], int t) {
  bool held = false;  // whether the thread holds its keys in reverse
#pragma unroll
  for (int ks = 1; ks <= 7; ++ks) {
    const int k = 1 << ks;
    const bool desc = k < kWidth && ((kSortKeys * t) & k) != 0;  // k >= kSortKeys
    if (k >= kSortKeys) {
      reverse_if(v, desc != held);
      held = desc;
    }
#pragma unroll
    for (int js = ks - 1; js >= 0; --js) {
      const int j = 1 << js;
      if (j >= kSortKeys) {
        const int tj = j / kSortKeys;
        const bool keep_min = ((t & tj) == 0) != desc;  // the lower key of an ascending pair
#pragma unroll
        for (int q = 0; q < kSortKeys; ++q) {
          const float pv = __shfl_xor_sync(kFull, v[q], tj);
          // swap where pv < v (keep_min) or v < pv: one compare of the
          // pair ordered by keep_min
          const float a = keep_min ? pv : v[q];
          const float b = keep_min ? v[q] : pv;
          v[q] = a < b ? pv : v[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < kSortKeys; ++q) {
          if (q & j) continue;
          order_pair(v[q], v[q + j], k < kSortKeys && (q & k) != 0);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kSortBlocks)
    row_sort(const float4* __restrict__ x, int rows, float4* __restrict__ out) {
  constexpr int kVecs = kSortKeys / 4;  // a thread's 16-byte words
  constexpr int kGroupRows = 32 / kSortRowThreads;  // the rows a warp sorts at once
  const int lane = threadIdx.x & 31;
  const int t = lane & (kSortRowThreads - 1);
  const long long n_groups = (rows + kGroupRows - 1LL) / kGroupRows;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  float4 words[kVecs];
  // group grp's words of this thread (a lane past the last row reads the
  // last row, sorts it and stores nothing)
  auto load = [&](long long grp) {
    const long long r = min(grp * kGroupRows + lane / kSortRowThreads, rows - 1LL);
    const float4* src = x + r * (kWidth / 4) + t * kVecs;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) words[i] = src[i];
  };
  long long g = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (g < n_groups) load(g);
  for (; g < n_groups; g += stride) {  // warp-uniform
    float v[kSortKeys];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      v[4 * i] = words[i].x;
      v[4 * i + 1] = words[i].y;
      v[4 * i + 2] = words[i].z;
      v[4 * i + 3] = words[i].w;
    }
    if (g + stride < n_groups) load(g + stride);
    sort_network(v, t);
    const long long r = g * kGroupRows + lane / kSortRowThreads;
    if (r < rows) {
      float4* dst = out + r * (kWidth / 4) + t * kVecs;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    }
  }
}

// lane_scan: out[r, c] = x[r, 0] + ... + x[r, c], as a warp computes it:
// lane t holds lanes 4t..4t+3 and sums them in order (s0 = a0, s1 = s0 +
// a1, ...); the lanes' totals are scanned by shuffles (Kogge-Stone, offsets
// 1, 2, 4, 8, 16: a lane at or past the offset adds the total from that
// many lanes down); lane t > 0 then adds the inclusive total of lane t - 1
// to each of its four sums.
//
// Replaces benchmarks/probe_mosaic.py:213 (jnp.cumsum along the lanes of
// (32, 128)). Bound on an H100 by bytes (each value read and written once).
// Design: a warp per row, one 16-byte load and store a lane, five shuffles
// and an add each for the scan; on 0/1 values every sum is an exact
// integer, so any order gives np.cumsum's bits.
__global__ void __launch_bounds__(kThreads)
    lane_scan(const float4* __restrict__ x, int rows, float4* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= rows) return;  // the whole warp
  const float4 a = x[r * (kWidth / 4) + lane];
  const float s0 = a.x;
  const float s1 = s0 + a.y;
  const float s2 = s1 + a.z;
  const float s3 = s2 + a.w;
  float incl = s3;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = incl + y;
  }
  const float pre = __shfl_up_sync(kFull, incl, 1);
  float4 o;
  if (lane == 0) {
    o = make_float4(s0, s1, s2, s3);
  } else {
    o = make_float4(pre + s0, pre + s1, pre + s2, pre + s3);
  }
  out[r * (kWidth / 4) + lane] = o;
}

unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// The dynamic shared memory each kernel has been allowed, per device:
// cudaFuncSetAttribute runs once for each larger size, not on every launch
// (also at 48 KB and below, where the kernel's static shared memory may
// already take the default's rest).
int table_shared_allowed[kMaxDevices];
int rw_shared_allowed[kMaxDevices];

cudaError_t allow_shared(const void* fn, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached) allowed[dev] = bytes;
  return err;
}


}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers to contiguous arrays of 32-bit words (float32 or int32; int32
// for indices), and returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a shape or route it does not take.

// tab [table_rows, 128] f32, idx [n_tiles * 32, 128] i32 -> out, the same
// shape f32; route 0 global, 1 shared (span_rows <= 453), 2 arith.
int wrt_table_gather(const float* tab, int table_rows, const int* idx, int n_tiles,
                     int span_rows, int n_fetch, int route, float* out, void* stream) {
  const int max_span = (kMaxSharedBytes - kGatherWarps * 8) / (kWidth * 4);
  if (table_rows <= 0 || n_tiles <= 0 || span_rows <= 0 || span_rows > INT_MAX / kWidth ||
      n_fetch < 0 || route < kGlobal || route > kArith ||
      (route == kShared && span_rows > max_span)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // "shared" sorts where its span leaves room for the sort
  const int span_bytes = route == kShared ? span_rows * kWidth * 4 : 0;
  const int sort = route != kArith && span_rows >= kSortMinSpan &&
                   span_bytes + kSortBytes <= kMaxSharedBytes - kGatherWarps * 8;
  const int smem = span_bytes + (sort ? kSortBytes : 0);
  if (route == kGlobal) {
    table_gather<kGlobal><<<n_tiles, kGatherThreads, smem, s>>>(tab, table_rows, idx, span_rows,
                                                                n_fetch, sort, out);
  } else if (route == kShared) {
    const cudaError_t err = allow_shared(reinterpret_cast<const void*>(table_gather<kShared>),
                                         smem, table_shared_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    table_gather<kShared><<<n_tiles, kGatherThreads, smem, s>>>(tab, table_rows, idx,
                                                                span_rows, n_fetch, sort, out);
  } else {
    table_gather<kArith><<<n_tiles, kGatherThreads, 0, s>>>(tab, table_rows, idx, span_rows,
                                                            n_fetch, 0, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// axis 1: out [out_rows, 128] from x [x_rows, 128] by idx [out_rows, 128]
// or shift [out_rows] (one of the two), rows [out_rows] or null; axis 0:
// x, idx and out [x_rows, 128], x_rows a multiple of 32, shift and rows
// null. route 0 shfl, 1 smem, 2 local.
int wrt_lane_gather(const uint32_t* x, int x_rows, const int* idx, const int* shift,
                    const int* rows, int out_rows, int axis, int route, uint32_t* out,
                    void* stream) {
  if (x_rows <= 0 || out_rows <= 0 || route < kShfl || route > kLocal || axis < 0 || axis > 1 ||
      (idx == nullptr) == (shift == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    if (route == kShfl) {
      lane_gather_rows<kShfl><<<blocks_for(out_rows, kWarps), kThreads, 0, s>>>(
          x, x_rows, idx, shift, rows, out_rows, out);
    } else if (route == kSmem) {
      lane_gather_rows<kSmem><<<blocks_for(out_rows, kWarps), kThreads, 0, s>>>(
          x, x_rows, idx, shift, rows, out_rows, out);
    } else {
      lane_gather_rows<kLocal><<<blocks_for(out_rows, kThreads), kThreads, 0, s>>>(
          x, x_rows, idx, shift, rows, out_rows, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (idx == nullptr || rows != nullptr || out_rows != x_rows || x_rows % kTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = x_rows / kTileRows;
  if (route == kShfl) {
    lane_gather_cols<kShfl><<<blocks_for(static_cast<long long>(n_tiles) * 32, kWarps),
                              kThreads, 0, s>>>(x, idx, n_tiles, out);
  } else if (route == kSmem) {
    lane_gather_cols<kSmem><<<n_tiles, kThreads, 0, s>>>(x, idx, n_tiles, out);
  } else {
    lane_gather_cols<kLocal><<<n_tiles, kLocalColThreads, 0, s>>>(x, idx, n_tiles, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// base [batch, words] -> out [batch, n_reads, read_width]; vals
// [n_writes, write_width] and write_idx [n_writes] (null when n_writes is
// 0), write_width <= words; read_idx [n_reads]. route 0 shfl (words 32,
// 64, ..., 1024), 1 smem (words * 4 <= 232,448), 2 direct (n_writes <=
// 1024, batch * n_reads * read_width < 2^31).
int wrt_smem_rw(const uint32_t* base, int batch, int words, const uint32_t* vals,
                const int* write_idx, int n_writes, int write_width, const int* read_idx,
                int n_reads, int read_width, int route, uint32_t* out, void* stream) {
  if (batch <= 0 || words <= 0 || n_writes < 0 || write_width <= 0 || write_width > words ||
      n_reads <= 0 || read_width <= 0 || route < kShfl || route > kDirect ||
      (n_writes > 0 && (vals == nullptr || write_idx == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kDirect) {
    const long long total = static_cast<long long>(batch) * n_reads * read_width;
    if (n_writes > kMaxDirectWrites || total >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool vec = read_width % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const int per = vec ? 4 : 1;
    const unsigned items = static_cast<unsigned>(total / per);
    const unsigned per_scratch = static_cast<unsigned>(static_cast<long long>(n_reads) *
                                                       read_width / per);
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned fill = static_cast<unsigned>(sms * kDirectBlocksPerSm);
    const unsigned blocks = blocks_for(items, kThreads) < fill ? blocks_for(items, kThreads)
                                                               : fill;
    if (vec) {
      smem_rw_direct<4><<<blocks, kThreads, 0, s>>>(base, words, vals, write_idx, n_writes,
                                                    write_width, read_idx, n_reads, read_width,
                                                    per_scratch, items, out);
    } else {
      smem_rw_direct<1><<<blocks, kThreads, 0, s>>>(base, words, vals, write_idx, n_writes,
                                                    write_width, read_idx, n_reads, read_width,
                                                    per_scratch, items, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kSmem) {
    if (words > kMaxSharedBytes / 4) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = words * 4;
    const cudaError_t err =
        allow_shared(reinterpret_cast<const void*>(smem_rw_shared), smem, rw_shared_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_rw_shared<<<batch, kThreads, smem, s>>>(base, words, vals, write_idx, n_writes,
                                                 write_width, read_idx, n_reads, read_width,
                                                 out);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks = blocks_for(batch, kWarps);
#define WRT_SMEM_RW_SHFL(R)                                                                 \
  smem_rw_shfl<R><<<blocks, kThreads, 0, s>>>(base, batch, vals, write_idx, n_writes,      \
                                             write_width, read_idx, n_reads, read_width, out)
  switch (words) {
    case 32: WRT_SMEM_RW_SHFL(1); break;
    case 64: WRT_SMEM_RW_SHFL(2); break;
    case 128: WRT_SMEM_RW_SHFL(4); break;
    case 256: WRT_SMEM_RW_SHFL(8); break;
    case 512: WRT_SMEM_RW_SHFL(16); break;
    case 1024: WRT_SMEM_RW_SHFL(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WRT_SMEM_RW_SHFL
  return static_cast<int>(cudaGetLastError());
}

// x and out [rows, 128] f32, 16-byte aligned.
int wrt_row_sort(const float* x, int rows, float* out, void* stream) {
  if (rows <= 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = min(blocks_for(rows, kThreads / kSortRowThreads),
                              static_cast<unsigned>(sms * kSortBlocks));
  row_sort<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), rows, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x and out [rows, 128] f32, 16-byte aligned.
int wrt_lane_scan(const float* x, int rows, float* out, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lane_scan<<<blocks_for(rows, kWarps), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), rows, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local-memory bytes a thread and static shared bytes
// of kernel `which` (ops/cuda/access.py KERNEL_NAMES).
int wrt_access_attributes(int which, int* num_regs, int* local_bytes, int* shared_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(table_gather<kGlobal>),
      reinterpret_cast<const void*>(table_gather<kShared>),
      reinterpret_cast<const void*>(table_gather<kArith>),
      reinterpret_cast<const void*>(lane_gather_rows<kShfl>),
      reinterpret_cast<const void*>(lane_gather_rows<kSmem>),
      reinterpret_cast<const void*>(lane_gather_rows<kLocal>),
      reinterpret_cast<const void*>(lane_gather_cols<kShfl>),
      reinterpret_cast<const void*>(lane_gather_cols<kSmem>),
      reinterpret_cast<const void*>(lane_gather_cols<kLocal>),
      reinterpret_cast<const void*>(smem_rw_shfl<1>),
      reinterpret_cast<const void*>(smem_rw_shfl<2>),
      reinterpret_cast<const void*>(smem_rw_shfl<4>),
      reinterpret_cast<const void*>(smem_rw_shfl<8>),
      reinterpret_cast<const void*>(smem_rw_shfl<16>),
      reinterpret_cast<const void*>(smem_rw_shfl<32>),
      reinterpret_cast<const void*>(smem_rw_shared),
      reinterpret_cast<const void*>(smem_rw_direct<1>),
      reinterpret_cast<const void*>(smem_rw_direct<4>),
      reinterpret_cast<const void*>(row_sort),
      reinterpret_cast<const void*>(lane_scan),
  };
  if (which < 0 || which >= static_cast<int>(sizeof(fns) / sizeof(fns[0]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

}  // extern "C"
