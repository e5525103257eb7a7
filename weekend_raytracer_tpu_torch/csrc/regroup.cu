// The lane-regrouped wavefront for Hopper (sm_90a): K0, PACK, K1 and
// COMBINE, the counterparts of the four TPU kernels of
// weekend_raytracer_tpu/ops/pallas/regroup.py:
//
//   K0       _make_k0 (pallas_call at regroup.py:1198): camera ray and
//            bounces [0, c1) per ray slot; writes the 16-component record
//            pool and the contribution tr * cr.
//   PACK     _make_pack_kernel_v2 / _pack_kernel (regroup.py:1322): stable
//            compaction of live records into a dense pool, the inverse map
//            and the live count.
//   K1       _make_k1 (regroup.py:1378): bounces [b_lo, b_hi) on the dense
//            pool, in place, plus the base-radiance pool tr * cr. Its
//            stats kernel, regroup_k1_stats, is _make_k1(stats=True)
//            (regroup.py:618, 745-758; launched by
//            benchmarks/profile_regroup.py:244), which sweeps every sphere
//            and counts per dense tile of 4096 records (stats.cuh).
//   COMBINE  _make_level_kernel_v2 / _make_level_kernel (regroup.py:1467):
//            the reverse-composed levels, and at the home level the fold of
//            each pixel's samples into the scanline accumulator.
//
// Layout (ops/cuda/regroup.py): a pool is SoA [16, cap] f32 with slots in
// the JAX order, slot = (tile * 32 + row) * 128 + lane, 32-row x 128-lane
// tiles with spp folded into lanes. Records, inverse maps and counts can so
// be compared element for element with the JAX pipeline. The home slot
// stays two exact f32 integers (HLO = slot & 4095, HHI = slot >> 12).
//
// What bounds it on an H100: K0 and K1 are the megakernel's body
// (bounce.cuh), one thread per record, so after a cut every warp runs 32
// live paths; they are bound by FP32 work in the closest-hit sweep. Their
// design answers with less of it:
//   - A per-warp cull (bounce.cuh sweep_culled) in scenes with chunks: a
//     warp sweeps a chunk's spheres only if some lane's slab test enters
//     its box (and its super-chunk's), widened by the lane's own rounding
//     margin, closer than the lane's best-t or the priors' bound. The TPU culls
//     per 4096-lane tile; a warp is 128 times finer, and in K0's layout
//     (spp folded into lanes) a warp at 32 spp holds one pixel's samples,
//     whose first rays are nearly one beam. The result is the full
//     sweep's (bt, bi) in every bit.
//   - The box tables in shared memory: every lane tests every box each
//     bounce, so each block stages the chunk and super-chunk bounds and
//     the priors' sweep rows once, before its first bounce, with
//     cooperative loads (bounce.cuh stage_cull, which the megakernel
//     shares: 824 B on RTiOW, 8,240 B on random_spheres(10000)). TMA buys
//     nothing for a few KiB loaded once per block. Boxes above
//     kStageBytes (about 1,800 chunk and super boxes, some 57,000 spheres
//     at 32 a chunk) would cost blocks an SM, so such a scene reads them
//     from global memory through __ldg at the same warp-uniform addresses
//     (the kStaged = false instantiations); the launch picks the placement
//     from the table's size (cull_staged). The sphere
//     table stays in global memory: the warp reads one row at a time at a
//     warp-uniform address, which the L1 broadcasts, and
//     random_spheres(10000)'s 160 KiB would leave one block of 256
//     threads an SM.
//   - One register budget, kTraceMinBlocks = 5 blocks of 256 threads an
//     SM (48 registers), chosen on the card among 48, 56 and 64 registers
//     with no spills.
// PACK and COMBINE are bound by memory: PACK moves 64 bytes per live record
// (16 f32 components) and COMBINE 12 bytes of radiance per slot. PACK is one
// launch a cut (a single-pass scan by decoupled look-back) and COMBINE one
// launch a frame (it follows the inverse maps to each home slot); see their
// sections. No matrix unit is used.
//
// Counts stay on the card: PACK writes the live count to device memory and
// the launches that follow read it there. K1 is sized by its upper bound
// (the record capacity), and threads past the count return at once; PACK's
// persistent blocks stop at the first tile past its input count. So a frame
// has no host synchronisation between its kernels.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

// Record components (regroup.py:77-82).
enum Comp {
  kOX, kOY, kOZ, kDX, kDY, kDZ, kTR, kTG, kTB, kCR, kCG, kCB, kHLO, kAL, kHHI, kSPARE,
  kNComp,
};
constexpr int kHomeRadix = 4096;                       // slot = hhi * 4096 + hlo
constexpr float kDeadHHI = static_cast<float>(1 << 16);  // pad records: slot 2^28

constexpr int kThreads = 256;    // K0, K1: one thread per record
// K0's and K1's register budget: __launch_bounds__(kThreads,
// kTraceMinBlocks), five blocks of 256 threads an SM, holds them to 48
// registers (65536 / (5 * 256) = 51, allocated in steps of 8). Measured on
// an H100 against 52-56 (what ptxas takes when allowed 56 or 64) and
// 48-register builds by tools/cull_variants.py: K1 runs 3% faster at 48,
// K0 the same, with no spills. K1's stats kernel, which also carries the
// counters, keeps four blocks or three (below), as the stats megakernel
// does: at 48 it spills.
constexpr int kTraceMinBlocks = 5;
// K1's stats kernel: 4 blocks where it stages the table whole, 3 (80
// registers) where it sweeps windows, as the stats megakernel.
constexpr int kStatsMinBlocks = 4;     // the table staged whole
constexpr int kWindowedMinBlocks = 3;  // swept in windows

// Image geometry of the tiles: width, height, tiles across, log2(spp).
struct Tiling {
  int width, height, tiles_x, spp_shift;
};

// The pixel and sample of a slot (regroup.py:184-199 and 723-736). Lanes
// past the image edge are clamped into it; the fold never reads them.
__device__ __forceinline__ void slot_pixel(const Tiling& g, uint32_t slot, int& x, int& y,
                                           uint32_t& sample) {
  const uint32_t lane = slot & 127u;
  const uint32_t srow = slot >> 7;
  const int tile = static_cast<int>(srow >> 5);
  const int row = static_cast<int>(srow & 31u);
  const int block_w = 128 >> g.spp_shift;
  x = min((tile % g.tiles_x) * block_w + static_cast<int>(lane >> g.spp_shift), g.width - 1);
  y = min((tile / g.tiles_x) * 32 + row, g.height - 1);
  sample = lane & ((1u << g.spp_shift) - 1u);
}

// The pixel index of the seed, in full-image rows (regroup.py:194-199).
__device__ __forceinline__ uint32_t seed_pixel(const Tiling& g, int x, int y,
                                               uint32_t row_offset) {
  const uint32_t y_g = static_cast<uint32_t>(y) + row_offset;
  return y_g * static_cast<uint32_t>(g.width) + static_cast<uint32_t>(x);
}

struct K0Args {
  const float* cam;  // [20]
  SceneRefs scene;
  CullRefs cull;
  CullMargin margin;
  float* pool;       // [16, cap]
  float* contrib;    // [3, cap]
  long long cap;
  Tiling g;
  float inv_w, inv_h;  // f32(1 / width), f32(1 / full_height)
  uint32_t frame, row_offset;
  int b_hi;
};

// K0: camera ray and bounces [0, b_hi) of one slot; every slot is written.
template <bool kTextured, bool kStaged>
__global__ void __launch_bounds__(kThreads, kTraceMinBlocks) regroup_k0(const K0Args a) {
  const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  const long long slot = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= a.cap) return;
  int x, y;
  uint32_t sample;
  slot_pixel(a.g, static_cast<uint32_t>(slot), x, y, sample);
  const uint32_t y_g = static_cast<uint32_t>(y) + a.row_offset;
  Ray r;
  r.state = sample_seed(seed_pixel(a.g, x, y, a.row_offset), jenkins(a.frame), sample);
  camera_ray(a.cam, static_cast<float>(x), static_cast<float>(static_cast<int>(y_g)), a.inv_w,
             a.inv_h, r);
  trace_bounces<kTextured, kStaged>(a.scene, 0, a.b_hi, r, &cv);

  float* p = a.pool + slot;
  const long long c = a.cap;
  p[kOX * c] = r.ox;
  p[kOY * c] = r.oy;
  p[kOZ * c] = r.oz;
  p[kDX * c] = r.dx;
  p[kDY * c] = r.dy;
  p[kDZ * c] = r.dz;
  p[kTR * c] = r.tr;
  p[kTG * c] = r.tg;
  p[kTB * c] = r.tb;
  p[kCR * c] = r.cr;
  p[kCG * c] = r.cg;
  p[kCB * c] = r.cb;
  p[kHLO * c] = static_cast<float>(static_cast<int>(slot & (kHomeRadix - 1)));
  p[kAL * c] = r.alive ? 1.0f : 0.0f;
  p[kHHI * c] = static_cast<float>(static_cast<int>(slot >> 12));
  p[kSPARE * c] = 0.0f;
  float* q = a.contrib + slot;
  q[0] = r.tr * r.cr;
  q[c] = r.tg * r.cg;
  q[2 * c] = r.tb * r.cb;
}

struct K1Args {
  SceneRefs scene;
  CullRefs cull;
  CullMargin margin;  // read by the culled kernel (sweep_culled)
  float* pool;       // [16, cap] dense, updated in place
  float* r8;         // [3, cap] base radiance tr * cr
  const int* count;  // live records in the pool
  long long cap;
  Tiling g;
  uint32_t frame, row_offset;
  int b_lo, b_hi;
};

// What K1's stats kernel reads besides: the counters and its windows of
// the sphere table (stats_plan).
struct K1StatsArgs : K1Args {
  StatsRefs st;
  int window;             // spheres a window
  unsigned table_offset;  // where the table starts in dynamic shared memory
};

constexpr int kTileRecords = 32 * 128;  // a dense TPU tile (regroup.py:679-721)

// Dense record i of K1's pool as the Ray entering bounce b_lo. The RNG
// state is the home slot's seed advanced 4 * (b_lo + 1) draws
// (regroup.py:723-741).
__device__ __forceinline__ void load_record(const K1Args& a, long long i, Ray& r) {
  const float* p = a.pool + i;
  const long long c = a.cap;
  const uint32_t slot = static_cast<uint32_t>(static_cast<int>(p[kHHI * c])) * kHomeRadix +
                        static_cast<uint32_t>(static_cast<int>(p[kHLO * c]));
  int x, y;
  uint32_t sample;
  slot_pixel(a.g, slot, x, y, sample);
  r.state = sample_seed(seed_pixel(a.g, x, y, a.row_offset), jenkins(a.frame), sample);
  for (int k = 0; k < 4 * (a.b_lo + 1); ++k) rng_step(r.state);
  r.ox = p[kOX * c];
  r.oy = p[kOY * c];
  r.oz = p[kOZ * c];
  r.dx = p[kDX * c];
  r.dy = p[kDY * c];
  r.dz = p[kDZ * c];
  r.tr = p[kTR * c];
  r.tg = p[kTG * c];
  r.tb = p[kTB * c];
  r.cr = p[kCR * c];
  r.cg = p[kCG * c];
  r.cb = p[kCB * c];
  r.alive = true;
}

// The path after K1's bounces back into record i, in place, and its base
// radiance tr * cr into r8.
__device__ __forceinline__ void store_record(const K1Args& a, long long i, const Ray& r) {
  float* p = a.pool + i;
  const long long c = a.cap;
  p[kOX * c] = r.ox;
  p[kOY * c] = r.oy;
  p[kOZ * c] = r.oz;
  p[kDX * c] = r.dx;
  p[kDY * c] = r.dy;
  p[kDZ * c] = r.dz;
  p[kTR * c] = r.tr;
  p[kTG * c] = r.tg;
  p[kTB * c] = r.tb;
  p[kCR * c] = r.cr;
  p[kCG * c] = r.cg;
  p[kCB * c] = r.cb;
  p[kAL * c] = r.alive ? 1.0f : 0.0f;
  float* q = a.r8 + i;
  q[0] = r.tr * r.cr;
  q[c] = r.tg * r.cg;
  q[2 * c] = r.tb * r.cb;
}

// K1: bounces [b_lo, b_hi) of one dense record. A block wholly past the
// count returns before it stages the cull tables.
template <bool kTextured, bool kStaged = true>
__global__ void __launch_bounds__(kThreads, kTraceMinBlocks) regroup_k1(const K1Args a) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = *a.count;
  if (first >= count) return;
  const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  const long long i = first + threadIdx.x;
  if (i >= count) return;
  Ray r;
  load_record(a, i, r);
  trace_bounces<kTextured, kStaged>(a.scene, a.b_lo, a.b_hi, r, &cv);
  store_record(a, i, r);
}

// K1's stats kernel, _make_k1(stats=True) at tsub1 = 32 (regroup.py:618,
// 745-758): K1's bounces with every sphere swept, counted per dense tile
// of 4096 records (stats.cuh; col 0 the tile's loop trips from b_lo). A
// persistent grid (the blocks the card holds at once) walks the records:
// each lane traces one record, one bounce a step, writes it back when its
// path ends or reaches b_hi, and takes the next record (take_item), so a
// lane idles only at the end of the pool; records are written in place
// and the counters are keyed by (dense tile, iteration), so the order
// changes no bit. Each step is one full sweep (bounce.cuh's stats
// section) of every lane that holds a record: where the table is staged
// whole each warp steps on its own, where it is swept in windows
// (kWindowed) the block steps together, every thread taking part in
// staging and the barriers until the pool is done. A block whose first records lie past the count
// returns at once.
template <bool kTextured, bool kStaged, bool kWindowed>
__global__ void __launch_bounds__(kThreads, kWindowed ? kWindowedMinBlocks : kStatsMinBlocks)
    regroup_k1_stats(const K1StatsArgs a) {
  const int count = *a.count;
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i - static_cast<int>(threadIdx.x) >= count) return;
  const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  float4* tab = stats_table(a.table_offset);
  const int n = a.scene.n;
  if constexpr (!kWindowed) {
    stage_window(tab, a.scene.sweep, 0, n);
    __syncthreads();
  }
  Ray r;
  int bounce = a.b_hi;  // bounce == b_hi: no record in hand
  if (i < count) {
    load_record(a, i, r);
    bounce = a.b_lo;
  }
  for (;;) {
    const bool live = bounce < a.b_hi;
    if (kWindowed ? !__syncthreads_or(live) : !__any_sync(0xffffffffu, live)) break;
    const int group = i / kTileRecords;
    CountedSweep cs;
    if (live) {
      begin_counted(cv, r, static_cast<unsigned>(group * a.st.n_iters + bounce - a.b_lo), cs);
    }
    if constexpr (kWindowed) {
      for (int w0 = 0; w0 < n; w0 += a.window) {
        const int nw = min(a.window, n - w0);
        __syncthreads();
        stage_window(tab, a.scene.sweep, w0, nw);
        __syncthreads();
        if (live) sweep_window<kStaged>(tab, w0, nw, cv, a.st, cs);
      }
    } else if (live) {
      sweep_window<kStaged>(tab, 0, n, cv, a.st, cs);
    }
    bool need = false;  // this lane's record is written back: it takes another
    if (live) {
      end_counted<kStaged>(cv, a.st, cs);
      const bool on = scatter_hit<kTextured>(a.scene, r, cs.bt, cs.bi);
      // the trips of this record's loop: its bounce steps, each a full sweep
      const unsigned trips = static_cast<unsigned>(bounce - a.b_lo) + 1u;
      if (on && ++bounce < a.b_hi) {
        // a live path's colour is 0 and it is alive (the pool holds live
        // records): said here so that neither is carried from step to step
        r.cr = r.cg = r.cb = 0.0f;
        r.alive = true;
      } else {
        count_trips(a.st, group, trips, 1u);
        store_record(a, i, r);
        bounce = a.b_hi;
        need = true;
      }
    }
    const long long next = take_item(a.st.ticket, need);
    if (need && next < count) {
      i = static_cast<int>(next);
      load_record(a, i, r);
      bounce = a.b_lo;
    }
  }
}

// --- PACK: one launch, a single-pass stable compaction -------------------
//
// The TPU pack carries a partial row from one grid step to the next, which
// needs the TPU's in-order grid (regroup.py:20-26). Here one launch does
// the same stable compaction by decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016): a block takes tiles of kPackTile slots in order from an atomic
// ticket, so every earlier tile is taken by a block already running and
// the look-back cannot deadlock; it publishes its live count, then its
// inclusive prefix, as one 64-bit status word (flag << 32 | value, release
// store, acquire load), and sums its predecessors' words back to the first
// inclusive one. The grid is persistent (the blocks that fit the card at
// once), and a block stops at the first tile past the input count, so a
// PACK costs what its live input does. Within a tile each warp owns 256
// consecutive slots, read as two full lines of 16-byte loads; a record's
// rank is a count of warp ballots, and each of the 16 component planes is
// compacted through shared memory so that its stores to the dense pool are
// contiguous, with the loads of the next planes in flight meanwhile. The
// tile and the depth of those loads were chosen by tools/pack_tiles.py,
// which times other values of both. The alive plane is read once. The
// dense order, the inverse map and the count are those of the JAX pack.
// Left out: _INV_FIRST and the spare tile, which serve the TPU's windowed
// combine and its clamped row DMAs; a gather needs neither, and every
// write here lies below ceil(live / 128) * 128 <= cap.

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackItems = 2;  // float4 loads a thread makes per plane of a tile
constexpr int kPackWarpSlots = 32 * 4 * kPackItems;  // 256
constexpr int kPackTile = kPackWarps * kPackWarpSlots;  // 2048 slots
constexpr int kPackDepth = 2;  // planes whose loads are in flight at once
constexpr unsigned long long kTileAggregate = 1ull << 32;  // status flags
constexpr unsigned long long kTilePrefix = 2ull << 32;

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

struct PackArgs {
  const float* pool;    // [16, cap], count_in live records
  float* dense;         // [16, cap]
  int* inv;             // [cap]
  const int* count_in;
  int* count_out;
  unsigned long long* status;  // [cap / kPackTile] tile status words, then the ticket
  long long cap;
};

// The sum of its predecessors' live counts, for a tile that has published
// its own aggregate: warp 0 reads 32 status words at a time, nearest first,
// waits until each has a flag, and sums back to the nearest inclusive
// prefix (tile -1 reads as an inclusive prefix of 0).
__device__ int look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int j = tile - 1;; j -= 32) {
    unsigned long long s;
    do {
      s = j - lane >= 0 ? load_acquire(status + j - lane) : kTilePrefix;
    } while (__any_sync(0xffffffffu, (s >> 32) == 0));
    const unsigned prefixes = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & 0xffffffffu) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (prefixes) return excl;
  }
}

// Plane k of a thread's items, a 16-byte load for each item with a live
// slot (the alive plane is already in registers).
__device__ __forceinline__ void load_plane(float4 (&v)[kPackItems], const PackArgs& a, int k,
                                           int first, unsigned live,
                                           const float4 (&alive)[kPackItems]) {
#pragma unroll
  for (int i = 0; i < kPackItems; ++i) {
    if ((live >> (4 * i)) & 15u) {
      v[i] = k == kAL ? alive[i]
                      : __ldg(reinterpret_cast<const float4*>(a.pool + k * a.cap + first +
                                                               128 * i));
    }
  }
}

__global__ void __launch_bounds__(kPackThreads) regroup_pack(const PackArgs a) {
  __shared__ float stage[2][kPackTile];
  __shared__ int warp_count[kPackWarps];
  __shared__ int tile_at, tile_prefix;
  const int n_in = *a.count_in;
  if (n_in == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.count_out = 0;
    return;
  }
  const int n_tiles = (n_in + kPackTile - 1) / kPackTile;
  unsigned long long* ticket = a.status + a.cap / kPackTile;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long cap = a.cap;
  for (;;) {
    if (t == 0) tile_at = static_cast<int>(atomicAdd(ticket, 1ull));
    __syncthreads();
    const int tile = tile_at;
    if (tile >= n_tiles) return;
    // slot of this thread's item i: first + 128 i (+ e for its e-th float)
    const int first = tile * kPackTile + warp * kPackWarpSlots + lane * 4;
    float4 alive[kPackItems];
    unsigned live = 0;  // bit 4 i + e: the slot is below n_in and alive
#pragma unroll
    for (int i = 0; i < kPackItems; ++i) {
      const int s = first + 128 * i;
      alive[i] = s < n_in ? __ldg(reinterpret_cast<const float4*>(a.pool + kAL * cap + s))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (s + e < n_in && lane_of(alive[i], e) > 0.5f) live |= 1u << (4 * i + e);
      }
    }
    // the first kPackDepth planes' loads go out now, ahead of the ranks and
    // the look-back
    float4 v[kPackDepth][kPackItems];
#pragma unroll
    for (int d = 0; d < kPackDepth; ++d) load_plane(v[d], a, d, first, live, alive);
    // rank within the warp, in slot order (item, lane, element): the warp's
    // live slots in earlier items, then in this item's lower lanes
    int rank[kPackItems];
    int count = 0;
#pragma unroll
    for (int i = 0; i < kPackItems; ++i) {
      int lower = 0, total = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned m = __ballot_sync(0xffffffffu, (live >> (4 * i + e)) & 1u);
        lower += __popc(m & below);
        total += __popc(m);
      }
      rank[i] = count + lower;
      count += total;
    }
    if (lane == 0) warp_count[warp] = count;
    __syncthreads();
    int tile_count = 0, warp_first = 0;
#pragma unroll
    for (int w = 0; w < kPackWarps; ++w) {
      const int c = warp_count[w];
      warp_first += w < warp ? c : 0;
      tile_count += c;
    }
    if (warp == 0) {
      if (tile == 0) {
        if (lane == 0) {
          store_release(a.status, kTilePrefix | static_cast<unsigned>(tile_count));
          tile_prefix = 0;
        }
      } else {
        if (lane == 0) {
          store_release(a.status + tile, kTileAggregate | static_cast<unsigned>(tile_count));
        }
        const int excl = look_back(a.status, tile);
        if (lane == 0) {
          store_release(a.status + tile,
                        kTilePrefix | static_cast<unsigned>(excl + tile_count));
          tile_prefix = excl;
        }
      }
    }
    __syncthreads();
    const int prefix = tile_prefix;
    // the inverse map: each input slot's dense position, or -1
#pragma unroll
    for (int i = 0; i < kPackItems; ++i) {
      const int s = first + 128 * i;
      int pos[4];
      int r = prefix + warp_first + rank[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = (live >> (4 * i + e)) & 1u;
        pos[e] = on ? r : -1;
        r += on ? 1 : 0;
      }
      if (s + 3 < n_in) {
        *reinterpret_cast<int4*>(a.inv + s) = make_int4(pos[0], pos[1], pos[2], pos[3]);
      } else {
        for (int e = 0; e < 4 && s + e < n_in; ++e) a.inv[s + e] = pos[e];
      }
    }
    // the 16 planes, each compacted through shared memory (two buffers, one
    // barrier a plane), with the loads of the next kPackDepth - 1 planes
    // in flight meanwhile
#pragma unroll
    for (int k = 0; k < kNComp; ++k) {
      float* buf = stage[k & 1];
      float4(&cur)[kPackItems] = v[k % kPackDepth];
#pragma unroll
      for (int i = 0; i < kPackItems; ++i) {
        int r = warp_first + rank[i];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((live >> (4 * i + e)) & 1u) buf[r++] = lane_of(cur[i], e);
        }
      }
      if (k + kPackDepth < kNComp) load_plane(cur, a, k + kPackDepth, first, live, alive);
      __syncthreads();
      float* out = a.dense + k * cap + prefix;
      for (int j = t; j < tile_count; j += kPackThreads) out[j] = buf[j];
    }
    // the tile that holds the last input slot writes the count and pads the
    // last dense row with dead records (alive 0, HHI = 2^16, the rest 0), as
    // the JAX pack's final flush does (regroup.py:595-613)
    if (tile == n_tiles - 1) {
      const int total = prefix + tile_count;
      if (t == 0) *a.count_out = total;
      const int p = total + t;
      if (t < 128 && p < ((total + 127) & ~127)) {
        for (int k = 0; k < kNComp; ++k) a.dense[k * cap + p] = k == kHHI ? kDeadHHI : 0.0f;
      }
    }
  }
}

// --- COMBINE: one launch, the inverse maps followed to the home slot ------
//
// Walking the phases last to first, R_i[p] = R_{i+1}[inv_{i+1}[p]] if the
// record at position p of phase i lived on, else its own base radiance
// (regroup.py:1396-1483). The TPU writes each level out because a core
// cannot gather across rows; a CUDA thread follows the inverse maps from a
// home slot down to the phase its record ended in (j1 = inv[0][s], else
// contrib[:, s]; j2 = inv[1][j1], else r8[0][:, j1]; ...) and reads that
// phase's radiance: the value the reverse-composed levels leave at the home
// level, bit for bit, with no level written to device memory. A block owns
// `group` tiles across x (a scanline run of 32 pixels or more where the
// image allows) and walks their 32 rows kCombineUnit slots at a time:
// consecutive threads take consecutive slots, so the inverse maps and
// contributions are read in full lines, and the later maps and radiance
// pools nearly so (PACK is stable, so a run of slots keeps its order among
// the dense positions). The three channels go to shared memory, each
// pixel's samples padded to an odd stride so that a thread per pixel reads
// them without bank conflicts, and that thread sums them in sample order
// from 0 and adds the sum to the accumulator (or writes it over it), as the
// megakernel sums a pixel's samples. Bound by bytes: a slot's inverse-map
// entry, an entry per phase its record lived into, one radiance triple, and
// the accumulator.

constexpr int kCombineThreads = 256;
constexpr int kCombineUnit = 2048;  // slots staged at once
constexpr int kCombinePer = kCombineUnit / kCombineThreads;
constexpr int kCombineStage = kCombineUnit + kCombineUnit / 2;  // spp 2: stride 3 a pixel

struct CombineArgs {
  const int* inv;        // [phases, cap]: inverse map of each PACK
  const float* r8;       // [phases, 3, cap]: each phase's base radiance, dense order
  const float* contrib;  // [3, cap]: K0's contributions, slot order
  float* acc;            // [height * width, 3]
  long long cap;
  Tiling g;
  int phases, group, clear;
};

// Tiles across x of a COMBINE block: 32 pixels of a row where the spp allows
// (1 << (spp_shift - 2) tiles of 128 >> spp_shift pixels), at most 16 tiles.
inline int combine_group(int spp_shift) {
  return spp_shift < 2 ? 1 : std::min(16, 1 << (spp_shift - 2));
}

__global__ void __launch_bounds__(kCombineThreads) regroup_combine(const CombineArgs a) {
  __shared__ float stage[3][kCombineStage];
  const Tiling& g = a.g;
  const int shift = g.spp_shift;
  const int spp = 1 << shift;
  const int block_w = 128 >> shift;
  const int row_slots = a.group * 128;
  const int rows = kCombineUnit / row_slots;  // rows a unit stages
  const int row_px = a.group * block_w;
  const int unit_px = kCombineUnit >> shift;
  const int stride = spp == 1 ? 1 : spp + 1;  // odd: a warp's pixels on distinct banks
  const int groups_x = (g.tiles_x + a.group - 1) / a.group;
  const int ty = blockIdx.x / groups_x;
  const int tx0 = (blockIdx.x % groups_x) * a.group;
  const long long cap = a.cap;
  for (int r0 = 0; r0 < 32 && ty * 32 + r0 < g.height; r0 += rows) {
    int slot[kCombinePer], j[kCombinePer], level[kCombinePer];
#pragma unroll
    for (int i = 0; i < kCombinePer; ++i) {
      const int u = threadIdx.x + i * kCombineThreads;
      const int row = r0 + u / row_slots;
      const int tx = tx0 + (u % row_slots >> 7);
      const int lane = u & 127;
      const int x = tx * block_w + (lane >> shift);
      slot[i] = ((ty * g.tiles_x + tx) * 32 + row) * 128 + lane;
      const bool real = x < g.width && ty * 32 + row < g.height;
      j[i] = real ? __ldg(a.inv + slot[i]) : -1;
      level[i] = real ? (j[i] >= 0 ? 0 : -1) : -2;  // -1: K0's contribution; -2: no pixel
    }
    for (int k = 1; k < a.phases; ++k) {
#pragma unroll
      for (int i = 0; i < kCombinePer; ++i) {
        if (level[i] == k - 1) {
          const int next = __ldg(a.inv + k * cap + j[i]);
          if (next >= 0) {
            j[i] = next;
            level[i] = k;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCombinePer; ++i) {
      if (level[i] == -2) continue;
      const float* src = level[i] < 0 ? a.contrib + slot[i] : a.r8 + level[i] * 3 * cap + j[i];
      const int u = threadIdx.x + i * kCombineThreads;
      const int at = spp == 1 ? u : u + (u >> shift);
      stage[0][at] = __ldg(src);
      stage[1][at] = __ldg(src + cap);
      stage[2][at] = __ldg(src + 2 * cap);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < unit_px; q += kCombineThreads) {
      const int x = tx0 * block_w + q % row_px;
      const int y = ty * 32 + r0 + q / row_px;
      if (x >= g.width || y >= g.height) continue;
      float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
      const int at = q * stride;
      for (int s = 0; s < spp; ++s) {
        tot_r = tot_r + stage[0][at + s];
        tot_g = tot_g + stage[1][at + s];
        tot_b = tot_b + stage[2][at + s];
      }
      float* out = a.acc + (static_cast<size_t>(y) * g.width + x) * 3;
      const float base_r = a.clear ? 0.0f : out[0];
      const float base_g = a.clear ? 0.0f : out[1];
      const float base_b = a.clear ? 0.0f : out[2];
      out[0] = base_r + tot_r;
      out[1] = base_g + tot_g;
      out[2] = base_b + tot_b;
    }
    __syncthreads();
  }
}

unsigned blocks(long long n, int per) { return static_cast<unsigned>((n + per - 1) / per); }

SceneRefs scene_refs(const float* sky, const float* sweep, const float* attrs,
                     const int* tex_pool, int n_spheres) {
  SceneRefs s;
  s.sky = sky;
  s.sweep = reinterpret_cast<const float4*>(sweep);
  s.attrs = attrs;
  s.tex_pool = tex_pool;
  s.n = n_spheres;
  return s;
}

Tiling tiling(int width, int height, int tiles_x, int spp_shift) {
  Tiling g;
  g.width = width;
  g.height = height;
  g.tiles_x = tiles_x;
  g.spp_shift = spp_shift;
  return g;
}

CullRefs cull_refs(const float* chunk_bounds, const float* super_bounds, const int* priors,
                   int n_chunks, int n_tests, int n_super, int chunk_size, int super_factor) {
  return CullRefs{chunk_bounds, super_bounds, priors, n_chunks, n_tests,
                  n_super, chunk_size, super_factor};
}

// Launch K0 or K1 with its dynamic shared memory (cull_smem_bytes), as
// `staged` (kStaged = true) where cull_staged and as `global` otherwise.
template <class Kernel, class KArgs>
int launch_culled(Kernel staged, Kernel global, const KArgs& a, long long cap, cudaStream_t s) {
  const Kernel kernel = cull_staged(a.cull) ? staged : global;
  kernel<<<blocks(cap, kThreads), kThreads, cull_smem_bytes(a.cull), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// regroup_k1_stats by [textured][boxes staged][windowed].
void (*const kK1StatsKernels[2][2][2])(K1StatsArgs) = {
    {{regroup_k1_stats<false, false, false>, regroup_k1_stats<false, false, true>},
     {regroup_k1_stats<false, true, false>, regroup_k1_stats<false, true, true>}},
    {{regroup_k1_stats<true, false, false>, regroup_k1_stats<true, false, true>},
     {regroup_k1_stats<true, true, false>, regroup_k1_stats<true, true, true>}},
};

K1StatsArgs k1_args(const float* sky, const float* sweep, const float* attrs, const int* tex_pool,
               int n_spheres, float* pool, float* r8, const int* count, long long cap, int width,
               int height, int tiles_x, int spp_shift, unsigned frame, unsigned row_offset,
               int b_lo, int b_hi, const CullRefs& cull) {
  K1StatsArgs a = {};
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
  a.cull = cull;
  a.pool = pool;
  a.r8 = r8;
  a.count = count;
  a.cap = cap;
  a.g = tiling(width, height, tiles_x, spp_shift);
  a.frame = frame;
  a.row_offset = row_offset;
  a.b_lo = b_lo;
  a.b_hi = b_hi;
  return a;
}

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers, and returns cudaGetLastError() after its launches. `cap` is
// the slot count, a multiple of 4096 below 2^28. K0 and K1 take the cull
// hierarchy of prepare_scene_arrays (n_chunks = 0: none, every sphere is
// swept), as the stats entry point does, and the two scene terms of each
// lane's box margin (KernelInputs.cull_reach, cull_scale).

int wrt_regroup_k0(const float* cam, const float* sky, const float* sweep, const float* attrs,
                   const int* tex_pool, int n_spheres, float* pool, float* contrib,
                   long long cap, int width, int height, int tiles_x, int spp_shift,
                   float inv_w, float inv_h, unsigned frame, unsigned row_offset, int b_hi,
                   const float* chunk_bounds, const float* super_bounds, const int* priors,
                   int n_chunks, int n_tests, int n_super, int chunk_size, int super_factor,
                   float cull_reach, float cull_scale, void* stream) {
  K0Args a;
  a.cam = cam;
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
  a.cull = cull_refs(chunk_bounds, super_bounds, priors, n_chunks, n_tests, n_super, chunk_size,
                     super_factor);
  a.margin = CullMargin{cull_reach, cull_scale};
  a.pool = pool;
  a.contrib = contrib;
  a.cap = cap;
  a.g = tiling(width, height, tiles_x, spp_shift);
  a.inv_w = inv_w;
  a.inv_h = inv_h;
  a.frame = frame;
  a.row_offset = row_offset;
  a.b_hi = b_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tex_pool != nullptr
             ? launch_culled(regroup_k0<true, true>, regroup_k0<true, false>, a, cap, s)
             : launch_culled(regroup_k0<false, true>, regroup_k0<false, false>, a, cap, s);
}

// count_in: live records of `pool`; writes count_out, `dense` and `inv`.
// status holds cap / 2048 + 1 u64 words of scratch (the tiles' status
// words and the ticket), cleared here on the stream before the launch.
int wrt_regroup_pack(const float* pool, float* dense, int* inv, const int* count_in,
                     int* count_out, unsigned long long* status, long long cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = cap / kPackTile;
  cudaError_t err = cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, per_sm = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, regroup_pack, kPackThreads,
                                                           0)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  PackArgs a{pool, dense, inv, count_in, count_out, status, cap};
  const long long grid = std::max(1LL, std::min(static_cast<long long>(per_sm) * sms, tiles));
  regroup_pack<<<static_cast<unsigned>(grid), kPackThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int wrt_regroup_k1(const float* sky, const float* sweep, const float* attrs, const int* tex_pool,
                   int n_spheres, float* pool, float* r8, const int* count, long long cap,
                   int width, int height, int tiles_x, int spp_shift, unsigned frame,
                   unsigned row_offset, int b_lo, int b_hi, const float* chunk_bounds,
                   const float* super_bounds, const int* priors, int n_chunks, int n_tests,
                   int n_super, int chunk_size, int super_factor, float cull_reach,
                   float cull_scale, void* stream) {
  K1Args a = k1_args(sky, sweep, attrs, tex_pool, n_spheres, pool, r8, count, cap, width, height,
                     tiles_x, spp_shift, frame, row_offset, b_lo, b_hi,
                     cull_refs(chunk_bounds, super_bounds, priors, n_chunks, n_tests, n_super,
                               chunk_size, super_factor));
  a.margin = CullMargin{cull_reach, cull_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tex_pool != nullptr
             ? launch_culled(regroup_k1<true, true>, regroup_k1<true, false>, a, cap, s)
             : launch_culled(regroup_k1<false, true>, regroup_k1<false, false>, a, cap, s);
}

// K1 through its stats kernel: also writes the per-dense-tile
// counters into stats [cap / 4096, 8] f32 (rows of tiles past the count
// stay 0). The cull hierarchy is prepare_scene_arrays'; scratch holds
// scratch_words u32 words (stats_scratch_words with groups = cap / 4096
// and n_iters = b_hi - b_lo).
int wrt_regroup_k1_stats(const float* sky, const float* sweep, const float* attrs,
                         const int* tex_pool, int n_spheres, float* pool, float* r8,
                         const int* count, long long cap, int width, int height, int tiles_x,
                         int spp_shift, unsigned frame, unsigned row_offset, int b_lo, int b_hi,
                         const float* chunk_bounds, const float* super_bounds, const int* priors,
                         int n_chunks, int n_tests, int n_super, int chunk_size,
                         int super_factor, unsigned* scratch, long long scratch_words,
                         float* stats, void* stream) {
  K1StatsArgs a = k1_args(sky, sweep, attrs, tex_pool, n_spheres, pool, r8, count, cap, width,
                          height, tiles_x, spp_shift, frame, row_offset, b_lo, b_hi,
                          cull_refs(chunk_bounds, super_bounds, priors, n_chunks, n_tests,
                                    n_super, chunk_size, super_factor));
  const int n_tiles = static_cast<int>(cap / kTileRecords);
  if (b_hi <= b_lo ||
      scratch_words != stats_scratch_words(n_tiles, b_hi - b_lo, n_tests, n_super)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.st = stats_refs(scratch, n_tiles, b_hi - b_lo, n_tests, n_super, stats);
  const StatsPlan plan = stats_plan(a.cull, n_spheres);
  a.window = plan.window;
  a.table_offset = static_cast<unsigned>(plan.table_offset);
  const auto kernel = kK1StatsKernels[tex_pool != nullptr][cull_staged(a.cull)][plan.windows > 1];
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, plan.smem, cap, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_counted(scratch, scratch_words, a.st, n_tests, n_super, super_factor, 1, n_tiles,
                     stats, s, [&] { kernel<<<grid, kThreads, plan.smem, s>>>(a); });
}

// inv [phases, cap] i32 and r8 [phases, 3, cap] f32: each PACK's inverse
// map and each phase's base radiance; contrib [3, cap] K0's contributions;
// acc [height * width, 3], added to, or written over when `clear`.
int wrt_regroup_combine(const int* inv, const float* r8, const float* contrib, float* acc,
                        int phases, long long cap, int width, int height, int tiles_x,
                        int spp_shift, int clear, void* stream) {
  CombineArgs a{inv, r8, contrib, acc, cap, tiling(width, height, tiles_x, spp_shift),
                phases, combine_group(spp_shift), clear};
  const unsigned grid = static_cast<unsigned>(((height + 31) / 32) *
                                              ((tiles_x + a.group - 1) / a.group));
  regroup_combine<<<grid, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and static shared bytes of one
// kernel, as the CUDA runtime reports them; returns a cudaError_t.
// `which`: 0/1 K0 untextured/textured, 2/3 K1, 4 PACK, 5 COMBINE, 6/7 K1's
// stats kernel (its table staged whole), 8/9 K0, 10/11 K1 and 12/13 K1's
// stats kernel with the box tables in global memory (kStaged = false), 14/15
// and 16/17 K1's stats kernel in windows (kWindowed), boxes staged and not.
int wrt_regroup_attributes(int which, int* num_regs, int* local_bytes, int* shared_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(regroup_k0<false, true>),
      reinterpret_cast<const void*>(regroup_k0<true, true>),
      reinterpret_cast<const void*>(regroup_k1<false, true>),
      reinterpret_cast<const void*>(regroup_k1<true, true>),
      reinterpret_cast<const void*>(regroup_pack),
      reinterpret_cast<const void*>(regroup_combine),
      reinterpret_cast<const void*>(regroup_k1_stats<false, true, false>),
      reinterpret_cast<const void*>(regroup_k1_stats<true, true, false>),
      reinterpret_cast<const void*>(regroup_k0<false, false>),
      reinterpret_cast<const void*>(regroup_k0<true, false>),
      reinterpret_cast<const void*>(regroup_k1<false, false>),
      reinterpret_cast<const void*>(regroup_k1<true, false>),
      reinterpret_cast<const void*>(regroup_k1_stats<false, false, false>),
      reinterpret_cast<const void*>(regroup_k1_stats<true, false, false>),
      reinterpret_cast<const void*>(regroup_k1_stats<false, true, true>),
      reinterpret_cast<const void*>(regroup_k1_stats<true, true, true>),
      reinterpret_cast<const void*>(regroup_k1_stats<false, false, true>),
      reinterpret_cast<const void*>(regroup_k1_stats<true, false, true>),
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

// K0's and K1's launch bounds: threads a block and the blocks an SM that
// fix their register budget.
void wrt_regroup_launch_bounds(int* threads, int* min_blocks) {
  *threads = kThreads;
  *min_blocks = kTraceMinBlocks;
}

// Dynamic shared bytes of a block of K0 or K1 for a cull hierarchy
// (stage_cull), and in `staged` whether its boxes are among them.
long long wrt_regroup_cull_smem(int n_chunks, int n_tests, int n_super, int* staged) {
  CullRefs cu = {};
  cu.n_chunks = n_chunks;
  cu.n_tests = n_tests;
  cu.n_super = n_super;
  *staged = n_chunks > 0 && cull_staged(cu);
  return static_cast<long long>(cull_smem_bytes(cu));
}

}  // extern "C"
