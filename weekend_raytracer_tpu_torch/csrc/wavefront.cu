// The row-compacted wavefront for Hopper (sm_90a): K0, COMPACT and K1, the
// counterparts of the three TPU kernels of
// weekend_raytracer_tpu/ops/pallas/wavefront.py:
//
//   K0       _make_k0 (pallas_call at wavefront.py:404): camera ray and
//            bounces [0, b1) per ray slot; writes the 15-component record
//            pool and each slot's contribution tr * cr.
//   COMPACT  _compact_kernel (wavefront.py:427): stable row-granular
//            compaction. Every 128-lane row with any live lane, among the
//            first count_in rows, is copied whole, in order, to a dense
//            pool; count_out is the number of rows copied.
//   K1       _make_k1 (wavefront.py:461): bounces [b_lo, b_hi) on the
//            count dense rows, written back in place, and every lane's
//            tr * cr to its row's home row of the contributions.
//
// Layout (ops/cuda/wavefront.py), the JAX one: a pool is [tiles, 15, 32,
// 128] f32, each tile's components a contiguous (32, 128) plane; a
// contribution buffer is [tiles, 3, 32, 128]. Slot = (tile * 32 + row) *
// 128 + lane, with spp folded into lanes (col = x_in * spp + s), as in
// regroup.cu, so K0's per-slot path is regroup K0's. A record keeps its
// RNG state (the uint32 bits in an f32, kST) and its home row (kHOME =
// tile * 32 + row, an exact f32 integer): lanes never leave their row, so
// the row's home says where its 128 contributions land.
//
// What bounds it on an H100: K0 and K1 are the megakernel's body
// (bounce.cuh), bound by divergent FP32 work in the sweep and the scatter.
// The design answers as the megakernel's does (its three levers, measured
// one at a time on the card by tools/wavefront_steps.py):
//   - The exact per-warp cull of regroup K0 and K1 (bounce.cuh
//     sweep_culled on stage_cull's tables; the boxes in global memory
//     above kStageBytes): the TPU kernels cull per 4096-lane tile
//     (_make_bounce through _make_k0 and _make_k1); a warp here sweeps a
//     chunk iff one of its lanes enters its box, widened by the lane's own
//     rounding margin. The result is the full sweep's (bt, bi) in every bit.
//   - K0: samples refilled per lane. Each warp walks min(spp, 32) slices of
//     32 consecutive slots, one above the other in a tile (a quarter of a
//     row, then the same quarter of the rows below), lane l taking slot l
//     of each: when a lane's path ends (a miss, an emitter, or b_hi reached
//     alive) it writes that slot's record and contribution at the slot's
//     own place and starts the same lane of the next slice, which at any
//     spp is the same sample of the pixel below. A warp runs for its
//     longest lane's total path length, not for the sum over slices of
//     each slice's longest path. Every slot is seeded on its own, so no
//     bit of the pool moves. With spp slices a warp's slots are 32 pixels'
//     samples, as a megakernel warp's are: at 1 spp it takes one slice and
//     refills nothing. Refilled across pixels, a warp's lanes trace paths
//     of unlike depths, and the vote takes the union of their chunks:
//     random_spheres(60000) at 1080p x 1 spp took 58 ms so, against 26 ms
//     unrefilled (tools/wavefront_steps.py).
//   - K1: live lanes regrouped per block. After a cut a dense row still
//     holds the dead lanes of its row (after the cuts of the main path
//     51%, 86% and 94% of K1's lanes), and a warp with one live lane pays
//     for a whole bounce. A block takes kK1Rows dense rows: a first pass
//     reads their alive planes, coalesced, writes each dead lane's stored
//     tr * cr to its home row, and ranks the live lanes by warp ballots
//     and a shared prefix into a list of lane indices, in lane order; a
//     second pass traces the list, thread j taking entries j, j + 256, ...
//     refilled as in K0, each record read and written at its own row and
//     lane. A record carries its RNG state and home row, so the order in
//     which a block traces its lanes moves no bit.
//   - One register budget for the culled instantiations, kMinBlocks blocks
//     of 256 threads an SM (tools/wavefront_steps.py tried others), with
//     no spills (chip_smoke's [build] gate).
// COMPACT is bound by memory: it reads each input row's alive plane (512
// bytes) twice and moves 15 x 512 bytes per live row, in 16-byte loads
// and stores, one warp per row.
//
// The kCull = false instantiations of K0 and K1 are the kernels before this
// design: one thread per slot (K0) or per lane of a dense row (K1), every
// sphere swept, no refill. The port reaches them only through
// ops/cuda/wavefront.py's private full-sweep launcher, as the exact
// reference its gates hold the culled kernels to (chip_smoke's [cull],
// tests/test_torch_cuda.py).
//
// Counts stay on the card: COMPACT writes the live row count to device
// memory and the launches that follow read it there and are sized by the
// capacity; blocks past the count return at once. A frame has no host
// synchronisation between its kernels.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

// Record components (wavefront.py:57-61).
enum Comp { kOX, kOY, kOZ, kDX, kDY, kDZ, kTR, kTG, kTB, kCR, kCG, kCB, kST, kAL, kHOME, kNComp };
constexpr int kLanes = 128;                 // lanes of a row
constexpr int kTileRows = 32;               // rows of a tile
constexpr int kPlane = kTileRows * kLanes;  // one component of one tile
constexpr int kThreads = 256;               // K0, K1: threads a block
constexpr int kWarps = kThreads / 32;
// The culled instantiations' register budget: __launch_bounds__(kThreads,
// kMinBlocks), up to 64 registers (see the header).
constexpr int kMinBlocks = 4;
// K0: the most slices of 32 slots a warp walks down a tile; a frame of spp
// samples a pixel takes min(spp, kK0MaxSlices), a divisor of a tile's 32
// rows.
constexpr int kK0MaxSlices = 32;
static_assert(kTileRows % kK0MaxSlices == 0, "K0's slices divide a tile's rows");
// K1: dense rows a block regroups. Its lane list is kK1Rows x 128 u16 of
// static shared memory.
constexpr int kK1Rows = 8;
constexpr int kK1Lanes = kK1Rows * kLanes;
constexpr int kK1Iters = kK1Lanes / kThreads;  // first-pass lanes a thread
static_assert(kK1Lanes % kThreads == 0 && kK1Iters <= 32,
              "K1 takes an even number of rows, at most 64");
// K1's static shared memory, which stage_cull's tables share kStageBytes with
constexpr size_t kK1StaticBytes =
    kK1Lanes * sizeof(unsigned short) + (kK1Iters * kWarps + 1) * sizeof(int);

// Image geometry of the tiles: width, height, tiles across, log2(spp).
struct Tiling {
  int width, height, tiles_x, spp_shift;
};

// The pixel and sample of a slot (wavefront.py:101-118; regroup.cu's
// slot_pixel). Lanes past the image edge are clamped into it; the fold
// never reads them.
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

// Offset of component 0 of (row, lane) in a pool, and of channel 0 in a
// contribution buffer.
__device__ __forceinline__ long long record_at(long long row, int lane) {
  return (row >> 5) * (kNComp * kPlane) + (row & 31) * kLanes + lane;
}
__device__ __forceinline__ long long contrib_at(long long row, int lane) {
  return (row >> 5) * (3 * kPlane) + (row & 31) * kLanes + lane;
}

// The bounce loop of a refilled lane: one more bounce of r unless its path
// ended. Returns true while the path goes on (bounce < b_hi after a bounce
// that did not end it); the same bounces, in the same order, as
// trace_bounces(b, b_hi) from the path's first bounce.
template <bool kTextured, bool kStaged>
__device__ __forceinline__ bool step_on(const SceneRefs& sc, Ray& r, int& bounce, int b_hi,
                                        const CullView& cv) {
  return bounce < b_hi && bounce_step<kTextured, kStaged>(sc, r, &cv) &&
         ++bounce < b_hi;
}

struct K0Args {
  const float* cam;  // [20]
  SceneRefs scene;
  CullRefs cull;     // read by the kCull instantiations
  CullMargin margin;
  float* pool;       // [tiles, 15, 32, 128]
  float* contrib;    // [tiles, 3, 32, 128]
  long long cap;     // slots
  Tiling g;
  float inv_w, inv_h;  // f32(1 / width), f32(1 / height)
  uint32_t frame;
  int b_hi;
};

// A slot's camera ray: its own seed, a live path.
__device__ __forceinline__ void k0_start(const K0Args& a, long long slot, Ray& r) {
  int x, y;
  uint32_t sample;
  slot_pixel(a.g, static_cast<uint32_t>(slot), x, y, sample);
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(a.g.width) +
                       static_cast<uint32_t>(x);
  r.state = sample_seed(pix, jenkins(a.frame), sample);
  camera_ray(a.cam, static_cast<float>(x), static_cast<float>(y), a.inv_w, a.inv_h, r);
}

// A slot's record and contribution, at the slot's own place.
__device__ __forceinline__ void k0_store(const K0Args& a, long long slot, const Ray& r) {
  const long long row = slot >> 7;
  const int lane = static_cast<int>(slot & 127);
  float* p = a.pool + record_at(row, lane);
  p[kOX * kPlane] = r.ox;
  p[kOY * kPlane] = r.oy;
  p[kOZ * kPlane] = r.oz;
  p[kDX * kPlane] = r.dx;
  p[kDY * kPlane] = r.dy;
  p[kDZ * kPlane] = r.dz;
  p[kTR * kPlane] = r.tr;
  p[kTG * kPlane] = r.tg;
  p[kTB * kPlane] = r.tb;
  p[kCR * kPlane] = r.cr;
  p[kCG * kPlane] = r.cg;
  p[kCB * kPlane] = r.cb;
  p[kST * kPlane] = __uint_as_float(r.state);
  p[kAL * kPlane] = r.alive ? 1.0f : 0.0f;
  p[kHOME * kPlane] = static_cast<float>(static_cast<int>(row));
  float* q = a.contrib + contrib_at(row, lane);
  q[0] = r.tr * r.cr;
  q[kPlane] = r.tg * r.cg;
  q[2 * kPlane] = r.tb * r.cb;
}

// Slices a culled K0 warp walks at 2^spp_shift samples a pixel.
__host__ __device__ __forceinline__ int k0_slices(int spp_shift) {
  return (1 << spp_shift) < kK0MaxSlices ? 1 << spp_shift : kK0MaxSlices;
}

// K0: camera ray and bounces [0, b_hi) of every slot; every slot is
// written. kCull = false: one slot a thread, every sphere swept. kCull:
// the cull tables staged per block, then each warp walks its k0_slices
// slices down a tile with refill.
template <bool kTextured, bool kCull, bool kStaged>
__global__ void __launch_bounds__(kThreads, kCull ? kMinBlocks : 0) wavefront_k0(const K0Args a) {
  if constexpr (!kCull) {
    const long long slot = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (slot >= a.cap) return;
    Ray r;
    k0_start(a, slot, r);
    trace_bounces<kTextured, kStaged>(a.scene, 0, a.b_hi, r);
    k0_store(a, slot, r);
  } else {
    const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
    // warp -> (tile, quarter of a row, first row): 4 x 32 / slices a tile
    const int slices = k0_slices(a.g.spp_shift);
    const int per_tile = 4 * (kTileRows / slices);
    const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
    const long long tile = warp / per_tile;
    const int in_tile = static_cast<int>(warp % per_tile);
    if (tile * kPlane >= a.cap) return;
    long long slot = tile * kPlane + (in_tile >> 2) * slices * kLanes + (in_tile & 3) * 32 +
                     (threadIdx.x & 31);
    Ray r;
    k0_start(a, slot, r);
    int bounce = 0;
    for (int slice = 0;;) {
      if (step_on<kTextured, kStaged>(a.scene, r, bounce, a.b_hi, cv)) continue;
      k0_store(a, slot, r);
      if (++slice == slices) break;
      slot += kLanes;
      k0_start(a, slot, r);
      bounce = 0;
    }
  }
}

struct K1Args {
  SceneRefs scene;
  CullRefs cull;     // read by the kCull instantiations
  CullMargin margin;
  float* pool;       // [tiles, 15, 32, 128] dense rows, updated in place
  float* contrib;    // [tiles, 3, 32, 128] by home row
  const int* count;  // dense rows in the pool
  long long cap;     // slots
  int b_lo, b_hi;
};

// A live lane's stored path entering b_lo. Its colour is 0 (a path has
// none until it ends), so it is not loaded: fewer values live across the
// bounces (loading it too made ptxas spill at 48 registers).
__device__ __forceinline__ void k1_load(const float* p, Ray& r) {
  r.ox = p[kOX * kPlane];
  r.oy = p[kOY * kPlane];
  r.oz = p[kOZ * kPlane];
  r.dx = p[kDX * kPlane];
  r.dy = p[kDY * kPlane];
  r.dz = p[kDZ * kPlane];
  r.tr = p[kTR * kPlane];
  r.tg = p[kTG * kPlane];
  r.tb = p[kTB * kPlane];
  r.cr = 0.0f;
  r.cg = 0.0f;
  r.cb = 0.0f;
  r.state = __float_as_uint(p[kST * kPlane]);
  r.alive = true;
}

// A traced lane's record, written back in place.
__device__ __forceinline__ void k1_store(float* p, const Ray& r) {
  p[kOX * kPlane] = r.ox;
  p[kOY * kPlane] = r.oy;
  p[kOZ * kPlane] = r.oz;
  p[kDX * kPlane] = r.dx;
  p[kDY * kPlane] = r.dy;
  p[kDZ * kPlane] = r.dz;
  p[kTR * kPlane] = r.tr;
  p[kTG * kPlane] = r.tg;
  p[kTB * kPlane] = r.tb;
  p[kCR * kPlane] = r.cr;
  p[kCG * kPlane] = r.cg;
  p[kCB * kPlane] = r.cb;
  p[kST * kPlane] = __uint_as_float(r.state);
  p[kAL * kPlane] = r.alive ? 1.0f : 0.0f;
}

// Lane `lane`'s tr * cr (of its record at p) to its row's home row.
__device__ __forceinline__ void k1_contrib(const K1Args& a, const float* p, int lane, float tr,
                                           float tg, float tb, float cr, float cg, float cb) {
  const long long home = static_cast<long long>(p[kHOME * kPlane]);
  float* q = a.contrib + contrib_at(home, lane);
  q[0] = tr * cr;
  q[kPlane] = tg * cg;
  q[2 * kPlane] = tb * cb;
}

// One lane of a dense row, as the full sweep's thread takes it: a live
// lane (alive > 0.5, as the TPU kernel's bounce loop reads it) is traced
// and written back; a dead one is left as it is. Every lane writes its
// tr * cr to its home row: a dead lane's is the value it wrote when its
// path ended (wavefront.py:282-284).
template <bool kTextured>
__device__ __forceinline__ void k1_lane(const K1Args& a, long long row, int lane) {
  float* p = a.pool + record_at(row, lane);
  if (p[kAL * kPlane] > 0.5f) {
    Ray r;
    k1_load(p, r);
    trace_bounces<kTextured>(a.scene, a.b_lo, a.b_hi, r);
    k1_store(p, r);
    k1_contrib(a, p, lane, r.tr, r.tg, r.tb, r.cr, r.cg, r.cb);
  } else {
    k1_contrib(a, p, lane, p[kTR * kPlane], p[kTG * kPlane], p[kTB * kPlane], p[kCR * kPlane],
               p[kCG * kPlane], p[kCB * kPlane]);
  }
}

// K1 regrouped: the block's kK1Rows dense rows from row0, of which `rows`
// are below the count. First pass, lane e = it * 256 + thread: a dead lane
// writes its contribution; a live lane's bit goes to the warp's ballot,
// whose count joins an exclusive prefix over (it, warp), so each live lane
// takes the list entry of its rank in lane order. Second pass: thread j
// traces entries j, j + 256, ... with refill.
template <bool kTextured, bool kStaged>
__device__ __forceinline__ void k1_regrouped(const K1Args& a, long long row0, int rows,
                                             const CullView& cv) {
  __shared__ unsigned short list[kK1Lanes];
  __shared__ int rank_base[kK1Iters * kWarps + 1];  // then the live count
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = rows * kLanes;
  unsigned mine = 0u;  // bit it: this thread's lane of pass `it` is live
#pragma unroll 1
  for (int it = 0; it < kK1Iters; ++it) {
    const int e = it * kThreads + threadIdx.x;
    bool live = false;
    if (e < n) {
      const float* p = a.pool + record_at(row0 + (e >> 7), e & 127);
      live = p[kAL * kPlane] > 0.5f;
      if (!live) {
        k1_contrib(a, p, e & 127, p[kTR * kPlane], p[kTG * kPlane], p[kTB * kPlane],
                   p[kCR * kPlane], p[kCG * kPlane], p[kCB * kPlane]);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) rank_base[it * kWarps + warp] = __popc(ballot);
    mine |= static_cast<unsigned>(live) << it;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix over (it, warp), 32 at a time
    int carry = 0;
    for (int k0 = 0; k0 < kK1Iters * kWarps; k0 += 32) {
      const int k = k0 + lane;
      const int v = k < kK1Iters * kWarps ? rank_base[k] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (k < kK1Iters * kWarps) rank_base[k] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) rank_base[kK1Iters * kWarps] = carry;
  }
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < kK1Iters; ++it) {
    const bool live = (mine >> it) & 1u;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) {
      list[rank_base[it * kWarps + warp] + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(it * kThreads + threadIdx.x);
    }
  }
  __syncthreads();
  const int n_live = rank_base[kK1Iters * kWarps];
  int at = threadIdx.x;
  if (at >= n_live) return;
  int e = list[at];
  float* p = a.pool + record_at(row0 + (e >> 7), e & 127);
  Ray r;
  k1_load(p, r);
  int bounce = a.b_lo;
  for (;;) {
    if (step_on<kTextured, kStaged>(a.scene, r, bounce, a.b_hi, cv)) continue;
    k1_store(p, r);
    k1_contrib(a, p, e & 127, r.tr, r.tg, r.tb, r.cr, r.cg, r.cb);
    at += kThreads;
    if (at >= n_live) break;
    e = list[at];
    p = a.pool + record_at(row0 + (e >> 7), e & 127);
    k1_load(p, r);
    bounce = a.b_lo;
  }
}

// K1: bounces [b_lo, b_hi) of the live lanes of the count dense rows, and
// every lane's tr * cr to its home row. kCull = false: one thread per lane,
// every sphere swept. kCull: a block wholly past the count returns before
// it stages the cull tables; the rest regroup their live lanes.
template <bool kTextured, bool kCull, bool kStaged>
__global__ void __launch_bounds__(kThreads, kCull ? kMinBlocks : 0) wavefront_k1(const K1Args a) {
  const int count = *a.count;
  if constexpr (!kCull) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= a.cap || (i >> 7) >= count) return;
    k1_lane<kTextured>(a, i >> 7, static_cast<int>(i & 127));
  } else {
    const long long row0 = static_cast<long long>(blockIdx.x) * kK1Rows;
    if (row0 >= count) return;
    const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
    const long long rows = count - row0;
    k1_regrouped<kTextured, kStaged>(a, row0, rows < kK1Rows ? static_cast<int>(rows) : kK1Rows,
                                     cv);
  }
}

// --- COMPACT: count -> scan -> scatter ------------------------------------
//
// The TPU kernel appends rows through a counter that persists across its
// in-order grid (wavefront.py:160-198). CUDA blocks run in no order, so the
// same stable compaction is three launches, as regroup.cu's PACK: one block
// per tile (a warp per row) counts the tile's live rows, one block scans
// the tile totals, and each block copies its live rows to (its tile's
// offset + the row's rank in the tile). Rows at or past count_in are dead.

constexpr int kCompactThreads = kTileRows * 32;  // a warp per row of the tile

// Whether row `row` of the pool has a live lane (max(alive) > 0,
// wavefront.py:175-178): lane l of the warp reads alive[4l .. 4l + 3].
__device__ __forceinline__ bool live_row(const float* __restrict__ pool, long long row,
                                         int n_in) {
  bool any = false;
  if (row < n_in) {
    const float4 v = *reinterpret_cast<const float4*>(
        pool + record_at(row, 4 * (threadIdx.x & 31)) + kAL * kPlane);
    any = v.x > 0.0f || v.y > 0.0f || v.z > 0.0f || v.w > 0.0f;
  }
  return __any_sync(0xffffffffu, any);
}

__global__ void __launch_bounds__(kCompactThreads) compact_count(
    const float* __restrict__ pool, const int* __restrict__ count_in,
    int* __restrict__ tile_sums) {
  const long long row = static_cast<long long>(blockIdx.x) * kTileRows + (threadIdx.x >> 5);
  const bool live = live_row(pool, row, *count_in);
  const int n = __syncthreads_count(live && (threadIdx.x & 31) == 0);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = n;
}

// Exclusive scan of the tile totals in place, by one block: each thread
// sums a contiguous run, the runs are scanned across the block, and each
// thread writes its run's prefixes. The total is the new row count.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads) compact_scan(int* __restrict__ tile_sums,
                                                             int n_tiles,
                                                             int* __restrict__ count_out) {
  __shared__ int warp_sums[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += tile_sums[i];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = tile_sums[i];
    tile_sums[i] = run;
    run += v;
  }
  if (t == kScanThreads - 1) *count_out = run;
}

// Scatter: each warp ranks its row among the tile's live rows by a ballot
// over the tile's row flags, then copies the row's 15 x 128 floats to its
// dense row, 16 bytes a lane.
__global__ void __launch_bounds__(kCompactThreads) compact_scatter(
    const float* __restrict__ pool, float* __restrict__ dense, const int* __restrict__ count_in,
    const int* __restrict__ tile_offsets) {
  __shared__ int flags[kTileRows];
  const int n_in = *count_in;
  if (static_cast<long long>(blockIdx.x) * kTileRows >= n_in) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kTileRows + warp;
  const bool live = live_row(pool, row, n_in);
  if (lane == 0) flags[warp] = live;
  __syncthreads();
  const unsigned mask = __ballot_sync(0xffffffffu, flags[lane] != 0);
  if (!live) return;
  const long long dst = tile_offsets[blockIdx.x] + __popc(mask & ((1u << warp) - 1u));
  const float4* src = reinterpret_cast<const float4*>(pool + record_at(row, 4 * lane));
  float4* out = reinterpret_cast<float4*>(dense + record_at(dst, 4 * lane));
  for (int k = 0; k < kNComp; ++k) out[k * (kPlane / 4)] = src[k * (kPlane / 4)];
}

unsigned blocks(long long n, long long per) { return static_cast<unsigned>((n + per - 1) / per); }

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

CullRefs cull_refs(const float* chunk_bounds, const float* super_bounds, const int* priors,
                   int n_chunks, int n_tests, int n_super, int chunk_size, int super_factor) {
  return CullRefs{chunk_bounds, super_bounds, priors, n_chunks, n_tests,
                  n_super, chunk_size, super_factor};
}

// Static shared bytes a culled kernel's block holds besides stage_cull's
// tables: K1's lane list.
constexpr size_t reserved_bytes(bool k1) { return k1 ? kK1StaticBytes : 0; }

// Blocks of a launch over `cap` slots (K0: at 2^spp_shift samples a pixel).
unsigned grid_k0(long long cap, int spp_shift, bool cull) {
  return cull ? blocks(cap / kPlane * 4 * (kTileRows / k0_slices(spp_shift)), kWarps)
              : blocks(cap, kThreads);
}
unsigned grid_k1(long long cap, bool cull) {
  return cull ? blocks(cap / kLanes, kK1Rows) : blocks(cap, kThreads);
}

K0Args k0_args(const float* cam, const float* sky, const float* sweep, const float* attrs,
               const int* tex_pool, int n_spheres, float* pool, float* contrib, long long cap,
               int width, int height, int tiles_x, int spp_shift, float inv_w, float inv_h,
               unsigned frame, int b_hi) {
  K0Args a = {};
  a.cam = cam;
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
  a.pool = pool;
  a.contrib = contrib;
  a.cap = cap;
  a.g = Tiling{width, height, tiles_x, spp_shift};
  a.inv_w = inv_w;
  a.inv_h = inv_h;
  a.frame = frame;
  a.b_hi = b_hi;
  return a;
}

K1Args k1_args(const float* sky, const float* sweep, const float* attrs, const int* tex_pool,
               int n_spheres, float* pool, float* contrib, const int* count, long long cap,
               int b_lo, int b_hi) {
  K1Args a = {};
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
  a.pool = pool;
  a.contrib = contrib;
  a.count = count;
  a.cap = cap;
  a.b_lo = b_lo;
  a.b_hi = b_hi;
  return a;
}

// Launch a culled K0 or K1 (kernels[textured][staged]) with its dynamic
// shared memory, staged where cull_staged with its static bytes reserved.
template <class KArgs>
int launch_culled(void (*const kernels[2][2])(KArgs), const KArgs& a, bool k1, unsigned grid,
                  cudaStream_t s) {
  const size_t reserved = reserved_bytes(k1);
  const bool staged = cull_staged(a.cull, reserved);
  kernels[a.scene.tex_pool != nullptr][staged]<<<grid, kThreads,
                                                  cull_smem_bytes(a.cull, reserved), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers, and returns cudaGetLastError() after its launches. `cap` is
// the slot count, a multiple of 4096 (whole tiles) below 2^31. K0 and K1
// take the cull hierarchy of prepare_scene_arrays (n_chunks = 0: none,
// every sphere is swept) and the two scene terms of each lane's box margin
// (KernelInputs.cull_reach, cull_scale), as regroup's do; their
// *_full_sweep entry points launch the kCull = false instantiations, the
// exact full-sweep reference, with the arguments K0 and K1 took before
// they culled.

int wrt_wavefront_k0(const float* cam, const float* sky, const float* sweep,
                     const float* attrs, const int* tex_pool, int n_spheres, float* pool,
                     float* contrib, long long cap, int width, int height, int tiles_x,
                     int spp_shift, float inv_w, float inv_h, unsigned frame, int b_hi,
                     const float* chunk_bounds, const float* super_bounds, const int* priors,
                     int n_chunks, int n_tests, int n_super, int chunk_size, int super_factor,
                     float cull_reach, float cull_scale, void* stream) {
  K0Args a = k0_args(cam, sky, sweep, attrs, tex_pool, n_spheres, pool, contrib, cap, width,
                     height, tiles_x, spp_shift, inv_w, inv_h, frame, b_hi);
  a.cull = cull_refs(chunk_bounds, super_bounds, priors, n_chunks, n_tests, n_super, chunk_size,
                     super_factor);
  a.margin = CullMargin{cull_reach, cull_scale};
  static void (*const kernels[2][2])(K0Args) = {
      {wavefront_k0<false, true, false>, wavefront_k0<false, true, true>},
      {wavefront_k0<true, true, false>, wavefront_k0<true, true, true>}};
  return launch_culled(kernels, a, false, grid_k0(cap, spp_shift, true),
                       static_cast<cudaStream_t>(stream));
}

int wrt_wavefront_k0_full_sweep(const float* cam, const float* sky, const float* sweep,
                                const float* attrs, const int* tex_pool, int n_spheres,
                                float* pool, float* contrib, long long cap, int width,
                                int height, int tiles_x, int spp_shift, float inv_w, float inv_h,
                                unsigned frame, int b_hi, void* stream) {
  const K0Args a = k0_args(cam, sky, sweep, attrs, tex_pool, n_spheres, pool, contrib, cap, width,
                           height, tiles_x, spp_shift, inv_w, inv_h, frame, b_hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (tex_pool != nullptr ? wavefront_k0<true, false, true> : wavefront_k0<false, false, true>)
      <<<grid_k0(cap, spp_shift, false), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// count_in: rows of `pool` to consider; writes count_out and the first
// count_out rows of `dense`. tile_sums holds cap / 4096 ints of scratch.
int wrt_wavefront_compact(const float* pool, float* dense, const int* count_in, int* count_out,
                          int* tile_sums, long long cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n_tiles = blocks(cap, kPlane);
  compact_count<<<n_tiles, kCompactThreads, 0, s>>>(pool, count_in, tile_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scan<<<1, kScanThreads, 0, s>>>(tile_sums, static_cast<int>(n_tiles), count_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter<<<n_tiles, kCompactThreads, 0, s>>>(pool, dense, count_in, tile_sums);
  return static_cast<int>(cudaGetLastError());
}

int wrt_wavefront_k1(const float* sky, const float* sweep, const float* attrs,
                     const int* tex_pool, int n_spheres, float* pool, float* contrib,
                     const int* count, long long cap, int b_lo, int b_hi,
                     const float* chunk_bounds, const float* super_bounds, const int* priors,
                     int n_chunks, int n_tests, int n_super, int chunk_size, int super_factor,
                     float cull_reach, float cull_scale, void* stream) {
  K1Args a = k1_args(sky, sweep, attrs, tex_pool, n_spheres, pool, contrib, count, cap, b_lo,
                     b_hi);
  a.cull = cull_refs(chunk_bounds, super_bounds, priors, n_chunks, n_tests, n_super, chunk_size,
                     super_factor);
  a.margin = CullMargin{cull_reach, cull_scale};
  static void (*const kernels[2][2])(K1Args) = {
      {wavefront_k1<false, true, false>, wavefront_k1<false, true, true>},
      {wavefront_k1<true, true, false>, wavefront_k1<true, true, true>}};
  return launch_culled(kernels, a, true, grid_k1(cap, true), static_cast<cudaStream_t>(stream));
}

int wrt_wavefront_k1_full_sweep(const float* sky, const float* sweep, const float* attrs,
                                const int* tex_pool, int n_spheres, float* pool, float* contrib,
                                const int* count, long long cap, int b_lo, int b_hi,
                                void* stream) {
  const K1Args a = k1_args(sky, sweep, attrs, tex_pool, n_spheres, pool, contrib, count, cap,
                           b_lo, b_hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (tex_pool != nullptr ? wavefront_k1<true, false, true> : wavefront_k1<false, false, true>)
      <<<grid_k1(cap, false), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and static shared bytes of one
// kernel, as the CUDA runtime reports them; returns a cudaError_t.
// `which`: 0/1 K0 untextured/textured, 2/3 the same with the boxes in
// global memory (kStaged = false), 4/5 K0's full sweep (kCull = false);
// 6-11 K1 in the same order; 12 compact_count, 13 compact_scan, 14
// compact_scatter.
int wrt_wavefront_attributes(int which, int* num_regs, int* local_bytes, int* shared_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(wavefront_k0<false, true, true>),
      reinterpret_cast<const void*>(wavefront_k0<true, true, true>),
      reinterpret_cast<const void*>(wavefront_k0<false, true, false>),
      reinterpret_cast<const void*>(wavefront_k0<true, true, false>),
      reinterpret_cast<const void*>(wavefront_k0<false, false, true>),
      reinterpret_cast<const void*>(wavefront_k0<true, false, true>),
      reinterpret_cast<const void*>(wavefront_k1<false, true, true>),
      reinterpret_cast<const void*>(wavefront_k1<true, true, true>),
      reinterpret_cast<const void*>(wavefront_k1<false, true, false>),
      reinterpret_cast<const void*>(wavefront_k1<true, true, false>),
      reinterpret_cast<const void*>(wavefront_k1<false, false, true>),
      reinterpret_cast<const void*>(wavefront_k1<true, false, true>),
      reinterpret_cast<const void*>(compact_count),
      reinterpret_cast<const void*>(compact_scan),
      reinterpret_cast<const void*>(compact_scatter),
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

// The culled K0's and K1's __launch_bounds__: threads a block and the
// blocks an SM that fix their register budget.
void wrt_wavefront_launch_bounds(int* threads, int* min_blocks) {
  *threads = kThreads;
  *min_blocks = kMinBlocks;
}

// Dynamic shared bytes of a block of the culled K0 (k1 = 0) or K1 (k1 =
// 1) for a cull hierarchy (stage_cull), and in `staged` whether its boxes
// are among them.
long long wrt_wavefront_cull_smem(int k1, int n_chunks, int n_tests, int n_super, int* staged) {
  CullRefs cu = {};
  cu.n_chunks = n_chunks;
  cu.n_tests = n_tests;
  cu.n_super = n_super;
  const size_t reserved = reserved_bytes(k1 != 0);
  *staged = n_chunks > 0 && cull_staged(cu, reserved);
  return static_cast<long long>(cull_smem_bytes(cu, reserved));
}

}  // extern "C"
