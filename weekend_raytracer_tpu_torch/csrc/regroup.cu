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
//            kStats instantiation is _make_k1(stats=True) (regroup.py:618,
//            745-758; launched by benchmarks/profile_regroup.py:244), which
//            also counts per dense tile of 4096 records (stats.cuh).
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
//     cooperative loads (stage_cull: 824 B on RTiOW, 8,240 B on
//     random_spheres(10000)). TMA buys nothing for a few KiB loaded once
//     per block. Boxes above kStageBytes (about 1,800 chunk and super
//     boxes, some 57,000 spheres at 32 a chunk) would cost blocks an SM,
//     so such a scene reads them from global memory through __ldg at the
//     same warp-uniform addresses (the kStaged = false instantiations);
//     the launch picks the placement from the table's size. The sphere
//     table stays in global memory: the warp reads one row at a time at a
//     warp-uniform address, which the L1 broadcasts, and
//     random_spheres(10000)'s 160 KiB would leave one block of 256
//     threads an SM.
//   - One register budget, kTraceMinBlocks = 5 blocks of 256 threads an
//     SM (48 registers), chosen on the card among 48, 56 and 64 registers
//     with no spills.
// PACK and COMBINE are bound by memory: each moves about 64 bytes per live
// record (16 f32 components), or 12 bytes per slot of radiance, with
// coalesced reads and, since the compaction is stable, mostly coalesced
// writes. No matrix unit is used.
//
// Counts stay on the card: PACK writes the live count to device memory and
// the launches that follow read it there and are sized by its upper bound
// (the record capacity); threads past the count return at once. So a frame
// has no host synchronisation between its kernels.

#include <cstdint>
#include <type_traits>
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

constexpr int kThreads = 256;    // K0, K1, COMBINE: one thread per record
// K0's and K1's register budget: __launch_bounds__(kThreads,
// kTraceMinBlocks), five blocks of 256 threads an SM, holds them to 48
// registers (65536 / (5 * 256) = 51, allocated in steps of 8). Measured on
// an H100 against 52-56 (what ptxas takes when allowed 56 or 64) and
// 48-register builds by tools/cull_variants.py: K1 runs 3% faster at 48,
// K0 the same, with no spills. K1's kStats instantiation, which also
// carries the counters, keeps four blocks (64 registers), as the stats
// megakernel does: at 48 it spills.
constexpr int kTraceMinBlocks = 5;
constexpr int kStatsMinBlocks = 4;
// The most dynamic shared memory a block of K0 or K1 stages: five blocks
// an SM, each with the 1 KiB the runtime reserves, fit an H100 SM's
// 228 KiB, and the 48 KiB a launch gets without opting in.
constexpr size_t kStageBytes = 44 * 1024;
constexpr int kPackBlock = 1024;  // PACK: slots per block, one per thread

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

// The two scene terms of each lane's box margin in sweep_culled
// (KernelInputs.cull_reach and cull_scale).
struct CullMargin {
  float reach, scale;
};

// Whether K0 and K1 stage a scene's chunk and super-chunk boxes in shared
// memory: while they and the priors' rows fit kStageBytes.
inline bool cull_staged(const CullRefs& cu) {
  return kNPriors * (sizeof(float4) + sizeof(int)) +
             6 * sizeof(float) * (cu.n_tests + cu.n_super) <=
         kStageBytes;
}

// Dynamic shared bytes of a block of K0 or K1 (stage_cull): the priors'
// sweep rows and indices, then the chunk and super-chunk boxes where
// cull_staged; 0 without a chunk hierarchy.
inline size_t cull_smem_bytes(const CullRefs& cu) {
  if (cu.n_chunks == 0) return 0;
  return kNPriors * (sizeof(float4) + sizeof(int)) +
         (cull_staged(cu) ? 6 * sizeof(float) * (cu.n_tests + cu.n_super) : 0);
}

// The cull view of a block of K0 or K1, staged once before its first
// bounce; every thread of the block must call it. The priors' rows go to
// shared memory, and the exact boxes too where kStaged (the launch's
// choice, cull_staged), with cooperative loads: a few KiB at most.
template <bool kStaged>
__device__ __forceinline__ CullView stage_cull(const CullRefs& cu, const float4* sweep,
                                               const CullMargin& margin) {
  extern __shared__ float4 cull_smem[];
  int* prior_index = reinterpret_cast<int*>(cull_smem + kNPriors);
  float* chunk = reinterpret_cast<float*>(prior_index + kNPriors);
  float* super = chunk + 6 * cu.n_tests;
  CullView v;
  v.prior = cull_smem;
  v.prior_index = prior_index;
  if constexpr (kStaged) {
    v.chunk = chunk;
    v.super = super;
  } else {
    v.chunk = cu.chunk_bounds;
    v.super = cu.super_bounds;
  }
  v.n_chunks = cu.n_chunks;
  v.n_tests = cu.n_tests;
  v.n_super = cu.n_super;
  v.chunk_size = cu.chunk_size;
  v.super_factor = cu.super_factor;
  v.reach = margin.reach;
  v.margin_scale = margin.scale;
  if (cu.n_chunks == 0) return v;
  if constexpr (kStaged) {
    for (int k = threadIdx.x; k < 6 * cu.n_tests; k += blockDim.x) {
      chunk[k] = __ldg(cu.chunk_bounds + k);
    }
    for (int k = threadIdx.x; k < 6 * cu.n_super; k += blockDim.x) {
      super[k] = __ldg(cu.super_bounds + k);
    }
  }
  if (threadIdx.x < kNPriors) {
    const int i = __ldg(cu.priors + threadIdx.x);
    prior_index[threadIdx.x] = i;
    cull_smem[threadIdx.x] = __ldg(sweep + i);
  }
  __syncthreads();
  return v;
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
  trace_bounces<kTextured, false, kStaged>(a.scene, 0, a.b_hi, r, nullptr, &cv);

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
  CullMargin margin;  // read by the kStats = false instantiations
  float* pool;       // [16, cap] dense, updated in place
  float* r8;         // [3, cap] base radiance tr * cr
  const int* count;  // live records in the pool
  long long cap;
  Tiling g;
  uint32_t frame, row_offset;
  int b_lo, b_hi;
};

// What the kStats instantiation reads besides (the kStats = false one keeps
// K1Args alone, so it compiles without the counters).
struct K1StatsArgs : K1Args {
  StatsRefs st;
};

template <bool kStats>
using K1ArgsOf = std::conditional_t<kStats, K1StatsArgs, K1Args>;

constexpr int kTileRecords = 32 * 128;  // a dense TPU tile (regroup.py:679-721)

// K1: bounces [b_lo, b_hi) of one dense record. The RNG state is the home
// slot's seed advanced 4 * (b_lo + 1) draws (regroup.py:723-741). The
// kStats instantiation also counts per dense tile of 4096 records, as
// _make_k1(stats=True) at tsub1 = 32 (regroup.py:745-758): col 0 is then
// the tile's loop trips from b_lo; it sweeps every sphere (sweep_counted)
// and stages nothing. A block wholly past the count returns before it
// stages the cull tables.
template <bool kTextured, bool kStats, bool kStaged = true>
__global__ void __launch_bounds__(kThreads, kStats ? kStatsMinBlocks : kTraceMinBlocks)
    regroup_k1(const K1ArgsOf<kStats> a) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = *a.count;
  if (first >= count) return;
  CullView cv{};
  if constexpr (!kStats) cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  const long long i = first + threadIdx.x;
  if (i >= count) return;
  float* p = a.pool + i;
  const long long c = a.cap;
  const uint32_t slot = static_cast<uint32_t>(static_cast<int>(p[kHHI * c])) * kHomeRadix +
                        static_cast<uint32_t>(static_cast<int>(p[kHLO * c]));
  int x, y;
  uint32_t sample;
  slot_pixel(a.g, slot, x, y, sample);
  Ray r;
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
  if constexpr (kStats) {
    RayCounter rc{&a.cull, &a.st, static_cast<int>(i / kTileRecords), 1u, 0u};
    trace_bounces<kTextured, true>(a.scene, a.b_lo, a.b_hi, r, &rc);
    count_trips(a.st, rc);
  } else {
    trace_bounces<kTextured, false, kStaged>(a.scene, a.b_lo, a.b_hi, r, nullptr, &cv);
  }

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

// --- PACK: count -> scan -> scatter --------------------------------------
//
// The TPU pack carries a partial row from one grid step to the next, which
// needs the TPU's in-order grid (regroup.py:20-26). CUDA blocks run in no
// order, so the same stable compaction is three launches: each block counts
// its live slots, one block scans the block totals, and each block scatters
// its live records to (its block's offset + its rank in the block). The
// dense order, the inverse map and the count are those of the JAX pack.
// Left out: _INV_FIRST and the spare tile, which serve the TPU's windowed
// combine and its clamped row DMAs; a gather needs neither, and every write
// here lies below ceil(live / 128) * 128 <= cap.

__device__ __forceinline__ bool live_slot(const float* __restrict__ alive, int slot, int n_in) {
  return slot < n_in && alive[slot] > 0.5f;
}

__global__ void __launch_bounds__(kPackBlock) pack_count(const float* __restrict__ alive,
                                                         const int* __restrict__ count_in,
                                                         int* __restrict__ block_sums) {
  const int slot = blockIdx.x * kPackBlock + threadIdx.x;
  const int n = __syncthreads_count(live_slot(alive, slot, *count_in));
  if (threadIdx.x == 0) block_sums[blockIdx.x] = n;
}

// Exclusive scan of the block totals in place, by one block: each thread
// sums a contiguous run, the runs are scanned across the block, and each
// thread writes its run's prefixes. The total is the new live count.
__global__ void __launch_bounds__(kPackBlock) pack_scan(int* __restrict__ block_sums,
                                                        int n_blocks,
                                                        int* __restrict__ count_out) {
  __shared__ int warp_sums[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n_blocks + kPackBlock - 1) / kPackBlock;
  const int lo = min(t * per, n_blocks);
  const int hi = min(lo + per, n_blocks);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += block_sums[i];
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
    const int v = block_sums[i];
    block_sums[i] = run;
    run += v;
  }
  if (t == kPackBlock - 1) *count_out = run;
}

// Scatter: rank in the block by warp ballots, then copy the 16 components
// of each live record and write the inverse map (dense position, or -1 for
// a record that ended). Block 0 also pads the last dense row with dead
// records (alive 0, HHI = 2^16, the rest 0), as the JAX pack's final flush
// does (regroup.py:595-613).
__global__ void __launch_bounds__(kPackBlock) pack_scatter(
    const float* __restrict__ pool, float* __restrict__ dense, int* __restrict__ inv,
    const int* __restrict__ count_in, const int* __restrict__ block_offsets,
    const int* __restrict__ count_out, long long cap) {
  __shared__ int warp_off[32];
  const int n_in = *count_in;
  if (blockIdx.x != 0 && static_cast<int>(blockIdx.x) * kPackBlock >= n_in) return;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int slot = blockIdx.x * kPackBlock + t;
  const bool alive = live_slot(pool + kAL * cap, slot, n_in);
  const unsigned mask = __ballot_sync(0xffffffffu, alive);
  if (lane == 0) warp_off[warp] = __popc(mask);
  __syncthreads();
  if (warp == 0) {
    const int w = warp_off[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    warp_off[lane] = wi - w;
  }
  __syncthreads();
  const int pos = block_offsets[blockIdx.x] + warp_off[warp] + __popc(mask & ((1u << lane) - 1u));
  if (slot < n_in) inv[slot] = alive ? pos : -1;
  if (alive) {
    for (int k = 0; k < kNComp; ++k) dense[k * cap + pos] = pool[k * cap + slot];
  }
  if (blockIdx.x == 0 && t < 128) {
    const int total = *count_out;
    const int p = total + t;
    if (p < ((total + 127) & ~127)) {
      for (int k = 0; k < kNComp; ++k) dense[k * cap + p] = k == kHHI ? kDeadHHI : 0.0f;
    }
  }
}

// --- COMBINE --------------------------------------------------------------
//
// Walking the phases last to first, R_i[p] = R_{i+1}[inv_{i+1}[p]] if the
// record at position p of phase i lived on, else its own base radiance
// (regroup.py:1396-1483). On the GPU a level is a plain per-slot gather
// through the inverse map, written over the base pool in place; it is not
// the TPU's one-hot window matmul, which exists because a TPU core cannot
// gather across rows. Positions past the destination count, and inverse-map
// entries of dead records, are never read.

__global__ void __launch_bounds__(kThreads) combine_level(const int* __restrict__ inv,
                                                          const float* __restrict__ src,
                                                          float* __restrict__ base,
                                                          const int* __restrict__ dest_count,
                                                          long long cap) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= *dest_count) return;
  const int j = inv[p];
  if (j < 0) return;
  base[p] = src[j];
  base[cap + p] = src[cap + j];
  base[2 * cap + p] = src[2 * cap + j];
}

// The home level fused with the fold: one thread per pixel takes R_0 of
// its spp contiguous lanes (through the first inverse map, else K0's
// contribution) and sums them in sample order from 0, as the megakernel
// sums a pixel's samples, then adds the sum to the accumulator or writes
// it over it (regroup.py:1487-1495).
__global__ void __launch_bounds__(kThreads) combine_home(const int* __restrict__ inv,
                                                         const float* __restrict__ src,
                                                         const float* __restrict__ contrib,
                                                         float* __restrict__ acc, long long cap,
                                                         Tiling g, int clear) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.width * g.height) return;
  const int x = i % g.width;
  const int y = i / g.width;
  const int bw_shift = 7 - g.spp_shift;
  const int tile = (y >> 5) * g.tiles_x + (x >> bw_shift);
  const long long slot0 = (static_cast<long long>(tile * 32 + (y & 31)) << 7) +
                          ((x & ((1 << bw_shift) - 1)) << g.spp_shift);
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
  for (int s = 0; s < (1 << g.spp_shift); ++s) {
    const long long slot = slot0 + s;
    const int j = inv[slot];
    const float* v = j >= 0 ? src + j : contrib + slot;
    tot_r = tot_r + v[0];
    tot_g = tot_g + v[cap];
    tot_b = tot_b + v[2 * cap];
  }
  float* out = acc + static_cast<size_t>(i) * 3;
  const float base_r = clear ? 0.0f : out[0];
  const float base_g = clear ? 0.0f : out[1];
  const float base_b = clear ? 0.0f : out[2];
  out[0] = base_r + tot_r;
  out[1] = base_g + tot_g;
  out[2] = base_b + tot_b;
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
// swept), as the kStats entry point does, and the two scene terms of each
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
// block_sums holds cap / 1024 ints of scratch.
int wrt_regroup_pack(const float* pool, float* dense, int* inv, const int* count_in,
                     int* count_out, int* block_sums, long long cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks(cap, kPackBlock);
  pack_count<<<nb, kPackBlock, 0, s>>>(pool + kAL * cap, count_in, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_scan<<<1, kPackBlock, 0, s>>>(block_sums, static_cast<int>(nb), count_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_scatter<<<nb, kPackBlock, 0, s>>>(pool, dense, inv, count_in, block_sums, count_out, cap);
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
  return tex_pool != nullptr ? launch_culled(regroup_k1<true, false, true>,
                                             regroup_k1<true, false, false>, a, cap, s)
                             : launch_culled(regroup_k1<false, false, true>,
                                             regroup_k1<false, false, false>, a, cap, s);
}

// K1 through the kStats instantiation: also writes the per-dense-tile
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
  a.st = stats_refs(scratch, n_tiles, b_hi - b_lo, n_tests, n_super);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_counted(scratch, scratch_words, a.st, n_tests, n_super, super_factor, 1, n_tiles,
                     stats, s, [&] {
                       if (tex_pool != nullptr) {
                         regroup_k1<true, true><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
                       } else {
                         regroup_k1<false, true><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
                       }
                     });
}

int wrt_regroup_combine(const int* inv, const float* src, float* base, const int* dest_count,
                        long long cap, void* stream) {
  combine_level<<<blocks(cap, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      inv, src, base, dest_count, cap);
  return static_cast<int>(cudaGetLastError());
}

int wrt_regroup_combine_home(const int* inv, const float* src, const float* contrib, float* acc,
                             long long cap, int width, int height, int tiles_x, int spp_shift,
                             int clear, void* stream) {
  combine_home<<<blocks(static_cast<long long>(width) * height, kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      inv, src, contrib, acc, cap, tiling(width, height, tiles_x, spp_shift), clear);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and static shared bytes of one
// kernel, as the CUDA runtime reports them; returns a cudaError_t.
// `which`: 0/1 K0 untextured/textured, 2/3 K1, 4 pack_count, 5 pack_scan,
// 6 pack_scatter, 7 combine_level, 8 combine_home, 9/10 K1 kStats, 11/12
// K0 and 13/14 K1 with the box tables in global memory (kStaged = false).
int wrt_regroup_attributes(int which, int* num_regs, int* local_bytes, int* shared_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(regroup_k0<false, true>),
      reinterpret_cast<const void*>(regroup_k0<true, true>),
      reinterpret_cast<const void*>(regroup_k1<false, false>),
      reinterpret_cast<const void*>(regroup_k1<true, false>),
      reinterpret_cast<const void*>(pack_count),
      reinterpret_cast<const void*>(pack_scan),
      reinterpret_cast<const void*>(pack_scatter),
      reinterpret_cast<const void*>(combine_level),
      reinterpret_cast<const void*>(combine_home),
      reinterpret_cast<const void*>(regroup_k1<false, true>),
      reinterpret_cast<const void*>(regroup_k1<true, true>),
      reinterpret_cast<const void*>(regroup_k0<false, false>),
      reinterpret_cast<const void*>(regroup_k0<true, false>),
      reinterpret_cast<const void*>(regroup_k1<false, false, false>),
      reinterpret_cast<const void*>(regroup_k1<true, false, false>),
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
