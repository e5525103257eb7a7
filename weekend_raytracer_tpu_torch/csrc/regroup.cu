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
//            pool, in place, plus the base-radiance pool tr * cr.
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
// (bounce.cuh) and are bound the same way, by divergent FP32 work in the
// sweep and the scatter; they are one thread per record, so after a cut
// every warp runs 32 live paths. PACK and COMBINE are bound by memory: each
// moves about 64 bytes per live record (16 f32 components), or 12 bytes
// per slot of radiance, with coalesced reads and, since the compaction is
// stable, mostly coalesced writes. Nothing here is staged through shared
// memory, and no matrix unit is used.
//
// Counts stay on the card: PACK writes the live count to device memory and
// the launches that follow read it there and are sized by its upper bound
// (the record capacity); threads past the count return at once. So a frame
// has no host synchronisation between its kernels.

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

constexpr int kThreads = 256;    // K0, K1, COMBINE: one thread per record
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

struct K0Args {
  const float* cam;  // [20]
  SceneRefs scene;
  float* pool;       // [16, cap]
  float* contrib;    // [3, cap]
  long long cap;
  Tiling g;
  float inv_w, inv_h;  // f32(1 / width), f32(1 / full_height)
  uint32_t frame, row_offset;
  int b_hi;
};

// K0: camera ray and bounces [0, b_hi) of one slot; every slot is written.
template <bool kTextured>
__global__ void __launch_bounds__(kThreads) regroup_k0(const K0Args a) {
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
  trace_bounces<kTextured>(a.scene, 0, a.b_hi, r);

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
  float* pool;       // [16, cap] dense, updated in place
  float* r8;         // [3, cap] base radiance tr * cr
  const int* count;  // live records in the pool
  long long cap;
  Tiling g;
  uint32_t frame, row_offset;
  int b_lo, b_hi;
};

// K1: bounces [b_lo, b_hi) of one dense record. The RNG state is the home
// slot's seed advanced 4 * (b_lo + 1) draws (regroup.py:723-741).
template <bool kTextured>
__global__ void __launch_bounds__(kThreads) regroup_k1(const K1Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= *a.count) return;
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
  trace_bounces<kTextured>(a.scene, a.b_lo, a.b_hi, r);

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

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers, and returns cudaGetLastError() after its launches. `cap` is
// the slot count, a multiple of 4096 below 2^28.

int wrt_regroup_k0(const float* cam, const float* sky, const float* sweep, const float* attrs,
                   const int* tex_pool, int n_spheres, float* pool, float* contrib,
                   long long cap, int width, int height, int tiles_x, int spp_shift,
                   float inv_w, float inv_h, unsigned frame, unsigned row_offset, int b_hi,
                   void* stream) {
  K0Args a;
  a.cam = cam;
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
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
  if (tex_pool != nullptr) {
    regroup_k0<true><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  } else {
    regroup_k0<false><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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
                   unsigned row_offset, int b_lo, int b_hi, void* stream) {
  K1Args a;
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
  a.pool = pool;
  a.r8 = r8;
  a.count = count;
  a.cap = cap;
  a.g = tiling(width, height, tiles_x, spp_shift);
  a.frame = frame;
  a.row_offset = row_offset;
  a.b_lo = b_lo;
  a.b_hi = b_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tex_pool != nullptr) {
    regroup_k1<true><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  } else {
    regroup_k1<false><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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

// Registers per thread and local (spill) bytes of one kernel, as the CUDA
// runtime reports them; returns a cudaError_t. `which`: 0/1 K0 untextured/
// textured, 2/3 K1, 4 pack_count, 5 pack_scan, 6 pack_scatter,
// 7 combine_level, 8 combine_home.
int wrt_regroup_attributes(int which, int* num_regs, int* local_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(regroup_k0<false>),
      reinterpret_cast<const void*>(regroup_k0<true>),
      reinterpret_cast<const void*>(regroup_k1<false>),
      reinterpret_cast<const void*>(regroup_k1<true>),
      reinterpret_cast<const void*>(pack_count),
      reinterpret_cast<const void*>(pack_scan),
      reinterpret_cast<const void*>(pack_scatter),
      reinterpret_cast<const void*>(combine_level),
      reinterpret_cast<const void*>(combine_home),
  };
  if (which < 0 || which >= static_cast<int>(sizeof(fns) / sizeof(fns[0]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
