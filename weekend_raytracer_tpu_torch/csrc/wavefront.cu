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
// A warp is 32 lanes of one row; after a cut it still holds the dead lanes
// of its row, which skip the bounces (a warp whose lanes are all dead costs
// only its loads and stores). COMPACT is bound by memory: it reads each
// input row's alive plane (512 bytes) twice and moves 15 x 512 bytes per
// live row, in 16-byte loads and stores, one warp per row.
//
// Counts stay on the card: COMPACT writes the live row count to device
// memory and the launches that follow read it there and are sized by the
// capacity; threads past the count return at once. A frame has no host
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
constexpr int kThreads = 256;               // K0, K1: one thread per slot

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

struct K0Args {
  const float* cam;  // [20]
  SceneRefs scene;
  float* pool;       // [tiles, 15, 32, 128]
  float* contrib;    // [tiles, 3, 32, 128]
  long long cap;     // slots
  Tiling g;
  float inv_w, inv_h;  // f32(1 / width), f32(1 / height)
  uint32_t frame;
  int b_hi;
};

// K0: camera ray and bounces [0, b_hi) of one slot; every slot is written.
template <bool kTextured>
__global__ void __launch_bounds__(kThreads) wavefront_k0(const K0Args a) {
  const long long slot = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= a.cap) return;
  int x, y;
  uint32_t sample;
  slot_pixel(a.g, static_cast<uint32_t>(slot), x, y, sample);
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(a.g.width) +
                       static_cast<uint32_t>(x);
  Ray r;
  r.state = sample_seed(pix, jenkins(a.frame), sample);
  camera_ray(a.cam, static_cast<float>(x), static_cast<float>(y), a.inv_w, a.inv_h, r);
  trace_bounces<kTextured>(a.scene, 0, a.b_hi, r);

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

struct K1Args {
  SceneRefs scene;
  float* pool;       // [tiles, 15, 32, 128] dense rows, updated in place
  float* contrib;    // [tiles, 3, 32, 128] by home row
  const int* count;  // dense rows in the pool
  long long cap;     // slots
  int b_lo, b_hi;
};

// K1: bounces [b_lo, b_hi) of one lane of a dense row, from its stored
// state. A live lane (alive > 0.5, as the TPU kernel's bounce loop reads
// it) is traced and written back; a dead one is left as it is. Every lane
// of the row writes its tr * cr to its home row: a dead lane's is the value
// it wrote when its path ended (wavefront.py:282-284). A live lane's colour
// is 0 (a path has none until it ends), so it is not loaded: fewer values
// live across the bounces (loading it too made ptxas spill at 48
// registers).
template <bool kTextured>
__global__ void __launch_bounds__(kThreads) wavefront_k1(const K1Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = i >> 7;
  if (i >= a.cap || row >= *a.count) return;
  const int lane = static_cast<int>(i & 127);
  float* p = a.pool + record_at(row, lane);
  Ray r;
  if (p[kAL * kPlane] > 0.5f) {
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
    trace_bounces<kTextured>(a.scene, a.b_lo, a.b_hi, r);
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
  } else {
    r.tr = p[kTR * kPlane];
    r.tg = p[kTG * kPlane];
    r.tb = p[kTB * kPlane];
    r.cr = p[kCR * kPlane];
    r.cg = p[kCG * kPlane];
    r.cb = p[kCB * kPlane];
  }
  const long long home = static_cast<long long>(p[kHOME * kPlane]);
  float* q = a.contrib + contrib_at(home, lane);
  q[0] = r.tr * r.cr;
  q[kPlane] = r.tg * r.cg;
  q[2 * kPlane] = r.tb * r.cb;
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

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers, and returns cudaGetLastError() after its launches. `cap` is
// the slot count, a multiple of 4096 (whole tiles) below 2^31.

int wrt_wavefront_k0(const float* cam, const float* sky, const float* sweep,
                     const float* attrs, const int* tex_pool, int n_spheres, float* pool,
                     float* contrib, long long cap, int width, int height, int tiles_x,
                     int spp_shift, float inv_w, float inv_h, unsigned frame, int b_hi,
                     void* stream) {
  K0Args a;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tex_pool != nullptr) {
    wavefront_k0<true><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  } else {
    wavefront_k0<false><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  }
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
                     const int* count, long long cap, int b_lo, int b_hi, void* stream) {
  K1Args a;
  a.scene = scene_refs(sky, sweep, attrs, tex_pool, n_spheres);
  a.pool = pool;
  a.contrib = contrib;
  a.count = count;
  a.cap = cap;
  a.b_lo = b_lo;
  a.b_hi = b_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tex_pool != nullptr) {
    wavefront_k1<true><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  } else {
    wavefront_k1<false><<<blocks(cap, kThreads), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes of one kernel, as the CUDA
// runtime reports them; returns a cudaError_t. `which`: 0/1 K0 untextured/
// textured, 2/3 K1, 4 compact_count, 5 compact_scan, 6 compact_scatter.
int wrt_wavefront_attributes(int which, int* num_regs, int* local_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(wavefront_k0<false>),
      reinterpret_cast<const void*>(wavefront_k0<true>),
      reinterpret_cast<const void*>(wavefront_k1<false>),
      reinterpret_cast<const void*>(wavefront_k1<true>),
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
  return 0;
}

}  // extern "C"
