// Fused path-tracing megakernel for Hopper (sm_90a): one progressive frame
// in one launch.
//
// Replaces weekend_raytracer_tpu/ops/pallas/megakernel.py::_make_kernel with
// its per-bounce body _make_bounce (the pallas_call at megakernel.py:1713).
// It computes what that kernel computes, per pixel and sample: the
// independent per-(pixel, frame, sample) seed, a jittered thin-lens camera
// ray, then up to num_bounces bounces of closest-hit sweep (expanded
// quadratic with kq = |c|^2 - r^2, strict <, first index wins), spherical
// UV and packed-RGB8 texture fetch, four RNG draws, the lambertian / metal /
// dielectric / checkerboard / error-pink scatter or the emissive end, and
// the Hosek-Wilkie-form sky on a miss. The sum of tr * c over the samples
// is added to the accumulator, or written over it when `clear` is set.
//
// What it does not copy from the TPU kernel: the (32, 128) lane tiles and
// their lane <-> pixel permutation (one thread per pixel here, reading and
// writing the scanline accumulator [H*W, 3] directly), the whole-tile
// liveness exit and the per-tile cull (see below), and the
// winner-retrieval LUT (a thread reads its winner's attributes directly).
//
// What bounds it on an H100: divergent FP32 ALU work in the sweep and the
// scatter, and register pressure from the long per-ray state; not memory
// bandwidth (sphere data is a few KiB, read as warp-uniform broadcasts that
// stay in L1, and each pixel writes 12 bytes once per frame). The design
// answers with:
//   - The exact per-warp cull of regroup K0 and K1 (bounce.cuh
//     sweep_culled): in a scene with chunks a warp sweeps a chunk's
//     spheres only if one of its lanes enters the chunk's box, widened by
//     the lane's own rounding margin, closer than its bound; the tables
//     are staged per block as K0 and K1 stage them (bounce.cuh stage_cull,
//     in global memory above kStageBytes). The TPU culls per 4096-lane
//     tile; a warp here is a 16x2 pixel patch of a 16x16 block. The
//     result is the full sweep's (bt, bi) in every bit.
//   - Samples refilled per lane: one loop of bounce steps, in which a lane
//     whose path ends (a miss, an emitter, or num_bounces reached) adds
//     its tr * c to the pixel's sum and starts its next sample at once, so
//     a warp runs for its longest lane's total path length, not for the
//     sum over samples of each sample's longest path (most paths end
//     within two bounces; a few run all eight). Each lane still owns one
//     pixel, adds its samples in sample order, and seeds each sample on
//     its own, so no pixel changes in any bit. The price is a less
//     coherent vote: a warp's lanes are at different bounces of different
//     samples.
//   - One register budget, kMinBlocks = 4 blocks of 256 threads an SM (up
//     to 64 registers; ptxas takes 60), chosen on the card
//     (tools/megakernel_steps.py): left to itself ptxas holds the loop to
//     48 registers and spills 40 bytes, as it does at 5 blocks.
//   - A per-material branch, so a thread evaluates only its material's
//     scatter (the TPU evaluates all of them and selects), and a textured
//     and an untextured instantiation, so scenes without image textures
//     carry no texture state.
//
// The camera ray and the one-bounce step live in bounce.cuh, shared with
// the regroup kernels K0 and K1 (regroup.cu) and the wavefront, so every
// kernel inlines the same expressions. Arithmetic mirrors the TPU kernel
// and the plain PyTorch version (ops/cuda/megakernel.py
// render_image_megakernel_plain) operation for operation. nvcc's default FMA
// contraction stays on; images are held to the plain version statistically,
// as the TPU kernel is held to the XLA path.
//
// The stats kernel, megakernel_stats, replaces the same TPU kernel built
// with stats=True (_make_kernel, 1146; its counters 1233-1286): the same
// frame, plus the per-tile counters of stats.cuh. It keeps the full sweep:
// it counts what the TPU's whole-tile cull would enter, skips nothing, and
// is the exact full-sweep reference of the culled kernel's image, which
// equals it in every bit. Bound like the frame itself, by FP32 work (15
// operations a pair; the cull tests add about 5%). Its design on an H100
// (see bounce.cuh's stats section): the sphere table staged in shared
// memory with 2c, in windows that the block walks in step where it does
// not fit; two spheres' discriminants before any root; and the samples
// refilled per lane, as above, one full sweep a step.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "mxu.cuh"

namespace {

struct Args {
  const float* cam;      // [20] eye, horizontal, vertical, u, v, llc, lens_r, 0
  SceneRefs scene;
  CullRefs cull;         // the chunk hierarchy (n_chunks = 0: none)
  CullMargin margin;     // read by the culled kernel (sweep_culled)
  float* acc;            // [height * width, 3]
  int width, height;
  float inv_w, inv_h;    // f32(1 / width), f32(1 / full_height)
  uint32_t frame, row_offset;
  int clear, spp, num_bounces;
  const float* amats;    // the MXU chunk sweep's A table (kMxu; mxu.cuh)
};

// What the stats kernel reads besides: the counters, the TPU tiles across,
// and its windows of the sphere table (stats_plan).
struct StatsArgs : Args {
  StatsRefs st;
  int tiles_x;
  unsigned pad_x, pad_y;  // lanes of the TPU's last tile past the image edge
  int window;             // spheres a window
  unsigned table_offset;  // where the table starts in dynamic shared memory
};

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
// The register budget (see the header). The stats kernel's, chosen on the
// card (tools/stats_steps.py): 4 blocks of 256 threads an SM (64
// registers) where it stages the table whole, 3 (80) where it sweeps
// windows, which at 4 spill 68-92 bytes and at 3 hold 78-80 registers with
// none, as fast or faster; its threads a block (one-dimensional: its lanes
// take pixels as they go).
constexpr int kMinBlocks = 4;
// The MXU instantiation's budget: 2 blocks of 256 threads an SM (up to
// 128 registers), room for the hoisted B fragments and the epilogue's
// slots (mxu.cuh) without spills.
constexpr int kMxuMinBlocks = 2;
constexpr int kStatsMinBlocks = 4;     // the table staged whole
constexpr int kWindowedMinBlocks = 3;  // swept in windows
constexpr int kStatsThreads = 256;

// The TPU kernel's tile: tsub = 32 rows of 128 lanes as a block_w = 64
// pixel-wide block (megakernel.py:1634-1640).
constexpr int kTileW = 64;
constexpr int kTileH = 64;

//
// kMxu: the same frame on the MXU chunk sweep (mxu.cuh), whose products
// take the whole warp: a lane whose pixel lies past the image, or whose
// samples are done, stays in the loop without a path until no lane of its
// warp has one, and each lane still adds its samples in sample order.
template <bool kTextured, bool kStaged = true, bool kMxu = false>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMxu ? kMxuMinBlocks : kMinBlocks)
    megakernel(const Args a) {
  const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if constexpr (kMxu) {
    const bool inside = x < a.width && y < a.height;
    const uint32_t y_g = static_cast<uint32_t>(y) + a.row_offset;
    const uint32_t pix = y_g * static_cast<uint32_t>(a.width) + static_cast<uint32_t>(x);
    const float xf = static_cast<float>(x);
    const float yf = static_cast<float>(static_cast<int>(y_g));
    const uint32_t frame_hash = jenkins(a.frame);
    float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
    Ray r = {};
    bool live = inside;
    if (live) {
      r.state = sample_seed(pix, frame_hash, 0u);
      camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
    }
    int s = 0, bounce = 0;
    while (__any_sync(kFullWarp, live)) {
      const bool on = bounce_step_mxu<kTextured, kStaged>(a.scene, r, cv, a.amats, live);
      if (!live) continue;
      if (on && ++bounce < a.num_bounces) continue;
      tot_r = tot_r + r.tr * r.cr;
      tot_g = tot_g + r.tg * r.cg;
      tot_b = tot_b + r.tb * r.cb;
      if (++s == a.spp) {
        live = false;
        continue;
      }
      r.state = sample_seed(pix, frame_hash, static_cast<uint32_t>(s));
      camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
      bounce = 0;
    }
    if (!inside) return;
    float* out = a.acc + (static_cast<size_t>(y) * a.width + x) * 3;
    const float base_r = a.clear ? 0.0f : out[0];
    const float base_g = a.clear ? 0.0f : out[1];
    const float base_b = a.clear ? 0.0f : out[2];
    out[0] = base_r + tot_r;
    out[1] = base_g + tot_g;
    out[2] = base_b + tot_b;
    return;
  }
  if (x >= a.width || y >= a.height) return;

  // Seeds and aim use the global row, so a row band of a sharded image
  // reproduces the same pixels as the whole image (megakernel.py:1207-1213).
  const uint32_t y_g = static_cast<uint32_t>(y) + a.row_offset;
  const uint32_t pix = y_g * static_cast<uint32_t>(a.width) + static_cast<uint32_t>(x);
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(static_cast<int>(y_g));
  const uint32_t frame_hash = jenkins(a.frame);

  // One bounce a step. When a path ends (a miss, an emitter, or
  // num_bounces reached alive, colour 0), its tr * c joins the sum and
  // the lane starts the pixel's next sample, until all spp are done.
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
  Ray r;
  r.state = sample_seed(pix, frame_hash, 0u);
  camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
  int s = 0, bounce = 0;
  for (;;) {
    if (bounce_step<kTextured, kStaged>(a.scene, r, &cv) && ++bounce < a.num_bounces) {
      continue;
    }
    tot_r = tot_r + r.tr * r.cr;
    tot_g = tot_g + r.tg * r.cg;
    tot_b = tot_b + r.tb * r.cb;
    if (++s == a.spp) break;
    r.state = sample_seed(pix, frame_hash, static_cast<uint32_t>(s));
    camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
    bounce = 0;
  }

  float* out = a.acc + (static_cast<size_t>(y) * a.width + x) * 3;
  const float base_r = a.clear ? 0.0f : out[0];
  const float base_g = a.clear ? 0.0f : out[1];
  const float base_b = a.clear ? 0.0f : out[2];
  out[0] = base_r + tot_r;
  out[1] = base_g + tot_g;
  out[2] = base_b + tot_b;
}

// Sample s of pixel (x, y): its seed and its camera ray (as the culled
// kernel starts each sample, from the global row).
__device__ __forceinline__ void start_sample(const Args& a, int x, int y, int s, Ray& r) {
  const uint32_t y_g = static_cast<uint32_t>(y) + a.row_offset;
  const uint32_t pix = y_g * static_cast<uint32_t>(a.width) + static_cast<uint32_t>(x);
  r.state = sample_seed(pix, jenkins(a.frame), static_cast<uint32_t>(s));
  camera_ray(a.cam, static_cast<float>(x), static_cast<float>(static_cast<int>(y_g)), a.inv_w,
             a.inv_h, r);
}

// The stats kernel: the frame above with every sphere swept and the
// counters of each (TPU tile, sample). The TPU pads the image to whole
// tiles and clamps a padded lane into the image, so the lane traces the
// edge pixel's path again and counts it (megakernel.py:1204-1206); here the
// edge pixel's path is traced once and its live lanes count with the
// weight of every lane that traces it.
//
// A persistent grid (the blocks the card holds at once) walks the pixels
// in scanline order: each lane traces one pixel's samples in order, one
// bounce a step, adds tr * c of each ended path to the pixel's sum and
// seeds its next sample, and when the pixel's last path ends writes it and
// takes the next pixel (take_item). So each pixel's sum is the culled
// kernel's in every bit, and a lane idles only at the end of the frame;
// the counters, ORs, maxima and sums keyed by (group, iteration), do not
// depend on the schedule. Each step is one full sweep of every lane that
// holds a path: where the table is staged whole, each warp steps on its
// own; where it is swept in windows (kWindowed), the block steps together,
// every thread taking part in staging and the barriers until the frame is
// done.
template <bool kTextured, bool kStaged, bool kWindowed>
__global__ void __launch_bounds__(kStatsThreads,
                                  kWindowed ? kWindowedMinBlocks : kStatsMinBlocks)
    megakernel_stats(const StatsArgs a) {
  const CullView cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  float4* tab = stats_table(a.table_offset);
  const int n = a.scene.n;
  if constexpr (!kWindowed) {
    stage_window(tab, a.scene.sweep, 0, n);
    __syncthreads();
  }
  const int pixels = a.width * a.height;
  int x = 0, y = 0, group = 0;  // group: the (tile, sample 0) group of the pixel
  int s = a.spp, bounce = 0;    // s == spp: no pixel in hand
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
  Ray r;
  // pixel p's first sample
  auto begin_pixel = [&](int p) {
    y = p / a.width;
    x = p - y * a.width;
    group = ((y / kTileH) * a.tiles_x + x / kTileW) * a.spp;
    s = 0;
    tot_r = tot_g = tot_b = 0.0f;
    start_sample(a, x, y, 0, r);
  };
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item < pixels) begin_pixel(item);
  for (;;) {
    const bool live = s < a.spp;
    if (kWindowed ? !__syncthreads_or(live) : !__any_sync(0xffffffffu, live)) break;
    CountedSweep cs;
    if (live) {
      begin_counted(cv, r, static_cast<unsigned>((group + s) * a.st.n_iters + bounce), cs);
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
    bool need = false;  // this lane's pixel is written: it takes another
    if (live) {
      end_counted<kStaged>(cv, a.st, cs);
      const bool on = scatter_hit<kTextured>(a.scene, r, cs.bt, cs.bi);
      // the trips of this sample's loop: its bounce steps, each a full sweep
      const unsigned trips = static_cast<unsigned>(bounce) + 1u;
      if (on && ++bounce < a.num_bounces) {
        // a live path's colour is 0 and it is alive, as camera_ray set them:
        // said here so that neither is carried from step to step
        r.cr = r.cg = r.cb = 0.0f;
        r.alive = true;
      } else {
        const unsigned weight = (x == a.width - 1 ? 1u + a.pad_x : 1u) *
                                (y == a.height - 1 ? 1u + a.pad_y : 1u);
        count_trips(a.st, group + s, trips, weight);
        tot_r = tot_r + r.tr * r.cr;
        tot_g = tot_g + r.tg * r.cg;
        tot_b = tot_b + r.tb * r.cb;
        bounce = 0;
        if (++s < a.spp) {
          start_sample(a, x, y, s, r);
        } else {
          float* out = a.acc + (static_cast<size_t>(y) * a.width + x) * 3;
          const float base_r = a.clear ? 0.0f : out[0];
          const float base_g = a.clear ? 0.0f : out[1];
          const float base_b = a.clear ? 0.0f : out[2];
          out[0] = base_r + tot_r;
          out[1] = base_g + tot_g;
          out[2] = base_b + tot_b;
          need = true;
        }
      }
    }
    const long long next = take_item(a.st.ticket, need);
    if (need && next < pixels) begin_pixel(static_cast<int>(next));
  }
}

// megakernel_stats by [textured][boxes staged][windowed].
void (*const kStatsKernels[2][2][2])(StatsArgs) = {
    {{megakernel_stats<false, false, false>, megakernel_stats<false, false, true>},
     {megakernel_stats<false, true, false>, megakernel_stats<false, true, true>}},
    {{megakernel_stats<true, false, false>, megakernel_stats<true, false, true>},
     {megakernel_stats<true, true, false>, megakernel_stats<true, true, true>}},
};

StatsArgs frame_args(const float* cam, const float* sky, const float* sweep, const float* attrs,
                     const int* tex_pool, float* acc, int n_spheres, int width, int height,
                     float inv_w, float inv_h, unsigned frame, unsigned row_offset, int clear,
                     int spp, int num_bounces, const float* chunk_bounds,
                     const float* super_bounds, const int* priors, int n_chunks, int n_tests,
                     int n_super, int chunk_size, int super_factor) {
  StatsArgs a = {};
  a.cull = CullRefs{chunk_bounds, super_bounds, priors, n_chunks, n_tests,
                    n_super, chunk_size, super_factor};
  a.cam = cam;
  a.scene.sky = sky;
  a.scene.sweep = reinterpret_cast<const float4*>(sweep);
  a.scene.attrs = attrs;
  a.scene.tex_pool = tex_pool;
  a.scene.n = n_spheres;
  a.acc = acc;
  a.width = width;
  a.height = height;
  a.inv_w = inv_w;
  a.inv_h = inv_h;
  a.frame = frame;
  a.row_offset = row_offset;
  a.clear = clear;
  a.spp = spp;
  a.num_bounces = num_bounces;
  return a;
}

}  // namespace

extern "C" {

// One frame over a width x height image. Pointers are device pointers;
// `stream` is a cudaStream_t. The cull hierarchy is prepare_scene_arrays'
// (chunk_bounds [6, n_tests], super_bounds [6, n_super], priors [4];
// n_chunks = 0: none, every sphere is swept), with the two scene terms of
// each lane's box margin (KernelInputs.cull_reach, cull_scale). Returns
// cudaGetLastError() after the launch.
int wrt_megakernel_launch(const float* cam, const float* sky, const float* sweep,
                          const float* attrs, const int* tex_pool, float* acc, int n_spheres,
                          int width, int height, float inv_w, float inv_h, unsigned frame,
                          unsigned row_offset, int clear, int spp, int num_bounces,
                          const float* chunk_bounds, const float* super_bounds,
                          const int* priors, int n_chunks, int n_tests, int n_super,
                          int chunk_size, int super_factor, float cull_reach, float cull_scale,
                          void* stream) {
  Args a = frame_args(cam, sky, sweep, attrs, tex_pool, acc, n_spheres, width, height, inv_w,
                      inv_h, frame, row_offset, clear, spp, num_bounces, chunk_bounds,
                      super_bounds, priors, n_chunks, n_tests, n_super, chunk_size,
                      super_factor);
  a.margin = CullMargin{cull_reach, cull_scale};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = cull_staged(a.cull);
  const size_t smem = cull_smem_bytes(a.cull);
  if (tex_pool != nullptr) {
    (staged ? megakernel<true, true> : megakernel<true, false>)<<<grid, block, smem, s>>>(a);
  } else {
    (staged ? megakernel<false, true> : megakernel<false, false>)<<<grid, block, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same frame on the MXU chunk sweep (megakernel<..., kMxu = true>):
// the arguments of wrt_megakernel_launch and the A table amats [n_chunks,
// 8, 2 * chunk_size] (mxu_sweep_amats). A scene without chunks has no MXU
// sweep: it is refused (cudaErrorInvalidValue), never swept otherwise.
int wrt_megakernel_mxu_launch(const float* cam, const float* sky, const float* sweep,
                              const float* attrs, const int* tex_pool, float* acc,
                              int n_spheres, int width, int height, float inv_w, float inv_h,
                              unsigned frame, unsigned row_offset, int clear, int spp,
                              int num_bounces, const float* chunk_bounds,
                              const float* super_bounds, const int* priors, int n_chunks,
                              int n_tests, int n_super, int chunk_size, int super_factor,
                              float cull_reach, float cull_scale, const float* amats,
                              void* stream) {
  if (n_chunks <= 0 || chunk_size <= 0 || amats == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = frame_args(cam, sky, sweep, attrs, tex_pool, acc, n_spheres, width, height, inv_w,
                      inv_h, frame, row_offset, clear, spp, num_bounces, chunk_bounds,
                      super_bounds, priors, n_chunks, n_tests, n_super, chunk_size,
                      super_factor);
  a.margin = CullMargin{cull_reach, cull_scale};
  a.amats = amats;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = cull_staged(a.cull);
  const size_t smem = cull_smem_bytes(a.cull);
  if (tex_pool != nullptr) {
    (staged ? megakernel<true, true, true> : megakernel<true, false, true>)<<<grid, block, smem,
                                                                              s>>>(a);
  } else {
    (staged ? megakernel<false, true, true> : megakernel<false, false, true>)<<<grid, block,
                                                                                smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same frame through the stats kernel, which sweeps every sphere and
// also writes the TPU kernel's per-tile counters into stats [n_tiles, 8]
// f32, n_tiles = ceil(width / 64) * ceil(height / 64). The cull hierarchy
// is the one wrt_megakernel_launch takes; scratch holds scratch_words u32
// words (stats_scratch_words with groups = n_tiles * spp and n_iters =
// num_bounces). Returns a cudaError_t.
int wrt_megakernel_stats_launch(const float* cam, const float* sky, const float* sweep,
                                const float* attrs, const int* tex_pool, float* acc,
                                int n_spheres, int width, int height, float inv_w, float inv_h,
                                unsigned frame, unsigned row_offset, int clear, int spp,
                                int num_bounces, const float* chunk_bounds,
                                const float* super_bounds, const int* priors, int n_chunks,
                                int n_tests, int n_super, int chunk_size, int super_factor,
                                unsigned* scratch, long long scratch_words, float* stats,
                                void* stream) {
  StatsArgs a = frame_args(cam, sky, sweep, attrs, tex_pool, acc, n_spheres, width, height,
                           inv_w, inv_h, frame, row_offset, clear, spp, num_bounces,
                           chunk_bounds, super_bounds, priors, n_chunks, n_tests, n_super,
                           chunk_size, super_factor);
  a.tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  a.pad_x = static_cast<unsigned>(a.tiles_x * kTileW - width);
  a.pad_y = static_cast<unsigned>(tiles_y * kTileH - height);
  const int n_tiles = a.tiles_x * tiles_y;
  const long long groups = static_cast<long long>(n_tiles) * spp;
  if (scratch_words != stats_scratch_words(groups, num_bounces, n_tests, n_super)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups * num_bounces > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.st = stats_refs(scratch, groups, num_bounces, n_tests, n_super, stats);
  const StatsPlan plan = stats_plan(a.cull, n_spheres);
  a.window = plan.window;
  a.table_offset = static_cast<unsigned>(plan.table_offset);
  const auto kernel = kStatsKernels[tex_pool != nullptr][cull_staged(a.cull)][plan.windows > 1];
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(kernel, kStatsThreads, plan.smem,
                                          static_cast<long long>(width) * height, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_counted(scratch, scratch_words, a.st, n_tests, n_super, super_factor, spp, n_tiles,
                     stats, s, [&] { kernel<<<grid, kStatsThreads, plan.smem, s>>>(a); });
}

// The stats kernels' windows (stats_plan, shared with regroup.cu's K1) for
// a cull hierarchy of n_spheres: spheres a window, windows, the table's
// offset in a block's dynamic shared memory and the block's dynamic bytes.
void wrt_stats_plan(int n_spheres, int n_chunks, int n_tests, int n_super, int chunk_size,
                    int* window, int* windows, long long* table_offset, long long* smem) {
  CullRefs cu = {};
  cu.n_chunks = n_chunks;
  cu.n_tests = n_tests;
  cu.n_super = n_super;
  cu.chunk_size = chunk_size;
  const StatsPlan p = stats_plan(cu, n_spheres);
  *window = p.window;
  *windows = p.windows;
  *table_offset = static_cast<long long>(p.table_offset);
  *smem = static_cast<long long>(p.smem);
}

// Registers per thread and local (spill) bytes of one instantiation, as the
// CUDA runtime reports them; returns a cudaError_t. `stats`: 0 the culled
// kernel, 1 the stats kernel with its table staged whole, 2 in windows;
// `staged` whether the box tables sit in shared memory.
int wrt_megakernel_attributes(int textured, int stats, int staged, int* num_regs,
                              int* local_bytes) {
  if (stats < 0 || stats > 2) return static_cast<int>(cudaErrorInvalidValue);
  const void* culled[2][2] = {
      {reinterpret_cast<const void*>(megakernel<false, false>),
       reinterpret_cast<const void*>(megakernel<false, true>)},
      {reinterpret_cast<const void*>(megakernel<true, false>),
       reinterpret_cast<const void*>(megakernel<true, true>)},
  };
  const void* fn = stats == 0 ? culled[textured != 0][staged != 0]
                              : reinterpret_cast<const void*>(
                                    kStatsKernels[textured != 0][staged != 0][stats == 2]);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// The culled kernel's launch bounds: threads a block and the blocks an SM
// that fix its register budget (0: no minimum).
void wrt_megakernel_launch_bounds(int* threads, int* min_blocks) {
  *threads = kBlockX * kBlockY;
  *min_blocks = kMinBlocks;
}

// The same of its MXU instantiation.
void wrt_megakernel_mxu_launch_bounds(int* threads, int* min_blocks) {
  *threads = kBlockX * kBlockY;
  *min_blocks = kMxuMinBlocks;
}

// Registers per thread and local (spill) bytes of the MXU instantiation,
// textured or not, with the box tables in shared memory (`staged`) or not;
// returns a cudaError_t.
int wrt_megakernel_mxu_attributes(int textured, int staged, int* num_regs, int* local_bytes) {
  const void* fns[2][2] = {
      {reinterpret_cast<const void*>(megakernel<false, false, true>),
       reinterpret_cast<const void*>(megakernel<false, true, true>)},
      {reinterpret_cast<const void*>(megakernel<true, false, true>),
       reinterpret_cast<const void*>(megakernel<true, true, true>)},
  };
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[textured != 0][staged != 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
