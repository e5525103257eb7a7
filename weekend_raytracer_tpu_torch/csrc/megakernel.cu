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
// The kStats instantiation replaces the same TPU kernel built with
// stats=True (_make_kernel, 1146; its counters 1233-1286): the same frame,
// plus the per-tile counters of stats.cuh. It keeps the loop of one sample
// after another and the full sweep: it counts what the TPU's whole-tile
// cull would enter, skips nothing, and is the exact full-sweep reference of
// the kStats = false image, which equals it in every bit. Bound like the
// frame itself, by FP32 work: the cull tests add about 4% to the sweep.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

struct Args {
  const float* cam;      // [20] eye, horizontal, vertical, u, v, llc, lens_r, 0
  SceneRefs scene;
  CullRefs cull;         // the chunk hierarchy (n_chunks = 0: none)
  CullMargin margin;     // read by the kStats = false instantiations
  float* acc;            // [height * width, 3]
  int width, height;
  float inv_w, inv_h;    // f32(1 / width), f32(1 / full_height)
  uint32_t frame, row_offset;
  int clear, spp, num_bounces;
};

// What the kStats instantiation reads besides: the counters and the TPU
// tiles across. (The kStats = false instantiations keep Args alone, so
// they compile without the counters.)
struct StatsArgs : Args {
  StatsRefs st;
  int tiles_x;
  unsigned pad_x, pad_y;  // lanes of the TPU's last tile past the image edge
};

template <bool kStats>
using ArgsOf = std::conditional_t<kStats, StatsArgs, Args>;

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
// The kStats = false instantiations' register budget (see the header).
constexpr int kMinBlocks = 4;

// The TPU kernel's tile: tsub = 32 rows of 128 lanes as a block_w = 64
// pixel-wide block (megakernel.py:1634-1640).
constexpr int kTileW = 64;
constexpr int kTileH = 64;

// The kStats instantiation counts per (TPU tile, sample). The TPU pads the
// image to whole tiles and clamps a padded lane into the image, so the lane
// traces the edge pixel's path again and counts it (megakernel.py:1204-1206);
// here the edge pixel's path is traced once and its live lanes count with
// the weight of every lane that traces it. Its launch bound asks for 4
// blocks per SM too: left to itself ptxas kept the textured kStats
// instantiation at 48 registers and spilled 88 bytes.
template <bool kTextured, bool kStats, bool kStaged = true>
__global__ void __launch_bounds__(kBlockX * kBlockY, kStats ? 4 : kMinBlocks)
    megakernel(const ArgsOf<kStats> a) {
  CullView cv{};
  if constexpr (!kStats) cv = stage_cull<kStaged>(a.cull, a.scene.sweep, a.margin);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.width || y >= a.height) return;

  // Seeds and aim use the global row, so a row band of a sharded image
  // reproduces the same pixels as the whole image (megakernel.py:1207-1213).
  const uint32_t y_g = static_cast<uint32_t>(y) + a.row_offset;
  const uint32_t pix = y_g * static_cast<uint32_t>(a.width) + static_cast<uint32_t>(x);
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(static_cast<int>(y_g));
  const uint32_t frame_hash = jenkins(a.frame);

  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
  if constexpr (kStats) {
    for (int s = 0; s < a.spp; ++s) {
      Ray r;
      r.state = sample_seed(pix, frame_hash, static_cast<uint32_t>(s));
      camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
      const int tile = (y / kTileH) * a.tiles_x + x / kTileW;
      const unsigned weight = (x == a.width - 1 ? 1u + a.pad_x : 1u) *
                              (y == a.height - 1 ? 1u + a.pad_y : 1u);
      RayCounter rc{&a.cull, &a.st, tile * a.spp + s, weight, 0u};
      trace_bounces<kTextured, true>(a.scene, 0, a.num_bounces, r, &rc);
      count_trips(a.st, rc);
      tot_r = tot_r + r.tr * r.cr;
      tot_g = tot_g + r.tg * r.cg;
      tot_b = tot_b + r.tb * r.cb;
    }
  } else {
    // One bounce a step. When a path ends (a miss, an emitter, or
    // num_bounces reached alive, colour 0), its tr * c joins the sum and
    // the lane starts the pixel's next sample, until all spp are done.
    Ray r;
    r.state = sample_seed(pix, frame_hash, 0u);
    camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
    int s = 0, bounce = 0;
    for (;;) {
      if (bounce_step<kTextured, false, kStaged>(a.scene, r, nullptr, 0, &cv) &&
          ++bounce < a.num_bounces) {
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
  }

  float* out = a.acc + (static_cast<size_t>(y) * a.width + x) * 3;
  const float base_r = a.clear ? 0.0f : out[0];
  const float base_g = a.clear ? 0.0f : out[1];
  const float base_b = a.clear ? 0.0f : out[2];
  out[0] = base_r + tot_r;
  out[1] = base_g + tot_g;
  out[2] = base_b + tot_b;
}

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
    (staged ? megakernel<true, false, true> : megakernel<true, false, false>)
        <<<grid, block, smem, s>>>(a);
  } else {
    (staged ? megakernel<false, false, true> : megakernel<false, false, false>)
        <<<grid, block, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same frame through the kStats instantiation, which sweeps every
// sphere and also writes the TPU kernel's per-tile counters into stats
// [n_tiles, 8] f32, n_tiles = ceil(width / 64) * ceil(height / 64). The
// cull hierarchy is the one wrt_megakernel_launch takes; scratch holds
// scratch_words u32 words (stats_scratch_words with groups = n_tiles * spp
// and n_iters = num_bounces). Returns a cudaError_t.
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
  a.st = stats_refs(scratch, groups, num_bounces, n_tests, n_super);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_counted(scratch, scratch_words, a.st, n_tests, n_super, super_factor, spp, n_tiles,
                     stats, s, [&] {
                       if (tex_pool != nullptr) {
                         megakernel<true, true><<<grid, block, 0, s>>>(a);
                       } else {
                         megakernel<false, true><<<grid, block, 0, s>>>(a);
                       }
                     });
}

// Registers per thread and local (spill) bytes of one instantiation, as the
// CUDA runtime reports them; returns a cudaError_t. `stats` picks kStats,
// `staged` (kStats = 0 only) whether the box tables sit in shared memory.
int wrt_megakernel_attributes(int textured, int stats, int staged, int* num_regs,
                              int* local_bytes) {
  const void* fns[2][3] = {
      {reinterpret_cast<const void*>(megakernel<false, false, false>),
       reinterpret_cast<const void*>(megakernel<false, false, true>),
       reinterpret_cast<const void*>(megakernel<false, true>)},
      {reinterpret_cast<const void*>(megakernel<true, false, false>),
       reinterpret_cast<const void*>(megakernel<true, false, true>),
       reinterpret_cast<const void*>(megakernel<true, true>)},
  };
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, fns[textured != 0][stats != 0 ? 2 : staged != 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// The kStats = false instantiations' launch bounds: threads a block and
// the blocks an SM that fix their register budget (0: no minimum).
void wrt_megakernel_launch_bounds(int* threads, int* min_blocks) {
  *threads = kBlockX * kBlockY;
  *min_blocks = kMinBlocks;
}

}  // extern "C"
