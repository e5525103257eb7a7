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
// liveness exit (a per-thread break: every sample's RNG stream is seeded
// independently, so no pixel changes), the chunk/super-chunk culling (speed
// only; this version sweeps every prepared sphere), and the winner-retrieval
// LUT (a thread reads its winner's attributes directly).
//
// What bounds it on an H100: divergent FP32 ALU work in the sweep and the
// scatter, and register pressure from the long per-ray state; not memory
// bandwidth (sphere data is a few KiB, read as warp-uniform broadcasts that
// stay in L1, and each pixel writes 12 bytes once per frame). The design
// answers with 16x16 blocks, so a warp covers a compact 16x2 screen patch
// whose rays stay coherent longer; a per-material branch, so a thread
// evaluates only its material's scatter (the TPU evaluates all of them and
// selects); and a textured and an untextured instantiation, so scenes
// without image textures carry no texture state.
//
// The camera ray and the bounce loop live in bounce.cuh, shared with the
// regroup kernels K0 and K1 (regroup.cu). Arithmetic mirrors the TPU kernel
// and the plain PyTorch version (ops/cuda/megakernel.py
// render_image_megakernel_plain) operation for operation. nvcc's default FMA
// contraction stays on; images are held to the plain version statistically,
// as the TPU kernel is held to the XLA path.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

struct Args {
  const float* cam;      // [20] eye, horizontal, vertical, u, v, llc, lens_r, 0
  SceneRefs scene;
  float* acc;            // [height * width, 3]
  int width, height;
  float inv_w, inv_h;    // f32(1 / width), f32(1 / full_height)
  uint32_t frame, row_offset;
  int clear, spp, num_bounces;
};

template <bool kTextured>
__global__ void __launch_bounds__(256) megakernel(const Args a) {
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
  for (int s = 0; s < a.spp; ++s) {
    Ray r;
    r.state = sample_seed(pix, frame_hash, static_cast<uint32_t>(s));
    camera_ray(a.cam, xf, yf, a.inv_w, a.inv_h, r);
    trace_bounces<kTextured>(a.scene, 0, a.num_bounces, r);
    tot_r = tot_r + r.tr * r.cr;
    tot_g = tot_g + r.tg * r.cg;
    tot_b = tot_b + r.tb * r.cb;
  }

  float* out = a.acc + (static_cast<size_t>(y) * a.width + x) * 3;
  const float base_r = a.clear ? 0.0f : out[0];
  const float base_g = a.clear ? 0.0f : out[1];
  const float base_b = a.clear ? 0.0f : out[2];
  out[0] = base_r + tot_r;
  out[1] = base_g + tot_g;
  out[2] = base_b + tot_b;
}

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

}  // namespace

extern "C" {

// One frame over a width x height image. Pointers are device pointers;
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launch.
int wrt_megakernel_launch(const float* cam, const float* sky, const float* sweep,
                          const float* attrs, const int* tex_pool, float* acc, int n_spheres,
                          int width, int height, float inv_w, float inv_h, unsigned frame,
                          unsigned row_offset, int clear, int spp, int num_bounces,
                          void* stream) {
  Args a;
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
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tex_pool != nullptr) {
    megakernel<true><<<grid, block, 0, s>>>(a);
  } else {
    megakernel<false><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes of one instantiation, as the
// CUDA runtime reports them; returns a cudaError_t.
int wrt_megakernel_attributes(int textured, int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = textured ? cudaFuncGetAttributes(&attr, megakernel<true>)
                                   : cudaFuncGetAttributes(&attr, megakernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
