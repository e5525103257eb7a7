// The per-ray path-tracing body shared by the megakernel (megakernel.cu),
// the regroup kernels K0 and K1 (regroup.cu) and the wavefront's K0 and K1
// (wavefront.cu).
//
// Counterpart of weekend_raytracer_tpu/ops/pallas/megakernel.py::_make_bounce
// (294-1143) and _camera_ray (128-162), the one body every TPU kernel of the
// JAX package runs: the per-(pixel, frame, sample) seed, a jittered
// thin-lens camera ray, then bounces [b_lo, b_hi) of closest-hit sweep
// (expanded quadratic with kq = |c|^2 - r^2, strict <, first index wins),
// spherical UV and packed-RGB8 texture fetch, four RNG draws, the
// lambertian / metal / dielectric / checkerboard / error-pink scatter or the
// emissive end, and the Hosek-Wilkie-form sky on a miss.
//
// A path's whole state is a Ray: origin, unit direction, throughput tr,
// colour cr (0 until the path ends), alive, and the RNG state. Because a
// path draws exactly four floats for the camera and four per bounce that
// hits, the state entering bounce b of a path still alive is the seed
// advanced 4 * (b + 1) times; K1 re-derives it that way instead of storing
// it. Running [0, n) in one call or [0, c) then [c, n) on a stored and
// reloaded Ray gives the same bits: every value crosses the cut as a
// rounded f32, and each kernel inlines the same expressions.
//
// Arithmetic mirrors the TPU kernel and the plain PyTorch version
// (ops/cuda/megakernel.py) operation for operation, including the
// polynomial acos/atan2. Built without --use_fast_math (IEEE sqrtf,
// accurate sinf/cosf/expf/powf).
//
// bounce_step is one bounce; trace_bounces runs it over a span of bounces,
// and the refill loops (the megakernel's, the wavefront's K0 and K1) call
// it directly, so each inlines the same expressions. Given the cull tables
// of a scene with chunks (CullView, staged by stage_cull), it sweeps only
// the chunks that some lane of its warp can enter (sweep_culled), which
// gives the full sweep's (bt, bi) in every bit; regroup K0 and K1, the
// megakernel and the wavefront's K0 and K1 pass them. The wavefront's
// kCull = false instantiations pass none and sweep every sphere: they are
// the exact full-sweep reference of the gates.
//
// The stats kernels (the megakernel's and K1's counters, stats.cuh) sweep
// every sphere too, from a table staged in shared memory (stats_plan,
// stage_window, sweep_window below), and then scatter through the same
// scatter_hit as bounce_step.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "card.cuh"
#include "stats.cuh"

namespace {

constexpr float kPi = static_cast<float>(3.14159265358979);
constexpr float kHalfPi = static_cast<float>(0.5 * 3.14159265358979);
constexpr float kFrac1Pi = static_cast<float>(1.0 / 3.14159265358979);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979);
constexpr float kInvTwoPi = static_cast<float>(1.0 / (2.0 * 3.14159265358979));
constexpr float kEps = static_cast<float>(1.0e-3);
constexpr float kMinT = static_cast<float>(1.0e-3);
constexpr float kMaxT = static_cast<float>(1.0e3);
constexpr float kInv2_24 = static_cast<float>(1.0 / (1 << 24));
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

// Material ids (models/materials.py), compared as floats like the TPU kernel.
constexpr float kLambertian = 0.0f;
constexpr float kMetal = 1.0f;
constexpr float kDielectric = 2.0f;
constexpr float kCheckerboard = 3.0f;
constexpr float kEmissive = 4.0f;
constexpr float kPinkR = static_cast<float>(0.9921);
constexpr float kPinkG = static_cast<float>(0.24705);
constexpr float kPinkB = static_cast<float>(0.57254);

// Attribute rows of the SoA sphere table (ops/cuda/megakernel.py).
enum Attr {
  kCx, kCy, kCz, kRad, kMid, kMx, kA1r, kA1g, kA1b, kA2r, kA2g, kA2b,
  kT1Base, kT1W, kT1H, kT2Base, kT2W, kT2H,
};

// What the bounce body reads: the prepared scene and the sky.
struct SceneRefs {
  const float* sky;      // [33] 27 params, 3 radiances, sun direction
  const float4* sweep;   // [n] (cx, cy, cz, kq)
  const float* attrs;    // [n_attr, n] SoA
  const int* tex_pool;   // packed RGB8 texels, 128 per row; null: no textures
  int n;                 // prepared (padded) sphere count
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;  // throughput
  float cr, cg, cb;  // colour of the light that ended the path, else 0
  bool alive;
  uint32_t state;
};

// --- RNG: the same uint32 recurrence as ops/rng.py (logical shifts) ------

__device__ __forceinline__ uint32_t jenkins(uint32_t x) {
  x = x + (x << 10);
  x = x ^ (x >> 6);
  x = x + (x << 3);
  x = x ^ (x >> 11);
  x = x + (x << 15);
  return x;
}

__device__ __forceinline__ void rng_step(uint32_t& state) {
  const uint32_t old = state + 747796405u + 2891336453u;
  const uint32_t shift = (old >> 28) + 4u;
  const uint32_t word = ((old >> shift) ^ old) * 277803737u;
  state = (word >> 22) ^ word;
}

__device__ __forceinline__ float rng_float(uint32_t& state) {
  rng_step(state);
  return static_cast<float>(static_cast<int>(state >> 8)) * kInv2_24;
}

// Seed of one (pixel, frame, sample) stream (ops/rng.py init_sample_state).
__device__ __forceinline__ uint32_t sample_seed(uint32_t pix, uint32_t frame_hash,
                                                uint32_t sample) {
  return jenkins(pix ^ frame_hash ^ (0x9E3779B9u * (sample + 1u)));
}

// --- approximate trig, as the TPU kernel (megakernel.py:70-98) -----------

__device__ __forceinline__ float atan2_approx(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = fminf(ax, ay);
  const float den = fmaxf(ax, ay);
  const float z = num / fmaxf(den, 1.0e-30f);
  const float z2 = z * z;
  float r = z * (0.9998660f + z2 * (-0.3302995f + z2 * (
      0.1801410f + z2 * (-0.0851330f + z2 * 0.0208351f))));
  r = swap ? kHalfPi - r : r;
  r = x < 0.0f ? kPi - r : r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float acos_approx(float x) {
  const float ax = fabsf(x);
  const float p = 1.5707288f + ax * (-0.2121144f + ax * (0.0742610f + ax * (-0.0187293f)));
  const float f = sqrtf(fmaxf(0.0f, 1.0f - ax)) * p;
  return x >= 0.0f ? f : kPi - f;
}

__device__ __forceinline__ float clip1(float x) { return fminf(fmaxf(x, -1.0f), 1.0f); }

// One channel of the HW-form sky radiance (raytracer.wgsl:316-343).
__device__ __forceinline__ float sky_channel(const float* __restrict__ p, float cos_theta,
                                             float gamma, float cos_gamma) {
  const float exp_m = expf(p[4] * gamma);
  const float ray_m = cos_gamma * cos_gamma;
  const float mie_base = 1.0f + p[8] * p[8] - 2.0f * p[8] * cos_gamma;
  const float mie = (1.0f + ray_m) / (mie_base * sqrtf(mie_base));
  const float zen = sqrtf(cos_theta);
  const float lhs = 1.0f + p[0] * expf(p[1] / (cos_theta + 0.01f));
  const float rhs = p[2] + p[3] * exp_m + p[5] * ray_m + p[6] * mie + p[7] * zen;
  return lhs * rhs;
}

// Image-texture fetch (megakernel.py:393-435): texel row and column come
// from float arithmetic that is exact below 2^24. A negative base marks a
// solid texture, which keeps its prefolded albedo.
__device__ __forceinline__ void tex_lookup(const int* __restrict__ pool, float base, float tw,
                                           float th, float u, float v, float& r, float& g,
                                           float& b) {
  if (!(base >= 0.0f)) return;
  const float uu = fminf(fmaxf(u, 0.0f), 1.0f);
  const float vv = 1.0f - fminf(fmaxf(v, 0.0f), 1.0f);
  const float j = fminf(floorf(uu * tw), tw - 1.0f);
  const float i = fminf(floorf(vv * th), th - 1.0f);
  const int flat = static_cast<int>(base * 128.0f + i * tw + j);
  const int packed = __ldg(pool + flat);
  r = static_cast<float>((packed >> 16) & 255) * kInv255;
  g = static_cast<float>((packed >> 8) & 255) * kInv255;
  b = static_cast<float>(packed & 255) * kInv255;
}

// Jittered thin-lens camera ray for pixel (xf, yf) in full-image
// coordinates (megakernel.py:128-162): four draws from r.state, then a live
// path with unit throughput and no colour.
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam, float xf, float yf,
                                           float inv_w, float inv_h, Ray& r) {
  const float ju = rng_float(r.state);
  const float jv = rng_float(r.state);
  const float dr = rng_float(r.state);
  const float da = rng_float(r.state);
  const float su = (xf + ju) * inv_w;
  const float sv = 1.0f - (yf + jv) * inv_h;
  const float lr = sqrtf(dr);
  const float la = kTwoPi * da;
  const float lens_x = cam[18] * lr * cosf(la);
  const float lens_y = cam[18] * lr * sinf(la);
  r.ox = cam[0] + lens_x * cam[9] + lens_y * cam[12];
  r.oy = cam[1] + lens_x * cam[10] + lens_y * cam[13];
  r.oz = cam[2] + lens_x * cam[11] + lens_y * cam[14];
  float dx = cam[15] + su * cam[3] + sv * cam[6] - r.ox;
  float dy = cam[16] + su * cam[4] + sv * cam[7] - r.oy;
  float dz = cam[17] + su * cam[5] + sv * cam[8] - r.oz;
  const float inv_len = 1.0f / sqrtf(fmaxf(1.0e-24f, dx * dx + dy * dy + dz * dz));
  r.dx = dx * inv_len;
  r.dy = dy * inv_len;
  r.dz = dz * inv_len;
  r.tr = 1.0f;
  r.tg = 1.0f;
  r.tb = 1.0f;
  r.cr = 0.0f;
  r.cg = 0.0f;
  r.cb = 0.0f;
  r.alive = true;
}

// x0 y0 + x1 y1 + x2 y2 rounded as nvcc contracts that sum written out:
// x1 y1 first, x0 y0 fused onto it, x2 y2 onto that, as the SASS of the
// written sum shows. Spelt out so that every kernel (the render kernels
// here, sweep.cu's sweep_fma) rounds every pair alike, whatever the code
// around it.
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1, float x2,
                                      float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x0, y0, __fmul_rn(x1, y1)));
}

// bq = c.d - o.d and the discriminant bq^2 - (|o|^2 - 2c.o + kq) of the
// sphere (cx, cy, cz, kq) = c whose 2c is (tx, ty, tz) (the expanded
// quadratic of sphere_ts, megakernel.py:437-465). c + c is exact, so a
// staged 2c gives the bits of c + c formed in the pair.
__device__ __forceinline__ float sphere_disc(const float4 c, float tx, float ty, float tz,
                                             float ox, float oy, float oz, float dx, float dy,
                                             float dz, float od, float oo, float& bq) {
  const float cd = dot3(c.x, dx, c.y, dy, c.z, dz);
  const float co2 = dot3(tx, ox, ty, oy, tz, oz);
  bq = __fsub_rn(cd, od);
  const float cq = __fadd_rn(__fsub_rn(oo, co2), c.w);
  return __fmaf_rn(bq, bq, -cq);
}

// The root test of sphere i from its bq and discriminant: (bt, bi) takes
// the nearer root above kMinT if it is below bt. The roots are taken only
// of a positive discriminant, the one case in which the TPU's test (sq > 0
// on sqrt(disc), NaN for disc < 0) can pass, so every input keeps its
// (bt, bi); a miss, most tests, never reaches sqrtf's slow path for a
// negative argument, and a warp whose lanes all miss skips the root.
__device__ __forceinline__ void sphere_root(float bq, float disc, int i, float& bt, int& bi) {
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t0 = bq - sq;
    const float t1 = bq + sq;
    const float ts = t0 > kMinT ? t0 : t1;
    if (ts > kMinT && ts < bt) {
      bt = ts;
      bi = i;
    }
  }
}

// One sphere of the closest-hit sweep (sphere_ts, megakernel.py:437-465):
// sphere i with (cx, cy, cz, kq) = c takes (bt, bi) if it is hit closer
// (expanded quadratic, strict <, first index wins).
__device__ __forceinline__ void sweep_sphere(const float4 c, int i, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float od, float oo,
                                             float& bt, int& bi) {
  float bq;
  const float disc =
      sphere_disc(c, c.x + c.x, c.y + c.y, c.z + c.z, ox, oy, oz, dx, dy, dz, od, oo, bq);
  sphere_root(bq, disc, i, bt, bi);
}

// The chunk hierarchy as K0 and K1 read it (regroup.cu stage_cull): the
// priors' sweep rows staged in shared memory, the exact chunk and
// super-chunk boxes of prepare_scene_arrays staged there too where they fit
// (kStaged) or else read from global memory, the sphere table itself left
// in global memory; and the two scene terms of each lane's box margin.
struct CullView {
  const float4* prior;     // [kNPriors] (cx, cy, cz, kq) of the priors
  const int* prior_index;  // [kNPriors] their sphere indices
  const float* chunk;      // [6, n_tests] chunk boxes
  const float* super;      // [6, n_super] super-chunk boxes
  int n_chunks, n_tests, n_super, chunk_size, super_factor;
  float reach, margin_scale;  // KernelInputs.cull_reach, cull_scale
};

// A box bound of a CullView table: from shared memory, or read-only
// through the L1 from global memory.
template <bool kStaged>
__device__ __forceinline__ float box_bound(const float* b, int k) {
  if constexpr (kStaged) {
    return b[k];
  } else {
    return __ldg(b + k);
  }
}

// The two scene terms of each lane's box margin in sweep_culled
// (KernelInputs.cull_reach and cull_scale).
struct CullMargin {
  float reach, scale;
};

// The most shared memory a block of a culled kernel (regroup K0 and K1,
// the megakernel, the wavefront's K0 and K1) stages: five blocks an SM,
// each with the 1 KiB the runtime reserves, fit an H100 SM's 228 KiB, and
// the 48 KiB a launch gets without opting in.
constexpr size_t kStageBytes = 44 * 1024;

// Whether a culled kernel stages a scene's chunk and super-chunk boxes in
// shared memory: while they, the priors' rows and the `reserved` bytes of
// the kernel's own static shared memory (the wavefront K1's lane list)
// fit kStageBytes. Above that (about 1,800 chunk and super boxes, some
// 57,000 spheres at 32 a chunk) the launch takes the kStaged = false
// instantiation, which reads them from global memory through __ldg at the
// same warp-uniform addresses; a table is never refused.
inline bool cull_staged(const CullRefs& cu, size_t reserved = 0) {
  return reserved + kNPriors * (sizeof(float4) + sizeof(int)) +
             6 * sizeof(float) * (cu.n_tests + cu.n_super) <=
         kStageBytes;
}

// Dynamic shared bytes of a block of a culled kernel (stage_cull): the
// priors' sweep rows and indices, then the chunk and super-chunk boxes
// where cull_staged; 0 without a chunk hierarchy.
inline size_t cull_smem_bytes(const CullRefs& cu, size_t reserved = 0) {
  if (cu.n_chunks == 0) return 0;
  return kNPriors * (sizeof(float4) + sizeof(int)) +
         (cull_staged(cu, reserved) ? 6 * sizeof(float) * (cu.n_tests + cu.n_super) : 0);
}

// The cull view of a block, staged once before its first bounce; every
// thread of the block must call it. The priors' rows go to shared memory,
// and the exact boxes too where kStaged (the launch's choice,
// cull_staged), with cooperative loads: a few KiB at most.
template <bool kStaged>
__device__ __forceinline__ CullView stage_cull(const CullRefs& cu, const float4* sweep,
                                               const CullMargin& margin) {
  extern __shared__ float4 cull_smem[];
  int* prior_index = reinterpret_cast<int*>(cull_smem + kNPriors);
  float* chunk = reinterpret_cast<float*>(prior_index + kNPriors);
  float* super = chunk + 6 * cu.n_tests;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
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
    for (int k = tid; k < 6 * cu.n_tests; k += threads) {
      chunk[k] = __ldg(cu.chunk_bounds + k);
    }
    for (int k = tid; k < 6 * cu.n_super; k += threads) {
      super[k] = __ldg(cu.super_bounds + k);
    }
  }
  if (tid < kNPriors) {
    const int i = __ldg(cu.priors + tid);
    prior_index[tid] = i;
    cull_smem[tid] = __ldg(sweep + i);
  }
  __syncthreads();
  return v;
}

// The closest-hit sweep culled per warp. The priors' own closest hit
// (pbt, pbi), least (t, index) first, is kept apart from the sweep's
// (bt, bi). Before each super-chunk, then before each chunk of an entered
// one, every lane runs the TPU's slab test against fminf(pbt, bt) on the
// box widened by its own margin m, and the warp sweeps a chunk's spheres,
// in index order, iff some lane enters it (__ballot_sync). Last, the
// priors' hit joins (bt, bi) by (t, index).
// Exactness: a chunk that a lane does not enter holds no non-prior sphere
// the lane hits closer than its bound, so the lane's bound before each
// chunk is the full sweep's, and any superset of the chunks it enters,
// swept in index order with the strict <, finds the full sweep's winner
// among the non-priors; the final merge adds the priors', and keeps the
// first index on ties as the full sweep does (it also gives back a prior
// hit on its own box's face, tnear == t, which the strict test skips when
// that prior sets the bound). The premise of the JAX kernel's slab test,
// that a computed hit lies in its sphere's exact box, fails by rounding:
// the expanded quadratic puts a hit off its sphere by up to about
// 15 * 2^-24 (|o| + |c| + r)^2 / r (megakernel.py CULL_MARGIN_ULPS), so a ray
// leaving a small sphere that sets a face of its box can hit it again just
// past MIN_T where the exact box has the ray out before MIN_T. Each lane
// therefore widens every box by m = cull_scale (|o| + cull_reach)^2, which
// bounds that offset for every non-prior sphere, plus the slab test's own
// rounding: m is one register, and each bound it moves one add.
// A lane's own vote is always in the ballot it reads, so this holds
// whichever lanes are converged at the vote: lanes that died, broke out of
// the bounce loop or returned past K1's count need no special case. No
// lane diverges inside: every branch here follows a ballot. The sphere
// rows are read at warp-uniform addresses through __ldg, one broadcast per
// row.
template <bool kStaged>
__device__ __forceinline__ void sweep_culled(const SceneRefs& sc, const CullView& cv, float ox,
                                             float oy, float oz, float dx, float dy, float dz,
                                             float od, float oo, float& bt, int& bi) {
  float pbt = kMaxT;
  int pbi = -1;
  for (int p = 0; p < kNPriors; ++p) {
    float t = kMaxT;
    int j = -1;
    sweep_sphere(cv.prior[p], cv.prior_index[p], ox, oy, oz, dx, dy, dz, od, oo, t, j);
    if (j >= 0 && (t < pbt || (t == pbt && j < pbi))) {
      pbt = t;
      pbi = j;
    }
  }
  const float ix = slab_inverse(dx);
  const float iy = slab_inverse(dy);
  const float iz = slab_inverse(dz);
  const float reach = sqrtf(oo) + cv.reach;
  const float m = cv.margin_scale * reach * reach;  // this lane's widening of every box
  const int per = cv.n_super > 0 ? cv.super_factor : cv.n_chunks;
  for (int c0 = 0; c0 < cv.n_chunks; c0 += per) {
    bool mine = true;  // this lane enters the super-chunk
    if (cv.n_super > 0) {
      const float* b = cv.super;
      const int s = c0 / per, k = cv.n_super;
      mine = slab_box(box_bound<kStaged>(b, s) - m, box_bound<kStaged>(b, k + s) - m,
                      box_bound<kStaged>(b, 2 * k + s) - m, box_bound<kStaged>(b, 3 * k + s) + m,
                      box_bound<kStaged>(b, 4 * k + s) + m, box_bound<kStaged>(b, 5 * k + s) + m,
                      ox, oy, oz, ix, iy, iz, fminf(pbt, bt));
      if (__ballot_sync(__activemask(), mine) == 0u) continue;
    }
    const int c_end = min(c0 + per, cv.n_chunks);
    for (int c = c0; c < c_end; ++c) {
      const float* b = cv.chunk;
      const int k = cv.n_tests;
      const bool enters =
          mine &&
          slab_box(box_bound<kStaged>(b, c) - m, box_bound<kStaged>(b, k + c) - m,
                   box_bound<kStaged>(b, 2 * k + c) - m, box_bound<kStaged>(b, 3 * k + c) + m,
                   box_bound<kStaged>(b, 4 * k + c) + m, box_bound<kStaged>(b, 5 * k + c) + m,
                   ox, oy, oz, ix, iy, iz, fminf(pbt, bt));
      if (__ballot_sync(__activemask(), enters) == 0u) continue;
      const int i_end = (c + 1) * cv.chunk_size;
      for (int i = c * cv.chunk_size; i < i_end; ++i) {
        sweep_sphere(__ldg(sc.sweep + i), i, ox, oy, oz, dx, dy, dz, od, oo, bt, bi);
      }
    }
  }
  if (pbi >= 0 && (pbt < bt || (pbt == bt && pbi < bi))) {
    bt = pbt;
    bi = pbi;
  }
}

// o.d and |o|^2 of a ray, rounded as written, in the order nvcc contracts
// them elsewhere: left to the compiler, their contraction depended on the
// kernel around them (the wavefront's culled K1 contracted them otherwise
// than its full-sweep instantiation, and parted from it by some ulps in a
// sphere's t), and every kernel must give the same bits for the same ray.
__device__ __forceinline__ void ray_terms(const Ray& r, float& od, float& oo) {
  od = __fmaf_rn(r.oz, r.dz, __fmaf_rn(r.oy, r.dy, __fmul_rn(r.ox, r.dx)));
  oo = __fmaf_rn(r.oz, r.oz, __fmaf_rn(r.oy, r.oy, __fmul_rn(r.ox, r.ox)));
}

// --- the stats kernels' full sweep -------------------------------------------
//
// The stats megakernel and K1's stats kernel sweep every sphere and count,
// before each chunk and super-chunk, what the TPU's whole-tile cull would
// enter (stats.cuh). Their sweep on an H100:
//  - the sphere table is staged in shared memory once a block, each sphere
//    as (cx, cy, cz, kq) and (2cx, 2cy, 2cz, 0), so a pair reads two
//    broadcast 16-byte rows and forms no c + c; a table larger than a
//    block's share (stats_plan) is swept in windows that start at chunk
//    boundaries, which the block walks in step, a barrier on each side of
//    staging a window, so a chunk's test always sees the best t of every
//    sphere before it;
//  - a lane forms kStatsUnroll spheres' discriminants before any root and
//    takes the roots only where it has a positive one, in sphere order
//    (strict <, so the first index wins a tie);
//  - the chunk and super-chunk boxes and the priors' rows come from
//    stage_cull's tables (the boxes in global memory above its limit).
// Each kernel runs it on a persistent grid whose lanes take the next pixel
// or record as their paths end (take_item, stats.cuh).

// Bytes of shared memory a stats kernel's block stages: the cull tables,
// then its window of the sphere table, 32 bytes a sphere. Four blocks of
// 256 threads an SM fit an H100 SM with this much each, and a launch gets
// it without opting in.
constexpr size_t kStatsSmemBytes = 48 * 1024;
constexpr int kStatsSphereBytes = 2 * sizeof(float4);
// The spheres whose discriminants a lane forms before any root: 4 and 8
// ran faster on the large scenes (tools/stats_steps.py, PERF.md) but spill
// at the stats kernels' register budgets.
constexpr int kStatsUnroll = 2;

// The windows of a stats kernel's launch: `window` spheres each (whole
// chunks in a scene with chunks), the last one shorter; where the table
// starts in the block's dynamic shared memory (after the cull tables,
// 16-byte aligned) and the block's dynamic shared bytes.
struct StatsPlan {
  int window, windows;
  size_t table_offset, smem;
};

// The fewest windows that each fit kStatsSmemBytes beside the cull
// tables, then the shortest window of whole chunks that covers the table
// in that many (so the windows are about even). A window holds one chunk
// at least; where that passes kStatsSmemBytes the launch opts in to more.
inline StatsPlan stats_plan(const CullRefs& cu, int n_spheres) {
  StatsPlan p;
  p.table_offset = (cull_smem_bytes(cu) + 15) / 16 * 16;
  const int unit = cu.n_chunks > 0 ? cu.chunk_size : 1;
  const int units = cu.n_chunks > 0 ? cu.n_chunks : n_spheres;
  const size_t room = kStatsSmemBytes > p.table_offset ? kStatsSmemBytes - p.table_offset : 0;
  const int most = std::max(1, static_cast<int>(room / kStatsSphereBytes) / unit);
  const int fewest = (units + most - 1) / most;
  p.window = (units + fewest - 1) / fewest * unit;
  p.windows = (n_spheres + p.window - 1) / p.window;
  p.smem = p.table_offset + static_cast<size_t>(std::min(p.window, n_spheres)) * kStatsSphereBytes;
  return p;
}

// The grid of a persistent stats launch: the blocks of `threads` with
// `smem` dynamic bytes that the card holds at once, fewer where `items`
// need fewer; the kernel is opted in to `smem` past kStatsSmemBytes.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long items,
                            unsigned* grid) {
  cudaError_t err = cudaSuccess;
  if (smem > kStatsSmemBytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess ||
      (err = sm_count(&sms)) != cudaSuccess) {
    return err;
  }
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long need = (items + threads - 1) / threads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<unsigned>(std::max(1LL, std::min(resident, need)));
  return cudaSuccess;
}

// The block's staged table: the dynamic shared memory past the cull tables.
__device__ __forceinline__ float4* stats_table(size_t table_offset) {
  extern __shared__ float4 stats_smem[];
  return stats_smem + table_offset / sizeof(float4);
}

// Spheres [w0, w0 + nw) into the block's table, as (c, kq) and (2c, 0);
// every thread of the block calls it, and a barrier must follow.
__device__ __forceinline__ void stage_window(float4* tab, const float4* __restrict__ sweep,
                                             int w0, int nw) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  for (int j = tid; j < nw; j += threads) {
    const float4 c = __ldg(sweep + w0 + j);
    tab[2 * j] = c;
    tab[2 * j + 1] = make_float4(c.x + c.x, c.y + c.y, c.z + c.z, 0.0f);
  }
}

// One ray's counted sweep in flight: its origin, direction, o.d, |o|^2,
// signed inverse direction (the slab tests), the priors' best t, its
// (bt, bi), the bits of its current word of chunk and super-chunk tests,
// and the row of words its (group, loop iteration) ORs them into.
struct CountedSweep {
  float ox, oy, oz, dx, dy, dz, od, oo, ix, iy, iz, pbt, bt;
  int bi;
  unsigned cbits, sbits, row;
};

// A ray's sweep begins: o.d and |o|^2 as bounce_step forms them, and, in
// a scene with chunks, the priors' own best t, which the TPU sweeps before
// any test (megakernel.py:615-623), from stage_cull's rows.
__device__ __forceinline__ void begin_counted(const CullView& cv, const Ray& r, unsigned row,
                                              CountedSweep& s) {
  s.ox = r.ox;
  s.oy = r.oy;
  s.oz = r.oz;
  s.dx = r.dx;
  s.dy = r.dy;
  s.dz = r.dz;
  ray_terms(r, s.od, s.oo);
  s.bt = kMaxT;
  s.bi = -1;
  s.cbits = 0u;
  s.sbits = 0u;
  s.row = row;
  s.pbt = kMaxT;
  if (cv.n_chunks == 0) return;
  int pbi = -1;
  for (int p = 0; p < kNPriors; ++p) {
    sweep_sphere(cv.prior[p], cv.prior_index[p], s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.od, s.oo,
                 s.pbt, pbi);
  }
  s.ix = slab_inverse(s.dx);
  s.iy = slab_inverse(s.dy);
  s.iz = slab_inverse(s.dz);
}

// kU staged spheres from row j of the window (sphere index `index`): every
// discriminant first, then, where the lane has a positive one, the roots
// in sphere order (fmaxf drops a NaN, which has no root).
template <int kU>
__device__ __forceinline__ void staged_pairs(const float4* tab, int j, int index,
                                             CountedSweep& s) {
  float bq[kU], disc[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const float4 c = tab[2 * (j + u)];
    const float4 t = tab[2 * (j + u) + 1];
    disc[u] = sphere_disc(c, t.x, t.y, t.z, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.od, s.oo, bq[u]);
  }
  float most = disc[0];
#pragma unroll
  for (int u = 1; u < kU; ++u) most = fmaxf(most, disc[u]);
  if (!(most > 0.0f)) return;
#pragma unroll
  for (int u = 0; u < kU; ++u) sphere_root(bq[u], disc[u], index + u, s.bt, s.bi);
}

// Rows [j0, j1) of the window that starts at sphere w0, kStatsUnroll at a
// time.
__device__ __forceinline__ void staged_run(const float4* tab, int j0, int j1, int w0,
                                           CountedSweep& s) {
  int j = j0;
  for (; j + kStatsUnroll <= j1; j += kStatsUnroll) staged_pairs<kStatsUnroll>(tab, j, w0 + j, s);
  for (; j < j1; ++j) staged_pairs<1>(tab, j, w0 + j, s);
}

// The TPU's tests before chunk c (sweep order): its super-chunk's first,
// where c starts one, then its own, each against min(priors' best t, best
// t of the spheres before c) on the exact box (bound_possible,
// megakernel.py:529-554), ORed into the row's words at each word's end.
template <bool kStaged>
__device__ __forceinline__ void chunk_tests(const CullView& cv, const StatsRefs& st, int c,
                                            CountedSweep& s) {
  const float tb = fminf(s.pbt, s.bt);
  if (cv.n_super > 0 && c % cv.super_factor == 0) {
    const int q = c / cv.super_factor, k = cv.n_super;
    const float* b = cv.super;
    if (slab_box(box_bound<kStaged>(b, q), box_bound<kStaged>(b, k + q),
                 box_bound<kStaged>(b, 2 * k + q), box_bound<kStaged>(b, 3 * k + q),
                 box_bound<kStaged>(b, 4 * k + q), box_bound<kStaged>(b, 5 * k + q), s.ox, s.oy,
                 s.oz, s.ix, s.iy, s.iz, tb)) {
      s.sbits |= 1u << (q & 31);
    }
    if ((q & 31) == 31 || q == k - 1) {
      or_word(st.super_words + static_cast<size_t>(s.row) * st.words_s + (q >> 5), s.sbits);
      s.sbits = 0u;
    }
  }
  const int k = cv.n_tests;
  const float* b = cv.chunk;
  if (slab_box(box_bound<kStaged>(b, c), box_bound<kStaged>(b, k + c),
               box_bound<kStaged>(b, 2 * k + c), box_bound<kStaged>(b, 3 * k + c),
               box_bound<kStaged>(b, 4 * k + c), box_bound<kStaged>(b, 5 * k + c), s.ox, s.oy,
               s.oz, s.ix, s.iy, s.iz, tb)) {
    s.cbits |= 1u << (c & 31);
  }
  if ((c & 31) == 31 || c == k - 1) {
    or_word(st.chunk_words + static_cast<size_t>(s.row) * st.words_c + (c >> 5), s.cbits);
    s.cbits = 0u;
  }
}

// The staged window of spheres [w0, w0 + nw): in a scene with chunks, each
// chunk's tests before its first pair.
template <bool kStaged>
__device__ __forceinline__ void sweep_window(const float4* tab, int w0, int nw,
                                             const CullView& cv, const StatsRefs& st,
                                             CountedSweep& s) {
  if (cv.n_chunks == 0) {
    staged_run(tab, 0, nw, w0, s);
    return;
  }
  const int cs = cv.chunk_size;
  for (int c = w0 / cs; c < (w0 + nw) / cs; ++c) {
    chunk_tests<kStaged>(cv, st, c, s);
    staged_run(tab, c * cs - w0, (c + 1) * cs - w0, w0, s);
  }
}

// After the last window: the tests of the chunk boxes that pad the last
// super-chunk (n_tests > n_chunks), which hold no spheres.
template <bool kStaged>
__device__ __forceinline__ void end_counted(const CullView& cv, const StatsRefs& st,
                                            CountedSweep& s) {
  if (cv.n_chunks == 0) return;
  for (int c = cv.n_chunks; c < cv.n_tests; ++c) chunk_tests<kStaged>(cv, st, c, s);
}

// The scatter of a live path whose closest hit is (bt, bi), the part of a
// bounce after the sweep that every kernel runs: it leaves r on the next
// ray with its throughput attenuated and its RNG state advanced four
// draws, and returns true. A miss (bi < 0) sets the sky colour and a hit
// on an emissive sphere its light; either ends the path (returns false,
// alive = false, the ray itself left as it was, the RNG state after the
// emitter's draws).
template <bool kTextured>
__device__ __forceinline__ bool scatter_hit(const SceneRefs& sc, Ray& r, float bt, int bi) {
  const float* __restrict__ sky = sc.sky;
  const float* __restrict__ at = sc.attrs;
  const int n = sc.n;
  const float ox = r.ox, oy = r.oy, oz = r.oz;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  uint32_t state = r.state;

  if (bi < 0) {  // miss: sky radiance ends the path
    const float cos_theta = fabsf(clip1(dy));
    const float cos_gamma = clip1(dx * sky[30] + dy * sky[31] + dz * sky[32]);
    const float gamma = acos_approx(cos_gamma);
    r.cr = sky[27] * sky_channel(sky + 0, cos_theta, gamma, cos_gamma);
    r.cg = sky[28] * sky_channel(sky + 9, cos_theta, gamma, cos_gamma);
    r.cb = sky[29] * sky_channel(sky + 18, cos_theta, gamma, cos_gamma);
    r.alive = false;
    return false;
  }

  // Hit record (megakernel.py:962-970); negative radii flip the normal.
  const float bcx = __ldg(at + kCx * n + bi);
  const float bcy = __ldg(at + kCy * n + bi);
  const float bcz = __ldg(at + kCz * n + bi);
  const float brad = __ldg(at + kRad * n + bi);
  const float bmid = __ldg(at + kMid * n + bi);
  const float bmx = __ldg(at + kMx * n + bi);
  float b1r = __ldg(at + kA1r * n + bi);
  float b1g = __ldg(at + kA1g * n + bi);
  float b1b = __ldg(at + kA1b * n + bi);
  float b2r = __ldg(at + kA2r * n + bi);
  float b2g = __ldg(at + kA2g * n + bi);
  float b2b = __ldg(at + kA2b * n + bi);
  const float px = ox + bt * dx;
  const float py = oy + bt * dy;
  const float pz = oz + bt * dz;
  const float inv_r = 1.0f / brad;
  const float nx = (px - bcx) * inv_r;
  const float ny = (py - bcy) * inv_r;
  const float nz = (pz - bcz) * inv_r;

  if (kTextured) {  // spherical UV (wgsl:431-440) + image fetch
    const float theta = acos_approx(clip1(-ny));
    const float phi = atan2_approx(-nz, nx) + kPi;
    const float u = phi * kInvTwoPi;
    const float v = theta * kFrac1Pi;
    tex_lookup(sc.tex_pool, __ldg(at + kT1Base * n + bi), __ldg(at + kT1W * n + bi),
               __ldg(at + kT1H * n + bi), u, v, b1r, b1g, b1b);
    tex_lookup(sc.tex_pool, __ldg(at + kT2Base * n + bi), __ldg(at + kT2W * n + bi),
               __ldg(at + kT2H * n + bi), u, v, b2r, b2g, b2b);
  }

  const float r1 = rng_float(state);
  const float r2 = rng_float(state);
  const float r3 = rng_float(state);
  const float r4 = rng_float(state);

  if (bmid == kEmissive) {  // area light: the path ends with x * albedo
    r.cr = bmx * b1r;
    r.cg = bmx * b1g;
    r.cb = bmx * b1b;
    r.alive = false;
    r.state = state;
    return false;
  }

  float ndx, ndy, ndz, att_r, att_g, att_b;
  if (bmid == kLambertian || bmid == kCheckerboard) {
    // pixarOnb + cosine hemisphere (megakernel.py:991-1012)
    const float sgn = nz >= 0.0f ? 1.0f : -1.0f;
    const float ia = -1.0f / (sgn + nz);
    const float bb = nx * ny * ia;
    const float t1x = 1.0f + sgn * nx * nx * ia;
    const float t1y = sgn * bb;
    const float t1z = -sgn * nx;
    const float t2x = bb;
    const float t2y = sgn + ny * ny * ia;
    const float t2z = -ny;
    const float sqr2 = sqrtf(r2);
    const float zl = sqrtf(fmaxf(0.0f, 1.0f - r2));
    const float phi = kTwoPi * r1;
    const float xl = cosf(phi) * sqr2;
    const float yl = sinf(phi) * sqr2;
    ndx = xl * t1x + yl * t2x + zl * nx;
    ndy = xl * t1y + yl * t2y + zl * ny;
    ndz = xl * t1z + yl * t2z + zl * nz;
    const float ndw = nx * ndx + ny * ndy + nz * ndz;
    const float lam_ratio = (kFrac1Pi * fmaxf(kEps, ndw)) / fmaxf(kEps, ndw * kFrac1Pi);
    float alr = b1r, alg = b1g, alb = b1b;
    if (bmid == kCheckerboard) {  // 3D sine parity (wgsl:300-307)
      const float sines = sinf(5.0f * px) * sinf(5.0f * py) * sinf(5.0f * pz);
      if (!(sines < 0.0f)) {
        alr = b2r;
        alg = b2g;
        alb = b2b;
      }
    }
    att_r = alr * lam_ratio;
    att_g = alg * lam_ratio;
    att_b = alb * lam_ratio;
  } else {
    // unit-ball point (metal fuzz / unknown material), megakernel.py:1015-1021
    const float rr = powf(r1, static_cast<float>(1.0 / 3.0));
    const float cth = 1.0f - 2.0f * r2;
    const float sth = sqrtf(fmaxf(0.0f, 1.0f - cth * cth));
    const float ph3 = kTwoPi * r3;
    const float ballx = rr * sth * cosf(ph3);
    const float bally = rr * sth * sinf(ph3);
    const float ballz = rr * cth;
    const float ddn2 = 2.0f * (dx * nx + dy * ny + dz * nz);
    const float rflx = dx - ddn2 * nx;
    const float rfly = dy - ddn2 * ny;
    const float rflz = dz - ddn2 * nz;
    if (bmid == kMetal) {
      ndx = rflx + bmx * ballx;
      ndy = rfly + bmx * bally;
      ndz = rflz + bmx * ballz;
      att_r = b1r;
      att_g = b1g;
      att_b = b1b;
    } else if (bmid == kDielectric) {  // RTiOW-correct, megakernel.py:1032-1056
      const float ddn = 0.5f * ddn2;
      const bool front = ddn < 0.0f;
      const float osx = front ? nx : -nx;
      const float osy = front ? ny : -ny;
      const float osz = front ? nz : -nz;
      const float eta = front ? 1.0f / bmx : bmx;
      const float cosine = front ? -ddn : bmx * ddn;
      const float dt = dx * osx + dy * osy + dz * osz;
      const float disc_d = 1.0f - eta * eta * (1.0f - dt * dt);
      const float sqd = sqrtf(fmaxf(disc_d, 0.0f));
      float r0 = (1.0f - bmx) / (1.0f + bmx);
      r0 = r0 * r0;
      const float omc = 1.0f - fminf(fmaxf(cosine, 0.0f), 1.0f);
      const float omc2 = omc * omc;
      const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
      const float reflect_prob = disc_d > 0.0f ? schlick : 1.0f;
      if (r4 < reflect_prob) {
        ndx = rflx;
        ndy = rfly;
        ndz = rflz;
      } else {
        ndx = eta * (dx - dt * osx) - sqd * osx;
        ndy = eta * (dy - dt * osy) - sqd * osy;
        ndz = eta * (dz - dt * osz) - sqd * osz;
      }
      att_r = 1.0f;
      att_g = 1.0f;
      att_b = 1.0f;
    } else {  // unknown id: aggressive pink (wgsl:309-314)
      ndx = nx + ballx;
      ndy = ny + bally;
      ndz = nz + ballz;
      att_r = kPinkR;
      att_g = kPinkG;
      att_b = kPinkB;
    }
  }
  const float inv_len = 1.0f / sqrtf(fmaxf(1.0e-24f, ndx * ndx + ndy * ndy + ndz * ndz));
  r.tr = r.tr * att_r;
  r.tg = r.tg * att_g;
  r.tb = r.tb * att_b;
  r.ox = px;
  r.oy = py;
  r.oz = pz;
  r.dx = ndx * inv_len;
  r.dy = ndy * inv_len;
  r.dz = ndz * inv_len;
  r.state = state;
  return true;
}

// One bounce of a live path, the body of the render kernels: the closest
// hit, then scatter_hit. Given the cull tables of a scene with chunks (cv,
// in shared memory if kStaged) it sweeps per warp what its lanes can enter
// (sweep_culled), else every sphere.
template <bool kTextured, bool kStaged>
__device__ __forceinline__ bool bounce_step(const SceneRefs& sc, Ray& r, const CullView* cv) {
  float od, oo;
  ray_terms(r, od, oo);
  float bt = kMaxT;
  int bi = -1;
  if (cv != nullptr && cv->n_chunks > 0) {
    sweep_culled<kStaged>(sc, *cv, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, od, oo, bt, bi);
  } else {
    for (int i = 0; i < sc.n; ++i) {
      sweep_sphere(__ldg(sc.sweep + i), i, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, od, oo, bt, bi);
    }
  }
  return scatter_hit<kTextured>(sc, r, bt, bi);
}

// Bounces [b_lo, b_hi) of one live path, one bounce_step each, until
// one ends it. A path still alive after b_hi keeps colour 0.
template <bool kTextured, bool kStaged = true>
__device__ __forceinline__ void trace_bounces(const SceneRefs& sc, int b_lo, int b_hi, Ray& r,
                                              const CullView* cv = nullptr) {
  for (int bounce = b_lo; bounce < b_hi; ++bounce) {
    if (!bounce_step<kTextured, kStaged>(sc, r, cv)) break;
  }
}

}  // namespace
