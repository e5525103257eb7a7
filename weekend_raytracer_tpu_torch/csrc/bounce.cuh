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
// it directly, so each inlines the same expressions.
// bounce_step<kTextured, kStats = true> is the body of
// the kStats instantiations: the same bounces, sweeping the same spheres in
// the same order, plus the cull counters of stats.cuh. Given the cull
// tables of a scene with chunks (CullView, staged by stage_cull), the
// kStats = false body sweeps only the chunks that some lane of its warp
// can enter (sweep_culled), which gives the full sweep's (bt, bi) in every
// bit; regroup K0 and K1, the megakernel and the wavefront's K0 and K1 pass
// them. The wavefront's kCull = false instantiations pass none and sweep
// every sphere: they are the exact full-sweep reference of the gates.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

// One sphere of the closest-hit sweep (sphere_ts, megakernel.py:437-465):
// sphere i with (cx, cy, cz, kq) = c takes (bt, bi) if it is hit closer.
// The root and the two roots are taken only of a positive discriminant,
// the one case in which the TPU's test (sq > 0 on sqrt(disc), NaN for
// disc < 0) can pass, so every input keeps its (bt, bi); a miss, most
// tests, never reaches sqrtf's slow path for a negative argument, and a
// warp whose lanes all miss skips the root.
__device__ __forceinline__ void sweep_sphere(const float4 c, int i, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float od, float oo,
                                             float& bt, int& bi) {
  const float cd = c.x * dx + c.y * dy + c.z * dz;
  const float co2 = (c.x + c.x) * ox + (c.y + c.y) * oy + (c.z + c.z) * oz;
  const float bq = cd - od;
  const float cq = oo - co2 + c.w;
  const float disc = bq * bq - cq;
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

// The same sweep, chunk by chunk, with the TPU's whole-tile cull tests run
// before each chunk and each super-chunk and their outcomes ORed into the
// loop iteration k's bits of the ray's group (stats.cuh). Sweeps every
// sphere in the same order, so (bt, bi) is the plain sweep's.
__device__ __forceinline__ void sweep_counted(const SceneRefs& sc, const RayCounter& rc, int k,
                                              float ox, float oy, float oz, float dx, float dy,
                                              float dz, float od, float oo, float& bt, int& bi) {
  const CullRefs& cu = *rc.cull;
  const StatsRefs& st = *rc.st;
  // best-t of the priors alone, which the TPU sweeps before any test
  // (megakernel.py:615-623)
  float pbt = kMaxT;
  int pbi = -1;
  for (int p = 0; p < kNPriors; ++p) {
    const int sp = __ldg(cu.priors + p);
    sweep_sphere(__ldg(sc.sweep + sp), sp, ox, oy, oz, dx, dy, dz, od, oo, pbt, pbi);
  }
  const float ix = slab_inverse(dx);
  const float iy = slab_inverse(dy);
  const float iz = slab_inverse(dz);
  const size_t row = static_cast<size_t>(rc.group) * st.n_iters + k;
  unsigned* cw = st.chunk_words + row * st.words_c;
  unsigned* sw = st.super_words + row * st.words_s;
  unsigned cbits = 0u, sbits = 0u;
  for (int c = 0; c < cu.n_tests; ++c) {
    const float tb = fminf(pbt, bt);
    if (cu.n_super > 0 && c % cu.super_factor == 0) {
      const int s = c / cu.super_factor;
      if (slab_enters(cu.super_bounds, cu.n_super, s, ox, oy, oz, ix, iy, iz, tb)) {
        sbits |= 1u << (s & 31);
      }
      if ((s & 31) == 31 || s == cu.n_super - 1) {
        or_word(sw + (s >> 5), sbits);
        sbits = 0u;
      }
    }
    if (slab_enters(cu.chunk_bounds, cu.n_tests, c, ox, oy, oz, ix, iy, iz, tb)) {
      cbits |= 1u << (c & 31);
    }
    if ((c & 31) == 31 || c == cu.n_tests - 1) {
      or_word(cw + (c >> 5), cbits);
      cbits = 0u;
    }
    if (c < cu.n_chunks) {
      for (int i = c * cu.chunk_size; i < (c + 1) * cu.chunk_size; ++i) {
        sweep_sphere(__ldg(sc.sweep + i), i, ox, oy, oz, dx, dy, dz, od, oo, bt, bi);
      }
    }
  }
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

// One bounce of a live path, the body every kernel runs: the closest hit,
// then the scatter, which leaves r on the next ray with its throughput
// attenuated and its RNG state advanced four draws, and returns true. A
// miss sets the sky colour and a hit on an emissive sphere its light;
// either ends the path (returns false, alive = false, the ray itself left
// as it was, the RNG state after the emitter's draws). The kStats
// instantiation also counts the iteration in rc->trips and, in a scene with
// chunks, the cull tests of loop iteration k (sweep_counted). The kStats =
// false one, given the cull tables of a scene with chunks (cv, in shared
// memory if kStaged), sweeps per warp what its lanes can enter
// (sweep_culled).
template <bool kTextured, bool kStats, bool kStaged>
__device__ __forceinline__ bool bounce_step(const SceneRefs& sc, Ray& r, RayCounter* rc, int k,
                                            const CullView* cv) {
  const float* __restrict__ sky = sc.sky;
  const float* __restrict__ at = sc.attrs;
  const int n = sc.n;
  const float ox = r.ox, oy = r.oy, oz = r.oz;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  uint32_t state = r.state;
  // Closest hit over the prepared spheres. od and oo are rounded as
  // written, in the order nvcc contracts them elsewhere: left to the
  // compiler, their contraction depended on the kernel around them (the
  // wavefront's culled K1 contracted them otherwise than its full-sweep
  // instantiation, and parted from it by some ulps in a sphere's t), and
  // every kernel must give the same bits for the same ray.
  const float od = __fmaf_rn(oz, dz, __fmaf_rn(oy, dy, __fmul_rn(ox, dx)));
  const float oo = __fmaf_rn(oz, oz, __fmaf_rn(oy, oy, __fmul_rn(ox, ox)));
  float bt = kMaxT;
  int bi = -1;
  if constexpr (kStats) {
    ++rc->trips;
    if (rc->cull->n_chunks > 0) {
      sweep_counted(sc, *rc, k, ox, oy, oz, dx, dy, dz, od, oo, bt, bi);
    } else {
      for (int i = 0; i < n; ++i) {
        sweep_sphere(__ldg(sc.sweep + i), i, ox, oy, oz, dx, dy, dz, od, oo, bt, bi);
      }
    }
  } else if (cv != nullptr && cv->n_chunks > 0) {
    sweep_culled<kStaged>(sc, *cv, ox, oy, oz, dx, dy, dz, od, oo, bt, bi);
  } else {
    for (int i = 0; i < n; ++i) {
      sweep_sphere(__ldg(sc.sweep + i), i, ox, oy, oz, dx, dy, dz, od, oo, bt, bi);
    }
  }

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

// Bounces [b_lo, b_hi) of one live path, one bounce_step each, until
// one ends it. A path still alive after b_hi keeps colour 0.
template <bool kTextured, bool kStats = false, bool kStaged = true>
__device__ __forceinline__ void trace_bounces(const SceneRefs& sc, int b_lo, int b_hi, Ray& r,
                                              RayCounter* rc = nullptr,
                                              const CullView* cv = nullptr) {
  for (int bounce = b_lo; bounce < b_hi; ++bounce) {
    if (!bounce_step<kTextured, kStats, kStaged>(sc, r, rc, bounce - b_lo, cv)) break;
  }
}

}  // namespace
