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
// Arithmetic mirrors the TPU kernel and the plain PyTorch version
// (ops/cuda/megakernel.py render_image_megakernel_plain) operation for
// operation, including the polynomial acos/atan2. Built without
// --use_fast_math: the sweep relies on sqrtf(negative) = NaN failing the
// sq > 0 test. nvcc's default FMA contraction stays on; images are held to
// the plain version statistically, as the TPU kernel is held to the XLA path.

#include <cstdint>
#include <cuda_runtime.h>

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

struct Args {
  const float* cam;      // [20] eye, horizontal, vertical, u, v, llc, lens_r, 0
  const float* sky;      // [33] 27 params, 3 radiances, sun direction
  const float4* sweep;   // [n] (cx, cy, cz, kq)
  const float* attrs;    // [n_attr, n] SoA
  const int* tex_pool;   // packed RGB8 texels, 128 per row; null: no textures
  float* acc;            // [height * width, 3]
  int n;                 // prepared (padded) sphere count
  int width, height;
  float inv_w, inv_h;    // f32(1 / width), f32(1 / full_height)
  uint32_t frame, row_offset;
  int clear, spp, num_bounces;
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

__device__ __forceinline__ float rng_float(uint32_t& state) {
  const uint32_t old = state + 747796405u + 2891336453u;
  const uint32_t shift = (old >> 28) + 4u;
  const uint32_t word = ((old >> shift) ^ old) * 277803737u;
  state = (word >> 22) ^ word;
  return static_cast<float>(static_cast<int>(state >> 8)) * kInv2_24;
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
  const float* __restrict__ cam = a.cam;
  const float* __restrict__ sky = a.sky;
  const float* __restrict__ at = a.attrs;
  const int n = a.n;

  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
  for (int s = 0; s < a.spp; ++s) {
    uint32_t state = jenkins(pix ^ frame_hash ^ (0x9E3779B9u * static_cast<uint32_t>(s + 1)));

    // Jittered thin-lens camera ray (megakernel.py:128-162).
    const float ju = rng_float(state);
    const float jv = rng_float(state);
    const float dr = rng_float(state);
    const float da = rng_float(state);
    const float su = (xf + ju) * a.inv_w;
    const float sv = 1.0f - (yf + jv) * a.inv_h;
    const float lr = sqrtf(dr);
    const float la = kTwoPi * da;
    const float lens_x = cam[18] * lr * cosf(la);
    const float lens_y = cam[18] * lr * sinf(la);
    float ox = cam[0] + lens_x * cam[9] + lens_y * cam[12];
    float oy = cam[1] + lens_x * cam[10] + lens_y * cam[13];
    float oz = cam[2] + lens_x * cam[11] + lens_y * cam[14];
    float dx = cam[15] + su * cam[3] + sv * cam[6] - ox;
    float dy = cam[16] + su * cam[4] + sv * cam[7] - oy;
    float dz = cam[17] + su * cam[5] + sv * cam[8] - oz;
    {
      const float inv_len = 1.0f / sqrtf(fmaxf(1.0e-24f, dx * dx + dy * dy + dz * dz));
      dx *= inv_len;
      dy *= inv_len;
      dz *= inv_len;
    }

    float tr = 1.0f, tg = 1.0f, tb = 1.0f;
    float cr = 0.0f, cg = 0.0f, cb = 0.0f;
    for (int bounce = 0; bounce < a.num_bounces; ++bounce) {
      // Closest hit over every prepared sphere (sphere_ts, megakernel.py:437-465).
      const float od = ox * dx + oy * dy + oz * dz;
      const float oo = ox * ox + oy * oy + oz * oz;
      float bt = kMaxT;
      int bi = -1;
      for (int i = 0; i < n; ++i) {
        const float4 c = __ldg(a.sweep + i);
        const float cd = c.x * dx + c.y * dy + c.z * dz;
        const float co2 = (c.x + c.x) * ox + (c.y + c.y) * oy + (c.z + c.z) * oz;
        const float bq = cd - od;
        const float cq = oo - co2 + c.w;
        const float sq = sqrtf(bq * bq - cq);  // NaN for a negative discriminant
        const float t0 = bq - sq;
        const float t1 = bq + sq;
        const float ts = t0 > kMinT ? t0 : t1;
        if (sq > 0.0f && ts > kMinT && ts < bt) {
          bt = ts;
          bi = i;
        }
      }

      if (bi < 0) {  // miss: sky radiance ends the path
        const float cos_theta = fabsf(clip1(dy));
        const float cos_gamma = clip1(dx * sky[30] + dy * sky[31] + dz * sky[32]);
        const float gamma = acos_approx(cos_gamma);
        cr = sky[27] * sky_channel(sky + 0, cos_theta, gamma, cos_gamma);
        cg = sky[28] * sky_channel(sky + 9, cos_theta, gamma, cos_gamma);
        cb = sky[29] * sky_channel(sky + 18, cos_theta, gamma, cos_gamma);
        break;
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
        tex_lookup(a.tex_pool, __ldg(at + kT1Base * n + bi), __ldg(at + kT1W * n + bi),
                   __ldg(at + kT1H * n + bi), u, v, b1r, b1g, b1b);
        tex_lookup(a.tex_pool, __ldg(at + kT2Base * n + bi), __ldg(at + kT2W * n + bi),
                   __ldg(at + kT2H * n + bi), u, v, b2r, b2g, b2b);
      }

      const float r1 = rng_float(state);
      const float r2 = rng_float(state);
      const float r3 = rng_float(state);
      const float r4 = rng_float(state);

      if (bmid == kEmissive) {  // area light: the path ends with x * albedo
        cr = bmx * b1r;
        cg = bmx * b1g;
        cb = bmx * b1b;
        break;
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
      tr = tr * att_r;
      tg = tg * att_g;
      tb = tb * att_b;
      ox = px;
      oy = py;
      oz = pz;
      dx = ndx * inv_len;
      dy = ndy * inv_len;
      dz = ndz * inv_len;
    }
    tot_r = tot_r + tr * cr;
    tot_g = tot_g + tg * cg;
    tot_b = tot_b + tb * cb;
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
  a.sky = sky;
  a.sweep = reinterpret_cast<const float4*>(sweep);
  a.attrs = attrs;
  a.tex_pool = tex_pool;
  a.acc = acc;
  a.n = n_spheres;
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
