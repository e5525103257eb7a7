// The MXU chunk sweep on the tensor cores: the culled closest-hit sweep of
// bounce.cuh with each entered chunk's c.d and -2 c.o + kq taken from 3xTF32
// mma.sync products, for the kMxu instantiations of regroup's K0 and K1
// (regroup.cu), the megakernel (megakernel.cu) and the wavefront's culled K0
// and K1 (wavefront.cu).
//
// Counterpart of the JAX package's mxu_sweep (weekend_raytracer_tpu/ops/
// pallas/megakernel.py:560-610, the chunk body of _make_bounce when its
// mxu_ref is given): for each chunk the cull enters, out = A_c^T . [d; o; 1;
// 0] at Precision.HIGHEST, b = out[:cs] - o.d, cq = |o|^2 + out[cs:], sq =
// sqrt(b^2 - cq), the nearer root above MIN_T, and the chunk's least (t,
// index) merged into the running best by a strict <. A_c is the chunk's
// [8, 2 cs] slice of the A table (ops/cuda/megakernel.py mxu_sweep_amats).
// HIGHEST is f32-accurate, so the products are 3xTF32: x = hi + lo with hi
// = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and hi.hi + hi.lo + lo.hi
// (sweep.cu's sweep_mma<kTf32x3>, held to the FP32 dot on the card). One
// TF32 product would leave the -2c.o term's error against kq in the
// discriminant. The estimator is the JAX knob's: statistically the FMA
// sweep's, not bit-identical (the sums round in the tensor cores' order).
//
// The warp, not the lane, is the unit. mma.sync.m16n8k8 takes a 16-sphere
// A tile (rows: spheres; columns k: d, o, 1, 0) against an 8-ray B tile; a
// warp's 32 rays are four 8-ray tiles, so an entered chunk of cs spheres
// costs ceil(cs / 16) x 2 m-tiles (c.d, then -2c.o + kq) x 4 n-tiles x 3
// products. Fragments (PTX ISA), lane = 4 g + q:
//   A 16 x 8: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B 8 x 8:  b0 (k = q, ray g), b1 (k = q + 4, ray g)
//   C 16 x 8: c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// So:
//  - every lane of the warp joins each sweep, each product and each vote:
//    a lane without a path (its pixel's samples done, past K1's count, an
//    idle slot) feeds a zero B column and drops what comes back. No lane
//    leaves for the FMA sweep, whatever the warp's fill;
//  - a ray's B column lives in 8 lanes, so the B fragments (the hi and lo
//    of [d; o; 1; 0] of the four 8-ray tiles) and o.d, |o|^2 of the rays of
//    each lane's C columns are gathered by shuffles once a bounce, not once
//    a chunk;
//  - a chunk's A tiles are read through the read-only path (__ldg) when the
//    warp enters it and split to TF32 in registers: a warp-wide load of 32
//    distinct floats an A fragment, from the L1 after the first warp of the
//    SM. The table is 31 KB on RTiOW and about 640 KB on random10k at cs 32,
//    beyond what a block of these kernels stages beside the cull tables;
//  - each lane runs the epilogue on its own C fragments (spheres g, g + 8 of
//    each 16-sphere tile against its rays 2q, 2q + 1 of each 8-ray tile) in
//    sphere order, so its running (t, index) per ray keeps the least index
//    on a tie; a chunk size below 16 pads the tile with rows it never reads
//    (and never takes); the 8 lanes of a ray then merge their (t, index) by
//    a butterfly that halves each lane's 8 rays per round (xor 16, 8, 4:
//    seven shuffle pairs, not 24), and one more shuffle pair hands each lane
//    its own ray's chunk minimum.
// What bounds it on an H100: the epilogue's FP32 work (4 operations a pair,
// 3 more for a real root) and the shuffles; the products are 42 flops a
// pair at the TF32 rate. Making it fast (wgmma, a staged table, a survivor
// queue) is later work.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// This thread's lane in its warp (the megakernel's blocks are 16 x 16, so
// threadIdx.x alone is not it).
__device__ __forceinline__ int mxu_lane() {
  unsigned lane;
  asm("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return static_cast<int>(lane);
}

__device__ __forceinline__ uint32_t mxu_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as the 3xTF32 pair (hi, lo).
__device__ __forceinline__ void mxu_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = mxu_tf32(x);
  lo = mxu_tf32(x - __uint_as_float(hi));
}

// d += a . b, one m16n8k8 TF32 product.
__device__ __forceinline__ void mxu_mma(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b in 3xTF32 from zero: the two small terms first, then hi.hi
// (sweep.cu mma_prec<kTf32x3>).
__device__ __forceinline__ void mxu_mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                         const uint32_t (&blo)[2]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  mxu_mma(d, alo, bhi);
  mxu_mma(d, ahi, blo);
  mxu_mma(d, ahi, bhi);
}

// (t, i) becomes (ot, oi) where that is less on (t, index).
__device__ __forceinline__ void mxu_take_least(float& t, int& i, float ot, int oi) {
  if (ot < t || (ot == t && oi < i)) {
    t = ot;
    i = oi;
  }
}

// One butterfly round of the chunk merge: the lanes `mask` apart swap the
// half of their kN (t, index) slots that the other keeps, and each merges
// the partner's into its own half, which moves to slots [0, kN / 2).
template <int kN>
__device__ __forceinline__ void mxu_halve(float (&t)[8], int (&i)[8], int mask, bool upper) {
#pragma unroll
  for (int k = 0; k < kN / 2; ++k) {
    const float send_t = upper ? t[k] : t[k + kN / 2];
    const int send_i = upper ? i[k] : i[k + kN / 2];
    float keep_t = upper ? t[k + kN / 2] : t[k];
    int keep_i = upper ? i[k + kN / 2] : i[k];
    mxu_take_least(keep_t, keep_i, __shfl_xor_sync(kFullWarp, send_t, mask),
                   __shfl_xor_sync(kFullWarp, send_i, mask));
    t[k] = keep_t;
    i[k] = keep_i;
  }
}

// The warp's rays as the products and the epilogue take them, gathered
// once a bounce: the B fragments of its four 8-ray tiles (ray g of tile j
// is lane 8 j + g; a lane without a path gives a zero column), and o.d and
// |o|^2 of each lane's C rays 8 j + 2 q + h.
struct MxuRays {
  uint32_t bhi[4][2], blo[4][2];
  float od[4][2], oo[4][2];
};

__device__ __forceinline__ void mxu_gather(bool live, float ox, float oy, float oz, float dx,
                                           float dy, float dz, float od, float oo,
                                           MxuRays& m) {
  const int lane = mxu_lane();
  const int g = lane >> 2;
  const int q = lane & 3;
  const float vdx = live ? dx : 0.0f, vdy = live ? dy : 0.0f, vdz = live ? dz : 0.0f;
  const float vox = live ? ox : 0.0f, voy = live ? oy : 0.0f, voz = live ? oz : 0.0f;
  const float one = live ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = 8 * j + g;
    const float c0 = __shfl_sync(kFullWarp, vdx, src);
    const float c1 = __shfl_sync(kFullWarp, vdy, src);
    const float c2 = __shfl_sync(kFullWarp, vdz, src);
    const float c3 = __shfl_sync(kFullWarp, vox, src);
    const float c4 = __shfl_sync(kFullWarp, voy, src);
    const float c5 = __shfl_sync(kFullWarp, voz, src);
    const float c6 = __shfl_sync(kFullWarp, one, src);
    const float k0 = q == 0 ? c0 : q == 1 ? c1 : q == 2 ? c2 : c3;  // component q
    const float k1 = q == 0 ? c4 : q == 1 ? c5 : q == 2 ? c6 : 0.0f;  // component q + 4
    mxu_split(k0, m.bhi[j][0], m.blo[j][0]);
    mxu_split(k1, m.bhi[j][1], m.blo[j][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m.od[j][h] = __shfl_sync(kFullWarp, od, 8 * j + 2 * q + h);
      m.oo[j][h] = __shfl_sync(kFullWarp, oo, 8 * j + 2 * q + h);
    }
  }
}

// The chunk's least (t, sphere) for this lane's own ray, from the A table
// [n_chunks, 8, 2 cs]: the products of its ceil(cs / 16) sphere tiles
// against the warp's rays, the epilogue on each lane's fragments, the
// butterfly, and the hand-over. Every lane of the warp must call it.
__device__ __forceinline__ void mxu_chunk(const float* __restrict__ amats, int c, int cs,
                                          const MxuRays& m, float& tc, int& ic) {
  const int lane = mxu_lane();
  const int g = lane >> 2;
  const int q = lane & 3;
  float t[8];  // slot 2 j + h: this lane's ray 8 j + 2 q + h
  int i[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    t[s] = kMaxT;
    i[s] = -1;
  }
  const float* a = amats + static_cast<size_t>(c) * 8 * (2 * cs);
  const int tiles = (cs + 15) >> 4;
  for (int tile = 0; tile < tiles; ++tile) {
    const int r0 = 16 * tile + g, r1 = r0 + 8;  // this lane's A rows: spheres of the chunk
    const bool v0 = r0 < cs, v1 = r1 < cs;
    // A fragments of the two m-tiles: c.d (columns [0, cs)), -2c.o + kq ([cs, 2cs))
    uint32_t dhi[4], dlo[4], ohi[4], olo[4];
    const float* k_lo = a + q * (2 * cs);        // component q
    const float* k_hi = a + (q + 4) * (2 * cs);  // component q + 4
    mxu_split(v0 ? __ldg(k_lo + r0) : 0.0f, dhi[0], dlo[0]);
    mxu_split(v1 ? __ldg(k_lo + r1) : 0.0f, dhi[1], dlo[1]);
    mxu_split(v0 ? __ldg(k_hi + r0) : 0.0f, dhi[2], dlo[2]);
    mxu_split(v1 ? __ldg(k_hi + r1) : 0.0f, dhi[3], dlo[3]);
    mxu_split(v0 ? __ldg(k_lo + cs + r0) : 0.0f, ohi[0], olo[0]);
    mxu_split(v1 ? __ldg(k_lo + cs + r1) : 0.0f, ohi[1], olo[1]);
    mxu_split(v0 ? __ldg(k_hi + cs + r0) : 0.0f, ohi[2], olo[2]);
    mxu_split(v1 ? __ldg(k_hi + cs + r1) : 0.0f, ohi[3], olo[3]);
    const int s0 = c * cs + r0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float cd[4], co[4];
      mxu_mma3(cd, dhi, dlo, m.bhi[j], m.blo[j]);
      mxu_mma3(co, ohi, olo, m.bhi[j], m.blo[j]);
      // element e: sphere r0 + 8 (e >> 1) against ray 8 j + 2 q + (e & 1),
      // sphere r0 before r0 + 8 for each ray
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((e >> 1) ? v1 : v0)) continue;
        const int h = e & 1;
        const float b = __fsub_rn(cd[e], m.od[j][h]);
        const float cq = __fadd_rn(m.oo[j][h], co[e]);
        const float disc = __fmaf_rn(b, b, -cq);
        if (disc > 0.0f) {  // sq > 0; NaN and the rest have no root
          const float sq = sqrtf(disc);
          const float t0 = b - sq;
          const float t1 = b + sq;
          const float ts = t0 > kMinT ? t0 : t1;
          if (ts > kMinT && ts < t[2 * j + h]) {
            t[2 * j + h] = ts;
            i[2 * j + h] = s0 + 8 * (e >> 1);
          }
        }
      }
    }
  }
  // the 8 lanes of each ray (same q, g = 0..7) merge: after the rounds on
  // g's bits 2, 1, 0, lane (g, q) holds slot g, ray 8 (g >> 1) + 2 q + (g & 1)
  mxu_halve<8>(t, i, 16, (lane & 16) != 0);
  mxu_halve<4>(t, i, 8, (lane & 8) != 0);
  mxu_halve<2>(t, i, 4, (lane & 4) != 0);
  // lane L's own ray is slot g = 2 (L >> 3) + (L & 1) of lane q = (L >> 1) & 3
  const int src = 8 * (lane >> 3) + 4 * (lane & 1) + ((lane >> 1) & 3);
  tc = __shfl_sync(kFullWarp, t[0], src);
  ic = __shfl_sync(kFullWarp, i[0], src);
}

// sweep_culled with the MXU chunk sweep: the same priors (on the FMA
// sweep, their least (t, index) kept apart and joined last), the same
// per-lane margin, super-chunks and per-warp votes (over the full warp:
// a lane without a path votes no), and for each chunk the warp enters,
// mxu_chunk; a lane takes the chunk's minimum if it is below its best
// (strict <: an earlier chunk's index wins a tie). Every lane of the warp
// must call it, `live` or not; a lane that is not live gets (kMaxT, -1).
template <bool kStaged>
__device__ __forceinline__ void sweep_culled_mma(const SceneRefs& sc, const CullView& cv,
                                                 const float* __restrict__ amats, bool live,
                                                 float ox, float oy, float oz, float dx,
                                                 float dy, float dz, float od, float oo,
                                                 float& bt, int& bi) {
  __syncwarp();
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
  MxuRays m;
  mxu_gather(live, ox, oy, oz, dx, dy, dz, od, oo, m);
  const float ix = slab_inverse(dx);
  const float iy = slab_inverse(dy);
  const float iz = slab_inverse(dz);
  const float reach = sqrtf(oo) + cv.reach;
  const float mg = cv.margin_scale * reach * reach;  // this lane's widening of every box
  const int per = cv.n_super > 0 ? cv.super_factor : cv.n_chunks;
  for (int c0 = 0; c0 < cv.n_chunks; c0 += per) {
    bool mine = live;  // this lane enters the super-chunk
    if (cv.n_super > 0) {
      const float* b = cv.super;
      const int s = c0 / per, k = cv.n_super;
      mine = live && slab_box(box_bound<kStaged>(b, s) - mg, box_bound<kStaged>(b, k + s) - mg,
                              box_bound<kStaged>(b, 2 * k + s) - mg,
                              box_bound<kStaged>(b, 3 * k + s) + mg,
                              box_bound<kStaged>(b, 4 * k + s) + mg,
                              box_bound<kStaged>(b, 5 * k + s) + mg, ox, oy, oz, ix, iy, iz,
                              fminf(pbt, bt));
      if (__ballot_sync(kFullWarp, mine) == 0u) continue;
    }
    const int c_end = min(c0 + per, cv.n_chunks);
    for (int c = c0; c < c_end; ++c) {
      const float* b = cv.chunk;
      const int k = cv.n_tests;
      const bool enters =
          mine &&
          slab_box(box_bound<kStaged>(b, c) - mg, box_bound<kStaged>(b, k + c) - mg,
                   box_bound<kStaged>(b, 2 * k + c) - mg, box_bound<kStaged>(b, 3 * k + c) + mg,
                   box_bound<kStaged>(b, 4 * k + c) + mg, box_bound<kStaged>(b, 5 * k + c) + mg,
                   ox, oy, oz, ix, iy, iz, fminf(pbt, bt));
      if (__ballot_sync(kFullWarp, enters) == 0u) continue;
      float tc;
      int ic;
      mxu_chunk(amats, c, cv.chunk_size, m, tc, ic);
      if (live && tc < bt) {
        bt = tc;
        bi = ic;
      }
    }
  }
  if (live && pbi >= 0 && (pbt < bt || (pbt == bt && pbi < bi))) {
    bt = pbt;
    bi = pbi;
  }
}

// One bounce of the whole warp on the MXU chunk sweep: every lane sweeps,
// a `live` one then scatters (scatter_hit) and returns whether its path
// goes on; a lane that is not live keeps its Ray and returns false.
template <bool kTextured, bool kStaged>
__device__ __forceinline__ bool bounce_step_mxu(const SceneRefs& sc, Ray& r, const CullView& cv,
                                                const float* __restrict__ amats, bool live) {
  float od, oo;
  ray_terms(r, od, oo);
  float bt = kMaxT;
  int bi = -1;
  sweep_culled_mma<kStaged>(sc, cv, amats, live, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, od, oo, bt,
                            bi);
  return live && scatter_hit<kTextured>(sc, r, bt, bi);
}

// trace_bounces on the MXU chunk sweep: bounces [b_lo, b_hi) of a path
// that is `live`, until one ends it, the whole warp stepping together while
// any of its lanes has a path.
template <bool kTextured, bool kStaged>
__device__ __forceinline__ void trace_bounces_mxu(const SceneRefs& sc, int b_lo, int b_hi, Ray& r,
                                                  bool live, const CullView& cv,
                                                  const float* __restrict__ amats) {
  for (int bounce = b_lo; bounce < b_hi; ++bounce) {
    if (!__any_sync(kFullWarp, live)) break;
    live = bounce_step_mxu<kTextured, kStaged>(sc, r, cv, amats, live);
  }
}

}  // namespace
