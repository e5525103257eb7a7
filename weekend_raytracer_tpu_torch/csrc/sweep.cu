// Closest-hit sweep probes for Hopper (sm_90a): the counterparts of the nine
// pallas_calls of benchmarks/probe_mxu_sweep.py, which ask whether the
// sweep's two dot products (c.d and c.o) can ride the matrix unit, at what
// speed and what error:
//
//   sweep_fma      the sweep as the port runs it: every sphere in
//                  bounce.cuh's sweep_sphere rounding (strict <, first
//                  index wins), the table staged once a block with 2c, 4
//                  rays a thread, or one with a ray's passes and spheres
//                  split over warps where the rays leave the card idle.
//                  _vpu_sweep_kernel (:164, pallas_call at :273) and
//                  _chunked_vpu_kernel (:430, at :561).
//   sweep_mma      the same sweep with c.d and -2 c.o + kq from TF32
//                  mma.sync (kPrec = TF32, one product, or 3xTF32, three),
//                  the root select and argmin on the accumulator fragments.
//                  _mxu_sweep_kernel (:215, at :293; rays from the packed
//                  B [8, R]), _rowdot_sweep_kernel (:322, at :394) and
//                  _chunked_mxu_kernel (:486, at :577; rays from the six SoA
//                  planes).
//   dot_mma        A[M, 8] . B[8, N] (p3, :98, at :108): dot_fp32, multiply
//                  then add in k order (bit for bit the probe's FMA-order
//                  reference), or dot_tc, TF32 or 3xTF32 on the tensor
//                  cores; both store C as 16-byte words.
//   layout_remap   p1 (:62, at :70), p2 (:79, at :87): a copy under the
//                  probe's index map (2x + 1 in place, or rows reversed).
//   layout_chain   p4 (:130, at :140): the 256-step chain
//                  acc = acc * v + 1e-7 with 1 or 4 chains a thread.
//
// On the TPU, a reshape, a concatenation and a layout decide how vregs are
// filled; a CUDA thread holds scalars, so p1, p2 and p4 become a copy under
// a row map and the question of independent chains per thread.
//
// The sweeps take the probe's miss value, MAX_T = 3.0e38, as the start of
// bt (the production kMaxT of bounce.cuh is 1e3), and its MIN_T (1e-3,
// bounce.cuh's kMinT). A sphere tested is, in the FP32 convention of the
// port's bounds, 21 operations (bounce.cuh sweep_sphere: cd 5, co2 8,
// bq 1, cq 2, bq^2 - cq 2, sqrt 1, t0 and t1 2); the tensor-core form
// moves cd and -2 c.o + kq (14: depth 3 and 4, multiply and add) into the
// product and keeps 7 (b, cq, b^2, - cq, sqrt, t0, t1) per pair on the FP32
// units. Compares and selects are counted in neither.
//
// TF32 fragments of mma.sync.aligned.m16n8k8 (PTX ISA), lane = 4 g + q:
//   A 16 x 8: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B 8 x 8:  b0 (k = q, n = g), b1 (k = q + 4, n = g)
//   C 16 x 8: c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// The sphere matrix is A (16 spheres a tile: rows of c against d, or of
// [-2c | kq] against [o | 1]), the rays are B (8 a tile), K = 8 is the
// probe's depth (d; o; 1; 0). 3xTF32 splits x into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi) and accumulates lo.hi + hi.lo + hi.hi.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "card.cuh"

namespace {

constexpr float kProbeMaxT = 3.0e38f;  // probe_mxu_sweep.py:44
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 2 * 32 * 4;  // one 16-sphere tile's two A fragments
// sweep_mma: a block's window of staged A fragments (RTiOW's 31 tiles in one
// 3xTF32 window); its register budget in blocks an SM at each precision
// (0: no minimum); and the 8-ray tiles a warp carries where the rays fill
// the card
constexpr int kMmaSmemBytes = 64 * 1024;
constexpr int kMmaBlocksTf32 = 3;
constexpr int kMmaBlocks3x = 2;
constexpr int kWideTiles = 2;
// sweep_fma: rays a thread where the rays fill the card, and its register
// budget there in blocks of kThreads an SM; at one ray a thread, a block
// of kFmaNarrowThreads and its budget; the spheres a block stages at once
// (32 B each: 32 KiB); the spheres whose discriminants a thread forms
// before their roots, at kFmaRays rays a thread and at one; and the warps
// that may share a ray group where the rays leave the card idle
constexpr int kFmaRays = 4;
constexpr int kFmaBlocks = 3;
constexpr int kFmaNarrowThreads = 1024;
constexpr int kFmaBlocksNarrow = 1;
constexpr int kFmaWindow = 1024;
constexpr int kFmaUnroll = 2;
constexpr int kFmaUnrollNarrow = 1;
constexpr int kFmaMaxSplits = 32;
constexpr int kDotThreads = 128;  // dot_mma: four warps a block
constexpr int kDotWarps = kDotThreads / 32;
constexpr int kDotMaxRows = 64;  // dot_mma: rows of A a block stages at most
constexpr int kDotTileCols = 64;  // dot_tc: columns a block takes

enum Prec { kFp32 = 0, kTf32 = 1, kTf32x3 = 2 };

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as the hi (and, for 3xTF32, lo) TF32 operand.
template <int kPrec>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = kPrec == kTf32x3 ? tf32_bits(x - __uint_as_float(hi)) : 0u;
}

// d += a . b, one m16n8k8 TF32 product. Not volatile: ptxas may schedule
// it among other work; sweep_mma keeps a pass's products in that pass by
// a dependence of B on the pass index.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b at kPrec: one product, or the two small terms first, then hi.hi.
template <int kPrec>
__device__ __forceinline__ void mma_prec(float (&d)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                         const uint32_t (&blo)[2]) {
  if constexpr (kPrec == kTf32x3) {
    mma_tf32(d, alo, bhi);
    mma_tf32(d, ahi, blo);
  }
  mma_tf32(d, ahi, bhi);
}

// Component k of ray r in the probe's B order (dx, dy, dz, ox, oy, oz, 1, 0),
// from the packed B [8, R] (13f) or from the SoA planes [6, R] (ox, oy, oz,
// dx, dy, dz; 13g, 13i), which need no layout change.
__device__ __forceinline__ float ray_component(const float* __restrict__ rays, bool packed,
                                               long long n_rays, int k, long long r) {
  if (packed) return rays[k * n_rays + r];
  if (k < 3) return rays[(k + 3) * n_rays + r];
  if (k < 6) return rays[(k - 3) * n_rays + r];
  return k == 6 ? 1.0f : 0.0f;
}

// The root test of one (sphere s, ray) pair of the tensor-core sweep, from
// b = c.d - o.d and the discriminant b^2 - cq (the probe's epilogue,
// :236-243), the running best kept as sweep_sphere keeps it: the nearer
// root above kMinT, taken if below bt.
__device__ __forceinline__ void root(float b, float disc, int s, float& bt, int& bi) {
  const float sq = sqrtf(disc);  // NaN for a negative discriminant
  const float t0 = b - sq;
  const float t1 = b + sq;
  const float ts = t0 > kMinT ? t0 : t1;
  if (sq > 0.0f && ts > kMinT && ts < bt) {
    bt = ts;
    bi = s;
  }
}

// Whether root(b, disc, ...) may take the pair, without the root: a real
// root (sqrtf(disc) > 0 where disc > 0, and NaN fails both). A pre-test
// that also dropped the roots outside (kMinT, bt) (each by disc <= w^2,
// rounded down, for w = kMinT - b or b - bt rounded down) cost more than
// the roots it saved at RTiOW's fill.
__device__ __forceinline__ bool may_take(float disc) { return disc > 0.0f; }

// (t, i) becomes (ot, oi) where that is less on (t, index): the first
// index wins a tie, as in sweep_sphere.
__device__ __forceinline__ void take_least(float& t, int& i, float ot, int oi) {
  if (ot < t || (ot == t && oi < i)) {
    t = ot;
    i = oi;
  }
}

// Ray r's (t, index), merged with what earlier windows wrote there.
__device__ __forceinline__ void put_ray(float* __restrict__ t_out, int* __restrict__ i_out,
                                        long long r, float t, int i, bool merge) {
  if (merge) take_least(t, i, t_out[r], i_out[r]);
  t_out[r] = t;
  i_out[r] = i;
}

// x0 y0 + x1 y1 + x2 y2 rounded as nvcc contracts that sum written out
// (bounce.cuh sweep_sphere's c.d and 2c.o, and o.d and |o|^2 as sweep_fma
// wrote them before): x1 y1 first, x0 y0 fused onto it, x2 y2 onto that,
// as the SASS of the written sum shows; spelt out so that every
// instantiation rounds alike.
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1, float x2,
                                      float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x0, y0, __fmul_rn(x1, y1)));
}

// A ray of sweep_fma: origin, direction, o.d, |o|^2 and its running (t, index).
template <int kR>
struct FmaRays {
  float ox[kR], oy[kR], oz[kR], dx[kR], dy[kR], dz[kR], od[kR], oo[kR], bt[kR];
  int bi[kR];
};

// kU spheres from staged[s] on (index of the first: `index`) against the
// thread's kR rays: every pair's bq = c.d - o.d and discriminant bq^2 -
// (|o|^2 - 2c.o + kq) in sweep_sphere's order first, then, where the
// thread has a positive one, the roots of those pairs in sphere order (the
// nearer root above kMinT, taken below the running best: the first index
// wins a tie).
template <int kR, int kU>
__device__ __forceinline__ void fma_run(const float4* __restrict__ staged, int s, int index,
                                        FmaRays<kR>& ray) {
  float bq[kU][kR], disc[kU][kR];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const float4 c = staged[2 * (s + u)];
    const float4 c2 = staged[2 * (s + u) + 1];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const float cd = dot3(c.x, ray.dx[k], c.y, ray.dy[k], c.z, ray.dz[k]);
      const float co2 = dot3(c2.x, ray.ox[k], c2.y, ray.oy[k], c2.z, ray.oz[k]);
      bq[u][k] = __fsub_rn(cd, ray.od[k]);
      const float cq = __fadd_rn(__fsub_rn(ray.oo[k], co2), c.w);
      disc[u][k] = __fmaf_rn(bq[u][k], bq[u][k], -cq);
    }
  }
  float most = disc[0][0];  // fmaxf drops a NaN, which has no root
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int k = 0; k < kR; ++k) most = fmaxf(most, disc[u][k]);
  }
  if (!(most > 0.0f)) return;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (disc[u][k] > 0.0f) {
        const float sq = sqrtf(disc[u][k]);
        const float t0 = bq[u][k] - sq;
        const float t1 = bq[u][k] + sq;
        const float ts = t0 > kMinT ? t0 : t1;
        if (ts > kMinT && ts < ray.bt[k]) {
          ray.bt[k] = ts;
          ray.bi[k] = index + u;
        }
      }
    }
  }
}

// sweep_fma<kR, kBlock>: the closest hit of each ray over n_spheres (cx,
// cy, cz, kq), `iters` passes, kR rays a thread, blocks of kBlock.
//
// Replaces benchmarks/probe_mxu_sweep.py:164 _vpu_sweep_kernel (pallas_call
// at :273) and :430 _chunked_vpu_kernel (at :561). Bound on an H100 by
// instruction issue: a pair is 10 FP32 instructions that every input
// needs in sweep_sphere's rounding (cd and 2c.o 3 each, bq, cq 2,
// disc), counted as 15 operations in the bound (an FMA as two); the root
// (the IEEE sqrtf's MUFU, corrections and range check, t0, t1, compares,
// selects) only where a lane has a real root (0.46% of RTiOW's fill
// pairs), counted as 3 operations (sqrt, t0, t1) for each such pair.
// Design:
//  - the block stages its window of the table (all of it up to kFmaWindow
//    spheres) once, each sphere as (cx, cy, cz, kq) and (2cx, 2cy, 2cz):
//    c + c is exact, so 2c.o rounds as sweep_sphere's (c + c).o does, and
//    a pair loses its three adds; a warp reads a sphere as two broadcast
//    16-byte loads;
//  - a thread carries kR rays (a sphere's loads serve kR independent
//    chains) and forms kFmaUnroll spheres' discriminants before any root,
//    then skips the roots where it has no positive one (a warp vote, or a
//    test ray by ray, cost more than it skipped);
//  - where the rays leave the card idle (the probes' 4,096), one ray a
//    thread in blocks of kFmaNarrowThreads, and `splits` warps of a block
//    (up to kFmaMaxSplits) share a ray group, each over its runs of passes
//    and of each window's spheres (fma_plan), merged in shared memory by
//    the least (t, index): a later pass takes nothing (strict <) and the
//    least index wins a tie, so every split gives the sequential sweep's
//    bits;
//  - the pass index rides dx at zero weight (x + 0 * it is not foldable
//    without fast math), so each pass runs its own pairs; dx takes it in
//    place, since no pass needs the d.x before it.
// Each warp walks its spheres in increasing index within a pass, and its
// passes in order, so its strict < keeps the least (t, index) of its pairs.
template <int kR, int kBlock>
__global__ void __launch_bounds__(kBlock, kBlock == kThreads ? kFmaBlocks : kFmaBlocksNarrow)
    sweep_fma(const float4* __restrict__ spheres, int n_spheres, int window,
              const float* __restrict__ rays, int n_rays, int iters, int splits,
              int pass_parts, float* __restrict__ t_out, int* __restrict__ i_out) {
  constexpr int kBlockWarps = kBlock / 32;
  constexpr int kU = kR == 1 ? kFmaUnrollNarrow : kFmaUnroll;
  extern __shared__ float4 fma_staged[];  // [window][2]: (c, kq), (2c, 0)
  __shared__ float part_t[kR == 1 ? kBlockWarps : 1][32];
  __shared__ int part_i[kR == 1 ? kBlockWarps : 1][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = warp / splits;  // the block's ray group this warp sweeps
  const int part = warp - slot * splits;  // its share of that group's work
  const int sphere_parts = splits / pass_parts;
  const int pass_part = part / sphere_parts;
  const int sphere_part = part - pass_part * sphere_parts;
  const long long nr = n_rays;
  const long long n_groups = (nr + 32 * kR - 1) / (32 * kR);
  const long long grp = static_cast<long long>(blockIdx.x) * (kBlockWarps / splits) + slot;
  const bool busy = grp < n_groups;  // warp-uniform
  const long long r0 = grp * (32 * kR) + lane;  // this lane's rays: r0 + 32 k
  FmaRays<kR> ray;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const long long r = r0 + 32 * k;
    const bool live = busy && r < nr;
    ray.ox[k] = live ? rays[r] : 0.0f;
    ray.oy[k] = live ? rays[nr + r] : 0.0f;
    ray.oz[k] = live ? rays[2 * nr + r] : 0.0f;
    ray.dx[k] = live ? rays[3 * nr + r] : 0.0f;
    ray.dy[k] = live ? rays[4 * nr + r] : 0.0f;
    ray.dz[k] = live ? rays[5 * nr + r] : 0.0f;
    ray.od[k] = dot3(ray.ox[k], ray.dx[k], ray.oy[k], ray.dy[k], ray.oz[k], ray.dz[k]);
    ray.oo[k] = dot3(ray.ox[k], ray.ox[k], ray.oy[k], ray.oy[k], ray.oz[k], ray.oz[k]);
    ray.bt[k] = kProbeMaxT;
    ray.bi[k] = -1;
  }
  const int it_lo = static_cast<int>(1LL * pass_part * iters / pass_parts);
  const int it_hi = static_cast<int>(1LL * (pass_part + 1) * iters / pass_parts);
  for (int w0 = 0; w0 < n_spheres; w0 += window) {
    const int nw = min(window, n_spheres - w0);
    if (w0 > 0) __syncthreads();
    for (int j = threadIdx.x; j < nw; j += kBlock) {
      const float4 c = spheres[w0 + j];
      fma_staged[2 * j] = c;
      fma_staged[2 * j + 1] = make_float4(c.x + c.x, c.y + c.y, c.z + c.z, 0.0f);
    }
    __syncthreads();
    if (!busy) continue;
    const int s_lo = sphere_part * nw / sphere_parts;
    const int s_hi = (sphere_part + 1) * nw / sphere_parts;
    for (int it = it_lo; it < it_hi; ++it) {
      // dx + 0 is dx but for -0.0, and every pass adds the same +0.0: each
      // pass sees d.x + it * 0, as a sum taken afresh each pass would give
#pragma unroll
      for (int k = 0; k < kR; ++k) ray.dx[k] += static_cast<float>(it) * 0.0f;
      int s = s_lo;
      for (; s + kU <= s_hi; s += kU) fma_run<kR, kU>(fma_staged, s, w0 + s, ray);
      for (; s < s_hi; ++s) fma_run<kR, 1>(fma_staged, s, w0 + s, ray);
    }
  }
  if constexpr (kR == 1) {  // fma_plan splits a ray group only at one ray a thread
    if (splits > 1) {
      if (busy) {
        part_t[warp][lane] = ray.bt[0];
        part_i[warp][lane] = ray.bi[0];
      }
      __syncthreads();
      if (busy && part == 0 && r0 < nr) {
        float t = ray.bt[0];
        int i = ray.bi[0];
        for (int p = 1; p < splits; ++p) take_least(t, i, part_t[warp + p][lane],
                                                    part_i[warp + p][lane]);
        t_out[r0] = t;
        i_out[r0] = i;
      }
      return;
    }
  }
  if (!busy) return;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const long long r = r0 + 32 * k;
    if (r < nr) {
      t_out[r] = ray.bt[k];
      i_out[r] = ray.bi[k];
    }
  }
}

// sweep_mma<kPrec, kRayTiles, kCensus>: the closest hit of each ray over
// n_tiles * 16 spheres, the products on the tensor cores.
//
// Replaces benchmarks/probe_mxu_sweep.py:215 _mxu_sweep_kernel (pallas_call
// at :293), :322 _rowdot_sweep_kernel (at :394) and :486
// _chunked_mxu_kernel (at :577). amats is the probe's per-chunk sphere
// matrix [n_chunks, 8, 2 cs] (p8's amats; p5's amat is its transpose with
// one chunk of 32): columns [0, cs) are c against d, [cs, 2 cs) are
// [-2c | kq] against [o | 1]. Bound on an H100 by operations: the products
// need 14 flops a pair (42 for 3xTF32) at the 495 TFLOP/s TF32 rate, the
// epilogue 4 FP32 operations a pair (b, cq, b^2 - cq) and 3 more (the root,
// t0, t1) for a pair with a real root; at RTiOW's fill (0.46% of pairs with
// one) the epilogue bounds TF32 and the products 3xTF32. The IEEE sqrtf
// (MUFU, corrections, a range check) of every pair would cost more than
// either, where almost every pair has no real root.
// Design:
//  - a lane runs the products of each 8-ray tile of a 16-sphere tile, then
//    forms b and the discriminant of its 4 pairs of each (independent work
//    that hides the products' latency). Where no lane of the warp has a
//    real root (a warp vote on the largest discriminant), that is all, and
//    so for each 8-ray tile of the others. Else the lane takes its pairs in
//    order (sphere s0 before s0 + 8 for each ray, as the running best
//    needs) and the root of those may_take passes: a warp takes one root a
//    round, in which any of its lanes has a survivor;
//  - a persistent grid, the blocks the card holds at once, walks the ray
//    groups, so a block stages its window of tiles once (split to TF32 in
//    fragment order, each thread stepping its element through the tiles
//    with no division), and conflict-free 16-byte loads feed the products;
//  - a warp carries kWideTiles 8-ray tiles (a fragment of A then feeds
//    that many products); where the rays alone would leave the card idle
//    (the probe's 4,096), one (kRayTiles 1), and `splits` warps of a block
//    share a ray group, each over its own run of a window's tiles, merged
//    in shared memory;
//  - a register budget of kMmaBlocks* blocks an SM; the products are not
//    volatile: A's operands depend on the pass index at zero weight (the
//    probe's anti-hoist).
// Each lane keeps a running (t, index) for its two rays of each 8-ray tile
// over the spheres g, g + 8, ... it sees in increasing order; the eight
// lanes of a ray, then the warps of a ray group, then the windows merge
// with take_least. (t, index) is then the least valid (root, sphere) of the
// ray, whatever the split: every launch shape gives the same bits.
// kCensus also counts into census[0..2] the pairs may_take keeps, the
// root rounds the warps take and their (tile, 8-ray tile) steps.
template <int kPrec, int kRayTiles, bool kCensus>
__global__ void __launch_bounds__(kThreads, kPrec == kTf32x3 ? kMmaBlocks3x : kMmaBlocksTf32)
    sweep_mma(const float* __restrict__ amats, int cs, int n_tiles, int window,
              const float* __restrict__ rays, int packed, int n_rays, int iters, int splits,
              float* __restrict__ t_out, int* __restrict__ i_out,
              unsigned long long* __restrict__ census) {
  static_assert(kThreads == kTileFloats, "a thread stages one element of each tile");
  constexpr int kRays = 8 * kRayTiles;  // a ray group
  extern __shared__ uint4 frag[];  // [window][2][32] hi, then as many lo for 3xTF32
  __shared__ float part_t[kWarps][32];
  __shared__ int part_i[kWarps][32];
  uint4* frag_lo = frag + window * 2 * 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int slot = warp / splits;  // which of the block's ray groups this warp sweeps
  const int part = warp - slot * splits;  // its run of each window's tiles
  const int groups = kWarps / splits;  // ray groups a block sweeps at once
  const long long nr = n_rays;
  const int n_groups = static_cast<int>((nr + kRays - 1) / kRays);
  // this thread's element of every tile it stages: matrix mat, lane ln,
  // value v, i.e. A row 16 j + (ln >> 2) + 8 (v & 1), component (ln & 3) +
  // 4 (v >> 1) of tile j of a chunk
  const int v = threadIdx.x & 3, ln = (threadIdx.x >> 2) & 31, mat = threadIdx.x >> 7;
  const int a_off = ((ln & 3) + 4 * (v >> 1)) * (2 * cs) + mat * cs + (ln >> 2) + 8 * (v & 1);
  const int tiles_per_chunk = cs / 16;
  int chunk = 0, tile_in_chunk = 0;  // of the next tile to stage
  unsigned kept = 0, rounds = 0, steps = 0;
  for (int w0 = 0; w0 < n_tiles; w0 += window) {
    const int nt = min(window, n_tiles - w0);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      uint32_t hi, lo;
      split<kPrec>(amats[static_cast<long long>(chunk) * 8 * (2 * cs) + 16 * tile_in_chunk + a_off],
                   hi, lo);
      reinterpret_cast<uint32_t*>(frag)[t * kTileFloats + threadIdx.x] = hi;
      if constexpr (kPrec == kTf32x3) {
        reinterpret_cast<uint32_t*>(frag_lo)[t * kTileFloats + threadIdx.x] = lo;
      }
      if (++tile_in_chunk == tiles_per_chunk) {
        tile_in_chunk = 0;
        ++chunk;
      }
    }
    __syncthreads();
    const int t_lo = part * nt / splits;
    const int t_hi = (part + 1) * nt / splits;
    for (int grp0 = blockIdx.x * groups; grp0 < n_groups; grp0 += gridDim.x * groups) {
      const int grp = grp0 + slot;  // warp-uniform, as is every branch on it
      const long long r_base = static_cast<long long>(grp) * kRays;
      float bt[kRayTiles][2];
      int bi[kRayTiles][2];
      if (grp < n_groups) {
        uint32_t bhi[kRayTiles][2], blo[kRayTiles][2];
        float od[kRayTiles][2], oo[kRayTiles][2];
#pragma unroll
        for (int rt = 0; rt < kRayTiles; ++rt) {
          const long long rb = r_base + 8 * rt + g;  // this lane's ray of B
          const bool in_b = rb < nr;
          split<kPrec>(in_b ? ray_component(rays, packed, nr, q, rb) : 0.0f, bhi[rt][0],
                       blo[rt][0]);
          split<kPrec>(in_b ? ray_component(rays, packed, nr, q + 4, rb) : 0.0f, bhi[rt][1],
                       blo[rt][1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // this lane's rays of C
            const long long rc = r_base + 8 * rt + 2 * q + h;
            float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            if (rc < nr) {
              for (int k = 0; k < 6; ++k) c[k] = ray_component(rays, packed, nr, k, rc);
            }
            od[rt][h] = c[0] * c[3] + c[1] * c[4] + c[2] * c[5];
            oo[rt][h] = c[3] * c[3] + c[4] * c[4] + c[5] * c[5];
            bt[rt][h] = kProbeMaxT;
            bi[rt][h] = -1;
          }
        }
        for (int it = 0; it < iters; ++it) {
          // 0.0f * it is not foldable without fast math: A's operands
          // depend on the pass through it, so each pass runs its own
          // products, and adding its bits (0) changes no bit
          const uint32_t zero = __float_as_uint(static_cast<float>(it) * 0.0f);
          for (int t = t_lo; t < t_hi; ++t) {
            uint32_t acd[4], am[4], acd_lo[4] = {0u, 0u, 0u, 0u}, am_lo[4] = {0u, 0u, 0u, 0u};
            const uint4 f0 = frag[(t * 2) * 32 + lane];
            const uint4 f1 = frag[(t * 2 + 1) * 32 + lane];
            acd[0] = f0.x + zero, acd[1] = f0.y, acd[2] = f0.z, acd[3] = f0.w;
            am[0] = f1.x + zero, am[1] = f1.y, am[2] = f1.z, am[3] = f1.w;
            if constexpr (kPrec == kTf32x3) {
              const uint4 l0 = frag_lo[(t * 2) * 32 + lane];
              const uint4 l1 = frag_lo[(t * 2 + 1) * 32 + lane];
              acd_lo[0] = l0.x, acd_lo[1] = l0.y, acd_lo[2] = l0.z, acd_lo[3] = l0.w;
              am_lo[0] = l1.x, am_lo[1] = l1.y, am_lo[2] = l1.z, am_lo[3] = l1.w;
            }
            const int s0 = (w0 + t) * 16 + g;
            // every 8-ray tile's products, then b and the discriminant of
            // its pairs: pair (rt, e) is sphere s0 + 8 (e >> 1) against the
            // lane's ray e & 1 of 8-ray tile rt
            float b[kRayTiles][4], disc[kRayTiles][4];
#pragma unroll
            for (int rt = 0; rt < kRayTiles; ++rt) {
              float cd[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_prec<kPrec>(cd, acd, acd_lo, bhi[rt], blo[rt]);
              mma_prec<kPrec>(m, am, am_lo, bhi[rt], blo[rt]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                b[rt][e] = cd[e] - od[rt][e & 1];
                const float cq = oo[rt][e & 1] + m[e];
                disc[rt][e] = b[rt][e] * b[rt][e] - cq;
              }
            }
            if constexpr (kCensus) steps += kRayTiles;
            // most tiles: no lane of the warp has a real root (fmaxf drops a
            // NaN, which has none); then most 8-ray tiles of the others
            float most[kRayTiles];
#pragma unroll
            for (int rt = 0; rt < kRayTiles; ++rt) {
              most[rt] = fmaxf(fmaxf(disc[rt][0], disc[rt][1]), fmaxf(disc[rt][2], disc[rt][3]));
            }
            float any = most[0];
#pragma unroll
            for (int rt = 1; rt < kRayTiles; ++rt) any = fmaxf(any, most[rt]);
            if (__any_sync(0xffffffffu, any > 0.0f)) {
#pragma unroll
              for (int rt = 0; rt < kRayTiles; ++rt) {
                if (!__any_sync(0xffffffffu, most[rt] > 0.0f)) continue;
                // the pairs in order, sphere s0 before s0 + 8 for each ray
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const bool take = may_take(disc[rt][e]);
                  if constexpr (kCensus) {
                    kept += take;
                    rounds += __any_sync(0xffffffffu, take);
                  }
                  if (take) root(b[rt][e], disc[rt][e], s0 + 8 * (e >> 1), bt[rt][e & 1],
                                 bi[rt][e & 1]);
                }
                __syncwarp();
              }
            }
          }
        }
#pragma unroll
        for (int rt = 0; rt < kRayTiles; ++rt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            for (int off = 4; off < 32; off <<= 1) {  // the lanes of other g, same q
              take_least(bt[rt][h], bi[rt][h], __shfl_xor_sync(0xffffffffu, bt[rt][h], off),
                         __shfl_xor_sync(0xffffffffu, bi[rt][h], off));
            }
          }
        }
      }
      if (splits == 1) {
        if (grp < n_groups && g == 0) {
#pragma unroll
          for (int rt = 0; rt < kRayTiles; ++rt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long rc = r_base + 8 * rt + 2 * q + h;
              if (rc < nr) put_ray(t_out, i_out, rc, bt[rt][h], bi[rt][h], w0 > 0);
            }
          }
        }
      } else {  // the warps of a ray group merge their runs of tiles
        if (grp < n_groups && g == 0) {
#pragma unroll
          for (int rt = 0; rt < kRayTiles; ++rt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              part_t[warp][8 * rt + 2 * q + h] = bt[rt][h];
              part_i[warp][8 * rt + 2 * q + h] = bi[rt][h];
            }
          }
        }
        __syncthreads();
        if (grp < n_groups && part == 0 && lane < kRays) {
          float t = part_t[warp][lane];
          int i = part_i[warp][lane];
          for (int p = 1; p < splits; ++p) take_least(t, i, part_t[warp + p][lane],
                                                      part_i[warp + p][lane]);
          const long long rc = r_base + lane;
          if (rc < nr) put_ray(t_out, i_out, rc, t, i, w0 > 0);
        }
        __syncthreads();
      }
    }
  }
  if constexpr (kCensus) {
    kept = __reduce_add_sync(0xffffffffu, kept);
    if (lane == 0) {
      atomicAdd(census, static_cast<unsigned long long>(kept));
      atomicAdd(census + 1, static_cast<unsigned long long>(rounds));
      atomicAdd(census + 2, static_cast<unsigned long long>(steps));
    }
  }
}

// dot_mma: C[M, N] = A[M, 8] . B[8, N], two kernels.
//
// Replace benchmarks/probe_mxu_sweep.py:98 p3's kernel (pallas_call at
// :108), jnp.dot at precision "highest" and at the default. Bound on an
// H100 by bytes at every shape: depth 8 gives 16 flops an output word
// against the 4 B written (4 MFLOP against 1.2 MB at p3's A[64, 8] . B[8,
// 4096]; 1.07 GFLOP against 302 MB at B[8, 2^20], 0.090 ms at 3.35 TB/s),
// far below the TF32 and FP32 lines, and C is most of the bytes. The
// kernel before this one gave a warp a 16 x 32 tile (64 blocks at p3 on
// 132 SMs), loaded B and stored C 4 bytes at a time, and in FP32 read 16
// values from global memory an output word. Both kernels here store C as
// coalesced 16-byte words, stage A once a block in shared memory, and
// size the grid to the card: a block covers its columns for up to 64 rows
// of A, and where that gives fewer blocks than SMs (p3) the rows a block
// takes are halved until it does not (dot_rows).

// dot_fp32: each output by __fmul_rn then __fadd_rn in k order from 0.0f,
// no contraction: bit for bit the probe's numpy reference (ref += a[:, k]
// * b[k, :]). Design: a thread owns a strip of 4 adjacent columns, loads
// its 8 B values as 16-byte loads once and reuses them for every row of
// the block's rows, whose A values it reads from shared memory (one
// address a warp: a broadcast), and stores each row's 4 outputs as one
// 16-byte word (a warp writes 512 contiguous bytes of a row).
__global__ void __launch_bounds__(kDotThreads)
    dot_fp32(const float* __restrict__ a, const float4* __restrict__ b, float4* __restrict__ c,
             int m, int n4, int rows) {
  __shared__ float as[kDotMaxRows * 8];
  const int m0 = blockIdx.y * rows;
  const int mr = min(rows, m - m0);
  for (int i = threadIdx.x; i < mr * 8; i += kDotThreads) as[i] = a[m0 * 8 + i];
  __syncthreads();
  const int col = blockIdx.x * kDotThreads + threadIdx.x;
  if (col >= n4) return;
  float4 bv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bv[k] = __ldg(b + static_cast<long long>(k) * n4 + col);
  float4* dst = c + static_cast<long long>(m0) * n4 + col;
  for (int r = 0; r < mr; ++r) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float av = as[r * 8 + k];
      acc.x = __fadd_rn(acc.x, __fmul_rn(av, bv[k].x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(av, bv[k].y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(av, bv[k].z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(av, bv[k].w));
    }
    dst[static_cast<long long>(r) * n4] = acc;
  }
}

// dot_tc<kPrec>: the products on the tensor cores, TF32 (one m16n8k8
// product) or 3xTF32 (lo.hi, hi.lo, then hi.hi into one accumulator).
// Design: a block of four warps takes kDotTileCols columns and up to 64
// rows. It stages A's rows and B's [8, 64] tile in shared memory, each
// element split to TF32 hi (and lo) once as it is staged (B read as
// 16-byte words; cp.async would land B unsplit and need a second pass over
// shared memory to split it, so B goes through registers); each warp takes
// two 8-column tiles, its B fragments read once, and runs every 16-row
// tile of A against them. The accumulators go to a [64, 72] tile of C in
// shared memory, and the block stores that tile as coalesced 16-byte rows
// (256 B a row). Row strides of 12 (A) and 72 (B, C) words put a
// fragment's 32 lanes on 32 banks. mma.sync and not wgmma: the product is
// no part of the time, and wgmma's K-major B would need B transposed as
// it is staged.
template <int kPrec>
__global__ void __launch_bounds__(kDotThreads)
    dot_tc(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
           int m, int n, int rows) {
  constexpr bool kLo = kPrec == kTf32x3;
  constexpr int kAStride = 12;
  constexpr int kStride = kDotTileCols + 8;
  __shared__ uint32_t a_hi[kDotMaxRows * kAStride];
  __shared__ uint32_t a_lo[kLo ? kDotMaxRows * kAStride : 1];
  __shared__ __align__(16) uint32_t b_hi[8 * kStride];
  __shared__ __align__(16) uint32_t b_lo[kLo ? 8 * kStride : 4];
  __shared__ __align__(16) float cs[kDotMaxRows * kStride];
  const int m0 = blockIdx.y * rows;
  const int mr = min(rows, m - m0);
  const int n0 = blockIdx.x * kDotTileCols;
  const int nc = min(kDotTileCols, n - n0);
  for (int i = threadIdx.x; i < mr * 8; i += kDotThreads) {
    uint32_t hi, lo;
    split<kPrec>(a[m0 * 8 + i], hi, lo);
    a_hi[(i >> 3) * kAStride + (i & 7)] = hi;
    if constexpr (kLo) a_lo[(i >> 3) * kAStride + (i & 7)] = lo;
  }
  {  // B's tile: 8 rows of 16 float4, one a thread
    const int k = threadIdx.x >> 4, c4 = threadIdx.x & 15;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (4 * c4 < nc) {
      v = __ldg(reinterpret_cast<const float4*>(b + static_cast<long long>(k) * n + n0) + c4);
    }
    uint4 hi, lo;
    split<kPrec>(v.x, hi.x, lo.x);
    split<kPrec>(v.y, hi.y, lo.y);
    split<kPrec>(v.z, hi.z, lo.z);
    split<kPrec>(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(b_hi + k * kStride + 4 * c4) = hi;
    if constexpr (kLo) *reinterpret_cast<uint4*>(b_lo + k * kStride + 4 * c4) = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < kDotTileCols / 8 / kDotWarps; ++j) {
    const int nt = warp + j * kDotWarps;
    if (8 * nt >= nc) break;  // n is a multiple of 8: whole tiles, warp-uniform
    uint32_t bh[2], bl[2] = {0u, 0u};
    bh[0] = b_hi[q * kStride + 8 * nt + g];
    bh[1] = b_hi[(q + 4) * kStride + 8 * nt + g];
    if constexpr (kLo) {
      bl[0] = b_lo[q * kStride + 8 * nt + g];
      bl[1] = b_lo[(q + 4) * kStride + 8 * nt + g];
    }
    for (int mt = 0; mt < mr / 16; ++mt) {
      const int r0 = (16 * mt + g) * kAStride + q;
      uint32_t ah[4], al[4] = {0u, 0u, 0u, 0u};
      ah[0] = a_hi[r0], ah[1] = a_hi[r0 + 8 * kAStride];
      ah[2] = a_hi[r0 + 4], ah[3] = a_hi[r0 + 8 * kAStride + 4];
      if constexpr (kLo) {
        al[0] = a_lo[r0], al[1] = a_lo[r0 + 8 * kAStride];
        al[2] = a_lo[r0 + 4], al[3] = a_lo[r0 + 8 * kAStride + 4];
      }
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_prec<kPrec>(acc, ah, al, bh, bl);
      float* row = cs + (16 * mt + g) * kStride + 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(row) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(row + 8 * kStride) = make_float2(acc[2], acc[3]);
    }
  }
  __syncthreads();
  float* dst = c + static_cast<long long>(m0) * n + n0;
  for (int e = threadIdx.x; e < mr * (kDotTileCols / 4); e += kDotThreads) {
    const int r = e / (kDotTileCols / 4), c4 = e % (kDotTileCols / 4);
    if (4 * c4 < nc) {
      reinterpret_cast<float4*>(dst + static_cast<long long>(r) * n)[c4] =
          *reinterpret_cast<const float4*>(cs + r * kStride + 4 * c4);
    }
  }
}

// layout_remap: p1's and p2's kernels of benchmarks/probe_mxu_sweep.py.
//
// Replaces p1's kernel (:62, pallas_call at :70: (32, 128) -> (1, 4096),
// 2x + 1, back) and p2's (:79, at :87: six rows concatenated in reverse).
// Bound by bytes: each value is read once and written once. A reshape of a
// contiguous array moves nothing on the card; what remains is the row map,
// a copy from global memory to global memory, one float4 a thread
// (16-byte accesses, coalesced both ways; a block covers a part of one
// row).
__global__ void __launch_bounds__(kThreads)
    layout_remap(const float4* __restrict__ in, float4* __restrict__ out, int rows,
                 long long cols4, int reverse, int affine, float scale, float bias) {
  const long long row = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= cols4) return;
  float4 v = in[row * cols4 + col];
  if (affine) {
    v.x = __fadd_rn(__fmul_rn(v.x, scale), bias);
    v.y = __fadd_rn(__fmul_rn(v.y, scale), bias);
    v.z = __fadd_rn(__fmul_rn(v.z, scale), bias);
    v.w = __fadd_rn(__fmul_rn(v.w, scale), bias);
  }
  const long long dst = reverse ? rows - 1 - row : row;
  out[dst * cols4 + col] = v;
}

// layout_chain: p4's kernel of benchmarks/probe_mxu_sweep.py.
//
// Replaces p4's kernel (:130, pallas_call at :140): 256 steps of
// acc = acc * v + 1e-7. Bound by FP32 operations (2 a step). The TPU probe
// asks whether a (1, N) layout wastes sublanes; on the card every layout of
// the same values is the same flat array, and the question becomes how many
// independent chains a thread needs to hide the FMA latency: 1 or 4
// (chains j of a thread are values tid + j * total threads, so loads stay
// coalesced). __fmaf_rn: one rounding a step.
__global__ void __launch_bounds__(kThreads)
    layout_chain(const float* __restrict__ in, float* __restrict__ out, long long n, int steps,
                 int chains, float c) {
  const long long total = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (chains == 4) {
    float v[4], acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = tid + j * total;
      v[j] = e < n ? in[e] : 0.0f;
      acc[j] = v[j];
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __fmaf_rn(acc[j], v[j], c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = tid + j * total;
      if (e < n) out[e] = acc[j];
    }
  } else if (tid < n) {
    const float v = in[tid];
    float acc = v;
    for (int s = 0; s < steps; ++s) acc = __fmaf_rn(acc, v, c);
    out[tid] = acc;
  }
}

// Blocks of sweep_mma<kPrec, kRayTiles, kCensus> an SM holds with `smem`
// bytes of window. The first call on a device allows the largest window
// (cudaFuncSetAttribute once, not on every launch); the answer for the
// last size asked is kept per device.
template <int kPrec, int kRayTiles, bool kCensus>
cudaError_t mma_blocks_per_sm(int smem, int* blocks) {
  static int cached_smem[kMaxDevices], cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && cached[dev] > 0 && cached_smem[dev] == smem) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  const void* fn = reinterpret_cast<const void*>(sweep_mma<kPrec, kRayTiles, kCensus>);
  if (!keep || cached[dev] == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  if (keep) {
    cached_smem[dev] = smem;
    cached[dev] = *blocks;
  }
  return cudaSuccess;
}

template <int kPrec, int kRayTiles, bool kCensus>
int launch_mma(const float* amats, int cs, int n_tiles, int window, int smem, const float* rays,
               int packed, int n_rays, int iters, int splits, long long blocks, float* t_out,
               int* i_out, unsigned long long* census, cudaStream_t s) {
  sweep_mma<kPrec, kRayTiles, kCensus><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      amats, cs, n_tiles, window, rays, packed, n_rays, iters, splits, t_out, i_out, census);
  return static_cast<int>(cudaGetLastError());
}

// sweep_mma's launch: the window of tiles a block stages; 8-ray tiles of 4
// (kRayTiles 4) where the 32-ray groups fill the warps the card holds at
// once, else of 1; the warps that share a ray group (splits, a power of
// two up to the tiles of a window) doubled while the warps the groups then
// take still fit the card; a grid of the blocks the card holds at once, or
// fewer. A census launch takes groups of 32 rays.
template <int kPrec>
int launch_sweep_mma(const float* amats, int n_chunks, int cs, const float* rays, int packed,
                     int n_rays, int iters, float* t_out, int* i_out, unsigned long long* census,
                     cudaStream_t s) {
  const int n_tiles = n_chunks * (cs / 16);
  const int tile_bytes = kTileFloats * 4 * (kPrec == kTf32x3 ? 2 : 1);
  const int window = min(n_tiles, kMmaSmemBytes / tile_bytes);
  const int smem = window * tile_bytes;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = census ? mma_blocks_per_sm<kPrec, kWideTiles, true>(smem, &per_sm)
                 : mma_blocks_per_sm<kPrec, kWideTiles, false>(smem, &per_sm);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kWideRays = 8 * kWideTiles;
  const bool narrow = !census &&
                      (n_rays + kWideRays - 1LL) / kWideRays < 1LL * sms * per_sm * kWarps;
  if (narrow) {
    err = mma_blocks_per_sm<kPrec, 1, false>(smem, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long resident = 1LL * sms * per_sm;  // blocks
  const int group_rays = narrow ? 8 : kWideRays;
  const long long n_groups = (n_rays + group_rays - 1LL) / group_rays;
  int splits = 1;
  while (splits < kWarps && 2 * splits <= window &&
         n_groups * splits * 2 <= resident * kWarps) {
    splits *= 2;
  }
  const long long groups = kWarps / splits;  // a block's at once
  const long long need = (n_groups + groups - 1) / groups;
  const long long blocks = min(need, resident);
  auto launch = census ? launch_mma<kPrec, kWideTiles, true>
               : narrow ? launch_mma<kPrec, 1, false>
                        : launch_mma<kPrec, kWideTiles, false>;
  return launch(amats, cs, n_tiles, window, smem, rays, packed, n_rays, iters, splits, blocks,
                t_out, i_out, census, s);
}

// sweep_fma's launch (mirrored by ops/cuda/sweep.py fma_plan): kFmaRays
// rays a thread where those warps fill the warps the card holds at once,
// else one; then, at one ray a thread, the warps that share a ray group
// (splits, a power of two up to kFmaMaxSplits and the (pass, sphere) pairs
// of a window) doubled while the warps the groups then take still fit the
// card, pass_parts of them over runs of passes (a power of two up to
// iters) and splits / pass_parts over runs of each window's spheres; a
// block of kWarps / splits ray groups.
struct FmaPlan {
  bool wide;  // kFmaRays rays a thread in blocks of kThreads, else one in kFmaNarrowThreads
  int rays, threads, splits, pass_parts, window;
  long long blocks;
};

FmaPlan fma_plan(int n_rays, int n_spheres, int iters, int sms) {
  FmaPlan p;
  p.window = min(n_spheres, kFmaWindow);
  const long long wide_groups = (n_rays + 32LL * kFmaRays - 1) / (32LL * kFmaRays);
  const bool wide = wide_groups >= 1LL * sms * kFmaBlocks * kWarps;
  p.wide = wide;
  p.rays = wide ? kFmaRays : 1;
  p.threads = wide ? kThreads : kFmaNarrowThreads;
  const int block_warps = p.threads / 32;
  const long long n_groups = (n_rays + 32LL * p.rays - 1) / (32LL * p.rays);
  const long long resident = 1LL * sms * (wide ? kFmaBlocks : kFmaBlocksNarrow) * block_warps;
  p.splits = 1;
  while (!wide && 2 * p.splits <= min(kFmaMaxSplits, block_warps) &&
         2LL * p.splits <= 1LL * iters * p.window && n_groups * 2 * p.splits <= resident) {
    p.splits *= 2;
  }
  p.pass_parts = 1;
  while (2 * p.pass_parts <= p.splits && 2 * p.pass_parts <= iters) p.pass_parts *= 2;
  const int groups = block_warps / p.splits;
  p.blocks = (n_groups + groups - 1) / groups;
  return p;
}

int launch_sweep_fma(const float4* spheres, int n_spheres, const float* rays, int n_rays,
                     int iters, float* t_out, int* i_out, cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FmaPlan p = fma_plan(n_rays, n_spheres, iters, sms);
  const int smem = p.window * 2 * static_cast<int>(sizeof(float4));
  const unsigned blocks = static_cast<unsigned>(p.blocks);
  if (p.wide) {
    sweep_fma<kFmaRays, kThreads><<<blocks, kThreads, smem, s>>>(
        spheres, n_spheres, p.window, rays, n_rays, iters, p.splits, p.pass_parts, t_out, i_out);
  } else {
    sweep_fma<1, kFmaNarrowThreads><<<blocks, kFmaNarrowThreads, smem, s>>>(
        spheres, n_spheres, p.window, rays, n_rays, iters, p.splits, p.pass_parts, t_out, i_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rows of A a dot_mma block takes: 64, halved (down to min_rows) while
// the grid would hold fewer blocks than the card's sms.
int dot_rows(int m, long long col_blocks, int min_rows, int sms) {
  int rows = kDotMaxRows;
  while (rows > min_rows && col_blocks * ((m + rows - 1) / rows) < sms) rows /= 2;
  return rows;
}

int launch_dot(const float* a, const float* b, float* c, int m, int n, int prec,
               cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prec == kFp32) {
    const int n4 = n / 4;
    const unsigned cols = static_cast<unsigned>((n4 + kDotThreads - 1) / kDotThreads);
    const int rows = dot_rows(m, cols, 1, sms);
    const dim3 grid(cols, static_cast<unsigned>((m + rows - 1) / rows));
    dot_fp32<<<grid, kDotThreads, 0, s>>>(a, reinterpret_cast<const float4*>(b),
                                          reinterpret_cast<float4*>(c), m, n4, rows);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned cols = static_cast<unsigned>((n + kDotTileCols - 1) / kDotTileCols);
  const int rows = dot_rows(m, cols, 16, sms);
  const dim3 grid(cols, static_cast<unsigned>((m + rows - 1) / rows));
  if (prec == kTf32) {
    dot_tc<kTf32><<<grid, kDotThreads, 0, s>>>(a, b, c, m, n, rows);
  } else {
    dot_tc<kTf32x3><<<grid, kDotThreads, 0, s>>>(a, b, c, m, n, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers to contiguous float32 (int32 for indices) arrays, and returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// shape it does not take. Rays are [6, n_rays] planes (ox, oy, oz, dx, dy,
// dz) or, for sweep_mma with packed = 1, the probe's B [8, n_rays] (dx, dy,
// dz, ox, oy, oz, 1, 0). Outputs: t [n_rays] (3.0e38 for a miss) and the
// closest sphere's index [n_rays] (-1 for a miss).

// The closest hit over spheres [n_spheres] (cx, cy, cz, kq), `iters`
// passes. `chunk` (1 to 2048) names the TPU kernel's chunk; the kernel
// stages its own window, and no result depends on it.
int wrt_sweep_fma(const float* spheres, int n_spheres, int chunk, const float* rays,
                  int n_rays, int iters, float* t_out, int* i_out, void* stream) {
  if (n_spheres <= 0 || chunk <= 0 || chunk > 2048 || n_rays <= 0 || iters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_sweep_fma(reinterpret_cast<const float4*>(spheres), n_spheres, rays, n_rays,
                          iters, t_out, i_out, static_cast<cudaStream_t>(stream));
}

// sweep_fma's launch for (n_rays, n_spheres, iters) on a card of `sms`
// SMs: plan[0..5] = rays a thread, threads a block, splits, pass_parts,
// window, blocks.
int wrt_sweep_fma_plan(int n_rays, int n_spheres, int iters, int sms, long long* plan) {
  if (n_rays <= 0 || n_spheres <= 0 || iters <= 0 || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FmaPlan p = fma_plan(n_rays, n_spheres, iters, sms);
  plan[0] = p.rays;
  plan[1] = p.threads;
  plan[2] = p.splits;
  plan[3] = p.pass_parts;
  plan[4] = p.window;
  plan[5] = p.blocks;
  return 0;
}

// wrt_sweep_mma (below), and with census non-null (three zeroed counters)
// its census instantiation: census[0] += the pairs the pre-test keeps, [1]
// += the root rounds the warps take, [2] += their (16-sphere tile, 8-ray
// tile) steps (128 pairs each), every pass counted.
int wrt_sweep_mma_census(const float* amats, int n_chunks, int cs, const float* rays, int packed,
                         int n_rays, int iters, int prec, float* t_out, int* i_out,
                         unsigned long long* census, void* stream) {
  if (n_chunks <= 0 || cs <= 0 || cs % 16 || n_rays <= 0 || iters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prec == kTf32) {
    return launch_sweep_mma<kTf32>(amats, n_chunks, cs, rays, packed, n_rays, iters, t_out,
                                   i_out, census, s);
  }
  if (prec == kTf32x3) {
    return launch_sweep_mma<kTf32x3>(amats, n_chunks, cs, rays, packed, n_rays, iters, t_out,
                                     i_out, census, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The closest hit over the spheres of amats [n_chunks, 8, 2 cs] (cs a
// multiple of 16) with the products at prec 1 (TF32) or 2 (3xTF32).
int wrt_sweep_mma(const float* amats, int n_chunks, int cs, const float* rays, int packed,
                  int n_rays, int iters, int prec, float* t_out, int* i_out, void* stream) {
  return wrt_sweep_mma_census(amats, n_chunks, cs, rays, packed, n_rays, iters, prec, t_out,
                              i_out, nullptr, stream);
}

// sweep_mma's __launch_bounds__ at prec 1 or 2: threads a block and
// blocks an SM (0: no minimum), which fix its register budget.
int wrt_sweep_mma_launch_bounds(int prec, int* threads, int* min_blocks) {
  if (prec != kTf32 && prec != kTf32x3) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kThreads;
  *min_blocks = prec == kTf32x3 ? kMmaBlocks3x : kMmaBlocksTf32;
  return 0;
}

// c [m, n] = a [m, 8] . b [8, n] at prec 0 (FP32, k order), 1 (TF32) or 2
// (3xTF32); m a multiple of 16, n of 8, b and c 16-byte aligned.
int wrt_dot_mma(const float* a, const float* b, float* c, int m, int n, int prec,
                void* stream) {
  if (m <= 0 || m % 16 || n <= 0 || n % 8 || m / 16 > 65535 || prec < kFp32 ||
      prec > kTf32x3 || (reinterpret_cast<uintptr_t>(b) & 15) ||
      (reinterpret_cast<uintptr_t>(c) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dot(a, b, c, m, n, prec, static_cast<cudaStream_t>(stream));
}

// out [rows, cols] = in [rows, cols] with rows reversed (reverse = 1) and,
// with affine = 1, each value x as x * scale + bias (no FMA); cols a
// multiple of 4, both arrays 16-byte aligned, rows at most 65,535.
int wrt_layout_remap(const float* in, float* out, int rows, int cols, int reverse, int affine,
                     float scale, float bias, void* stream) {
  if (rows <= 0 || rows > 65535 || cols <= 0 || cols % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cols4 = cols / 4;
  const dim3 grid(static_cast<unsigned>((cols4 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows));
  layout_remap<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), rows, cols4, reverse,
      affine, scale, bias);
  return static_cast<int>(cudaGetLastError());
}

// out [n] = in [n] after `steps` of acc = fma(acc, in, c) from acc = in,
// with 1 or 4 chains a thread.
int wrt_layout_chain(const float* in, float* out, long long n, int steps, int chains, float c,
                     void* stream) {
  if (n <= 0 || steps < 0 || (chains != 1 && chains != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = static_cast<long long>(kThreads) * chains;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  layout_chain<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n, steps,
                                                                          chains, c);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes of one kernel, as the CUDA
// runtime reports them; returns a cudaError_t. `which`: 0 sweep_fma
// (kFmaRays rays a thread), 1/2 sweep_mma TF32/3xTF32 (kWideTiles 8-ray
// tiles a warp), 3/4/5 dot_mma FP32/TF32/3xTF32, 6/7 layout remap/chain,
// 8/9 sweep_mma TF32/3xTF32 with one 8-ray tile a warp, 10/11 their
// census instantiations, 12 sweep_fma with one ray a thread (blocks of
// kFmaNarrowThreads).
int wrt_sweep_attributes(int which, int* num_regs, int* local_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(sweep_fma<kFmaRays, kThreads>),
      reinterpret_cast<const void*>(sweep_mma<kTf32, kWideTiles, false>),
      reinterpret_cast<const void*>(sweep_mma<kTf32x3, kWideTiles, false>),
      reinterpret_cast<const void*>(dot_fp32),
      reinterpret_cast<const void*>(dot_tc<kTf32>),
      reinterpret_cast<const void*>(dot_tc<kTf32x3>),
      reinterpret_cast<const void*>(layout_remap),
      reinterpret_cast<const void*>(layout_chain),
      reinterpret_cast<const void*>(sweep_mma<kTf32, 1, false>),
      reinterpret_cast<const void*>(sweep_mma<kTf32x3, 1, false>),
      reinterpret_cast<const void*>(sweep_mma<kTf32, kWideTiles, true>),
      reinterpret_cast<const void*>(sweep_mma<kTf32x3, kWideTiles, true>),
      reinterpret_cast<const void*>(sweep_fma<1, kFmaNarrowThreads>),
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
