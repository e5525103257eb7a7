// Closest-hit sweep probes for Hopper (sm_90a): the counterparts of the nine
// pallas_calls of benchmarks/probe_mxu_sweep.py, which ask whether the
// sweep's two dot products (c.d and c.o) can ride the matrix unit, at what
// speed and what error:
//
//   sweep_fma      the sweep as the port runs it: one thread per ray, every
//                  sphere through bounce.cuh's own sweep_sphere (strict <,
//                  first index wins). _vpu_sweep_kernel (:164, pallas_call
//                  at :273) and _chunked_vpu_kernel (:430, at :561).
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
constexpr int kRayTiles = 4;  // 8-ray tiles a warp of sweep_mma carries: 32 rays
constexpr int kTileFloats = 2 * 32 * 4;  // one 16-sphere tile's two A fragments
constexpr int kMmaSmemBytes = 48 * 1024;  // a block's window of staged A fragments
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

// d += a . b, one m16n8k8 TF32 product. Volatile: a pass of the sweep is
// never merged with another (the probe's anti-hoist).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
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

// sweep_fma: the closest hit of each ray over n_spheres (cx, cy, cz, kq),
// staged chunk by chunk into shared memory, `iters` passes.
//
// Replaces benchmarks/probe_mxu_sweep.py:164 _vpu_sweep_kernel (pallas_call
// at :273) and :430 _chunked_vpu_kernel (at :561). Bound on an H100 by
// instruction throughput: 21 counted operations a test, but sweep_sphere
// runs more instructions than that (the IEEE sqrtf's range check,
// reciprocal square root and correction, three compares, two selects, the
// c + c adds) where it hits; a miss, most tests, skips the root. Design:
// one thread per ray so that nothing crosses lanes; a chunk's spheres are
// one shared-memory broadcast load (LDS.128) each; the block stages the
// next chunk between two barriers, with a runtime chunk size as the TPU
// kernel's fori over chunks. The pass index rides dx at
// zero weight (x + 0 * it is not foldable without fast math). Four blocks
// an SM: with sweep_sphere's branch around the root ptxas would otherwise
// hold it to 48 registers and spill 8 bytes.
__global__ void __launch_bounds__(kThreads, 4)
    sweep_fma(const float4* __restrict__ spheres, int n_spheres, int chunk,
              const float* __restrict__ rays, int n_rays, int iters, float* __restrict__ t_out,
              int* __restrict__ i_out) {
  extern __shared__ float4 staged[];  // chunk
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nr = n_rays;
  const bool live = r < nr;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    for (int k = 0; k < 3; ++k) {
      o[k] = rays[k * nr + r];
      d[k] = rays[(k + 3) * nr + r];
    }
  }
  const float od = o[0] * d[0] + o[1] * d[1] + o[2] * d[2];
  const float oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  float bt = kProbeMaxT;
  int bi = -1;
  for (int it = 0; it < iters; ++it) {
    const float dxj = d[0] + static_cast<float>(it) * 0.0f;
    for (int c0 = 0; c0 < n_spheres; c0 += chunk) {
      const int n = min(chunk, n_spheres - c0);
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kThreads) staged[j] = spheres[c0 + j];
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        sweep_sphere(staged[j], c0 + j, o[0], o[1], o[2], dxj, d[1], d[2], od, oo, bt, bi);
      }
    }
  }
  if (live) {
    t_out[r] = bt;
    i_out[r] = bi;
  }
}

// One (sphere s, ray) pair of the tensor-core sweep, from its products
// cd = c.d and m = -2 c.o + kq: the probe's epilogue (:236-243) with the
// running best kept as sweep_sphere keeps it.
__device__ __forceinline__ void pair(float cd, float m, float od, float oo, int s, float& bt,
                                     int& bi) {
  const float b = cd - od;
  const float cq = oo + m;
  const float sq = sqrtf(b * b - cq);  // NaN for a negative discriminant
  const float t0 = b - sq;
  const float t1 = b + sq;
  const float ts = t0 > kMinT ? t0 : t1;
  if (sq > 0.0f && ts > kMinT && ts < bt) {
    bt = ts;
    bi = s;
  }
}

// sweep_mma<kPrec>: the closest hit of each ray over n_tiles * 16 spheres,
// the products on the tensor cores.
//
// Replaces benchmarks/probe_mxu_sweep.py:215 _mxu_sweep_kernel (pallas_call
// at :293), :322 _rowdot_sweep_kernel (at :394) and :486
// _chunked_mxu_kernel (at :577). amats is the probe's per-chunk sphere
// matrix [n_chunks, 8, 2 cs] (p8's amats; p5's amat is its transpose with
// one chunk of 32): columns [0, cs) are c against d, [cs, 2 cs) are
// [-2c | kq] against [o | 1]. Bound on an H100 by the epilogue's
// instructions: the products the sweep needs are 14 flops a pair (42 for
// 3xTF32), a small share of the 495 TFLOP/s TF32 rate, and the 7 counted
// operations of the epilogue (with its sqrt, compares and selects) remain
// on the FP32 pipe, at 77 (TF32) or 98 (3xTF32) registers a thread.
// Design: a block stages a window of tiles into shared memory once,
// already split to TF32 in fragment order, so a warp reads each tile's A
// fragments as one conflict-free 16-byte load per matrix; a warp carries
// 32 rays (four B fragments, split once, in registers) so each A fragment
// feeds four products; each thread keeps a running (t, index) for its two
// rays of each tile over the spheres g, g + 8, g + 16, ... it sees in
// increasing order, and the eight lanes that share a ray merge once, after
// the loop, lexicographically on (t, index): the first index wins, as in
// sweep_sphere.
template <int kPrec>
__global__ void __launch_bounds__(kThreads)
    sweep_mma(const float* __restrict__ amats, int cs, int n_tiles, int window,
              const float* __restrict__ rays, int packed, int n_rays, int iters,
              float* __restrict__ t_out, int* __restrict__ i_out) {
  extern __shared__ uint4 frag[];  // [window][2][32] hi, then as many lo for 3xTF32
  uint4* frag_lo = frag + window * 2 * 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const long long nr = n_rays;
  const long long r_base =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * (8 * kRayTiles);
  uint32_t bhi[kRayTiles][2], blo[kRayTiles][2];
  float od[kRayTiles][2], oo[kRayTiles][2], bt[kRayTiles][2];
  int bi[kRayTiles][2];
#pragma unroll
  for (int rt = 0; rt < kRayTiles; ++rt) {
    const long long rb = r_base + 8 * rt + g;  // this lane's ray of B
    const bool in_b = rb < nr;
    split<kPrec>(in_b ? ray_component(rays, packed, nr, q, rb) : 0.0f, bhi[rt][0], blo[rt][0]);
    split<kPrec>(in_b ? ray_component(rays, packed, nr, q + 4, rb) : 0.0f, bhi[rt][1],
                 blo[rt][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // this lane's rays of C
      const long long rc = r_base + 8 * rt + 2 * q + h;
      float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (rc < nr) {
        for (int k = 0; k < 6; ++k) v[k] = ray_component(rays, packed, nr, k, rc);
      }
      od[rt][h] = v[0] * v[3] + v[1] * v[4] + v[2] * v[5];
      oo[rt][h] = v[3] * v[3] + v[4] * v[4] + v[5] * v[5];
      bt[rt][h] = kProbeMaxT;
      bi[rt][h] = -1;
    }
  }
  const int tiles_per_chunk = cs / 16;
  for (int w0 = 0; w0 < n_tiles; w0 += window) {
    const int nt = min(window, n_tiles - w0);
    __syncthreads();
    // element (tile, matrix, lane, v): sphere row 16 j + gg + 8 (v & 1),
    // component qq + 4 (v >> 1) of the tile's chunk
    for (int e = threadIdx.x; e < nt * kTileFloats; e += kThreads) {
      const int v = e & 3;
      const int ln = (e >> 2) & 31;
      const int mat = (e >> 7) & 1;
      const int t = w0 + (e >> 8);
      const int c = t / tiles_per_chunk;
      const int j = t - c * tiles_per_chunk;
      const int row = 16 * j + (ln >> 2) + 8 * (v & 1);
      const int k = (ln & 3) + 4 * (v >> 1);
      const float x = amats[(static_cast<long long>(c) * 8 + k) * (2 * cs) + mat * cs + row];
      uint32_t hi, lo;
      split<kPrec>(x, hi, lo);
      reinterpret_cast<uint32_t*>(frag)[e] = hi;
      if constexpr (kPrec == kTf32x3) reinterpret_cast<uint32_t*>(frag_lo)[e] = lo;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      for (int t = 0; t < nt; ++t) {
        uint32_t acd[4], am[4], acd_lo[4] = {0u, 0u, 0u, 0u}, am_lo[4] = {0u, 0u, 0u, 0u};
        const uint4 f0 = frag[(t * 2) * 32 + lane];
        const uint4 f1 = frag[(t * 2 + 1) * 32 + lane];
        acd[0] = f0.x, acd[1] = f0.y, acd[2] = f0.z, acd[3] = f0.w;
        am[0] = f1.x, am[1] = f1.y, am[2] = f1.z, am[3] = f1.w;
        if constexpr (kPrec == kTf32x3) {
          const uint4 l0 = frag_lo[(t * 2) * 32 + lane];
          const uint4 l1 = frag_lo[(t * 2 + 1) * 32 + lane];
          acd_lo[0] = l0.x, acd_lo[1] = l0.y, acd_lo[2] = l0.z, acd_lo[3] = l0.w;
          am_lo[0] = l1.x, am_lo[1] = l1.y, am_lo[2] = l1.z, am_lo[3] = l1.w;
        }
        const int s0 = (w0 + t) * 16 + g;
#pragma unroll
        for (int rt = 0; rt < kRayTiles; ++rt) {
          float cd[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_prec<kPrec>(cd, acd, acd_lo, bhi[rt], blo[rt]);
          mma_prec<kPrec>(m, am, am_lo, bhi[rt], blo[rt]);
          // sphere s0 before s0 + 8, for each of the lane's two rays
          pair(cd[0], m[0], od[rt][0], oo[rt][0], s0, bt[rt][0], bi[rt][0]);
          pair(cd[1], m[1], od[rt][1], oo[rt][1], s0, bt[rt][1], bi[rt][1]);
          pair(cd[2], m[2], od[rt][0], oo[rt][0], s0 + 8, bt[rt][0], bi[rt][0]);
          pair(cd[3], m[3], od[rt][1], oo[rt][1], s0 + 8, bt[rt][1], bi[rt][1]);
        }
      }
    }
  }
#pragma unroll
  for (int rt = 0; rt < kRayTiles; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = bt[rt][h];
      int i = bi[rt][h];
      for (int off = 4; off < 32; off <<= 1) {  // the lanes of other g, same q
        const float ot = __shfl_xor_sync(0xffffffffu, t, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (ot < t || (ot == t && oi < i)) {
          t = ot;
          i = oi;
        }
      }
      const long long rc = r_base + 8 * rt + 2 * q + h;
      if (g == 0 && rc < nr) {
        t_out[rc] = t;
        i_out[rc] = i;
      }
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

template <int kPrec>
int launch_sweep_mma(const float* amats, int n_chunks, int cs, const float* rays, int packed,
                     int n_rays, int iters, float* t_out, int* i_out, cudaStream_t s) {
  const int n_tiles = n_chunks * (cs / 16);
  const int tile_bytes = kTileFloats * 4 * (kPrec == kTf32x3 ? 2 : 1);
  const int window = min(n_tiles, kMmaSmemBytes / tile_bytes);
  const int smem = window * tile_bytes;
  cudaError_t err = cudaFuncSetAttribute(sweep_mma<kPrec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rays_a_block = 8LL * kRayTiles * kWarps;
  const unsigned blocks = static_cast<unsigned>((n_rays + rays_a_block - 1) / rays_a_block);
  sweep_mma<kPrec><<<blocks, kThreads, smem, s>>>(amats, cs, n_tiles, window, rays, packed,
                                                  n_rays, iters, t_out, i_out);
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

// The closest hit over spheres [n_spheres] (cx, cy, cz, kq) in chunks of
// `chunk` (1 to 2048) staged in shared memory, `iters` passes.
int wrt_sweep_fma(const float* spheres, int n_spheres, int chunk, const float* rays,
                  int n_rays, int iters, float* t_out, int* i_out, void* stream) {
  if (n_spheres <= 0 || chunk <= 0 || chunk > 2048 || n_rays <= 0 || iters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
  const int smem = chunk * static_cast<int>(sizeof(float4));
  const float4* sp = reinterpret_cast<const float4*>(spheres);
  sweep_fma<<<blocks, kThreads, smem, s>>>(sp, n_spheres, chunk, rays, n_rays, iters, t_out,
                                           i_out);
  return static_cast<int>(cudaGetLastError());
}

// The closest hit over the spheres of amats [n_chunks, 8, 2 cs] (cs a
// multiple of 16) with the products at prec 1 (TF32) or 2 (3xTF32).
int wrt_sweep_mma(const float* amats, int n_chunks, int cs, const float* rays, int packed,
                  int n_rays, int iters, int prec, float* t_out, int* i_out, void* stream) {
  if (n_chunks <= 0 || cs <= 0 || cs % 16 || n_rays <= 0 || iters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prec == kTf32) {
    return launch_sweep_mma<kTf32>(amats, n_chunks, cs, rays, packed, n_rays, iters, t_out,
                                   i_out, s);
  }
  if (prec == kTf32x3) {
    return launch_sweep_mma<kTf32x3>(amats, n_chunks, cs, rays, packed, n_rays, iters, t_out,
                                     i_out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
// runtime reports them; returns a cudaError_t. `which`: 0 sweep_fma, 1/2
// sweep_mma TF32/3xTF32, 3/4/5 dot_mma FP32/TF32/3xTF32, 6/7 layout
// remap/chain.
int wrt_sweep_attributes(int which, int* num_regs, int* local_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(sweep_fma),
      reinterpret_cast<const void*>(sweep_mma<kTf32>),
      reinterpret_cast<const void*>(sweep_mma<kTf32x3>),
      reinterpret_cast<const void*>(dot_fp32),
      reinterpret_cast<const void*>(dot_tc<kTf32>),
      reinterpret_cast<const void*>(dot_tc<kTf32x3>),
      reinterpret_cast<const void*>(layout_remap),
      reinterpret_cast<const void*>(layout_chain),
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
