// Whole-tile cull counters for the stats kernels of the megakernel
// (megakernel.cu megakernel_stats) and K1 (regroup.cu regroup_k1_stats).
//
// Counterpart of the stats=True counters of the TPU kernels:
// weekend_raytracer_tpu/ops/pallas/megakernel.py::_make_bounce (the cull
// tests, 515-660 and 826-848; the counters, 883-888) summed per tile by
// _make_kernel (1233-1286), and regroup.py::_make_k1 (745-758). Per TPU
// tile the table holds, as f32: col 0 bounce iterations of the tile's loop
// (summed over samples), col 1 live lanes summed over those iterations,
// col 2 chunk bodies the whole-tile cull enters (inside entered
// super-chunks), col 3 super-chunk bodies it enters, cols 4-7 zero.
//
// The stats kernels sweep every sphere and skip nothing. They can still
// count what the TPU's cull decides, because that cull never changes a
// winner: a chunk is skipped only when no live lane of the tile can hit
// inside it, so at chunk c each lane's best-t is min(priors, spheres
// before c) in the culled sweep and in the full one alike. So a stats
// kernel's ray, before each chunk of its unchanged chunk-ordered sweep,
// runs the TPU's slab test (bound_possible, megakernel.py:529-554) with
// min(prior best-t, best-t so far), and before each super-chunk's first
// chunk the super test; the
// priors are evaluated into their own best-t first. The bits are ORed over
// the tile's rays per (tile, sample, loop iteration) with warp-aggregated
// atomics, and stats_finish counts them: a chunk counts only inside an
// entered super-chunk, as the JAX loops nest them. The counters are the
// whole-tile cull's decisions, computed on the GPU, without any skipping.
//
// Cost on an H100: the slab tests add 12 FP32 operations per chunk to a
// sweep of 15 a pair (16 spheres a chunk: about 5%), the priors 4 pairs
// per bounce, and one aggregated atomic per warp per 32 chunks; none of it
// is on the main path, whose kernels compile without it. The stats
// kernels sweep a table staged in shared memory, a run of discriminants
// before any root, on a persistent grid whose lanes take the next pixel or
// record as their paths end (bounce.cuh's stats section, megakernel.cu,
// regroup.cu). The main path's own cull, per warp and
// skipping what no lane enters, is bounce.cuh's sweep_culled; it shares
// the slab test (slab_box) and the priors with these counters.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNPriors = 4;            // largest-|radius| spheres (N_PRIORS)
constexpr float kSlabEps = 1.0e-12f;   // signed-epsilon inverse direction
constexpr float kSlabMinT = 1.0e-3f;   // MIN_T, as bounce.cuh's kMinT

// The chunk hierarchy of the prepared scene (prepare_scene_arrays).
struct CullRefs {
  const float* chunk_bounds;  // [6, n_tests]: lo x, y, z, hi x, y, z
  const float* super_bounds;  // [6, n_super]
  const int* priors;          // [kNPriors] sphere indices
  int n_chunks;               // chunks holding spheres: n = n_chunks * chunk_size
  int n_tests;                // chunk boxes: n_chunks, padded to n_super * super_factor
  int n_super;                // 0: no super level
  int chunk_size, super_factor;
};

// Where a launch counts, per group of rays: a (tile, sample) of the
// megakernel, a dense tile of K1. One zeroed u32 scratch holds all four.
struct StatsRefs {
  unsigned* iters;        // [groups] most loop iterations of any ray
  unsigned* live;         // [groups] loop iterations summed over the rays
  unsigned* chunk_words;  // [groups, n_iters, words_c] entered-chunk bits
  unsigned* super_words;  // [groups, n_iters, words_s] entered-super bits
  unsigned* ticket;       // the persistent grid's next item (take_item)
  int n_iters, words_c, words_s;
};

inline int stats_words(int bits) { return (bits + 31) / 32; }

// u32 words of the scratch: iters, live, then the chunk and super bits.
inline long long stats_scratch_words(long long groups, int n_iters, int n_tests, int n_super) {
  return groups * (2 + static_cast<long long>(n_iters) *
                           (stats_words(n_tests) + stats_words(n_super)));
}

// The scratch's parts, and the launch's work ticket: the first word of the
// stats table `out`, which stats_finish writes over once the kernel is done.
inline StatsRefs stats_refs(unsigned* scratch, long long groups, int n_iters, int n_tests,
                            int n_super, float* out) {
  StatsRefs s;
  s.ticket = reinterpret_cast<unsigned*>(out);
  s.n_iters = n_iters;
  s.words_c = stats_words(n_tests);
  s.words_s = stats_words(n_super);
  s.iters = scratch;
  s.live = scratch + groups;
  s.chunk_words = scratch + 2 * groups;
  s.super_words = s.chunk_words + groups * n_iters * s.words_c;
  return s;
}

__device__ __forceinline__ unsigned lane_id() {
  unsigned l;
  asm("mov.u32 %0, %%laneid;" : "=r"(l));
  return l;
}

// The leader of the warp's threads that share `key`, and their mask.
__device__ __forceinline__ unsigned peers_of(const void* key) {
  return __match_any_sync(__activemask(), reinterpret_cast<unsigned long long>(key));
}

__device__ __forceinline__ bool leads(unsigned peers) {
  return static_cast<int>(lane_id()) == __ffs(peers) - 1;
}

// ORs `bits` into *word, one atomic per set of warp threads on that word.
__device__ __forceinline__ void or_word(unsigned* word, unsigned bits) {
  const unsigned peers = peers_of(word);
  const unsigned all = __reduce_or_sync(peers, bits);
  if (leads(peers) && all != 0u) atomicOr(word, all);
}

// A ray's loop iterations (`trips`, each a full sweep) into its group:
// the group's maximum, and the sum over the `weight` lanes of the TPU tile
// that trace the ray (its padding repeats the edge). The peers on a word
// are the lanes of the warp at this call with the same group, whatever
// sample or bounce each is at.
__device__ __forceinline__ void count_trips(const StatsRefs& st, int group, unsigned trips,
                                            unsigned weight) {
  unsigned* it = st.iters + group;
  const unsigned peers = peers_of(it);
  const unsigned most = __reduce_max_sync(peers, trips);
  const unsigned sum = __reduce_add_sync(peers, trips * weight);
  if (leads(peers)) {
    atomicMax(it, most);
    atomicAdd(st.live + group, sum);
  }
}

// The persistent grid's work: items [0, gridDim.x * blockDim.x) are the
// threads' first, by thread index, and a lane that needs another (`need`)
// takes the next one the ticket hands out, counted from there; every lane
// of the warp calls it, converged. One atomic a warp, for the lanes that
// need one, in lane order.
__device__ __forceinline__ long long take_item(unsigned* ticket, bool need) {
  const unsigned want = __ballot_sync(0xffffffffu, need);
  if (want == 0u) return -1;
  const int leader = __ffs(want) - 1;
  unsigned base = 0u;
  if (static_cast<int>(lane_id()) == leader) base = atomicAdd(ticket, __popc(want));
  base = __shfl_sync(0xffffffffu, base, leader);
  return static_cast<long long>(gridDim.x) * blockDim.x + base +
         __popc(want & ((1u << lane_id()) - 1u));
}

// The TPU's slab test of the box (lo x, y, z, hi x, y, z): can this ray
// enter it closer than bt? (slab_hit, megakernel.py:529-550; the min/max
// swap folded into the signed inverse direction.)
__device__ __forceinline__ bool slab_box(float lx, float ly, float lz, float hx, float hy,
                                         float hz, float ox, float oy, float oz, float ix,
                                         float iy, float iz, float bt) {
  const float tx0 = (lx - ox) * ix;
  const float tx1 = (hx - ox) * ix;
  const float ty0 = (ly - oy) * iy;
  const float ty1 = (hy - oy) * iy;
  const float tz0 = (lz - oz) * iz;
  const float tz1 = (hz - oz) * iz;
  const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tfar >= tnear && tfar > kSlabMinT && tnear < bt;
}

__device__ __forceinline__ float slab_inverse(float d) {
  const float sgn = d >= 0.0f ? 1.0f : -1.0f;
  return 1.0f / (sgn * fmaxf(fabsf(d), kSlabEps));
}

// One thread per tile: the [n_tiles, 8] f32 table from the scratch of
// groups_per_tile consecutive groups per tile.
__global__ void stats_finish(const StatsRefs st, int n_tests, int n_super, int super_factor,
                             int groups_per_tile, int n_tiles, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  unsigned iters = 0, live = 0, chunks = 0, supers = 0;
  for (int g = t * groups_per_tile; g < (t + 1) * groups_per_tile; ++g) {
    iters += st.iters[g];
    live += st.live[g];
    for (int k = 0; k < st.n_iters; ++k) {
      const size_t row = static_cast<size_t>(g) * st.n_iters + k;
      const unsigned* cw = st.chunk_words + row * st.words_c;
      const unsigned* sw = st.super_words + row * st.words_s;
      for (int w = 0; w < st.words_s; ++w) supers += __popc(sw[w]);
      for (int w = 0; w < st.words_c; ++w) {
        unsigned bits = cw[w];
        if (n_super > 0) {  // a chunk counts only inside an entered super-chunk
          unsigned inside = 0u;
          for (int j = 0; j < 32 && 32 * w + j < n_tests; ++j) {
            const int s = (32 * w + j) / super_factor;
            if ((sw[s >> 5] >> (s & 31)) & 1u) inside |= 1u << j;
          }
          bits &= inside;
        }
        chunks += __popc(bits);
      }
    }
  }
  float* o = out + static_cast<size_t>(t) * 8;
  o[0] = static_cast<float>(iters);
  o[1] = static_cast<float>(live);
  o[2] = static_cast<float>(chunks);
  o[3] = static_cast<float>(supers);
  o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// Zero the scratch and the ticket, run `launch` (the stats kernel), then
// stats_finish.
// Returns a cudaError_t.
template <class Launch>
int run_counted(unsigned* scratch, long long scratch_words, const StatsRefs& st, int n_tests,
                int n_super, int super_factor, int groups_per_tile, int n_tiles, float* out,
                cudaStream_t s, Launch launch) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, scratch_words * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(st.ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch();
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finish<<<(n_tiles + 127) / 128, 128, 0, s>>>(st, n_tests, n_super, super_factor,
                                                      groups_per_tile, n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
