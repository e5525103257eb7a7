// Record reorder kernels for Hopper (sm_90a): the counterparts of the
// record-DMA probes of benchmarks/probe_dma.py and probe_mosaic.py, which
// move whole records of an HBM array by an index list:
//
//   record_gather   dst record i = src record idx[i]. The gathers of
//                   probe_dma.py (pallas_call at :36, :63 and :104) and
//                   probe_mosaic.py:143; on the SoA pool of the regroup
//                   pipeline it applies a binning permutation to the dense
//                   records of a cut.
//   record_scatter  dst record idx[j] = src record j; records not named keep
//                   what dst held. probe_dma.py:145; it also undoes a
//                   binning permutation.
//   dma_rate        probe_dma_rate (probe_dma.py:165-212, pallas_call at
//                   :199): per tile, 32 whole records picked by a
//                   permutation are copied into shared memory, and the sum of
//                   their component 0 is written, broadcast to (8, 128).
//
// A record is, for each of `pieces` planes c, the `width` contiguous values
// at c * ld + i * width. Row records of an array [rows, W] are one plane
// (width W); the columns of the SoA pool [16, cap] are 16 planes of width 1
// (ops/cuda/reorder.py). The gather and the scatter take a vector type:
// float4 where widths, strides and addresses allow 16-byte accesses, float
// otherwise. One thread moves one vector, neighbouring threads neighbouring
// vectors of a record, so a 128-wide row record is one warp's 16-byte loads
// and stores; a SoA column is one float per thread and plane, with the
// writes coalesced and the reads where the index list points.
//
// What bounds them on an H100: memory. Each moves every record byte once in
// and once out (and reads the index list); nothing is computed. dma_rate
// reads each record once into shared memory with asynchronous 16-byte copies
// (cp.async), all 32 records of a tile in flight together, then reduces 4096
// values from shared memory and writes 4 KiB; its tile of 32 x 11 x 128 f32
// (176 KiB) leaves room for one block per SM, so a tile's reduction and
// store are not overlapped with its own loads, only with other SMs'.
//
// The sum order of dma_rate is fixed and the plain version in reorder.py
// repeats it, so the two agree in every bit: thread t adds values
// t, t + 256, t + 512, ... of the tile's 32 x 128 component-0 values in
// turn from 0.0f, each warp halves its 32 partial sums five times, and the
// 8 warp sums are added in warp order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRateRecords = 32;  // records per tile (probe_dma.py:180-194)
constexpr int kRateWarps = kThreads / 32;
constexpr int kOutTile = 8 * 128;  // floats of a tile's (8, 128) output block

template <typename V>
__global__ void __launch_bounds__(kThreads)
    record_gather(const V* __restrict__ src, V* __restrict__ dst, const int* __restrict__ idx,
                  unsigned items, unsigned width, long long src_ld, long long dst_ld) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= items) return;
  const unsigned i = e / width;
  const unsigned k = e - i * width;
  const long long plane = blockIdx.y;
  dst[plane * dst_ld + static_cast<long long>(i) * width + k] =
      src[plane * src_ld + static_cast<long long>(idx[i]) * width + k];
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    record_scatter(const V* __restrict__ src, V* __restrict__ dst, const int* __restrict__ idx,
                   unsigned items, unsigned width, long long src_ld, long long dst_ld) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= items) return;
  const unsigned j = e / width;
  const unsigned k = e - j * width;
  const long long plane = blockIdx.y;
  dst[plane * dst_ld + static_cast<long long>(idx[j]) * width + k] =
      src[plane * src_ld + static_cast<long long>(j) * width + k];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One block per tile of 32 records. rec4: float4s of a record; comp: values
// of its component 0 (a multiple of 8, so that 32 * comp values split
// evenly over the 256 threads).
__global__ void __launch_bounds__(kThreads)
    dma_rate(const float4* __restrict__ pool, const int* __restrict__ perm,
             float4* __restrict__ out, int rec4, int comp) {
  extern __shared__ float4 tile[];  // kRateRecords * rec4
  __shared__ int rows[kRateRecords];
  __shared__ float warp_sums[kRateWarps];
  const long long t = blockIdx.x;
  if (threadIdx.x < kRateRecords) rows[threadIdx.x] = perm[t * kRateRecords + threadIdx.x];
  __syncthreads();
  for (int e = threadIdx.x; e < kRateRecords * rec4; e += kThreads) {
    const int j = e / rec4;
    cp_async16(&tile[e], pool + static_cast<long long>(rows[j]) * rec4 + (e - j * rec4));
  }
  cp_async_wait_all();
  __syncthreads();

  const float* vals = reinterpret_cast<const float*>(tile);
  const int rec_floats = 4 * rec4;
  float s = 0.0f;
  for (int e = threadIdx.x; e < kRateRecords * comp; e += kThreads) {
    const int j = e / comp;
    s += vals[j * rec_floats + (e - j * comp)];
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = warp_sums[0];
  for (int w = 1; w < kRateWarps; ++w) total += warp_sums[w];
  const float4 v = make_float4(total, total, total, total);
  for (int e = threadIdx.x; e < kOutTile / 4; e += kThreads) out[t * (kOutTile / 4) + e] = v;
}

template <typename V>
int launch_reorder(bool scatter, const float* src, float* dst, const int* idx, long long n,
                   int pieces, long long width, long long src_ld, long long dst_ld,
                   cudaStream_t s) {
  const long long items = n * width;
  if (n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((items + kThreads - 1) / kThreads),
                  static_cast<unsigned>(pieces));
  const V* vs = reinterpret_cast<const V*>(src);
  V* vd = reinterpret_cast<V*>(dst);
  if (scatter) {
    record_scatter<V><<<grid, kThreads, 0, s>>>(vs, vd, idx, static_cast<unsigned>(items),
                                                static_cast<unsigned>(width), src_ld, dst_ld);
  } else {
    record_gather<V><<<grid, kThreads, 0, s>>>(vs, vd, idx, static_cast<unsigned>(items),
                                               static_cast<unsigned>(width), src_ld, dst_ld);
  }
  return static_cast<int>(cudaGetLastError());
}

int reorder(bool scatter, const float* src, float* dst, const int* idx, long long n,
            int pieces, long long width, long long src_ld, long long dst_ld, int vec4,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * width >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec4) {
    return launch_reorder<float4>(scatter, src, dst, idx, n, pieces, width / 4, src_ld / 4,
                                  dst_ld / 4, s);
  }
  return launch_reorder<float>(scatter, src, dst, idx, n, pieces, width, src_ld, dst_ld, s);
}

}  // namespace

extern "C" {

// Every function launches on `stream` (a cudaStream_t), takes device
// pointers, and returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for a shape it does not take). Widths and strides
// are in floats; with vec4 set they are multiples of 4 and the pointers
// 16-byte aligned. n * width must be below 2^31.

// dst record i = src record idx[i], for i < n; `pieces` planes.
int wrt_record_gather(const float* src, float* dst, const int* idx, long long n, int pieces,
                      long long width, long long src_ld, long long dst_ld, int vec4,
                      void* stream) {
  return reorder(false, src, dst, idx, n, pieces, width, src_ld, dst_ld, vec4, stream);
}

// dst record idx[j] = src record j, for j < n; the indices must not repeat.
int wrt_record_scatter(const float* src, float* dst, const int* idx, long long n, int pieces,
                       long long width, long long src_ld, long long dst_ld, int vec4,
                       void* stream) {
  return reorder(true, src, dst, idx, n, pieces, width, src_ld, dst_ld, vec4, stream);
}

// n_tiles tiles of 32 records of rec_floats floats (a multiple of 4, with
// 32 * rec_floats * 4 bytes at most the 227 KiB a block may hold), the
// records picked by perm [n_tiles * 32]; out [n_tiles * 8, 128] gets each
// tile's sum of the first comp floats of its records.
int wrt_dma_rate(const float* pool, const int* perm, float* out, int n_tiles, int rec_floats,
                 int comp, void* stream) {
  const int smem = kRateRecords * rec_floats * static_cast<int>(sizeof(float));
  if (n_tiles <= 0 || rec_floats % 4 || comp % 8 || comp > rec_floats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err =
      cudaFuncSetAttribute(dma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dma_rate<<<n_tiles, kThreads, smem, s>>>(reinterpret_cast<const float4*>(pool), perm,
                                           reinterpret_cast<float4*>(out), rec_floats / 4,
                                           comp);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes of one kernel, as the CUDA
// runtime reports them; returns a cudaError_t. `which`: 0/1 record_gather
// float/float4, 2/3 record_scatter float/float4, 4 dma_rate.
int wrt_reorder_attributes(int which, int* num_regs, int* local_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(record_gather<float>),
      reinterpret_cast<const void*>(record_gather<float4>),
      reinterpret_cast<const void*>(record_scatter<float>),
      reinterpret_cast<const void*>(record_scatter<float4>),
      reinterpret_cast<const void*>(dma_rate),
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
