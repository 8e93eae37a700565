// Row gathers of the on-chip probe tools, for Hopper (sm_90a).
//
// take_rows -- out[b, t, :] = x[b, clamp(idx[b, t], 0, Nx - 1), :]
//   Replaces the TPU probes hotformerloc_tpu/tools/gather_bench.py:k_take
//   (one tap of the depthwise conv's gather, x resident in VMEM, a missing
//   tap -1 read as row 0) and mosaic_probe.py:k_take, k_jtake, k_rowloop
//   and k_tiled (four layouts of the same row gather). On the TPU these
//   asked how a row gather can be written at all inside a kernel; on a GPU
//   a row gather is the native operation, so one kernel serves all five.
//   Bound on the H100: bytes (no arithmetic). At the probes' shapes (0.5-1
//   MB moved) a call is the launch plus two dependent memory latencies
//   (index, then row), so the design keeps each to one round trip and the
//   work between them short. The output is taken as one flat run of rows *
//   vecs 16-byte vectors; each warp copies a span of 32 * U of them (U
//   vectors a lane, lane l taking vectors l, l + 32, ...), so a row of any
//   width, 9 vectors or 64, keeps every lane busy and every store is a
//   contiguous 512-byte burst. The launch plan (ops/kernels/gather.py:
//   take_plan) takes blocks of 4 warps (fewer, larger blocks launched
//   faster than more, smaller ones reaching every SM) and the largest U
//   that still gives each of the card's 132 SMs a block. A warp first
//   reads the indices of all the rows its span touches (at most 32) in one
//   load, one index a lane, clamped and turned into a source row there;
//   each vector's lane then takes its row's source by __shfl_sync. Every
//   lane issues all of its U row loads before its first store. The indices
//   are read once (ld.global.nc.L1::no_allocate) and the output is never
//   read again (st.global.cs); the rows are read through L1, because a
//   neighbour table's missing taps all read row 0 (over half of T1's), and
//   on the H100 T1 ran slower with row loads that bypass L1. The kernel
//   copies bytes, so fp32 and bf16 share one body. The indices may be a
//   strided view (column 0 of a (B, N, 27) neighbour table), read in place.
//
// dwconv_resident -- out[b,n,c] = sum_k w[k,c] x[b, neigh[b,n,k], c]
//   Replaces gather_bench.py:k_dw, the TPU formulation of the depthwise
//   octree conv that keeps all of x resident on chip and gathers from
//   there. It keeps that idea and builds it the Hopper way: a cluster of
//   CTAs holds x[b, :, slice] in its blocks' shared memory, split by rows
//   (block rank r holds rows [r * rows, (r + 1) * rows)), loaded by
//   cp.async.bulk (one copy for a block's rows when the slice is whole
//   rows, else one per row) completing on an mbarrier. After a cluster
//   barrier each block computes its own rows' outputs: for each valid tap
//   (listed once per row in shared memory) it reads the neighbour row from
//   the block that holds it through distributed shared memory, with fp32
//   accumulation in tap order 0..26 and one rounding to the output dtype;
//   a missing tap (-1) contributes 0. A block reads only its own nodes'
//   neighbour-table rows, so a call
//   reads the table once per channel slice (once with a cluster of 16 at
//   bf16, twice with 8), where the design before (one block per sample
//   and 16-channel slice) read it 16 times. A second cluster barrier keeps
//   each block's shared memory alive while the others read it. The plan
//   (cluster size, channel slice, rows per block) is the wrapper's
//   (ops/kernels/gather.py:resident_plan). Bound on the H100: bytes (x and
//   neigh read, out written). It is the same function as K3
//   (octree_conv.cu:octree_dwconv_fwd), which gathers from device memory
//   through L1/L2; the two times at one shape are what this probe is for.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kTaps = 27;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int ld_once(const int* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p));
  return v;
}
__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// total = B * TN * vecs output vectors (< 2^31), row r of vecs of them;
// idx[r * istride] is the source row of output row r within its sample.
// The plan keeps 32 * U < 31 * vecs + 2, so a span touches at most 32
// rows. Offsets are 32-bit: what precedes the first row load is the
// latency of a call at the probes' sizes, so it is kept short.
template <int U>
__global__ void __launch_bounds__(128)
take_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                 uint4* __restrict__ out, unsigned Nx, unsigned TN,
                 unsigned vecs, unsigned istride, unsigned total) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned s = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32 * U;
  if (s >= total) return;                      // the whole warp together
  const unsigned row0 = s / vecs, lead = s - row0 * vecs;
  const unsigned r = row0 + lane;
  unsigned src = 0;                            // sample b's row j: b * Nx + j
  if (lane * vecs <= lead + 32 * U - 1 && (size_t)r * vecs < total) {
    const int j = ld_once(idx + (size_t)r * istride);
    src = r / TN * Nx + (j < 0 ? 0u : (unsigned)j >= Nx ? Nx - 1 : j);
  }
  // lane's k-th vector: flat s + lane + 32 k = row row0 + rel, vector v
  const unsigned q32 = 32 / vecs, r32 = 32 - q32 * vecs;
  unsigned rel = (lead + lane) / vecs;
  unsigned v = lead + lane - rel * vecs;
  uint4 buf[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const unsigned sr = __shfl_sync(0xffffffffu, src, rel & 31);
    if (s + lane + 32 * k < total)
      buf[k] = __ldg(x + (size_t)sr * vecs + v);
    v += r32;
    rel += q32;
    if (v >= vecs) {
      v -= vecs;
      ++rel;
    }
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const unsigned f = s + lane + 32 * k;
    if (f < total) st_stream(out + f, buf[k]);
  }
}

template <int U>
cudaError_t launch_take(const void* x, const void* idx, void* out, int Nx,
                        int TN, int vecs, int istride, unsigned total,
                        int threads, long long blocks, cudaStream_t s) {
  take_rows_kernel<U><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(idx),
      static_cast<uint4*>(out), Nx, TN, vecs, istride, total);
  return cudaGetLastError();
}

constexpr int kResidentThreads = 512;
constexpr int kMaxCluster = 16;       // non-portable cluster size limit

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// bytes (a multiple of 16) from global src to this block's shared dst,
// completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// count 4-byte words from global src to shared dst (16-byte aligned): by
// 16-byte cp.async where src is 16-byte aligned too, else word by word.
__device__ __forceinline__ void stage_words(int* dst, const int* src,
                                            int count) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    i0 = count & ~3;
    for (int i = 4 * threadIdx.x; i < i0; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i);
  }
  for (int i = i0 + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

// Dynamic shared memory of a block: rows x S elements of x, 27 x S
// weights, the rows' valid-tap lists (27 words a row) and counts, the
// mbarrier. rows is a multiple of 4, so every part starts 16-byte aligned.
template <typename T>
size_t resident_smem(int S, int rows) {
  return (size_t)rows * S * sizeof(T) + sizeof(T) * kTaps * S +
         sizeof(int) * (size_t)(kTaps + 1) * rows + 8;
}

// grid (cluster * C / S, B), clusters of (cluster, 1, 1) blocks: cluster
// blockIdx.x / cluster holds channels [c0, c0 + S) of sample blockIdx.y,
// its block of rank r rows [r * rows, min(N, (r + 1) * rows)). x comes in
// by cp.async.bulk (one copy when the slice is whole rows, else one per
// row); the block's neighbour rows and weights by cp.async. Each row's
// valid taps are then listed once, in tap order, as (tap, owner block,
// row in the owner), so the gathers walk valid taps only. A thread takes
// (row, 16-byte vector) items, so a warp's gathers of one tap read a
// neighbour row's slice as one burst.
template <typename T>
__global__ void __launch_bounds__(kResidentThreads)
dwconv_resident_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                       const T* __restrict__ w, T* __restrict__ out, int N,
                       int C, int S, int rows) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = (int)(blockIdx.x / cluster.num_blocks()) * S;
  const int b = blockIdx.y;
  const int nvec = S / V;
  uint4* xs = reinterpret_cast<uint4*>(smem_raw);
  uint4* ws = xs + (size_t)rows * nvec;                 // (27, nvec)
  int* taps = reinterpret_cast<int*>(ws + kTaps * nvec); // (rows, 27)
  int* cnt = taps + (size_t)kTaps * rows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(cnt + rows);
  const int r0 = rank * rows;
  const int own = max(0, min(rows, N - r0));
  const T* xb = x + ((size_t)b * N + r0) * C + c0;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_arrive_expect_tx(bar, (uint32_t)(own * S * sizeof(T)));
  }
  __syncthreads();
  // the tap lists are built while x is still arriving, so the neighbour
  // rows and weights are asked for first
  stage_words(taps, neigh + ((size_t)b * N + r0) * kTaps, own * kTaps);
  for (int i = threadIdx.x; i < kTaps * nvec; i += blockDim.x) {
    const int k = i / nvec;
    cp_async16(ws + i,
               reinterpret_cast<const uint4*>(w + (size_t)k * C + c0) +
                   (i - k * nvec));
  }
  if (S == C) {                        // the block's rows are contiguous
    if (threadIdx.x == 0 && own > 0)
      bulk_load(xs, xb, (uint32_t)(own * S * sizeof(T)), bar);
  } else {
    for (int n = threadIdx.x; n < own; n += blockDim.x)
      bulk_load(xs + (size_t)n * nvec, xb + (size_t)n * C,
                (uint32_t)(S * sizeof(T)), bar);
  }
  cp_async_wait_all();
  __syncthreads();
  // list each row's valid taps in tap order, a warp per row:
  // (tap << 27) | (owner << 23) | row in the owner (cluster <= 16, rows <
  // 2^23)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < own; n += blockDim.x >> 5) {
    int* t = taps + n * kTaps;
    const int j = lane < kTaps ? t[lane] : -1;
    const bool ok = (unsigned)j < (unsigned)N;     // -1: missing tap
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    __syncwarp();
    if (ok) {
      const int owner = j / rows;
      t[__popc(m & ((1u << lane) - 1))] =
          (int)(((unsigned)lane << 27) | ((unsigned)owner << 23) |
                (unsigned)(j - owner * rows));
    }
    if (lane == 0) cnt[n] = __popc(m);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  cluster.sync();                      // every block's rows are loaded

  T* ob = out + ((size_t)b * N + r0) * C + c0;
  for (int i = threadIdx.x; i < own * nvec; i += blockDim.x) {
    const int n = i / nvec, v = i - n * nvec;
    const int* t = taps + n * kTaps;
    const int c = cnt[n];
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int u = 0; u < c; ++u) {
      const unsigned p = (unsigned)t[u];
      const int owner = (int)((p >> 23) & 15u);
      const uint4* src = owner == rank ? xs
                                       : cluster.map_shared_rank(xs, owner);
      const uint4 raw = src[(size_t)(p & 0x7fffffu) * nvec + v];
      const uint4 wraw = ws[(p >> 27) * nvec + v];
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* wk = reinterpret_cast<const T*>(&wraw);
#pragma unroll
      for (int q = 0; q < V; ++q)
        acc[q] = fmaf(to_f(wk[q]), to_f(e[q]), acc[q]);
    }
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int q = 0; q < V; ++q) e[q] = from_f<T>(acc[q]);
    reinterpret_cast<uint4*>(ob + (size_t)n * C)[v] = raw;
  }
  cluster.sync();                      // others may still read our rows
}

// The launch configuration of a plan; sets the kernel's attributes.
template <typename T>
cudaError_t resident_config(cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr, int B, int C,
                            int cluster, int S, int rows, cudaStream_t s) {
  const size_t smem = resident_smem<T>(S, rows);
  cudaError_t e = cudaFuncSetAttribute(
      dwconv_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(dwconv_resident_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(cluster * (C / S)), (unsigned)B, 1);
  cfg->blockDim = dim3(kResidentThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_resident(const void* x, const int* neigh, const void* w,
                            void* out, int B, int N, int C, int cluster,
                            int S, int rows, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resident_config<T>(&cfg, &attr, B, C, cluster, S, rows, s);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, dwconv_resident_kernel<T>,
                         static_cast<const T*>(x), neigh,
                         static_cast<const T*>(w), static_cast<T*>(out), N,
                         C, S, rows);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t active_resident(int* count, int C, int cluster, int S,
                            int rows) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resident_config<T>(&cfg, &attr, 1, C, cluster, S, rows, 0);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(count, dwconv_resident_kernel<T>,
                                        &cfg);
}

// A plan the kernel takes: whole 16-byte vectors per row slice, the
// slices tiling C, the blocks' rows covering N.
inline bool resident_plan_ok(int N, int C, int cluster, int S, int rows,
                             int esz) {
  return N >= 1 && C >= 1 && cluster >= 1 && cluster <= kMaxCluster &&
         S >= 1 && C % S == 0 && (S * esz) % 16 == 0 && rows >= 4 &&
         rows % 4 == 0 && rows < (1 << 23) &&
         (long long)rows * cluster >= N;
}

}  // namespace

// x: (B, Nx, C) with rows of vecs 16-byte vectors (16-byte aligned); idx:
// B * TN indices, the t-th of sample b at idx[(b * TN + t) * istride];
// out: (B, TN, C) of fewer than 2^31 vectors. The plan (ops/kernels/
// gather.py:take_plan): per_lane vectors a lane (1, 2, 4 or 8), blocks of
// threads (a multiple of 32, at most 128), as many as cover every vector.
// Returns cudaError_t; another plan, or one whose warps span more than 32
// rows, is refused.
extern "C" int take_rows(const void* x, const void* idx, void* out, int B,
                         int Nx, int TN, int vecs, int istride, int per_lane,
                         int threads, long long blocks, void* stream) {
  if (B < 1 || Nx < 1 || TN < 1 || vecs < 1 || istride < 1 ||
      (long long)B * Nx > 0x7fffffffLL || threads < 32 || threads > 128 ||
      threads % 32 || per_lane < 1 || 32LL * per_lane >= 31LL * vecs + 2)
    return cudaErrorInvalidValue;
  const long long total = (long long)B * TN * vecs;
  const long long warps = (total + 32LL * per_lane - 1) / (32LL * per_lane);
  if (total > 0x7fffffffLL || blocks != (warps + threads / 32 - 1) /
                                            (threads / 32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_lane) {
    case 1: return launch_take<1>(x, idx, out, Nx, TN, vecs, istride, total,
                                  threads, blocks, s);
    case 2: return launch_take<2>(x, idx, out, Nx, TN, vecs, istride, total,
                                  threads, blocks, s);
    case 4: return launch_take<4>(x, idx, out, Nx, TN, vecs, istride, total,
                                  threads, blocks, s);
    case 8: return launch_take<8>(x, idx, out, Nx, TN, vecs, istride, total,
                                  threads, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: (B, N, C), 16-byte aligned; neigh: (B, N, 27) int32; w: (27, C) in
// x's dtype; out: (B, N, C). The plan (ops/kernels/gather.py:
// resident_plan): clusters of `cluster` blocks, each cluster a channel
// slice of S channels of one sample, each block `rows` rows of it. dtype
// 0 = float32, 1 = bfloat16. Returns cudaError_t; a plan the card cannot
// take (shared memory, cluster size) is refused here, not silently.
extern "C" int dwconv_resident(const void* x, const void* neigh,
                               const void* w, void* out, int B, int N, int C,
                               int cluster, int S, int rows, int dtype,
                               void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esz = dtype == 0 ? 4 : 2;
  if (B < 1 || (dtype != 0 && dtype != 1) ||
      !resident_plan_ok(N, C, cluster, S, rows, esz))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_resident<float>(x, nb, w, out, B, N, C, cluster, S, rows,
                                  s);
  return launch_resident<__nv_bfloat16>(x, nb, w, out, B, N, C, cluster, S,
                                        rows, s);
}

// *count = cudaOccupancyMaxActiveClusters of a plan: how many of its
// clusters the card holds at once. Returns cudaError_t.
extern "C" int dwconv_resident_active_clusters(int N, int C, int cluster,
                                               int S, int rows, int dtype,
                                               int* count) {
  const int esz = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) ||
      !resident_plan_ok(N, C, cluster, S, rows, esz))
    return cudaErrorInvalidValue;
  if (dtype == 0) return active_resident<float>(count, C, cluster, S, rows);
  return active_resident<__nv_bfloat16>(count, C, cluster, S, rows);
}
