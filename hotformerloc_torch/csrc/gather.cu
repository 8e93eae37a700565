// Row gathers of the on-chip probe tools, for Hopper (sm_90a).
//
// take_rows -- out[b, t, :] = x[b, clamp(idx[b, t], 0, Nx - 1), :]
//   Replaces the TPU probes hotformerloc_tpu/tools/gather_bench.py:k_take
//   (one tap of the depthwise conv's gather, x resident in VMEM, a missing
//   tap -1 read as row 0) and mosaic_probe.py:k_take, k_jtake, k_rowloop
//   and k_tiled (four layouts of the same row gather). On the TPU these
//   asked how a row gather can be written at all inside a kernel; on a GPU
//   a row gather is the native operation, so one kernel serves all five.
//   Bound on the H100: bytes (no arithmetic). Design: one warp per output
//   row, each lane moving 16-byte vectors, so a warp reads one gathered row
//   as a coalesced burst of up to 512 bytes; the kernel copies bytes and so
//   serves fp32 and bf16 alike. The indices may be a strided view (column
//   0 of a (B, N, 27) neighbour table), read in place.
//
// dwconv_resident -- out[b,n,c] = sum_k w[k,c] x[b, neigh[b,n,k], c]
//   Replaces gather_bench.py:k_dw, the TPU formulation of the depthwise
//   octree conv that keeps all of x resident on chip and gathers from
//   there. It keeps that design question: one block per (sample, channel
//   slice) loads x[b, :, slice] into shared memory once (16 bf16 or 8 fp32
//   channels of 4224 rows = 135 KB, beside the slice's 27 weights in fp32)
//   and walks all N nodes x 27 taps, gathering from shared memory with fp32
//   accumulation; a missing tap (-1) contributes 0. Bound on the H100:
//   bytes (x and neigh read, out written). It is the same function as K3
//   (octree_conv.cu:octree_dwconv_fwd), which gathers from device memory
//   through L1/L2; the two times at one shape are what this probe is for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// rows = B * TN output rows of vecs 16-byte vectors each; idx[r * istride]
// is the source row of output row r within its sample.
__global__ void __launch_bounds__(256)
take_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                 uint4* __restrict__ out, int Nx, int TN, int vecs,
                 int istride, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < rows; r += nwarps) {
    const long long b = r / TN;
    int j = __ldg(idx + r * istride);
    j = j < 0 ? 0 : (j >= Nx ? Nx - 1 : j);
    const uint4* src = x + (b * Nx + j) * vecs;
    uint4* dst = out + r * vecs;
    for (int v = lane; v < vecs; v += 32) dst[v] = __ldg(src + v);
  }
}

// grid (C / slice, B); slice = nvec 16-byte vectors of channels. Dynamic
// shared memory: N * nvec vectors of x, then 27 * slice fp32 weights.
template <typename T>
__global__ void __launch_bounds__(512)
dwconv_resident_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                       const T* __restrict__ w, T* __restrict__ out, int N,
                       int C, int nvec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ uint4 xs[];
  const int S = nvec * V;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * S;
  float* ws = reinterpret_cast<float*>(xs + (size_t)N * nvec);
  const T* xb = x + (size_t)b * N * C + c0;
  const int items = N * nvec;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int n = i / nvec, v = i - n * nvec;
    xs[i] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)n * C) + v);
  }
  for (int i = threadIdx.x; i < kTaps * S; i += blockDim.x) {
    const int k = i / S, c = i - k * S;
    ws[i] = to_f(w[k * C + c0 + c]);
  }
  __syncthreads();
  const int* nb = neigh + (size_t)b * N * kTaps;
  T* ob = out + (size_t)b * N * C + c0;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int n = i / nvec, v = i - n * nvec;
    const int* nr = nb + (size_t)n * kTaps;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int k = 0; k < kTaps; ++k) {
      const int j = __ldg(nr + k);
      if ((unsigned)j >= (unsigned)N) continue;        // -1: missing tap
      const uint4 raw = xs[j * nvec + v];
      const T* e = reinterpret_cast<const T*>(&raw);
      const float* wk = ws + k * S + v * V;
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = fmaf(wk[q], to_f(e[q]), acc[q]);
    }
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int q = 0; q < V; ++q) e[q] = from_f<T>(acc[q]);
    reinterpret_cast<uint4*>(ob + (size_t)n * C)[v] = raw;
  }
}

template <typename T>
cudaError_t launch_resident(const void* x, const int* neigh, const void* w,
                            void* out, int B, int N, int C, int nvec,
                            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = (size_t)N * nvec * 16 + sizeof(float) * kTaps * nvec * V;
  cudaError_t e = cudaFuncSetAttribute(
      dwconv_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(C / (nvec * V)), (unsigned)B);
  dwconv_resident_kernel<T><<<grid, 512, smem, s>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(w),
      static_cast<T*>(out), N, C, nvec);
  return cudaGetLastError();
}

}  // namespace

// x: (B, Nx, C) with rows of vecs 16-byte vectors (16-byte aligned); idx:
// B * TN indices, the t-th of sample b at idx[(b * TN + t) * istride];
// out: (B, TN, C). Returns cudaError_t.
extern "C" int take_rows(const void* x, const void* idx, void* out, int B,
                         int Nx, int TN, int vecs, int istride,
                         void* stream) {
  if (B < 1 || Nx < 1 || TN < 1 || vecs < 1 || istride < 1)
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * TN;
  long long blocks = (rows + 7) / 8;                  // 8 warps per block
  if (blocks > 132 * 16) blocks = 132 * 16;           // warp-stride beyond
  take_rows_kernel<<<(unsigned)blocks, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(idx),
      static_cast<uint4*>(out), Nx, TN, vecs, istride, rows);
  return cudaGetLastError();
}

// x: (B, N, C); neigh: (B, N, 27) int32; w: (27, C) in x's dtype; out:
// (B, N, C). nvec: 16-byte vectors of channels per slice (C is a multiple
// of the slice); the wrapper picks it so the slice fits shared memory.
// dtype 0 = float32, 1 = bfloat16. Returns cudaError_t; an oversized
// shared-memory request is refused here, not silently.
extern "C" int dwconv_resident(const void* x, const void* neigh,
                               const void* w, void* out, int B, int N, int C,
                               int nvec, int dtype, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || nvec < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_resident<float>(x, nb, w, out, B, N, C, nvec, s);
  if (dtype == 1)
    return launch_resident<__nv_bfloat16>(x, nb, w, out, B, N, C, nvec, s);
  return cudaErrorInvalidValue;
}
