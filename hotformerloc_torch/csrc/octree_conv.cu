// Stride-1 27-tap octree convolutions by direct neighbour gather, forward
// only, for Hopper (sm_90a). neigh[b, n, k] is the row of node n's k-th
// neighbour within sample b, -1 where there is none (contributes 0).
//
// octree_dwconv_fwd -- depthwise:  out[b,n,c] = sum_k w[k,c] x[b, neigh[b,n,k], c]
//   Replaces hotformerloc_tpu/ops/pallas/band_conv.py:_dw_fwd_kernel together
//   with its escape patch (_esc_dw_rows, _place; entry banded_dwconv).
//   Bound on the H100: bytes. 27 multiply-adds per gathered element; the
//   least time reads x once and writes out once. Design: one thread per
//   (node, vector of 4 fp32 / 8 bf16 channels), channels contiguous so the
//   threads of a node read one gathered row as a coalesced 16-byte-per-lane
//   load; the (27, C) weights sit in shared memory as fp32. Neighbouring
//   nodes share most neighbours (z-order), so repeated rows hit L1/L2. The
//   TPU kernel's halo band and escape list only existed because a TPU
//   kernel cannot gather rows from HBM cheaply; a direct gather needs
//   neither and is exact for every table.
//
// octree_conv_fwd -- full (gather-GEMM):
//   out[b,n,o] = sum_{k,c} w[k,c,o] x[b, neigh[b,n,k], c] + bias[o]
//   Replaces band_conv.py:_conv_fwd_kernel with its escape patch
//   (_esc_conv_rows, _place; entry banded_conv).
//   Bound on the H100: at C = O = 128, 2*27*C*O flops per node against
//   (C + O) elements moved, so fp32 CUDA-core arithmetic (67 TFLOP/s), not
//   bytes, is the limit. Design: a 64-node x 64-output tile per block of
//   256 threads, 4 x 4 outputs per thread in fp32 registers. For each tap
//   the tile's 64 neighbour rows are gathered into shared memory 16
//   channels at a time beside the matching (16, 64) weight slice, then
//   multiplied out. Any C and O (C = 3 at the stem's first conv) work:
//   tiles are zero-padded at the edges. Tensor cores (wgmma) and a
//   pipelined gather are later work.
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

// VEC consecutive elements <-> fp32 registers. VEC * sizeof(T) is 16 bytes
// on the vector path, 1 element on the scalar path.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* r) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = to_f(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* r) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(r[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(r[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
dwconv_fwd_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                  const T* __restrict__ w, T* __restrict__ out, int N, int C,
                  long long rows) {
  extern __shared__ float4 wsm4[];
  float* wsm = reinterpret_cast<float*>(wsm4);
  for (int i = threadIdx.x; i < kTaps * C; i += blockDim.x) wsm[i] = to_f(w[i]);
  __syncthreads();
  const int CV = C / VEC;
  const long long total = rows * CV;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / CV;
    const int c0 = (int)(idx - r * CV) * VEC;
    const long long sample_base = (r / N) * N;
    const int* nr = neigh + r * kTaps;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k = 0; k < kTaps; ++k) {
      const int j = __ldg(nr + k);
      if (j < 0) continue;
      float xv[VEC];
      load_vec<T, VEC>(x + (sample_base + j) * C + c0, xv);
      const float* wk = wsm + k * C + c0;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wk[i], xv[i], acc[i]);
    }
    store_vec<T, VEC>(out + r * C + c0, acc);
  }
}

constexpr int kTN = 64;   // nodes per block tile
constexpr int kTO = 64;   // outputs per block tile
constexpr int kCC = 16;   // channels per shared-memory chunk

template <typename T>
__global__ void __launch_bounds__(256)
conv_fwd_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ out, int N, int C, int O, long long rows) {
  __shared__ __align__(16) float xs[kCC][kTN];
  __shared__ __align__(16) float ws[kCC][kTO];
  __shared__ long long src[kTN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // output group: outputs tx*4 .. tx*4+3
  const int ty = tid >> 4;         // node group: nodes ty*4 .. ty*4+3
  const long long r0 = (long long)blockIdx.y * kTN;
  const int o0 = blockIdx.x * kTO;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kTaps; ++k) {
    if (tid < kTN) {
      const long long r = r0 + tid;
      long long s = -1;
      if (r < rows) {
        const int j = __ldg(neigh + r * kTaps + k);
        if (j >= 0) s = (r / N) * N + j;
      }
      src[tid] = s;
    }
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += kCC) {
      for (int i = tid; i < kTN * kCC; i += 256) {
        const int n = i / kCC, cc = i - n * kCC;
        const long long s = src[n];
        const int c = c0 + cc;
        xs[cc][n] = (s >= 0 && c < C) ? to_f(x[s * C + c]) : 0.f;
      }
      for (int i = tid; i < kCC * kTO; i += 256) {
        const int cc = i / kTO, o = i - cc * kTO;
        const int c = c0 + cc, oo = o0 + o;
        ws[cc][o] = (c < C && oo < O)
                        ? to_f(w[((long long)k * C + c) * O + oo]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[cc][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[cc][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < O)
        out[r * O + o] = from_f<T>(acc[i][j] + (bias ? to_f(bias[o]) : 0.f));
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_dw(const void* x, const int* neigh, const void* w,
                      void* out, int B, int N, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kTaps * C;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dwconv_fwd_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long rows = (long long)B * N;
  const long long total = rows * (C / VEC);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  dwconv_fwd_kernel<T, VEC><<<(unsigned)blocks, 256, smem, stream>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(w),
      static_cast<T*>(out), N, C, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(const void* x, const int* neigh, const void* w,
                        const void* bias, void* out, int B, int N, int C,
                        int O, cudaStream_t stream) {
  const long long rows = (long long)B * N;
  const long long ytiles = (rows + kTN - 1) / kTN;
  if (ytiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((O + kTO - 1) / kTO, (unsigned)ytiles);
  conv_fwd_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), N, C, O, rows);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, N, C) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// neigh: (B, N, 27) int32; w: (27, C) in x's dtype. vec != 0 selects the
// 16-byte vector path (C a multiple of 16 / sizeof(element), pointers
// 16-byte aligned). Returns cudaError_t.
extern "C" int octree_dwconv_fwd(const void* x, const void* neigh,
                                 const void* w, void* out, int B, int N, int C,
                                 int dtype, int vec, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_dw<float, 4>(x, nb, w, out, B, N, C, s)
               : launch_dw<float, 1>(x, nb, w, out, B, N, C, s);
  if (dtype == 1)
    return vec ? launch_dw<__nv_bfloat16, 8>(x, nb, w, out, B, N, C, s)
               : launch_dw<__nv_bfloat16, 1>(x, nb, w, out, B, N, C, s);
  return cudaErrorInvalidValue;
}

// x: (B, N, C); neigh: (B, N, 27) int32; w: (27, C, O) and bias: (O,) or
// null, in x's dtype; out: (B, N, O). Returns cudaError_t.
extern "C" int octree_conv_fwd(const void* x, const void* neigh, const void* w,
                               const void* bias, void* out, int B, int N,
                               int C, int O, int dtype, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_conv<float>(x, nb, w, bias, out, B, N, C, O, s);
  if (dtype == 1)
    return launch_conv<__nv_bfloat16>(x, nb, w, bias, out, B, N, C, O, s);
  return cudaErrorInvalidValue;
}
