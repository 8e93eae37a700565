// Stride-1 27-tap octree convolutions by direct neighbour gather, forward
// and backward, for Hopper (sm_90a). neigh[b, n, k] is the row of node n's
// k-th neighbour within sample b, -1 where there is none (contributes 0).
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
//
// octree_dwconv_bwd (K4) and octree_conv_bwd (K6) replace
//   band_conv.py:_dw_bwd_kernel and _conv_bwd_kernel with their escape
//   patches (_banded_dwconv_bwd, _banded_conv_bwd). dx reuses the forward
//   bodies through the stencil flip identity, as the TPU kernels do. The
//   weight gradient is a reduction over all B*N rows: on the TPU a grid
//   carried it in VMEM from step to step; here blocks run in parallel, so
//   each writes a partial over its split of rows and a second small
//   kernel adds the splits in a fixed order (deterministic, no atomics).
//   Bound on the H100: K4 by bytes (x, dy read, dx written), K6 at
//   C = O = 128 by fp32 CUDA-core operations (4 * 27 * C * O per node).
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

// ---- backward weight gradients -------------------------------------------
// Both reduce over all B*N rows. Block p of the grid sums a contiguous
// split of rows into a per-split partial in device memory; sum_parts_kernel
// then adds the splits in a fixed order, so the result is deterministic.

constexpr int kDwCT = 64;   // channels per block (one thread each)
constexpr int kDwRG = 4;    // row groups per block: 4 x 64 = 256 threads

// partial[p, k, c] = sum_{r in split p} x[src(r, k), c] * dy[r, c]
template <typename T>
__global__ void __launch_bounds__(256)
dwconv_dw_partial_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                         const T* __restrict__ dy, float* __restrict__ partial,
                         int N, int C, long long rows, long long per_part) {
  __shared__ float red[kDwRG][kTaps][kDwCT];
  const int cl = threadIdx.x % kDwCT, grp = threadIdx.x / kDwCT;
  const int c = blockIdx.y * kDwCT + cl;
  const long long r0 = (long long)blockIdx.x * per_part;
  const long long r1 = min(rows, r0 + per_part);
  float acc[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc[k] = 0.f;
  if (c < C) {
    for (long long r = r0 + grp; r < r1; r += kDwRG) {
      const float d = to_f(dy[r * C + c]);
      const long long sb = (r / N) * N;
      const int* nr = neigh + r * kTaps;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int j = __ldg(nr + k);
        if (j >= 0) acc[k] = fmaf(to_f(x[(sb + j) * C + c]), d, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) red[grp][k][cl] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < kTaps * kDwCT; i += blockDim.x) {
    const int k = i / kDwCT, cc = i - k * kDwCT;
    const int cg = blockIdx.y * kDwCT + cc;
    if (cg < C)
      partial[((size_t)blockIdx.x * kTaps + k) * C + cg] =
          red[0][k][cc] + red[1][k][cc] + red[2][k][cc] + red[3][k][cc];
  }
}

constexpr int kWC = 64;     // input channels per block tile
constexpr int kWO = 64;     // output channels per block tile
constexpr int kWR = 16;     // rows per shared-memory chunk

// partial[p, k, c, o] = sum_{r in split p} x[src(r, k), c] * dy[r, o]:
// one block per (C x O tile, tap k, split p), 256 threads with a 4 x 4
// register tile each. Chunks of 16 rows whose tap-k neighbours are all
// missing are skipped (sparse taps at the fine depths).
template <typename T>
__global__ void __launch_bounds__(256)
conv_dw_partial_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                       const T* __restrict__ dy, float* __restrict__ partial,
                       int N, int C, int O, int otiles, long long rows,
                       long long per_part) {
  __shared__ __align__(16) float xs[kWR][kWC];
  __shared__ __align__(16) float ds[kWR][kWO];
  __shared__ long long src[kWR];
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // outputs tx*4 .. tx*4+3
  const int ty = tid >> 4;         // channels ty*4 .. ty*4+3
  const int o0 = (blockIdx.x % otiles) * kWO;
  const int c0 = (blockIdx.x / otiles) * kWC;
  const int k = blockIdx.y;
  const int p = blockIdx.z;
  const long long r_beg = (long long)p * per_part;
  const long long r_end = min(rows, r_beg + per_part);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_beg; r0 < r_end; r0 += kWR) {
    bool valid = false;
    if (tid < kWR) {
      const long long r = r0 + tid;
      long long s = -1;
      if (r < r_end) {
        const int j = __ldg(neigh + r * kTaps + k);
        if (j >= 0) s = (r / N) * N + j;
      }
      src[tid] = s;
      valid = s >= 0;
    }
    if (!__syncthreads_or(valid)) continue;
    for (int i = tid; i < kWR * kWC; i += 256) {
      const int rr = i / kWC, cc = i - rr * kWC;
      const long long s = src[rr];
      const int c = c0 + cc;
      xs[rr][cc] = (s >= 0 && c < C) ? to_f(x[s * C + c]) : 0.f;
    }
    for (int i = tid; i < kWR * kWO; i += 256) {
      const int rr = i / kWO, oo = i - rr * kWO;
      const int o = o0 + oo;
      ds[rr][oo] = (src[rr] >= 0 && o < O) ? to_f(dy[(r0 + rr) * O + o])
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWR; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[rr][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)p * kTaps + k) * C * O;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < O) out[(size_t)c * O + o] = acc[i][j];
    }
  }
}

// out[i] = sum_p partial[p, i], p in order.
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int parts, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += partial[(size_t)p * n + i];
    out[i] = s;
  }
}

cudaError_t launch_sum(const float* partial, float* out, int parts,
                       long long n, cudaStream_t stream) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  sum_parts_kernel<<<(unsigned)blocks, 256, 0, stream>>>(partial, out, parts,
                                                          n);
  return cudaGetLastError();
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

namespace {

template <typename T>
cudaError_t dwconv_bwd(const void* x, const int* neigh, const void* wflip,
                       const void* dy, void* dx, float* partial, float* dw,
                       int B, int N, int C, int parts, int vec,
                       cudaStream_t s) {
  if (dx) {
    constexpr int V = 16 / sizeof(T);
    const cudaError_t e =
        vec ? launch_dw<T, V>(dy, neigh, wflip, dx, B, N, C, s)
            : launch_dw<T, 1>(dy, neigh, wflip, dx, B, N, C, s);
    if (e != cudaSuccess) return e;
  }
  const long long rows = (long long)B * N;
  const long long per_part = (rows + parts - 1) / parts;
  const dim3 grid((unsigned)parts, (C + kDwCT - 1) / kDwCT);
  dwconv_dw_partial_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(dy), partial, N,
      C, rows, per_part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum(partial, dw, parts, (long long)kTaps * C, s);
}

template <typename T>
cudaError_t conv_bwd(const void* x, const int* neigh, const void* wft,
                     const void* dy, void* dx, float* partial, float* dw,
                     int B, int N, int C, int O, int parts, cudaStream_t s) {
  if (dx) {
    const cudaError_t e = launch_conv<T>(dy, neigh, wft, nullptr, dx, B, N,
                                         O, C, s);
    if (e != cudaSuccess) return e;
  }
  const long long rows = (long long)B * N;
  const long long per_part = (rows + parts - 1) / parts;
  const int otiles = (O + kWO - 1) / kWO;
  const dim3 grid((unsigned)(otiles * ((C + kWC - 1) / kWC)), kTaps,
                  (unsigned)parts);
  conv_dw_partial_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(dy), partial, N,
      C, O, otiles, rows, per_part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum(partial, dw, parts, (long long)kTaps * C * O, s);
}

}  // namespace

// K4, the backward of octree_dwconv_fwd. x, dy: (B, N, C); wflip: (27, C)
// = w[::-1] in x's dtype. dx (null to skip) = dwconv(dy, neigh, w[::-1]),
// the stencil flip identity (neigh[m, k] = n <=> neigh[n, 26 - k] = m; every
// padding row of neigh is -1), run by the forward kernel's body.
// dw (27, C) float32 = sum over rows of x[src(r, k)] * dy[r], through
// partial (parts, 27, C) float32 scratch. vec as for octree_dwconv_fwd,
// for dy. Returns cudaError_t.
extern "C" int octree_dwconv_bwd(const void* x, const void* neigh,
                                 const void* wflip, const void* dy, void* dx,
                                 void* partial, void* dw, int B, int N, int C,
                                 int parts, int dtype, int vec, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  float* pt = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dwconv_bwd<float>(x, nb, wflip, dy, dx, pt, out, B, N, C, parts,
                             vec, s);
  if (dtype == 1)
    return dwconv_bwd<__nv_bfloat16>(x, nb, wflip, dy, dx, pt, out, B, N, C,
                                     parts, vec, s);
  return cudaErrorInvalidValue;
}

// K6, the backward of octree_conv_fwd (without db, a plain sum the caller
// takes). x: (B, N, C); dy: (B, N, O); wft: (27, O, C) = swap(w[::-1], 1, 2)
// in x's dtype. dx (null to skip) = conv(dy, neigh, wft) by the forward
// kernel's body; dw (27, C, O) float32 through partial (parts, 27, C, O)
// float32 scratch. Returns cudaError_t.
extern "C" int octree_conv_bwd(const void* x, const void* neigh,
                               const void* wft, const void* dy, void* dx,
                               void* partial, void* dw, int B, int N, int C,
                               int O, int parts, int dtype, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  float* pt = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts < 1 || parts > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return conv_bwd<float>(x, nb, wft, dy, dx, pt, out, B, N, C, O, parts, s);
  if (dtype == 1)
    return conv_bwd<__nv_bfloat16>(x, nb, wft, dy, dx, pt, out, B, N, C, O,
                                   parts, s);
  return cudaErrorInvalidValue;
}
