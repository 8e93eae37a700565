// The ten building blocks of the fused window attention that the TPU
// probe hotformerloc_tpu/tools/mosaic_probe.py:constructs compiled one by
// one through _run (each a pl.pallas_call asking whether the TPU's Mosaic
// compiler accepts the construct). Here each is a small CUDA kernel that
// computes the same function with the same roundings, for Hopper
// (sm_90a):
//
//   headloop    out[w,t,s] = sum_{h<nh} sum_{d<hd} q[w,t,h*hd+d] k[w,s,h*hd+d]
//               bf16 in, fp32 per-head sums added in head order (k_headloop)
//   reshape     int32 (n,) -> float32 (n, 1)                     (k_reshape)
//   onehot4d    out[i,h] = float(bf16(tab[idx[i],h])), 0 off-table (k_onehot4d)
//   dtab        out[r,h] = sum_{idx[i]=r} float(bf16(g[i,h])), fp32 (k_dtab)
//   pad         (WT,K,K) -> (WT,K+G,K+G), G leading zero rows/cols (k_pad)
//   selloop     out[i] = sum_{r<nsel} [idx[i]=r] tab[r,0]         (k_selloop)
//   softmax     fp32 softmax over the last axis                  (k_softmax)
//   slicestore  out[r,c] = 2 q[r,c] for c < width, bf16       (k_slicestore)
//   dk          out[w,a,b] = sum_t q[w,t,a] k[w,t,b], a,b < hd, fp32 (k_dk)
//   packbias    out[w,t,s] = sum_{d<hd} q[w,t,d] k[w,s,d], fp32 (k_packbias)
//
// Every one is far below launch latency at the probe's shapes (at most
// about 1 MB moved or 10 MFLOP), so each is the plainest correct kernel:
// one thread per output element, or one warp per softmax row; dtab sums
// into shared-memory bins with one global atomic per bin, as K2 sums its
// table gradient. Bound on the H100: bytes for all but the three
// products, whose operation counts are still below a microsecond.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

inline unsigned blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b > 132 * 32) b = 132 * 32;                     // grid-stride beyond
  return (unsigned)(b < 1 ? 1 : b);
}

#define GRID_STRIDE(i, n)                                                    \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;      \
       i < (n); i += (long long)gridDim.x * blockDim.x)

// out[w,t,s] over (WT, Tq, Tk): nh head slices of hd lanes from column 0.
template <int NH>
__global__ void qk_heads_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                float* __restrict__ out, int WT, int T, int C,
                                int hd) {
  const long long n = (long long)WT * T * T;
  GRID_STRIDE(i, n) {
    const int s = (int)(i % T);
    const int t = (int)((i / T) % T);
    const long long w = i / ((long long)T * T);
    const bf16* qr = q + (w * T + t) * C;
    const bf16* kr = k + (w * T + s) * C;
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float part = 0.f;
      for (int d = 0; d < hd; ++d)
        part = fmaf(bf(qr[h * hd + d]), bf(kr[h * hd + d]), part);
      acc += part;
    }
    out[i] = acc;
  }
}

__global__ void reshape_kernel(const int* __restrict__ idx,
                               float* __restrict__ out, long long n) {
  GRID_STRIDE(i, n) out[i] = (float)idx[i];
}

__global__ void onehot4d_kernel(const int* __restrict__ idx,
                                const float* __restrict__ tab,
                                float* __restrict__ out, long long n, int H,
                                int R) {
  GRID_STRIDE(i, n * H) {
    const long long e = i / H;
    const int h = (int)(i - e * H);
    const int r = idx[e];
    out[i] = (r >= 0 && r < R) ? round_bf16(tab[(long long)r * H + h]) : 0.f;
  }
}

// out must be zero on entry. Dynamic shared memory: R * H fp32 bins.
__global__ void dtab_kernel(const int* __restrict__ idx,
                            const float* __restrict__ g,
                            float* __restrict__ out, long long n, int H,
                            int R) {
  extern __shared__ float bins[];
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) bins[i] = 0.f;
  __syncthreads();
  GRID_STRIDE(i, n * H) {
    const long long e = i / H;
    const int h = (int)(i - e * H);
    const int r = idx[e];
    if (r >= 0 && r < R) atomicAdd(&bins[r * H + h], round_bf16(g[i]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * H; i += blockDim.x)
    if (bins[i] != 0.f) atomicAdd(&out[i], bins[i]);
}

__global__ void pad_kernel(const float* __restrict__ in,
                           float* __restrict__ out, int WT, int K, int G) {
  const int P = K + G;
  const long long n = (long long)WT * P * P;
  GRID_STRIDE(i, n) {
    const int j = (int)(i % P);
    const int r = (int)((i / P) % P);
    const long long w = i / ((long long)P * P);
    out[i] = (r >= G && j >= G) ? in[(w * K + (r - G)) * K + (j - G)] : 0.f;
  }
}

__global__ void selloop_kernel(const int* __restrict__ idx,
                               const float* __restrict__ tab,
                               float* __restrict__ out, long long n, int nsel,
                               int H) {
  GRID_STRIDE(i, n) {
    const int r = idx[i];
    float acc = 0.f;
    for (int s = 0; s < nsel; ++s) acc += (r == s) ? tab[s * H] : 0.f;
    out[i] = acc;
  }
}

// One warp per row of L <= 1024 values (the probe's L is 49).
__global__ void softmax_kernel(const float* __restrict__ in,
                               float* __restrict__ out, long long rows,
                               int L) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < rows; r += nwarps) {
    const float* x = in + r * L;
    float m = __int_as_float(0xff800000);          // -inf
    for (int j = lane; j < L; j += 32) m = fmaxf(m, x[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) sum += expf(x[j] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
    for (int j = lane; j < L; j += 32) out[r * L + j] = expf(x[j] - m) * inv;
  }
}

__global__ void slicestore_kernel(const bf16* __restrict__ q,
                                  bf16* __restrict__ out, long long rows,
                                  int C, int width) {
  GRID_STRIDE(i, rows * width) {
    const long long r = i / width;
    const int c = (int)(i - r * width);
    out[i] = __float2bfloat16(bf(q[r * C + c]) * 2.f);
  }
}

__global__ void dk_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          float* __restrict__ out, int WT, int T, int C,
                          int hd) {
  const long long n = (long long)WT * hd * hd;
  GRID_STRIDE(i, n) {
    const int b = (int)(i % hd);
    const int a = (int)((i / hd) % hd);
    const long long w = i / ((long long)hd * hd);
    float acc = 0.f;
    for (int t = 0; t < T; ++t)
      acc = fmaf(bf(q[(w * T + t) * C + a]), bf(k[(w * T + t) * C + b]), acc);
    out[i] = acc;
  }
}

}  // namespace

// Every entry point launches on `stream` and returns cudaError_t.

// q, k: (WT, T, C) bf16; out: (WT, T, T) fp32 over two heads of hd lanes.
extern "C" int construct_headloop(const void* q, const void* k, void* out,
                                  int WT, int T, int C, int hd,
                                  void* stream) {
  const long long n = (long long)WT * T * T;
  qk_heads_kernel<2><<<blocks_for(n, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<float*>(out), WT, T, C, hd);
  return cudaGetLastError();
}

// idx: n int32; out: n fp32.
extern "C" int construct_reshape(const void* idx, void* out, long long n,
                                 void* stream) {
  reshape_kernel<<<blocks_for(n, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<float*>(out), n);
  return cudaGetLastError();
}

// idx: n int32; tab: (R, H) fp32; out: (n, H) fp32.
extern "C" int construct_onehot4d(const void* idx, const void* tab, void* out,
                                  long long n, int H, int R, void* stream) {
  onehot4d_kernel<<<blocks_for(n * H, 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(tab),
      static_cast<float*>(out), n, H, R);
  return cudaGetLastError();
}

// idx: n int32; g: (n, H) fp32; out: (R, H) fp32, zero on entry.
extern "C" int construct_dtab(const void* idx, const void* g, void* out,
                              long long n, int H, int R, void* stream) {
  const size_t smem = sizeof(float) * (size_t)R * H;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  long long blocks = (n * H + 1023) / 1024;
  if (blocks > 132) blocks = 132;                     // one bin set per SM
  dtab_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), 256, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(g),
      static_cast<float*>(out), n, H, R);
  return cudaGetLastError();
}

// in: (WT, K, K) fp32; out: (WT, K+G, K+G) fp32.
extern "C" int construct_pad(const void* in, void* out, int WT, int K, int G,
                             void* stream) {
  const long long n = (long long)WT * (K + G) * (K + G);
  pad_kernel<<<blocks_for(n, 256), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), WT, K, G);
  return cudaGetLastError();
}

// idx: n int32; tab: (>= nsel, H) fp32; out: n fp32.
extern "C" int construct_selloop(const void* idx, const void* tab, void* out,
                                 long long n, int nsel, int H, void* stream) {
  selloop_kernel<<<blocks_for(n, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(tab),
      static_cast<float*>(out), n, nsel, H);
  return cudaGetLastError();
}

// in, out: (rows, L) fp32.
extern "C" int construct_softmax(const void* in, void* out, long long rows,
                                 int L, void* stream) {
  softmax_kernel<<<blocks_for(rows * 32, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), rows, L);
  return cudaGetLastError();
}

// q: (rows, C) bf16; out: (rows, width) bf16.
extern "C" int construct_slicestore(const void* q, void* out, long long rows,
                                    int C, int width, void* stream) {
  slicestore_kernel<<<blocks_for(rows * width, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(out), rows, C, width);
  return cudaGetLastError();
}

// q, k: (WT, T, C) bf16; out: (WT, hd, hd) fp32.
extern "C" int construct_dk(const void* q, const void* k, void* out, int WT,
                            int T, int C, int hd, void* stream) {
  const long long n = (long long)WT * hd * hd;
  dk_kernel<<<blocks_for(n, 256), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<float*>(out), WT, T, C, hd);
  return cudaGetLastError();
}

// q, k: (WT, T, C) bf16; out: (WT, T, T) fp32 over the first hd lanes.
extern "C" int construct_packbias(const void* q, const void* k, void* out,
                                  int WT, int T, int C, int hd,
                                  void* stream) {
  const long long n = (long long)WT * T * T;
  qk_heads_kernel<1><<<blocks_for(n, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<float*>(out), WT, T, C, hd);
  return cudaGetLastError();
}
