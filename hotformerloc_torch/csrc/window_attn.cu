// Windowed multi-head attention with a fused relative-position bias (RPE),
// forward only, for Hopper (sm_90a).
//
// Replaces: hotformerloc_tpu/ops/pallas/window_attn.py:_fwd_kernel (entry
// fused_window_attention). Per window w and head h, with hd = C / H:
//   logits[t,s] = q_t . k_s * hd^-1/2 + bias[t,s] + (mask[s] ? 0 : -1e9)
//   bias[t,s]   = sum_a table[a*num + clip(x_a[t-G] - x_a[s-G], +-bnd) + bnd, h]
//                 for t, s >= G (G = T - K leading relay slots), else 0
//   out[t]      = softmax_s(logits[t]) . v        (fp32 softmax)
//   out[t]      = 0 exactly where mask[t] == 0.
//
// What bounds it on the H100: bytes. A window is T <= 64 tokens and a head
// hd = 16 channels, so q.k^T and attn.v are 49x49x16 products: about 2*2*T
// flops per loaded element, far below the ~20 fp32 flops per byte where the
// CUDA cores would be the limit. The least time is reading q, k, v and
// writing out once (4 * BW * T * C elements).
//
// Design: one block per (window, head), 4 warps. The head's q, k, v rows
// (T x hd), the window's integer coords and the table column for the head
// (3 * num floats) are staged in shared memory; logits and the bias never
// touch device memory. The bias is a direct table lookup from the coords:
// the TPU kernel's one-hot pair matrices (Delta, U) were a workaround for
// the MXU and are not carried over. Each warp owns query rows; a lane owns
// key slots s = lane and lane + 32, so the row max and sum are warp
// shuffles. Tensor cores and wider head tiles are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;
constexpr int kWarps = 4;
constexpr float kMaskValue = -1e9f;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ xyz,
                       const int* __restrict__ mask,
                       const float* __restrict__ table, T* __restrict__ out,
                       int H, int Tn, int C, int K, int bnd, int use_rpe,
                       float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hd = C / H;
  const int hdp = hd + 1;          // padded row: conflict-free column reads
  const int G = Tn - K;
  const int num = 2 * bnd + 1;
  float* qs = smem;
  float* ks = qs + Tn * hdp;
  float* vs = ks + Tn * hdp;
  float* prob = vs + Tn * hdp;     // kWarps * kMaxT
  float* tab = prob + kWarps * kMaxT;
  int* cs = reinterpret_cast<int*>(tab + (use_rpe ? 3 * num : 0));
  int* ms = cs + (use_rpe ? 3 * K : 0);

  const size_t base = (size_t)w * Tn * C + (size_t)h * hd;
  for (int i = threadIdx.x; i < Tn * hd; i += blockDim.x) {
    const int t = i / hd, d = i - t * hd;
    const size_t off = base + (size_t)t * C + d;
    qs[t * hdp + d] = to_f(q[off]);
    ks[t * hdp + d] = to_f(k[off]);
    vs[t * hdp + d] = to_f(v[off]);
  }
  if (use_rpe) {
    for (int i = threadIdx.x; i < 3 * num; i += blockDim.x)
      tab[i] = table[(size_t)i * H + h];
    for (int i = threadIdx.x; i < 3 * K; i += blockDim.x)
      cs[i] = xyz[(size_t)w * 3 * K + i];
  }
  for (int i = threadIdx.x; i < Tn; i += blockDim.x)
    ms[i] = mask[(size_t)w * Tn + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = prob + warp * kMaxT;
  for (int t = warp; t < Tn; t += kWarps) {
    T* orow = out + base + (size_t)t * C;
    if (ms[t] == 0) {
      for (int d = lane; d < hd; d += 32) orow[d] = from_f<T>(0.f);
      continue;
    }
    float lg[2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = lane + 32 * j;
      float l = -INFINITY;
      if (s < Tn) {
        float acc = 0.f;
        for (int d = 0; d < hd; ++d)
          acc = fmaf(qs[t * hdp + d], ks[s * hdp + d], acc);
        l = acc * scale;
        if (use_rpe && t >= G && s >= G) {
          float b = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            int dl = cs[a * K + t - G] - cs[a * K + s - G];
            dl = min(max(dl, -bnd), bnd);
            b += tab[a * num + dl + bnd];
          }
          l += b;
        }
        if (ms[s] == 0) l += kMaskValue;
      }
      lg[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    const float e0 = lane < Tn ? expf(lg[0] - mx) : 0.f;
    const float e1 = lane + 32 < Tn ? expf(lg[1] - mx) : 0.f;
    const float sum = warp_sum(e0 + e1);
    p[lane] = e0 / sum;
    p[lane + 32] = e1 / sum;
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int s = 0; s < Tn; ++s) acc = fmaf(p[s], vs[s * hdp + d], acc);
      orow[d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* xyz, const int* mask, const float* table,
                   void* out, int BW, int Tn, int C, int H, int K, int bnd,
                   int use_rpe, float scale, cudaStream_t stream) {
  const int hd = C / H;
  const int num = 2 * bnd + 1;
  size_t smem = sizeof(float) * (3 * Tn * (hd + 1) + kWarps * kMaxT);
  if (use_rpe) smem += sizeof(float) * 3 * num + sizeof(int) * 3 * K;
  smem += sizeof(int) * Tn;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  window_attn_fwd_kernel<T><<<dim3((unsigned)BW * H), kWarps * 32, smem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), xyz, mask, table, static_cast<T*>(out), H, Tn,
      C, K, bnd, use_rpe, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (BW, T, C) in float32 (dtype 0) or bfloat16 (dtype 1),
// contiguous. xyz: (BW, 3, K) int32 with K = T - G; mask: (BW, T) int32;
// table: (3 * (2 * bnd + 1), H) float32. T <= 64. Returns cudaError_t.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v,
                               const void* xyz, const void* mask,
                               const void* table, void* out, int BW, int Tn,
                               int C, int H, int K, int bnd, int use_rpe,
                               float scale, int dtype, void* stream) {
  if (Tn > kMaxT || Tn < 1 || C % H != 0 || K > Tn) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(xyz);
  const int* mi = static_cast<const int*>(mask);
  const float* tb = static_cast<const float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, xi, mi, tb, out, BW, Tn, C, H, K, bnd,
                         use_rpe, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, xi, mi, tb, out, BW, Tn, C, H, K,
                                 bnd, use_rpe, scale, s);
  return cudaErrorInvalidValue;
}
