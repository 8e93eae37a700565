// Windowed multi-head attention with a fused relative-position bias (RPE),
// forward (K1) and backward (K2), for Hopper (sm_90a).
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
//
// Backward (K2) replaces window_attn.py:_bwd_kernel with its table-gradient
// epilogue _dtab_from_dm. Bound on the H100: bytes again (q, k, v, g read,
// dq, dk, dv written; ~10 T flops per element). It recomputes the softmax
// as the forward does and reduces the RPE table gradient straight to the
// (3*num, H) rows by a shared-memory histogram per block; the TPU kernel's
// per-axis (P, H*P) pair matrices and their Toeplitz fold are not needed.
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

// Backward: one block per (window, head), 4 warps, everything of the
// window-head in shared memory (fp32): q, k, v, g rows, the softmax P and
// dlogits dL (T x T each), the table column and a 3*num-float histogram of
// the table gradient. Phase 1, a warp per query row t (keys on lanes, as in
// the forward): recompute the logits and fp32 softmax, then
//   dattn[s] = g_t . v_s,  dL[t,s] = P[t,s] (dattn[s] - sum_s' dattn P)
//   dq_t     = scale * sum_s dL[t,s] k_s
// and add dL[t,s] to the histogram bin of each axis for t, s >= G. Phase 2,
// a thread per (key s, channel d):
//   dv_s = sum_t P[t,s] g_t,  dk_s = scale * sum_t dL[t,s] q_t
// (deterministic, no atomics). Last, the block adds its histogram into the
// (3*num, H) fp32 table gradient with global atomics (one per non-zero
// bin), which is the only reduction across windows.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ xyz,
                       const int* __restrict__ mask,
                       const float* __restrict__ table,
                       const T* __restrict__ g, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dtable, int H, int Tn, int C,
                       int K, int bnd, int use_rpe, int want_dtab,
                       float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hd = C / H;
  const int hdp = hd + 1;
  const int G = Tn - K;
  const int num = 2 * bnd + 1;
  float* qs = smem;
  float* ks = qs + Tn * hdp;
  float* vs = ks + Tn * hdp;
  float* gs = vs + Tn * hdp;
  float* P = gs + Tn * hdp;        // Tn x Tn
  float* dL = P + Tn * Tn;         // Tn x Tn
  float* tab = dL + Tn * Tn;       // 3 * num when use_rpe
  float* hist = tab + (use_rpe ? 3 * num : 0);   // 3 * num when want_dtab
  int* cs = reinterpret_cast<int*>(hist + (want_dtab ? 3 * num : 0));
  int* ms = cs + (use_rpe ? 3 * K : 0);

  const size_t base = (size_t)w * Tn * C + (size_t)h * hd;
  for (int i = threadIdx.x; i < Tn * hd; i += blockDim.x) {
    const int t = i / hd, d = i - t * hd;
    const size_t off = base + (size_t)t * C + d;
    qs[t * hdp + d] = to_f(q[off]);
    ks[t * hdp + d] = to_f(k[off]);
    vs[t * hdp + d] = to_f(v[off]);
    gs[t * hdp + d] = to_f(g[off]);
  }
  if (use_rpe) {
    for (int i = threadIdx.x; i < 3 * num; i += blockDim.x)
      tab[i] = table[(size_t)i * H + h];
    for (int i = threadIdx.x; i < 3 * K; i += blockDim.x)
      cs[i] = xyz[(size_t)w * 3 * K + i];
  }
  if (want_dtab)
    for (int i = threadIdx.x; i < 3 * num; i += blockDim.x) hist[i] = 0.f;
  for (int i = threadIdx.x; i < Tn; i += blockDim.x)
    ms[i] = mask[(size_t)w * Tn + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < Tn; t += kWarps) {
    float* prow = P + t * Tn;
    float* drow = dL + t * Tn;
    T* dqrow = dq + base + (size_t)t * C;
    if (ms[t] == 0) {           // invalid query: attn row 0, no gradient
      for (int s = lane; s < Tn; s += 32) {
        prow[s] = 0.f;
        drow[s] = 0.f;
      }
      for (int d = lane; d < hd; d += 32) dqrow[d] = from_f<T>(0.f);
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
    const float inv = 1.f / warp_sum(e0 + e1);
    const float p[2] = {e0 * inv, e1 * inv};
    float da[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = lane + 32 * j;
      if (s < Tn)
        for (int d = 0; d < hd; ++d)
          da[j] = fmaf(gs[t * hdp + d], vs[s * hdp + d], da[j]);
    }
    const float dsum = warp_sum(p[0] * da[0] + p[1] * da[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = lane + 32 * j;
      if (s >= Tn) continue;
      const float dl = p[j] * (da[j] - dsum);
      prow[s] = p[j];
      drow[s] = dl;
      if (want_dtab && t >= G && s >= G) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          int dd = cs[a * K + t - G] - cs[a * K + s - G];
          dd = min(max(dd, -bnd), bnd);
          atomicAdd(&hist[a * num + dd + bnd], dl);
        }
      }
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int s = 0; s < Tn; ++s) acc = fmaf(drow[s], ks[s * hdp + d], acc);
      dqrow[d] = from_f<T>(acc * scale);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Tn * hd; i += blockDim.x) {
    const int s = i / hd, d = i - s * hd;
    float av = 0.f, ak = 0.f;
    for (int t = 0; t < Tn; ++t) {
      av = fmaf(P[t * Tn + s], gs[t * hdp + d], av);
      ak = fmaf(dL[t * Tn + s], qs[t * hdp + d], ak);
    }
    const size_t off = base + (size_t)s * C + d;
    dv[off] = from_f<T>(av);
    dk[off] = from_f<T>(ak * scale);
  }
  if (want_dtab)
    for (int i = threadIdx.x; i < 3 * num; i += blockDim.x) {
      const float hv = hist[i];
      if (hv != 0.f) atomicAdd(&dtable[(size_t)i * H + h], hv);
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

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* xyz, const int* mask, const float* table,
                       const void* g, void* dq, void* dk, void* dv,
                       float* dtable, int BW, int Tn, int C, int H, int K,
                       int bnd, int use_rpe, int want_dtab, float scale,
                       cudaStream_t stream) {
  const int hd = C / H;
  const int num = 2 * bnd + 1;
  size_t smem = sizeof(float) * (4 * Tn * (hd + 1) + 2 * Tn * Tn);
  if (use_rpe) smem += sizeof(float) * 3 * num + sizeof(int) * 3 * K;
  if (want_dtab) smem += sizeof(float) * 3 * num;
  smem += sizeof(int) * Tn;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  window_attn_bwd_kernel<T><<<dim3((unsigned)BW * H), kWarps * 32, smem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), xyz, mask, table, static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dtable,
      H, Tn, C, K, bnd, use_rpe, want_dtab, scale);
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

// Backward of window_attn_fwd for the output cotangent g (BW, T, C) in the
// inputs' dtype: writes dq, dk, dv (BW, T, C) in that dtype and, when
// want_dtab, ADDS the table gradient into dtable (3 * (2 * bnd + 1), H)
// float32, which the caller zeroes. Returns cudaError_t.
extern "C" int window_attn_bwd(const void* q, const void* k, const void* v,
                               const void* xyz, const void* mask,
                               const void* table, const void* g, void* dq,
                               void* dk, void* dv, void* dtable, int BW,
                               int Tn, int C, int H, int K, int bnd,
                               int use_rpe, int want_dtab, float scale,
                               int dtype, void* stream) {
  if (Tn > kMaxT || Tn < 1 || C % H != 0 || K > Tn) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(xyz);
  const int* mi = static_cast<const int*>(mask);
  const float* tb = static_cast<const float*>(table);
  float* dt = static_cast<float*>(dtable);
  want_dtab = want_dtab && use_rpe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, xi, mi, tb, g, dq, dk, dv, dt, BW, Tn,
                             C, H, K, bnd, use_rpe, want_dtab, scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, xi, mi, tb, g, dq, dk, dv, dt,
                                     BW, Tn, C, H, K, bnd, use_rpe,
                                     want_dtab, scale, s);
  return cudaErrorInvalidValue;
}
