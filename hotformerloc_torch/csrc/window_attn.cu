// Windowed multi-head attention with a fused relative-position bias (RPE),
// forward (K1) and backward (K2), for Hopper (sm_90a).
//
// Replaces hotformerloc_tpu/ops/pallas/window_attn.py:_fwd_kernel (K1,
// entry fused_window_attention) and :_bwd_kernel with its table-gradient
// epilogue :_dtab_from_dm (K2). Per window w and head h, with hd = C / H:
//   logits[t,s] = q_t . k_s * hd^-1/2 + bias[t,s] + (mask[s] ? 0 : -1e9)
//   bias[t,s]   = sum_a table[a*num + clip(x_a[t-G] - x_a[s-G], +-bnd) + bnd, h]
//                 for t, s >= G (G = T - K leading relay slots), else 0
//   P[t]        = softmax_s(logits[t]) (fp32), 0 exactly where mask[t] == 0
//   out[t]      = P[t] . v
// and the backward for the output cotangent g (dO):
//   dV = P^T g,  dP = g v^T,  dS = P * (dP - rowsum(dP * P))
//   dq = dS k * hd^-1/2,  dk = dS^T q * hd^-1/2,
//   dtable[a*num + clip(x_a[t] - x_a[s]) + bnd, h] += dS[t,s] over t, s >= G.
// At bf16, P is rounded to bf16 before P.v and P^T.g, and dS before dS.k and
// dS^T.q, where _fwd_kernel:173 and _bwd_kernel:221,233 round them; the
// row sum, dS itself and the table gradient stay fp32 (the table gradient
// is summed from the fp32 dS, where JAX sums the bf16 one).
//
// Two bodies per direction; ops/kernels/window_attn.py:attn_body picks one
// by dtype and shape.
//
// Tensor-core bodies (bf16, hd % 16 == 0, hd <= 64, T <= 80: the main
// path's hd = 16, T = 48 / 49 at patch 48 and T = 64 / 65 at patch 64).
// What bounds them on the H100: not the
// tensor cores (with hd = 16 every product is one to four k16 steps of
// mma.sync) and not HBM (a window's (T, C) tiles, ~25 KB each, take about
// a microsecond at an SM's share of the bandwidth), but the per-element
// work on the CUDA cores: the RPE bias lookup (6 shared loads per logit),
// the fp32 softmax and, in K2, the table-gradient histogram (one shared
// load per dS element and axis). The CUDA-core bodies were 20-35x above
// their byte bounds because every product was a scalar fp32 FMA loop with
// two or four shared loads per FMA, and 16 blocks per window each loaded
// their head's columns as strided 2-byte reads. What the design does:
// - one block per window for all heads: the block loads the window's whole
//   (T, C) tiles of q, k, v (and g) once, with 16-byte cp.async copies, in
//   rows of C + 8 bf16 so that ldmatrix reads are free of bank conflicts.
//   Not persistent and not double-buffered: a 49 x 256 window is ~100 KB
//   of K2's tiles, so one resident block per SM keeps the copies simple
//   and the 704-2816 windows of a call still give several waves;
// - a warp owns one 16-row query slab of one head; S = Q K^T (and in K2
//   dP = dO V^T) are mma.sync.m16n8k16 (bf16 in, fp32 accumulate) over
//   16 KS key columns (KS = 4 key slabs for T <= 64, 5 for T <= 80: a
//   template parameter, so that T <= 64 keeps 32 fp32 registers of S per
//   thread) with fragments from ldmatrix. T = 65 (64 nodes and a relay
//   slot) takes a fifth slab held in registers like the others (S in 40
//   registers per thread), not a second pass over the keys with an online
//   softmax: one pass keeps the softmax, the rounding points and K2's
//   dS = P (dP - rowsum) as they are, and the registers fit (the
//   backward's S and dP are 80 of the 128 a thread of 512 may hold:
//   ptxas gives it 123 registers and no spill at hd 16). The softmax, the
//   bias and dS = P (dP - rowsum) stay in registers in fp32, row
//   reductions by quad shuffles; P (dS) is rounded to bf16 in registers
//   and used as the A fragment of O = P V (dQ = dS K) directly,
//   FlashAttention-2 style;
// - K2 writes P and dS once to shared memory as bf16 and computes dV = P^T
//   dO and dK = dS^T Q per 16-key slab with ldmatrix.trans, hpr heads at
//   a time (a warp per head and slab: hpr KS warps). hpr is the most heads
//   of a round, up to 16 warps, whose buffers fit shared memory beside the
//   window's tiles (bwd_heads): 4 at patch 48, 3 for the dilated OctFormer
//   windows at patch 64 (T 64, C 128, a 205-bin table per axis), 1 for
//   H-OSA's (T 65, C 256, R = 80-row P and dS);
// - rows beyond T are never stored: ldmatrix row addresses are clamped into
//   the tile, and their logits are -inf (keys) or their P rows 0 (queries);
// - outputs are staged in the consumed q/k/v tile columns and written back
//   as coalesced 16-byte rows;
// - the table gradient: a bin of axis a gathers the (t, s) pairs with one
//   clipped difference x_a[t] - x_a[s]. The block sorts its valid nodes
//   by each axis once (sort_nodes); K2 keeps the round's dS in fp32 in
//   shared memory, and a warp per (head, axis) walks the keys in
//   coordinate order with a lane per two query nodes, sums each run of
//   equal key coordinate, merges the lanes of equal query coordinate (a
//   segmented shuffle scan) and adds once per (query coordinate, key
//   coordinate) pair: no two lanes of an add share a bin, where one
//   shared atomic per (t, s, axis) made the lanes of a warp collide on
//   bins (rows next to each other in Morton order share coordinates).
//   Each round of heads ends with one global atomic per non-zero bin. In
//   trial builds timed on the H100 on the train path's windows (whose
//   nodes spread over many coordinates per axis at the OctFormer depth,
//   so runs are short), merging before the add beat adding per run and
//   lane; a plain add by the tail lanes instead of the atomic, and
//   splitting each axis's runs over four warps that carry all the round's
//   heads, were no faster.
//
// CUDA-core bodies (*_cc_kernel): one block per (window, head), scalar
// fp32 products over shared memory.
// - fp32 runs them: they are the parity path, with every product in full
//   fp32, which mma.sync's bf16 operands are not.
// - bf16 runs them at the shapes the tensor-core bodies do not take (hd
//   not a multiple of 16 or above 64, tiles beyond shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 80;          // 5 slabs of 16 rows
constexpr int kCcKeys = (kMaxT + 31) / 32;   // keys per lane, CUDA-core
constexpr int kWarps = 4;          // CUDA-core bodies
constexpr int kFwdWarps = 8;       // tensor-core forward
constexpr int kBwdWarps = 16;      // tensor-core backward, at most
constexpr int kPad = 8;            // bf16 row padding of the shared tiles
constexpr size_t kSmemLimit = 232448;   // opt-in shared memory of a block
constexpr float kMaskValue = -1e9f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to the compute type T and back (a no-op for fp32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// CUDA-core bodies: one block per (window, head), 4 warps. q, k, v, g rows
// are sr elements apart and windows sw apart (last dimension contiguous);
// outputs are contiguous (BW, T, C).

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attn_fwd_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, long long sw, long long sr,
                          const int* __restrict__ xyz,
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

  const size_t ibase = (size_t)w * sw + (size_t)h * hd;
  const size_t obase = (size_t)w * Tn * C + (size_t)h * hd;
  for (int i = threadIdx.x; i < Tn * hd; i += blockDim.x) {
    const int t = i / hd, d = i - t * hd;
    const size_t off = ibase + (size_t)t * sr + d;
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
    T* orow = out + obase + (size_t)t * C;
    if (ms[t] == 0) {
      for (int d = lane; d < hd; d += 32) orow[d] = from_f<T>(0.f);
      continue;
    }
    float lg[kCcKeys];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j) {
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
    float e[kCcKeys];
    float esum = 0.f;
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j) {
      e[j] = lane + 32 * j < Tn ? expf(lg[j] - mx) : 0.f;
      esum += e[j];
    }
    const float sum = warp_sum(esum);
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j)
      if (lane + 32 * j < Tn) p[lane + 32 * j] = round_to<T>(e[j] / sum);
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
// dlogits dL (T x T each, rounded to T), the table column and a 3*num-float
// histogram of the table gradient. Phase 1, a warp per query row t (keys
// on lanes, as in the forward): recompute the logits and fp32 softmax, then
//   dattn[s] = g_t . v_s,  dL[t,s] = P[t,s] (dattn[s] - sum_s' dattn P)
//   dq_t     = scale * sum_s dL[t,s] k_s
// and add the fp32 dL[t,s] to the histogram bin of each axis for t, s >= G.
// Phase 2, a thread per (key s, channel d):
//   dv_s = sum_t P[t,s] g_t,  dk_s = scale * sum_t dL[t,s] q_t
// (deterministic, no atomics). Last, the block adds its histogram into the
// (3*num, H) fp32 table gradient with global atomics (one per non-zero
// bin), which is the only reduction across windows.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attn_bwd_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, long long sw, long long sr,
                          const int* __restrict__ xyz,
                          const int* __restrict__ mask,
                          const float* __restrict__ table,
                          const T* __restrict__ g, long long gsw,
                          long long gsr, T* __restrict__ dq,
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

  const size_t ibase = (size_t)w * sw + (size_t)h * hd;
  const size_t gbase = (size_t)w * gsw + (size_t)h * hd;
  const size_t obase = (size_t)w * Tn * C + (size_t)h * hd;
  for (int i = threadIdx.x; i < Tn * hd; i += blockDim.x) {
    const int t = i / hd, d = i - t * hd;
    const size_t off = ibase + (size_t)t * sr + d;
    qs[t * hdp + d] = to_f(q[off]);
    ks[t * hdp + d] = to_f(k[off]);
    vs[t * hdp + d] = to_f(v[off]);
    gs[t * hdp + d] = to_f(g[gbase + (size_t)t * gsr + d]);
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
    T* dqrow = dq + obase + (size_t)t * C;
    if (ms[t] == 0) {           // invalid query: attn row 0, no gradient
      for (int s = lane; s < Tn; s += 32) {
        prow[s] = 0.f;
        drow[s] = 0.f;
      }
      for (int d = lane; d < hd; d += 32) dqrow[d] = from_f<T>(0.f);
      continue;
    }
    float lg[kCcKeys];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j) {
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
    float p[kCcKeys];
    float esum = 0.f;
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j) {
      p[j] = lane + 32 * j < Tn ? expf(lg[j] - mx) : 0.f;
      esum += p[j];
    }
    const float inv = 1.f / warp_sum(esum);
    float da[kCcKeys];
    float pda = 0.f;
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j) {
      const int s = lane + 32 * j;
      p[j] *= inv;
      da[j] = 0.f;
      if (s < Tn)
        for (int d = 0; d < hd; ++d)
          da[j] = fmaf(gs[t * hdp + d], vs[s * hdp + d], da[j]);
      pda += p[j] * da[j];
    }
    const float dsum = warp_sum(pda);
#pragma unroll
    for (int j = 0; j < kCcKeys; ++j) {
      const int s = lane + 32 * j;
      if (s >= Tn) continue;
      const float dl = p[j] * (da[j] - dsum);
      prow[s] = round_to<T>(p[j]);
      drow[s] = round_to<T>(dl);
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
    const size_t off = obase + (size_t)s * C + d;
    dv[off] = from_f<T>(av);
    dk[off] = from_f<T>(ak * scale);
  }
  if (want_dtab)
    for (int i = threadIdx.x; i < 3 * num; i += blockDim.x) {
      const float hv = hist[i];
      if (hv != 0.f) atomicAdd(&dtable[(size_t)i * H + h], hv);
    }
}

// ---------------------------------------------------------------------------
// Tensor-core bodies (bf16). PTX helpers: 16-byte cp.async, ldmatrix and
// mma.sync.m16n8k16 (row.col, bf16 in, fp32 accumulate). Fragment layouts
// (g = lane / 4, c = lane % 4): A rows g and g + 8, k columns 2c, 2c + 1
// (regs 0, 1) and 2c + 8, 2c + 9 (regs 2, 3); B k rows 2c.. and 2c + 8..,
// column g; C rows g (regs 0, 1) and g + 8 (regs 2, 3), columns 2c, 2c + 1.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Loads rows [0, Tn) of a (Tn, C) bf16 tile (rows sr, windows sw elements
// apart in global memory) into shared rows of ld elements, 16 bytes per
// cp.async.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long sr, int Tn, int C,
                                          int ld) {
  const int cpr = C / 8;
  for (int i = threadIdx.x; i < Tn * cpr; i += blockDim.x) {
    const int t = i / cpr, c = (i - t * cpr) * 8;
    cp_async16(dst + t * ld + c, src + (size_t)t * sr + c);
  }
}
// Writes rows [0, Tn) of a shared tile to a contiguous (Tn, C) output.
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* src, int Tn,
                                           int C, int ld) {
  const int cpr = C / 8;
  for (int i = threadIdx.x; i < Tn * cpr; i += blockDim.x) {
    const int t = i / cpr, c = (i - t * cpr) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)t * C + c) =
        *reinterpret_cast<const uint4*>(src + t * ld + c);
  }
}

// A window's shared coordinates and mask, and its RPE constants.
struct Window {
  const int* cs;     // (3, K) node coords
  const int* ms;     // (Tn) key / query mask
  int Tn, K, G, bnd, num, use_rpe;
};

// The logits of one warp's 16-row slab (rows t0 + g, t0 + g + 8) for one
// head against the 16 KS key columns: S[j][e] is column 8j + 2c + (e & 1)
// of row t0 + g + 8 (e >> 1). Scaled, biased and masked in place; keys >=
// Tn are -inf. tab is the head's table column (3 * num floats).
template <int HD, int KS>
__device__ __forceinline__ void slab_logits(float (&S)[2 * KS][4],
                                            const bf16* qs,
                                            const bf16* ks, int ld, int t0,
                                            int col0, const Window& win,
                                            const float* tab, float scale,
                                            int lane) {
  const int Tn = win.Tn;
  const int nkey = (Tn + 15) / 16;
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
  const int arow = min(t0 + (lane & 7) + 8 * ((lane >> 3) & 1), Tn - 1);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + arow * ld + col0 + kk * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int jp = 0; jp < KS; ++jp) {
      if (jp >= nkey) continue;
      const int brow = min(16 * jp + (lane & 7) + 8 * (lane >> 4), Tn - 1);
      uint32_t b[4];
      ldsm_x4(b, ks + brow * ld + col0 + kk * 16 + 8 * ((lane >> 3) & 1));
      mma16816(S[2 * jp], a, b[0], b[1]);
      mma16816(S[2 * jp + 1], a, b[2], b[3]);
    }
  }
  const int g = lane >> 2, c = lane & 3;
  const int rt[2] = {t0 + g, t0 + g + 8};
  int rc[2][3];                    // row node coords
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rc[i][a] = (win.use_rpe && rt[i] >= win.G && rt[i] < Tn)
                     ? win.cs[a * win.K + rt[i] - win.G] : 0;
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int s = 8 * j + 2 * c + e2;
      if (s >= Tn) {
        S[j][e2] = S[j][2 + e2] = -INFINITY;
        continue;
      }
      const float madd = win.ms[s] == 0 ? kMaskValue : 0.f;
      const bool sb = win.use_rpe && s >= win.G;
      int sc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        sc[a] = sb ? win.cs[a * win.K + s - win.G] : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = S[j][2 * i + e2] * scale;
        if (sb && rt[i] >= win.G && rt[i] < Tn) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const int dl = min(max(rc[i][a] - sc[a], -win.bnd), win.bnd);
            l += tab[a * win.num + dl + win.bnd];
          }
        }
        S[j][2 * i + e2] = l + madd;
      }
    }
}

// Softmax of the slab's rows in place (fp32; quad shuffles reduce a row),
// rows of invalid queries (mask 0 or t >= Tn) set to 0.
template <int KS>
__device__ __forceinline__ void slab_softmax(float (&S)[2 * KS][4], int t0,
                                             const Window& win, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + (lane >> 2) + 8 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
      mx = fmaxf(mx, fmaxf(S[j][2 * i], S[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ex = expf(S[j][2 * i + e] - mx);
        S[j][2 * i + e] = ex;
        sum += ex;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const bool valid = t < win.Tn && win.ms[t] != 0;
    const float inv = valid ? 1.f / sum : 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) S[j][2 * i + e] *= inv;
  }
}

// A fragment of key step kk (keys 16kk..16kk+15) from a slab's C fragments,
// rounded to bf16.
template <int KS>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const float (&X)[2 * KS][4], int kk) {
  a[0] = pack_bf16(X[2 * kk][0], X[2 * kk][1]);
  a[1] = pack_bf16(X[2 * kk][2], X[2 * kk][3]);
  a[2] = pack_bf16(X[2 * kk + 1][0], X[2 * kk + 1][1]);
  a[3] = pack_bf16(X[2 * kk + 1][2], X[2 * kk + 1][3]);
}

// acc (16 x HD) += X (16 x 16 KS, C fragments, rounded to bf16) . B, with
// B the (16 KS, HD) rows of a shared tile at column col0 (rows clamped
// below Tn: X is 0 there).
template <int HD, int KS>
__device__ __forceinline__ void slab_times_tile(float (&acc)[HD / 8][4],
                                                const float (&X)[2 * KS][4],
                                                const bf16* bs, int ld,
                                                int col0, int Tn, int lane) {
  const int nkey = (Tn + 15) / 16;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk >= nkey) continue;
    uint32_t a[4];
    a_frag<KS>(a, X, kk);
    const int brow = min(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1), Tn - 1);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, bs + brow * ld + col0 + dp * 16 + 8 * (lane >> 4));
      mma16816(acc[2 * dp], a, b[0], b[1]);
      mma16816(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Writes a (16 x HD) C-fragment block, scaled, as bf16 into rows t0.. of a
// shared tile at column col0 (rows >= Tn skipped).
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int t0,
                                           int col0, int Tn,
                                           const float (&acc)[HD / 8][4],
                                           float scale, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + g + 8 * i;
      if (t < Tn)
        *reinterpret_cast<uint32_t*>(dst + t * ld + col0 + 8 * n + 2 * c) =
            pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
}

template <int HD, int KS>
__global__ void __launch_bounds__(kFwdWarps * 32)
window_attn_fwd_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, long long sw,
                          long long sr, const int* __restrict__ xyz,
                          const int* __restrict__ mask,
                          const float* __restrict__ table,
                          bf16* __restrict__ out, int H, int Tn, int K,
                          int bnd, int use_rpe, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * HD;
  const int ld = C + kPad;
  const int num = 2 * bnd + 1;
  const int w = blockIdx.x;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tn * ld;
  bf16* vs = ks + Tn * ld;
  float* tab = reinterpret_cast<float*>(vs + Tn * ld);   // (H, 3 * num)
  int* cs = reinterpret_cast<int*>(tab + (use_rpe ? H * 3 * num : 0));
  int* ms = cs + (use_rpe ? 3 * K : 0);

  const size_t ibase = (size_t)w * sw;
  load_tile(qs, q + ibase, sr, Tn, C, ld);
  load_tile(ks, k + ibase, sr, Tn, C, ld);
  load_tile(vs, v + ibase, sr, Tn, C, ld);
  if (use_rpe) {
    for (int i = threadIdx.x; i < 3 * num * H; i += blockDim.x)
      tab[(i % H) * 3 * num + i / H] = table[i];
    for (int i = threadIdx.x; i < 3 * K; i += blockDim.x)
      cs[i] = xyz[(size_t)w * 3 * K + i];
  }
  for (int i = threadIdx.x; i < Tn; i += blockDim.x)
    ms[i] = mask[(size_t)w * Tn + i];
  cp_async_wait_all();
  __syncthreads();

  const Window win{cs, ms, Tn, K, Tn - K, bnd, num, use_rpe};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nslab = (Tn + 15) / 16;
  // unit u = (slab u / H, head u % H): a warp's consecutive units share a
  // slab. O is staged in the slab's q columns of its head, which only this
  // unit reads.
  for (int u = warp; u < nslab * H; u += kFwdWarps) {
    const int t0 = 16 * (u / H), h = u % H, col0 = h * HD;
    float S[2 * KS][4];
    slab_logits<HD, KS>(S, qs, ks, ld, t0, col0, win, tab + h * 3 * num,
                        scale, lane);
    slab_softmax<KS>(S, t0, win, lane);
    float O[HD / 8][4] = {};
    slab_times_tile<HD, KS>(O, S, vs, ld, col0, Tn, lane);
    stage_rows<HD>(qs, ld, t0, col0, Tn, O, 1.f, lane);
  }
  __syncthreads();
  store_tile(out + (size_t)w * Tn * C, qs, Tn, C, ld);
}

// Sorts the window's valid nodes (t >= G, mask != 0) by each axis: for
// axis a, ord[a * K + r] is the node of rank r by (coordinate, index) and
// val[a * K + r] its coordinate. Returns the number of valid nodes (a
// barrier: every thread of the block calls it).
__device__ __forceinline__ int sort_nodes(int* ord, int* val, int* rs,
                                          int* nrun, const Window& win) {
  const int K = win.K;
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int a = i / K, n = i - a * K;
    if (win.ms[win.G + n] == 0) continue;
    const int* x = win.cs + a * K;
    const int xn = x[n];
    int r = 0;
    for (int m = 0; m < K; ++m)
      r += win.ms[win.G + m] != 0 && (x[m] < xn || (x[m] == xn && m < n));
    ord[a * K + r] = n;
    val[a * K + r] = xn;
  }
  const int nv =
      __syncthreads_count(threadIdx.x < K && win.ms[win.G + threadIdx.x]);
  // runs of equal coordinate: run i of axis a is ranks rs[a * (K + 1) + i]
  // to rs[a * (K + 1) + i + 1]
  for (int i = threadIdx.x; i < 3 * nv; i += blockDim.x) {
    const int a = i / nv, r = i - a * nv;
    const int* v = val + a * K;
    int idx = 0;                   // runs that start at or before r
    for (int m = 0; m <= r; ++m) idx += m == 0 || v[m] != v[m - 1];
    if (r == 0 || v[r] != v[r - 1]) rs[a * (K + 1) + idx - 1] = r;
    if (r == nv - 1) {
      rs[a * (K + 1) + idx] = nv;
      nrun[a] = idx;
    }
  }
  __syncthreads();
  return nv;
}

// Adds one head's fp32 dS into its axis-a histogram hh, for the valid
// nodes of ranks lane + 32 r (r < NR) as query rows (nv <= 32 NR valid
// nodes in all; run i of the key nodes in coordinate order is ranks rs[i]
// to rs[i+1]). Per run, a lane sums its rows' dS over the run's keys (one
// shared load per element; the loads of a run are independent). Lanes of
// equal row coordinate (neighbours: rows are sorted too) would add to one
// bin, so they first merge their sums by a segmented shuffle scan (its
// depth, the log of the longest segment, and each lane's masks are fixed
// per task), and the last lane of a segment adds the total to the bin of
// (row coordinate - run coordinate). So a shared add serves a (row
// coordinate, key coordinate) pair instead of a (t, s) pair, and no two
// lanes of an add share a bin but where clipping merges bins. (Segments
// do not cross from rank 32 r + 31 to 32 (r + 1): those two adds are
// separate atomics.)
template <int NR>
__device__ __forceinline__ void node_histogram(float* hh, const float* ds,
                                               int dld, const int* ord,
                                               const int* val, const int* rs,
                                               int nrun, int nv,
                                               const Window& win, int lane) {
  const unsigned full = 0xffffffffu;
  bool on[NR], tail[NR];
  int key[NR];
  const float* row[NR];
  unsigned m[NR];                  // bit i: add the sum of lane - 2^i
  int len = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int rank = lane + 32 * r;
    on[r] = rank < nv;
    // distinct keys above every coordinate for the lanes past nv
    key[r] = on[r] ? val[rank] : INT_MAX - 32 * (NR - r) + 1 + lane;
    row[r] = ds + (win.G + (on[r] ? ord[rank] : 0)) * dld + win.G;
    len = max(len, __popc(__match_any_sync(full, key[r])));
    m[r] = 0;
  }
  const int steps = 32 - __clz(__reduce_max_sync(full, len) - 1);
  for (int i = 0; i < steps; ++i) {
    const int o = 1 << i;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int k = __shfl_up_sync(full, key[r], o);
      m[r] |= (lane >= o && k == key[r]) << i;
    }
  }
  // every lane shuffles (a lane that skipped a full-mask shuffle would
  // hang the warp); then the last lane of each segment is its tail
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int kn = __shfl_down_sync(full, key[r], 1);
    tail[r] = on[r] && (lane == 31 || kn != key[r]);
  }
  for (int i = 0; i < nrun; ++i) {
    const int j0 = rs[i], j1 = rs[i + 1];
    float sum[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) sum[r] = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const int s = ord[j];
#pragma unroll
      for (int r = 0; r < NR; ++r) sum[r] += row[r][s];
    }
    for (int st = 0; st < steps; ++st) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float y = __shfl_up_sync(full, sum[r], 1 << st);
        if ((m[r] >> st) & 1) sum[r] += y;
      }
    }
    const int v = val[j0];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (tail[r] && sum[r] != 0.f)
        atomicAdd(&hh[min(max(key[r] - v, -win.bnd), win.bnd) + win.bnd],
                  sum[r]);
  }
}

// Backward, hpr KS warps, hpr heads per round (bwd_heads). Round of heads
// h0..h0+hpr-1:
//   phase 1, warp (head slot w / KS, query slab w % KS): S, P (fp32), dP =
//     dO V^T, dS = P (dP - rowsum); P and dS to shared memory as bf16,
//     and dS as fp32 for the table gradient; dQ = dS K kept in registers;
//   phase 2, warp (head slot, key slab): dV = P^T dO, dK = dS^T Q; then
//     the round's histogram tasks, a warp per (head slot, axis):
//     node_histogram;
//   then the histogram goes to dtable (one atomic per non-zero bin) and is
//     zeroed, and dQ, dK, dV are staged in their head's consumed q, k, v
//     columns.
template <int HD, int KS>
__global__ void __launch_bounds__(kBwdWarps * 32)
window_attn_bwd_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, long long sw,
                          long long sr, const int* __restrict__ xyz,
                          const int* __restrict__ mask,
                          const float* __restrict__ table,
                          const bf16* __restrict__ g, long long gsw,
                          long long gsr, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dtable, int H, int Tn, int K,
                          int bnd, int use_rpe, int want_dtab, int hpr,
                          float scale) {
  constexpr int NR = (16 * KS + 31) / 32;   // query ranks per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * HD;
  const int ld = C + kPad;
  const int num = 2 * bnd + 1;
  const int nslab = (Tn + 15) / 16;
  const int R = 16 * nslab;
  const int pld = R + kPad;
  const int dld = Tn | 1;          // odd: a warp's rows hit distinct banks
  const int w = blockIdx.x;
  const int nwarps = blockDim.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tn * ld;
  bf16* vs = ks + Tn * ld;
  bf16* gs = vs + Tn * ld;
  bf16* Ps = gs + Tn * ld;                       // hpr x (R, pld)
  bf16* Ds = Ps + hpr * R * pld;                 // hpr x (R, pld)
  float* tab = reinterpret_cast<float*>(Ds + hpr * R * pld);
  // want_dtab: fp32 dS hpr x (Tn, dld), histogram hpr x (3, num), nodes
  // sorted per axis (ord, val: 3 x K each)
  float* dsf = tab + (use_rpe ? hpr * 3 * num : 0);
  float* hist = dsf + (want_dtab ? hpr * Tn * dld : 0);
  int* ord = reinterpret_cast<int*>(hist + (want_dtab ? hpr * 3 * num : 0));
  int* val = ord + (want_dtab ? 3 * K : 0);
  int* rs = val + (want_dtab ? 3 * K : 0);       // run starts, 3 x (K + 1)
  int* nrun = rs + (want_dtab ? 3 * (K + 1) : 0);
  int* cs = nrun + (want_dtab ? 3 : 0);
  int* ms = cs + (use_rpe ? 3 * K : 0);

  load_tile(qs, q + (size_t)w * sw, sr, Tn, C, ld);
  load_tile(ks, k + (size_t)w * sw, sr, Tn, C, ld);
  load_tile(vs, v + (size_t)w * sw, sr, Tn, C, ld);
  load_tile(gs, g + (size_t)w * gsw, gsr, Tn, C, ld);
  if (use_rpe)
    for (int i = threadIdx.x; i < 3 * K; i += blockDim.x)
      cs[i] = xyz[(size_t)w * 3 * K + i];
  if (want_dtab)
    for (int i = threadIdx.x; i < hpr * 3 * num; i += blockDim.x)
      hist[i] = 0.f;
  for (int i = threadIdx.x; i < Tn; i += blockDim.x)
    ms[i] = mask[(size_t)w * Tn + i];
  cp_async_wait_all();
  __syncthreads();

  const Window win{cs, ms, Tn, K, Tn - K, bnd, num, use_rpe};
  const int nv = want_dtab ? sort_nodes(ord, val, rs, nrun, win) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hs = warp / KS, slab = warp % KS;
  const int gq = lane >> 2, cq = lane & 3;
  bf16* P = Ps + hs * R * pld;
  bf16* D = Ds + hs * R * pld;
  for (int h0 = 0; h0 < H; h0 += hpr) {
    if (use_rpe)                   // table columns of this round's heads
      for (int i = threadIdx.x; i < hpr * 3 * num; i += blockDim.x) {
        const int hi = h0 + i / (3 * num);
        tab[i] = hi < H ? table[(size_t)(i % (3 * num)) * H + hi] : 0.f;
      }
    __syncthreads();
    const int h = h0 + hs, col0 = h * HD;
    const bool busy = h < H && slab < nslab;
    const int t0 = 16 * slab;
    float dQ[HD / 8][4] = {};
    if (busy) {
      float S[2 * KS][4];
      slab_logits<HD, KS>(S, qs, ks, ld, t0, col0, win, tab + hs * 3 * num,
                          scale, lane);
      slab_softmax<KS>(S, t0, win, lane);        // S holds P (fp32)
      float dP[2 * KS][4] = {};
      {
        const int arow = min(t0 + (lane & 7) + 8 * ((lane >> 3) & 1), Tn - 1);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, gs + arow * ld + col0 + kk * 16 + 8 * (lane >> 4));
#pragma unroll
          for (int jp = 0; jp < KS; ++jp) {
            if (jp >= nslab) continue;
            const int brow = min(16 * jp + (lane & 7) + 8 * (lane >> 4),
                                 Tn - 1);
            uint32_t b[4];
            ldsm_x4(b, vs + brow * ld + col0 + kk * 16 +
                           8 * ((lane >> 3) & 1));
            mma16816(dP[2 * jp], a, b[0], b[1]);
            mma16816(dP[2 * jp + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j)
          rs += S[j][2 * i] * dP[j][2 * i] + S[j][2 * i + 1] * dP[j][2 * i + 1];
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dP[j][2 * i + e] = S[j][2 * i + e] * (dP[j][2 * i + e] - rs);
      }                                          // dP holds dS (fp32)
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j) {
        if (j >= 2 * nslab) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = (t0 + gq + 8 * i) * pld + 8 * j + 2 * cq;
          *reinterpret_cast<uint32_t*>(P + off) =
              pack_bf16(S[j][2 * i], S[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(D + off) =
              pack_bf16(dP[j][2 * i], dP[j][2 * i + 1]);
        }
      }
      if (want_dtab) {             // fp32 dS of rows and keys < Tn
        float* dsh = dsf + hs * Tn * dld;
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = t0 + gq + 8 * i, s = 8 * j + 2 * cq + e;
              if (t < Tn && s < Tn) dsh[t * dld + s] = dP[j][2 * i + e];
            }
      }
      slab_times_tile<HD, KS>(dQ, dP, ks, ld, col0, Tn, lane);
    }
    __syncthreads();
    float dK[HD / 8][4] = {}, dV[HD / 8][4] = {};
    if (busy) {                    // key slab s0 = t0
#pragma unroll
      for (int kt = 0; kt < KS; ++kt) {
        if (kt >= nslab) continue;
        const int prow = 16 * kt + (lane & 7) + 8 * (lane >> 4);
        const int pcol = t0 + 8 * ((lane >> 3) & 1);
        uint32_t ap[4], ad[4];
        ldsm_x4_t(ap, P + prow * pld + pcol);
        ldsm_x4_t(ad, D + prow * pld + pcol);
        const int brow = min(16 * kt + (lane & 7) + 8 * ((lane >> 3) & 1),
                             Tn - 1);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t b[4];
          const int bc = col0 + dp * 16 + 8 * (lane >> 4);
          ldsm_x4_t(b, gs + brow * ld + bc);
          mma16816(dV[2 * dp], ap, b[0], b[1]);
          mma16816(dV[2 * dp + 1], ap, b[2], b[3]);
          ldsm_x4_t(b, qs + brow * ld + bc);
          mma16816(dK[2 * dp], ad, b[0], b[1]);
          mma16816(dK[2 * dp + 1], ad, b[2], b[3]);
        }
      }
    }
    // histogram tasks: a warp per (head slot, axis)
    for (int task = warp; nv > 0 && task < hpr * 3; task += nwarps) {
      const int ht = task / 3, a = task % 3;
      if (h0 + ht < H)
        node_histogram<NR>(hist + task * num, dsf + ht * Tn * dld, dld,
                           ord + a * K, val + a * K, rs + a * (K + 1),
                           nrun[a], nv, win, lane);
    }
    __syncthreads();
    if (want_dtab)
      for (int i = threadIdx.x; i < hpr * 3 * num; i += blockDim.x) {
        const int hi = h0 + i / (3 * num);
        const float hv = hist[i];
        hist[i] = 0.f;
        if (hi < H && hv != 0.f)
          atomicAdd(&dtable[(size_t)(i % (3 * num)) * H + hi], hv);
      }
    if (busy) {
      stage_rows<HD>(qs, ld, t0, col0, Tn, dQ, scale, lane);
      stage_rows<HD>(ks, ld, t0, col0, Tn, dK, scale, lane);
      stage_rows<HD>(vs, ld, t0, col0, Tn, dV, 1.f, lane);
    }
  }
  __syncthreads();
  const size_t obase = (size_t)w * Tn * C;
  store_tile(dq + obase, qs, Tn, C, ld);
  store_tile(dk + obase, ks, Tn, C, ld);
  store_tile(dv + obase, vs, Tn, C, ld);
}

// ---------------------------------------------------------------------------
// Launchers

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t fwd_tc_smem(int Tn, int C, int H, int K, int bnd, int use_rpe) {
  size_t s = sizeof(bf16) * 3 * Tn * (C + kPad) + sizeof(int) * Tn;
  if (use_rpe) s += sizeof(float) * H * 3 * (2 * bnd + 1) + sizeof(int) * 3 * K;
  return s;
}

// The tensor-core bodies' key slabs: 4 (T <= 64) or 5 (T <= 80).
int key_slabs(int Tn) { return Tn > 64 ? 5 : 4; }

size_t bwd_tc_smem(int Tn, int C, int K, int bnd, int use_rpe,
                   int want_dtab, int hpr) {
  const int R = 16 * ((Tn + 15) / 16);
  const int num = 2 * bnd + 1;
  size_t s = sizeof(bf16) * (4 * Tn * (C + kPad) +
                             2 * (size_t)hpr * R * (R + kPad)) +
             sizeof(int) * Tn;
  if (use_rpe) s += sizeof(float) * hpr * 3 * num + sizeof(int) * 3 * K;
  if (want_dtab)
    s += sizeof(float) * hpr * (Tn * (Tn | 1) + 3 * num) +
         sizeof(int) * (3 * (3 * K + 1) + 3);
  return s;
}

// Heads per round of the tensor-core backward: the most, up to kBwdWarps /
// KS and H, whose buffers fit kSmemLimit beside the window's tiles (1 when
// none does: the launch then refuses the shape).
int bwd_heads(int Tn, int C, int H, int K, int bnd, int use_rpe,
              int want_dtab) {
  int hpr = min(kBwdWarps / key_slabs(Tn), H);
  while (hpr > 1 &&
         bwd_tc_smem(Tn, C, K, bnd, use_rpe, want_dtab, hpr) > kSmemLimit)
    --hpr;
  return hpr;
}

template <typename T>
cudaError_t launch_fwd_cc(const void* q, const void* k, const void* v,
                          long long sw, long long sr, const int* xyz,
                          const int* mask, const float* table, void* out,
                          int BW, int Tn, int C, int H, int K, int bnd,
                          int use_rpe, float scale, cudaStream_t stream) {
  const int hd = C / H;
  const int num = 2 * bnd + 1;
  size_t smem = sizeof(float) * (3 * Tn * (hd + 1) + kWarps * kMaxT);
  if (use_rpe) smem += sizeof(float) * 3 * num + sizeof(int) * 3 * K;
  smem += sizeof(int) * Tn;
  cudaError_t e = set_smem((const void*)window_attn_fwd_cc_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  window_attn_fwd_cc_kernel<T><<<dim3((unsigned)BW * H), kWarps * 32, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sw, sr, xyz, mask, table,
      static_cast<T*>(out), H, Tn, C, K, bnd, use_rpe, scale);
  return cudaGetLastError();
}

template <int HD, int KS>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          long long sw, long long sr, const int* xyz,
                          const int* mask, const float* table, void* out,
                          int BW, int Tn, int C, int H, int K, int bnd,
                          int use_rpe, float scale, cudaStream_t stream) {
  const size_t smem = fwd_tc_smem(Tn, C, H, K, bnd, use_rpe);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e =
      set_smem((const void*)window_attn_fwd_tc_kernel<HD, KS>, smem);
  if (e != cudaSuccess) return e;
  window_attn_fwd_tc_kernel<HD, KS><<<dim3((unsigned)BW), kFwdWarps * 32,
                                      smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), sw, sr, xyz, mask, table,
      static_cast<bf16*>(out), H, Tn, K, bnd, use_rpe, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_cc(const void* q, const void* k, const void* v,
                          long long sw, long long sr, const int* xyz,
                          const int* mask, const float* table, const void* g,
                          long long gsw, long long gsr, void* dq, void* dk,
                          void* dv, float* dtable, int BW, int Tn, int C,
                          int H, int K, int bnd, int use_rpe, int want_dtab,
                          float scale, cudaStream_t stream) {
  const int hd = C / H;
  const int num = 2 * bnd + 1;
  size_t smem = sizeof(float) * (4 * Tn * (hd + 1) + 2 * Tn * Tn);
  if (use_rpe) smem += sizeof(float) * 3 * num + sizeof(int) * 3 * K;
  if (want_dtab) smem += sizeof(float) * 3 * num;
  smem += sizeof(int) * Tn;
  cudaError_t e = set_smem((const void*)window_attn_bwd_cc_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  window_attn_bwd_cc_kernel<T><<<dim3((unsigned)BW * H), kWarps * 32, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sw, sr, xyz, mask, table,
      static_cast<const T*>(g), gsw, gsr, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dtable, H, Tn, C, K, bnd,
      use_rpe, want_dtab, scale);
  return cudaGetLastError();
}

template <int HD, int KS>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          long long sw, long long sr, const int* xyz,
                          const int* mask, const float* table, const void* g,
                          long long gsw, long long gsr, void* dq, void* dk,
                          void* dv, float* dtable, int BW, int Tn, int C,
                          int H, int K, int bnd, int use_rpe, int want_dtab,
                          float scale, cudaStream_t stream) {
  const int hpr = bwd_heads(Tn, C, H, K, bnd, use_rpe, want_dtab);
  const size_t smem = bwd_tc_smem(Tn, C, K, bnd, use_rpe, want_dtab, hpr);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e =
      set_smem((const void*)window_attn_bwd_tc_kernel<HD, KS>, smem);
  if (e != cudaSuccess) return e;
  window_attn_bwd_tc_kernel<HD, KS><<<dim3((unsigned)BW), hpr * KS * 32,
                                      smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), sw, sr, xyz, mask, table,
      static_cast<const bf16*>(g), gsw, gsr, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dtable, H, Tn, K, bnd,
      use_rpe, want_dtab, hpr, scale);
  return cudaGetLastError();
}

typedef cudaError_t (*FwdTc)(const void*, const void*, const void*,
                             long long, long long, const int*, const int*,
                             const float*, void*, int, int, int, int, int,
                             int, int, float, cudaStream_t);
typedef cudaError_t (*BwdTc)(const void*, const void*, const void*,
                             long long, long long, const int*, const int*,
                             const float*, const void*, long long, long long,
                             void*, void*, void*, float*, int, int, int, int,
                             int, int, int, int, float, cudaStream_t);

template <int HD>
FwdTc fwd_tc_for(int KS) {
  if (KS == 5) return launch_fwd_tc<HD, 5>;
  return launch_fwd_tc<HD, 4>;
}
template <int HD>
BwdTc bwd_tc_for(int KS) {
  if (KS == 5) return launch_bwd_tc<HD, 5>;
  return launch_bwd_tc<HD, 4>;
}

// The tensor-core instantiation for head width hd and key slabs KS
// (nullptr for a head width the bodies do not take).
FwdTc fwd_tc_fn(int hd, int KS) {
  switch (hd) {
    case 16: return fwd_tc_for<16>(KS);
    case 32: return fwd_tc_for<32>(KS);
    case 48: return fwd_tc_for<48>(KS);
    case 64: return fwd_tc_for<64>(KS);
    default: return nullptr;
  }
}
BwdTc bwd_tc_fn(int hd, int KS) {
  switch (hd) {
    case 16: return bwd_tc_for<16>(KS);
    case 32: return bwd_tc_for<32>(KS);
    case 48: return bwd_tc_for<48>(KS);
    case 64: return bwd_tc_for<64>(KS);
    default: return nullptr;
  }
}

// The tensor-core bodies' shape rule (mirrored by attn_body in
// ops/kernels/window_attn.py, which adds the shared-memory limit):
// bf16, hd in {16, 32, 48, 64}, T <= 80, 16-byte aligned rows.
bool tc_shape_ok(int Tn, int C, int H, long long sw, long long sr) {
  const int hd = C / H;
  return hd % 16 == 0 && hd <= 64 && Tn <= kMaxT && sw % 8 == 0 &&
         sr % 8 == 0;
}

}  // namespace

// The tensor-core bodies' plan at a shape: writes the forward's and the
// backward's shared-memory bytes and returns the backward's heads per
// round (ops/kernels/window_attn.py:tc_plan computes the same).
extern "C" int window_attn_tc_plan(int Tn, int C, int H, int K, int bnd,
                                   int use_rpe, int want_dtab,
                                   long long* fwd_bytes,
                                   long long* bwd_bytes) {
  want_dtab = want_dtab && use_rpe;
  const int hpr = bwd_heads(Tn, C, H, K, bnd, use_rpe, want_dtab);
  *fwd_bytes = (long long)fwd_tc_smem(Tn, C, H, K, bnd, use_rpe);
  *bwd_bytes = (long long)bwd_tc_smem(Tn, C, K, bnd, use_rpe, want_dtab, hpr);
  return hpr;
}

// q, k, v: (BW, T, C) float32 (dtype 0) or bfloat16 (dtype 1) with the
// last dimension contiguous, rows sr and windows sw elements apart (the
// same for the three); out: contiguous (BW, T, C). xyz: (BW, 3, K) int32
// with K = T - G; mask: (BW, T) int32; table: (3 * (2 * bnd + 1), H)
// float32. T <= 80. tc = 1 runs the tensor-core body (bf16 only, shapes of
// tc_shape_ok, 16-byte aligned pointers), 0 the CUDA-core body. Returns
// cudaError_t.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v,
                               long long sw, long long sr, const void* xyz,
                               const void* mask, const void* table, void* out,
                               int BW, int Tn, int C, int H, int K, int bnd,
                               int use_rpe, float scale, int dtype, int tc,
                               void* stream) {
  if (Tn > kMaxT || Tn < 1 || C % H != 0 || K > Tn) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(xyz);
  const int* mi = static_cast<const int*>(mask);
  const float* tb = static_cast<const float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    const FwdTc fn = fwd_tc_fn(C / H, key_slabs(Tn));
    if (dtype != 1 || !tc_shape_ok(Tn, C, H, sw, sr) || fn == nullptr)
      return cudaErrorInvalidValue;
    return fn(q, k, v, sw, sr, xi, mi, tb, out, BW, Tn, C, H, K, bnd,
              use_rpe, scale, s);
  }
  if (dtype == 0)
    return launch_fwd_cc<float>(q, k, v, sw, sr, xi, mi, tb, out, BW, Tn, C,
                                H, K, bnd, use_rpe, scale, s);
  if (dtype == 1)
    return launch_fwd_cc<bf16>(q, k, v, sw, sr, xi, mi, tb, out, BW, Tn, C,
                               H, K, bnd, use_rpe, scale, s);
  return cudaErrorInvalidValue;
}

// Backward of window_attn_fwd for the output cotangent g (BW, T, C) in the
// inputs' dtype (rows gsr, windows gsw elements apart): writes contiguous
// dq, dk, dv (BW, T, C) in that dtype and, when want_dtab, ADDS the table
// gradient into dtable (3 * (2 * bnd + 1), H) float32, which the caller
// zeroes. tc as for window_attn_fwd (g's strides too). Returns cudaError_t.
extern "C" int window_attn_bwd(const void* q, const void* k, const void* v,
                               long long sw, long long sr, const void* xyz,
                               const void* mask, const void* table,
                               const void* g, long long gsw, long long gsr,
                               void* dq, void* dk, void* dv, void* dtable,
                               int BW, int Tn, int C, int H, int K, int bnd,
                               int use_rpe, int want_dtab, float scale,
                               int dtype, int tc, void* stream) {
  if (Tn > kMaxT || Tn < 1 || C % H != 0 || K > Tn) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(xyz);
  const int* mi = static_cast<const int*>(mask);
  const float* tb = static_cast<const float*>(table);
  float* dt = static_cast<float*>(dtable);
  want_dtab = want_dtab && use_rpe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    const BwdTc fn = bwd_tc_fn(C / H, key_slabs(Tn));
    if (dtype != 1 || !tc_shape_ok(Tn, C, H, sw, sr) || gsw % 8 || gsr % 8 ||
        fn == nullptr)
      return cudaErrorInvalidValue;
    return fn(q, k, v, sw, sr, xi, mi, tb, g, gsw, gsr, dq, dk, dv, dt, BW,
              Tn, C, H, K, bnd, use_rpe, want_dtab, scale, s);
  }
  if (dtype == 0)
    return launch_bwd_cc<float>(q, k, v, sw, sr, xi, mi, tb, g, gsw, gsr, dq,
                                dk, dv, dt, BW, Tn, C, H, K, bnd, use_rpe,
                                want_dtab, scale, s);
  if (dtype == 1)
    return launch_bwd_cc<bf16>(q, k, v, sw, sr, xi, mi, tb, g, gsw, gsr, dq,
                               dk, dv, dt, BW, Tn, C, H, K, bnd, use_rpe,
                               want_dtab, scale, s);
  return cudaErrorInvalidValue;
}
