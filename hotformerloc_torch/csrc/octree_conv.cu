// Stride-1 27-tap octree convolutions by direct neighbour gather, forward
// and backward, for Hopper (sm_90a). neigh[b, n, k] is the row of node n's
// k-th neighbour within sample b, -1 where there is none (contributes 0).
// The backward weight gradients read per-tap pair lists instead of the
// table: for tap k, dst[k, p] and src[k, p] are the global rows (b*N + n,
// b*N + j) of every neigh[b, n, k] = j >= 0 in row order, count[k] of them
// (ops/plan.py build_tap_lists, built once per plan level on the device).
//
// K3 octree_dwconv_fwd -- depthwise: out[b,n,c] = sum_k w[k,c] x[b,neigh,c]
//   Replaces hotformerloc_tpu/ops/pallas/band_conv.py:_dw_fwd_kernel with
//   its escape patch (_esc_dw_rows, _place; entry banded_dwconv). Bound on
//   the H100: bytes (27 multiply-adds per gathered element), and in
//   practice the latency of the gathers: a node of a uniform cloud has ~1
//   valid tap at the fine depths, ~20 at the coarse dense one. The TPU
//   kernel's halo band and escape list only existed because a TPU kernel
//   cannot gather rows from HBM cheaply; a direct gather needs neither.
//   Hopper's TMA has no row-gather mode either, so rows come by 16-byte
//   loads. dwconv_fwd_kernel: a persistent grid sized to the resident
//   blocks walks tiles of 64 Morton-ordered nodes. A tile's neighbour
//   rows (64 x 108 contiguous bytes) come into shared memory by cp.async,
//   double-buffered: the next tile's rows load while this one computes,
//   so no index load sits on a node's critical path. A group of S lanes
//   (S = the row's 16-byte vectors, at most 32) owns one node at a time:
//   its lanes read the node's 27 indices from shared memory, OR their
//   valid bits together by shuffles, then walk only the valid taps,
//   issuing four independent row gathers before the multiply-adds that
//   use them. The groups of a block take neighbouring nodes in turn, so
//   their rows overlap in L1 at the dense depth. Weights sit in shared
//   memory in the activations' dtype (read flipped, w[26 - k], for K4's
//   dx). fp32 sums in tap order, one rounding; no atomics: deterministic.
//
// K5 octree_conv_fwd -- full (gather-GEMM), and K6's dx by the flip
//   identity: out[b,n,o] = sum_{k,c} W_k[c,o] x[b, neigh[b,n,k], c] + bias[o]
//   with W_k = w[k], or for dx W_k = w[26 - k]^T read in place.
//   Replaces band_conv.py:_conv_fwd_kernel with its escape patch
//   (_esc_conv_rows, _place; entry banded_conv).
//   - conv_fwd_tc_kernel (bf16, C and O multiples of 16): bound by the
//     gather's latency, not by the 2*27*C*O flops per node, most of which
//     multiply missing neighbours (a node of a sparse cloud has a few of
//     its 27). A block owns 64 Morton-ordered nodes x 64 outputs: it reads
//     the tile's neighbour rows once into shared memory, finds with one
//     ballot per tap which taps have any neighbour in the tile, and runs
//     only those. Per (tap, 32-channel chunk) it gathers the 64 rows with
//     16-byte cp.async (zero-fill for a missing neighbour) beside the
//     weight slice, double-buffered against the previous stage's
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Bias in fp32, one
//     rounding, 16-byte stores. No scatter, no atomics: deterministic.
//     Hopper's TMA has no row-gather mode, so the rows come by cp.async.
//   - conv_fwd_kernel (CUDA cores, fp32 accumulate): the fp32 parity path,
//     because mma.sync takes no fp32 operands (TF32 would round them) and
//     this body sums exactly the products the plain version sums; and any
//     shape the tensor-core body does not take (the stem's first conv,
//     C = 3: its 6-byte rows are too narrow for 16-byte copies, and
//     padding them to 16 channels would multiply zeros 5x). It skips taps
//     with no neighbour in its 64-node tile as the tensor-core body does.
//
// K4 octree_dwconv_bwd replaces band_conv.py:_dw_bwd_kernel with its escape
//   patch (_banded_dwconv_bwd). dx = dwconv(dy, neigh, w[::-1]) runs K3's
//   body (stencil flip identity, as the TPU kernel does). dw[k, c] =
//   sum over tap k's pairs of x[src, c] * dy[dst, c] (dwconv_dw_taps_
//   kernel, every dtype): a per-channel reduction with no product for the
//   tensor cores, bound by the latency of its gathers. Each lane holds one
//   16-byte vector of channels and groups of lanes stride the pairs, so a
//   valid tap costs one index pair and two vector loads; the empty taps
//   (most of them at the fine depths) cost nothing.
//
// K6 octree_conv_bwd replaces band_conv.py:_conv_bwd_kernel with its escape
//   patch (_banded_conv_bwd). dx as for K5 above. dw[k] = X_k^T DY_k over
//   tap k's pairs: conv_dw_tc_kernel (bf16) gathers 32 pairs' x and dy row
//   pieces by cp.async and multiplies them on mma.sync with ldmatrix.trans
//   (the reduction runs over rows); conv_dw_partial_kernel (CUDA cores:
//   fp32, for the reason above, and the shapes the tensor-core body does
//   not take) walks the table and skips 16-row chunks without a tap-k
//   neighbour. db is a torch sum, outside the kernel, as in JAX.
//
// Weight-gradient reductions: on the TPU a sequential grid carried the sum
// in VMEM; here blocks run in parallel. The pair-list kernels split the
// concatenated chunk list of all taps evenly over a fixed grid of workers
// (the grid is sized without reading the counts on the host), so the work
// follows the valid pairs. A worker writes one partial per tap its range
// touches, into slot (worker + tap), and sum_segments_kernel adds each
// tap's partials in worker order: deterministic, no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 27;
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

// PTX helpers: 16-byte cp.async with zero-fill, ldmatrix and
// mma.sync.m16n8k16 (row.col, bf16 in, fp32 accumulate). Fragment layouts
// (g = lane / 4, c = lane % 4): A rows g and g + 8, k columns 2c, 2c + 1
// (regs 0, 1) and 2c + 8, 2c + 9 (regs 2, 3); B k rows 2c.. and 2c + 8..,
// column g; C rows g (regs 0, 1) and g + 8 (regs 2, 3), columns 2c, 2c + 1.
// ldmatrix x4 takes lanes 0-7, 8-15, 16-23, 24-31 as the row addresses of
// its four 8x8 matrices.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Copies 16 bytes, or writes 16 zero bytes when !ok (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---- K3 (and K4's dx) -----------------------------------------------------

constexpr int kDwFwdThreads = 256;
constexpr int kDwFwdTile = 64;      // nodes per index tile (at least)
constexpr int kDwFwdUnroll = 4;     // row gathers issued before their use

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// VEC elements of shared (or global) memory -> fp32 registers, by a
// generic load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec_plain(const T* p, float* r) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = to_f(p[i]);
  }
}

// Bytes of the weights in shared memory, rounded up to 16.
__host__ __device__ __forceinline__ int dw_wbytes(int C, int esize) {
  return (kTaps * C * esize + 15) & ~15;
}

// Shared memory: the (27, C) weights in T (when wsmem; else they are
// read from global memory, which only a C of thousands needs), then two
// index tiles of tn rows of 27 int32. S lanes per node (a power of two,
// 32 at most, S divides 256), tn = max(64, 256 / S) nodes per tile, so
// every group has tn * S / 256 nodes per tile. aligned: neigh is 16-byte
// aligned (else the index rows come by 4-byte copies).
template <typename T, int VEC>
__global__ void __launch_bounds__(kDwFwdThreads)
dwconv_fwd_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                  const T* __restrict__ w, T* __restrict__ out, int N, int C,
                  int rows, int S, int tn, int flip, int aligned,
                  int wsmem) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* wsm = reinterpret_cast<T*>(dw_smem);
  int* isn = reinterpret_cast<int*>(
      dw_smem + (wsmem ? dw_wbytes(C, sizeof(T)) : 0));
  const int tid = threadIdx.x;
  const int tiles = (rows + tn - 1) / tn;
  const long long nwords = (long long)rows * kTaps;

  // index rows of tile t into buffer buf (one cp.async group per call)
  auto stage = [&](int t, int buf) {
    if (t < tiles) {
      int* dst = isn + buf * tn * kTaps;
      const long long w0 = (long long)t * tn * kTaps;
      const int nw = (int)min((long long)tn * kTaps, nwords - w0);
      const int n16 = aligned ? nw / 4 : 0;
      for (int i = tid; i < n16; i += kDwFwdThreads)
        cp_async16(dst + 4 * i, neigh + w0 + 4 * i, true);
      for (int i = 4 * n16 + tid; i < nw; i += kDwFwdThreads)
        cp_async4(dst + i, neigh + w0 + i);
    }
    cp_async_commit();
  };

  stage(blockIdx.x, 0);
  if (wsmem)
    for (int i = tid; i < kTaps * C; i += kDwFwdThreads) {
      const int k = i / C;
      wsm[i] = w[flip ? i + (kTaps - 1 - 2 * k) * C : i];
    }
  const T* wb = wsmem ? wsm : w;
  const int wflip = flip && !wsmem;
  const int CV = C / VEC;
  const int groups = kDwFwdThreads / S;
  const int g = tid / S, lig = tid % S;
  for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
    const int buf = it & 1;
    stage(t + gridDim.x, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const int* tile = isn + buf * tn * kTaps;
    const int r0 = t * tn;
    // every lane runs the same number of node slots, so the shuffles
    // below see the whole warp
    for (int n = g; n < tn; n += groups) {
      const int r = r0 + n;
      const bool live = r < rows;
      const int* row = tile + n * kTaps;
      unsigned bits = 0u;
      if (live)
        for (int k = lig; k < kTaps; k += S)
          if (row[k] >= 0) bits |= 1u << k;
      for (int o = 1; o < S; o <<= 1)
        bits |= __shfl_xor_sync(0xffffffffu, bits, o);
      if (!live) continue;
      const T* xs = x + (long long)(r / N) * N * C;
      for (int v = lig; v < CV; v += S) {
        const int c0 = v * VEC;
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
        unsigned m = bits;
        while (m) {
          int kk[kDwFwdUnroll];
          float xv[kDwFwdUnroll][VEC];
#pragma unroll
          for (int u = 0; u < kDwFwdUnroll; ++u) {
            kk[u] = m ? __ffs(m) - 1 : -1;
            m &= m - 1;
          }
#pragma unroll
          for (int u = 0; u < kDwFwdUnroll; ++u)
            if (kk[u] >= 0)
              load_vec<T, VEC>(xs + (long long)row[kk[u]] * C + c0, xv[u]);
#pragma unroll
          for (int u = 0; u < kDwFwdUnroll; ++u)
            if (kk[u] >= 0) {
              float wv[VEC];
              const int kw = wflip ? kTaps - 1 - kk[u] : kk[u];
              load_vec_plain<T, VEC>(wb + kw * C + c0, wv);
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                acc[i] = fmaf(wv[i], xv[u][i], acc[i]);
            }
        }
        store_vec<T, VEC>(out + (long long)r * C + c0, acc);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ---- K5 / K6 dx, CUDA-core body ------------------------------------------

constexpr int kTN = 64;   // nodes per block tile
constexpr int kTO = 64;   // outputs per block tile
constexpr int kCC = 16;   // channels per shared-memory chunk

// Index of W_k[c, o] in w: (27, C, O) as given, or with flip_t the
// forward's (27, O, C) weight read as w[26 - k]^T (K6's dx).
__device__ __forceinline__ size_t w_index(int k, int c, int o, int C, int O,
                                          int flip_t) {
  return flip_t ? ((size_t)(kTaps - 1 - k) * O + o) * C + c
                : ((size_t)k * C + c) * O + o;
}

template <typename T>
__global__ void __launch_bounds__(256)
conv_fwd_kernel(const T* __restrict__ x, const int* __restrict__ neigh,
                const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ out, int N, int C, int O, long long rows,
                int flip_t) {
  __shared__ __align__(16) float xs[kCC][kTN];
  __shared__ __align__(16) float ws[kCC][kTO];
  __shared__ long long src[kTN];
  __shared__ unsigned tap_mask;
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // output group: outputs tx*4 .. tx*4+3
  const int ty = tid >> 4;         // node group: nodes ty*4 .. ty*4+3
  const long long r0 = (long long)blockIdx.x * kTN;
  const int o0 = blockIdx.y * kTO;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // taps with a neighbour anywhere in the tile: 4 threads per node
  if (tid == 0) tap_mask = 0u;
  __syncthreads();
  {
    const long long r = r0 + (tid & (kTN - 1));
    unsigned bits = 0u;
    if (r < rows)
      for (int k = tid >> 6; k < kTaps; k += 4)
        if (__ldg(neigh + r * kTaps + k) >= 0) bits |= 1u << k;
    bits = __reduce_or_sync(0xffffffffu, bits);
    if ((tid & 31) == 0 && bits) atomicOr(&tap_mask, bits);
  }
  __syncthreads();
  const unsigned mask = tap_mask;

  for (int k = 0; k < kTaps; ++k) {
    if (!((mask >> k) & 1u)) continue;
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
                        ? to_f(w[w_index(k, c, oo, C, O, flip_t)]) : 0.f;
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

// ---- K5 / K6 dx, tensor-core body (bf16) ---------------------------------

constexpr int kFM = 64;             // nodes per block tile
constexpr int kFN = 64;             // outputs per block tile
constexpr int kFK = 32;             // channels per stage
constexpr int kFLdA = kFK + 8;      // shared row of a gathered (node, chunk)
constexpr int kFLdO = kFN + 8;      // shared row of the output tile
constexpr int kFThreads = 128;      // 4 warps, 16 nodes x 64 outputs each

// FLIP_T: w is the forward's (27, O, C) weight and W_k = w[26 - k]^T, held
// in shared memory as [o][c] rows (ldmatrix without .trans); otherwise w is
// (27, C, O), held as [c][o] rows (ldmatrix.trans).
template <bool FLIP_T>
__global__ void __launch_bounds__(kFThreads)
conv_fwd_tc_kernel(const bf16* __restrict__ x, const int* __restrict__ neigh,
                   const bf16* __restrict__ w, const bf16* __restrict__ bias,
                   bf16* __restrict__ out, int N, int C, int O,
                   long long rows) {
  constexpr int kLdB = FLIP_T ? kFK + 8 : kFN + 8;
  constexpr int kBSize = FLIP_T ? kFN * kLdB : kFK * kLdB;
  __shared__ __align__(16) bf16 As[2][kFM * kFLdA];
  __shared__ __align__(16) bf16 Bs[2][kBSize];
  __shared__ int nbs[kTaps][kFM];     // global source row, -1 if none
  __shared__ int taps[kTaps];
  __shared__ unsigned tap_mask;
  static_assert(kFM * kFLdO <= 2 * kFM * kFLdA, "output tile fits in As");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kFM;
  const int o0 = blockIdx.y * kFN;

  if (tid == 0) tap_mask = 0u;
  for (int i = tid; i < kFM * kTaps; i += kFThreads) {
    const int n = i / kTaps, k = i - n * kTaps;
    const long long r = r0 + n;
    int s = -1;
    if (r < rows) {
      const int j = __ldg(neigh + r0 * kTaps + i);
      if (j >= 0) s = (int)((r / N) * N + j);
    }
    nbs[k][n] = s;
  }
  __syncthreads();
  for (int k = warp; k < kTaps; k += kFThreads / 32) {
    const bool any = __any_sync(0xffffffffu,
                                nbs[k][lane] >= 0 || nbs[k][lane + 32] >= 0);
    if (lane == 0 && any) atomicOr(&tap_mask, 1u << k);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < kTaps; ++k)
      if ((tap_mask >> k) & 1u) taps[n++] = k;
  }
  __syncthreads();
  const int nchunk = (C + kFK - 1) / kFK;
  const int stages = __popc(tap_mask) * nchunk;

  // Stage s = (tap taps[s / nchunk], channels c0 .. c0 + 31).
  auto load_stage = [&](int s, int buf) {
    const int k = taps[s / nchunk];
    const int c0 = (s % nchunk) * kFK;
    bf16* a = As[buf];
    bf16* b = Bs[buf];
    for (int i = tid; i < kFM * (kFK / 8); i += kFThreads) {
      const int n = i / (kFK / 8), cc = (i % (kFK / 8)) * 8;
      const int sr = nbs[k][n];
      const bool ok = sr >= 0 && c0 + cc < C;
      cp_async16(a + n * kFLdA + cc, ok ? x + (size_t)sr * C + c0 + cc : x,
                 ok);
    }
    if (FLIP_T) {
      for (int i = tid; i < kFN * (kFK / 8); i += kFThreads) {
        const int o = i / (kFK / 8), cc = (i % (kFK / 8)) * 8;
        const bool ok = o0 + o < O && c0 + cc < C;
        cp_async16(b + o * kLdB + cc,
                   ok ? w + ((size_t)(kTaps - 1 - k) * O + o0 + o) * C + c0 +
                            cc
                      : w,
                   ok);
      }
    } else {
      for (int i = tid; i < kFK * (kFN / 8); i += kFThreads) {
        const int cc = i / (kFN / 8), o = (i % (kFN / 8)) * 8;
        const bool ok = c0 + cc < C && o0 + o < O;
        cp_async16(b + cc * kLdB + o,
                   ok ? w + ((size_t)k * C + c0 + cc) * O + o0 + o : w, ok);
      }
    }
    cp_async_commit();
  };

  float acc[kFN / 8][4];
#pragma unroll
  for (int j = 0; j < kFN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (stages > 0) load_stage(0, 0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      load_stage(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = As[s & 1];
    const bf16* b_s = Bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < kFK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                           kFLdA + kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < kFN / 16; ++np) {
        uint32_t b[4];
        if (FLIP_T)
          ldsm_x4(b, b_s + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kLdB +
                         kk * 16 + 8 * ((lane >> 3) & 1));
        else
          ldsm_x4_t(b, b_s + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                             kLdB + np * 16 + 8 * (lane >> 4));
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  // epilogue: + bias in fp32, one rounding, staged in As for 16-byte stores
  bf16* os = As[0];
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int j = 0; j < kFN / 8; ++j) {
    const int col = 8 * j + 2 * cq;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr && o0 + col < O) {
      b0 = __bfloat162float(bias[o0 + col]);
      b1 = __bfloat162float(bias[o0 + col + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + g + 8 * i;
      *reinterpret_cast<uint32_t*>(os + row * kFLdO + col) =
          pack_bf16(acc[j][2 * i] + b0, acc[j][2 * i + 1] + b1);
    }
  }
  __syncthreads();
  for (int i = tid; i < kFM * (kFN / 8); i += kFThreads) {
    const int n = i / (kFN / 8), o = (i % (kFN / 8)) * 8;
    const long long r = r0 + n;
    if (r < rows && o0 + o < O)
      *reinterpret_cast<uint4*>(out + r * O + o0 + o) =
          *reinterpret_cast<const uint4*>(os + n * kFLdO + o);
  }
}

// ---- weight gradients over the tap lists ---------------------------------
// Tap k's pairs are cut into chunks of CHUNK pairs; pre[k] is the number of
// chunks of taps before k (pre[27] in all). Of the grid's workers, the
// first G = min(grid, total) run: worker b takes chunks
// [b * total / G, (b + 1) * total / G), never empty, and writes one partial
// per tap its range touches, into slot b + k. The ranges are ordered, so
// two (worker, tap) pairs never share a slot, G + 27 slots always suffice,
// and the workers of tap k are the contiguous run from the owner of its
// first chunk to the owner of its last.

// pre[] in shared memory by one warp: lane k loads count[k], then an
// inclusive shuffle scan of the chunk counts.
__device__ __forceinline__ void chunk_prefix(const int* __restrict__ count,
                                             int chunk, int* pre) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int v = lane < kTaps ? (__ldg(count + lane) + chunk - 1) / chunk : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane < kTaps) pre[lane + 1] = v;
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
}

__device__ __forceinline__ int worker_begin(int b, int total, int G) {
  return (int)((long long)b * total / G);
}

// The worker whose range holds chunk j: the largest b with
// worker_begin(b) <= j.
__device__ __forceinline__ int worker_of(int j, int total, int G) {
  return (int)(((long long)(j + 1) * G + total - 1) / total) - 1;
}

__device__ __forceinline__ int tap_of_chunk(const int* pre, int ch) {
  int k = 0;
  while (pre[k + 1] <= ch) ++k;
  return k;
}

constexpr int kDwPairs = 64;        // K4: pairs per chunk
constexpr int kDwThreads = 256;

// partial[b + k, c] = sum over worker b's pairs of tap k of
// x[src, c] * dy[dst, c]. Grid (workers, channel slices of 256 vectors).
template <typename T, int VEC>
__global__ void __launch_bounds__(kDwThreads)
dwconv_dw_taps_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const int* __restrict__ tdst,
                      const int* __restrict__ tsrc,
                      const int* __restrict__ tcount, int cap,
                      float* __restrict__ partial, int C) {
  __shared__ int pre[kTaps + 1];
  __shared__ float red[kDwThreads * VEC];
  chunk_prefix(tcount, kDwPairs, pre);
  const int total = pre[kTaps], G = min((int)gridDim.x, total);
  const int b = blockIdx.x;
  if (b >= G) return;
  const int g1 = worker_begin(b + 1, total, G);
  const int V = C / VEC;
  const int vb0 = blockIdx.y * kDwThreads;
  const int VB = min(V - vb0, kDwThreads);
  const int groups = kDwThreads / VB;
  const int t = threadIdx.x, v = t % VB, q = t / VB;
  const bool act = q < groups;
  const int c = (vb0 + v) * VEC;
  for (int ch = worker_begin(b, total, G); ch < g1;) {
    const int k = tap_of_chunk(pre, ch);
    const int end = min(g1, pre[k + 1]);
    const int p_end = min(__ldg(tcount + k), (end - pre[k]) * kDwPairs);
    if (act) {
      const int* pd = tdst + (size_t)k * cap;
      const int* ps = tsrc + (size_t)k * cap;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int p = (ch - pre[k]) * kDwPairs + q; p < p_end; p += groups) {
        const int s = __ldg(ps + p), d = __ldg(pd + p);
        float xv[VEC], dv[VEC];
        load_vec<T, VEC>(x + (size_t)s * C + c, xv);
        load_vec<T, VEC>(dy + (size_t)d * C + c, dv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(xv[i], dv[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[(q * VB + v) * VEC + i] = acc[i];
    }
    __syncthreads();
    float* out = partial + (size_t)(b + k) * C + (size_t)vb0 * VEC;
    for (int e = t; e < VB * VEC; e += kDwThreads) {
      float s = 0.f;
      for (int qq = 0; qq < groups; ++qq) s += red[qq * VB * VEC + e];
      out[e] = s;
    }
    __syncthreads();
    ch = end;
  }
}

constexpr int kWPairs = 32;         // K6 tensor-core: pairs per chunk/stage
constexpr int kWTile = 64;          // C and O per block tile
constexpr int kWLd = kWTile + 8;

// partial[b + k, c, o] = sum over worker b's pairs of tap k of
// x[src, c] * dy[dst, o] for one 64 x 64 (C, O) tile. Grid (workers,
// tiles); 4 warps, each a 32 x 32 quarter of the tile.
__global__ void __launch_bounds__(128)
conv_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const int* __restrict__ tdst, const int* __restrict__ tsrc,
                  const int* __restrict__ tcount, int cap,
                  float* __restrict__ partial, int C, int O, int otiles) {
  __shared__ __align__(16) bf16 Xs[2][kWPairs * kWLd];
  __shared__ __align__(16) bf16 Ds[2][kWPairs * kWLd];
  __shared__ int pre[kTaps + 1];
  chunk_prefix(tcount, kWPairs, pre);
  const int total = pre[kTaps], G = min((int)gridDim.x, total);
  const int b = blockIdx.x;
  if (b >= G) return;
  const int g1 = worker_begin(b + 1, total, G);
  const int o0 = (blockIdx.y % otiles) * kWTile;
  const int c0 = (blockIdx.y / otiles) * kWTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, cq = lane & 3;
  for (int ch = worker_begin(b, total, G); ch < g1;) {
    const int k = tap_of_chunk(pre, ch);
    const int end = min(g1, pre[k + 1]);
    const int cnt = __ldg(tcount + k);
    const int base = pre[k];
    const int* pd = tdst + (size_t)k * cap;
    const int* ps = tsrc + (size_t)k * cap;
    auto load_stage = [&](int chunk, int buf) {
      const int p0 = (chunk - base) * kWPairs;
      for (int i = tid; i < kWPairs * (kWTile / 8); i += 128) {
        const int p = i / (kWTile / 8), cc = (i % (kWTile / 8)) * 8;
        const int pi = p0 + p;
        const bool live = pi < cnt;
        const int s = live ? __ldg(ps + pi) : 0;
        const int d = live ? __ldg(pd + pi) : 0;
        const bool okx = live && c0 + cc < C, oky = live && o0 + cc < O;
        cp_async16(&Xs[buf][p * kWLd + cc],
                   okx ? x + (size_t)s * C + c0 + cc : x, okx);
        cp_async16(&Ds[buf][p * kWLd + cc],
                   oky ? dy + (size_t)d * O + o0 + cc : dy, oky);
      }
      cp_async_commit();
    };
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    const int n = end - ch;
    load_stage(ch, 0);
    for (int s = 0; s < n; ++s) {
      if (s + 1 < n) {
        load_stage(ch + s + 1, (s + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* xs = Xs[s & 1];
      const bf16* ds = Ds[s & 1];
#pragma unroll
      for (int kk = 0; kk < kWPairs / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_t(a[mt], xs + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                    kWLd + wm * 32 + mt * 16 +
                                    8 * ((lane >> 3) & 1));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, ds + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                 kWLd + wn * 32 + np * 16 + 8 * (lane >> 4));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma16816(acc[mt][2 * np], a[mt], bb[0], bb[1]);
            mma16816(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
      __syncthreads();
    }
    float* out = partial + (size_t)(b + k) * C * O;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = c0 + wm * 32 + mt * 16 + g + 8 * i;
          const int o = o0 + wn * 32 + 8 * j + 2 * cq;
          if (c < C && o < O)
            *reinterpret_cast<float2*>(out + (size_t)c * O + o) =
                make_float2(acc[mt][j][2 * i], acc[mt][j][2 * i + 1]);
        }
    ch = end;
  }
}

// out[k, e] = sum of tap k's partials in worker order (zero for a tap
// without pairs); G is the grid size the workers ran with. Block
// (32 elements, tap k) of 8 warps: warp w adds the w-th eighth of the
// tap's workers, then warp 0 adds the eight sums in order.
__global__ void __launch_bounds__(256)
sum_segments_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    const int* __restrict__ tcount, int chunk, int G, int E) {
  __shared__ int pre[kTaps + 1];
  __shared__ float part[8][32];
  chunk_prefix(tcount, chunk, pre);
  const int k = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int total = pre[kTaps];
  float s = 0.f;
  if (pre[k + 1] > pre[k] && e < E) {
    const int Ge = min(G, total);
    const int b0 = worker_of(pre[k], total, Ge);
    const int n = worker_of(pre[k + 1] - 1, total, Ge) + 1 - b0;
    const int lo = b0 + (int)((long long)n * warp / 8);
    const int hi = b0 + (int)((long long)n * (warp + 1) / 8);
    const float* p = partial + (size_t)k * E + e;      // slot b + k
#pragma unroll 4
    for (int b = lo; b < hi; ++b) s += p[(size_t)b * E];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < E) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += part[w][lane];
    out[(size_t)k * E + e] = t;
  }
}

// ---- K6 CUDA-core weight gradient (fp32 and odd shapes) -------------------
// Block p of the grid sums a contiguous split of rows into a per-split
// partial in device memory; sum_parts_kernel then adds the splits in a
// fixed order, so the result is deterministic.

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

// ---- launchers -----------------------------------------------------------

unsigned grid_for(long long n, int sms) {
  long long blocks = (n + 255) / 256;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// K3's body: S lanes per node, the row's 16-byte vectors (or elements, on
// the scalar path) rounded up to a power of two, at most 32; a persistent
// grid of the blocks that fit on the card at once, at most one per tile.
template <typename T, int VEC>
cudaError_t launch_dw(const void* x, const int* neigh, const void* w,
                      void* out, int B, int N, int C, int flip, int sms,
                      cudaStream_t stream) {
  const long long rows = (long long)B * N;
  if (rows < 1 || C < 1) return cudaSuccess;
  int S = 1;
  while (S < 32 && S < C / VEC) S <<= 1;
  const int tn = kDwFwdTile > kDwFwdThreads / S ? kDwFwdTile
                                                : kDwFwdThreads / S;
  const size_t tiles_smem = 2 * sizeof(int) * (size_t)tn * kTaps;
  const int wsmem = dw_wbytes(C, sizeof(T)) + tiles_smem <= 227 * 1024;
  const size_t smem =
      tiles_smem + (wsmem ? (size_t)dw_wbytes(C, sizeof(T)) : 0);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(dwconv_fwd_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  // resident blocks per SM, asked once per instantiation and shared
  // memory size (the model's calls take a handful of sizes)
  static size_t cached_smem[8];
  static int cached_per_sm[8];
  int per_sm = 0;
  for (int i = 0; i < 8 && cached_per_sm[i]; ++i)
    if (cached_smem[i] == smem) per_sm = cached_per_sm[i];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dwconv_fwd_kernel<T, VEC>, kDwFwdThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    for (int i = 0; i < 8; ++i)
      if (!cached_per_sm[i]) {
        cached_smem[i] = smem;
        cached_per_sm[i] = per_sm;
        break;
      }
  }
  const long long tiles = (rows + tn - 1) / tn;
  const long long blocks = tiles < (long long)sms * per_sm
                               ? tiles : (long long)sms * per_sm;
  const int aligned = (reinterpret_cast<uintptr_t>(neigh) & 15) == 0;
  dwconv_fwd_kernel<T, VEC><<<(unsigned)blocks, kDwFwdThreads, smem,
                              stream>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(w),
      static_cast<T*>(out), N, C, (int)rows, S, tn, flip, aligned, wsmem);
  return cudaGetLastError();
}

// The node tile is grid.x (up to 2^31 - 1 tiles), the output tile grid.y.
template <typename T>
cudaError_t launch_conv(const void* x, const int* neigh, const void* w,
                        const void* bias, void* out, int B, int N, int C,
                        int O, int flip_t, cudaStream_t stream) {
  const long long rows = (long long)B * N;
  const long long tiles = (rows + kTN - 1) / kTN;
  const dim3 grid((unsigned)tiles, (O + kTO - 1) / kTO);
  conv_fwd_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), neigh, static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), N, C, O, rows,
      flip_t);
  return cudaGetLastError();
}

cudaError_t launch_conv_tc(const void* x, const int* neigh, const void* w,
                           const void* bias, void* out, int B, int N, int C,
                           int O, int flip_t, cudaStream_t stream) {
  if (C % 16 || O % 16) return cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  const dim3 grid((unsigned)((rows + kFM - 1) / kFM), (O + kFN - 1) / kFN);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  if (flip_t)
    conv_fwd_tc_kernel<true><<<grid, kFThreads, 0, stream>>>(
        xb, neigh, wb, bb, ob, N, C, O, rows);
  else
    conv_fwd_tc_kernel<false><<<grid, kFThreads, 0, stream>>>(
        xb, neigh, wb, bb, ob, N, C, O, rows);
  return cudaGetLastError();
}

cudaError_t launch_sum_segments(const float* partial, float* out,
                                const int* tcount, int chunk, int G, int E,
                                cudaStream_t stream) {
  sum_segments_kernel<<<dim3((E + 31) / 32, kTaps), 256, 0, stream>>>(
      partial, out, tcount, chunk, G, E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dwconv_bwd(const void* x, const int* neigh, const void* w,
                       const void* dy, void* dx, const int* tdst,
                       const int* tsrc, const int* tcount, float* partial,
                       float* dw, int B, int N, int C, int workers, int vec,
                       int sms, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (dx) {
    const cudaError_t e =
        vec ? launch_dw<T, V>(dy, neigh, w, dx, B, N, C, 1, sms, s)
            : launch_dw<T, 1>(dy, neigh, w, dx, B, N, C, 1, sms, s);
    if (e != cudaSuccess) return e;
  }
  const int cap = B * N;
  const int nvec = vec ? C / V : C;
  const dim3 grid((unsigned)workers, (nvec + kDwThreads - 1) / kDwThreads);
  if (vec)
    dwconv_dw_taps_kernel<T, V><<<grid, kDwThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), tdst, tsrc,
        tcount, cap, partial, C);
  else
    dwconv_dw_taps_kernel<T, 1><<<grid, kDwThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), tdst, tsrc,
        tcount, cap, partial, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum_segments(partial, dw, tcount, kDwPairs, workers, C, s);
}

template <typename T>
cudaError_t conv_bwd_cc(const void* x, const int* neigh, const void* w,
                        const void* dy, void* dx, float* partial, float* dw,
                        int B, int N, int C, int O, int parts, int sms,
                        cudaStream_t s) {
  if (dx) {
    const cudaError_t e =
        launch_conv<T>(dy, neigh, w, nullptr, dx, B, N, O, C, 1, s);
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
  const long long n = (long long)kTaps * C * O;
  sum_parts_kernel<<<grid_for(n, sms), 256, 0, s>>>(partial, dw, parts, n);
  return cudaGetLastError();
}

cudaError_t conv_bwd_tc(const void* x, const int* neigh, const void* w,
                        const void* dy, void* dx, const int* tdst,
                        const int* tsrc, const int* tcount, float* partial,
                        float* dw, int B, int N, int C, int O, int workers,
                        cudaStream_t s) {
  if (dx) {
    const cudaError_t e =
        launch_conv_tc(dy, neigh, w, nullptr, dx, B, N, O, C, 1, s);
    if (e != cudaSuccess) return e;
  }
  if (C % 16 || O % 16) return cudaErrorInvalidValue;
  const int otiles = (O + kWTile - 1) / kWTile;
  const int tiles = otiles * ((C + kWTile - 1) / kWTile);
  conv_dw_tc_kernel<<<dim3((unsigned)workers, (unsigned)tiles), 128, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), tdst, tsrc,
      tcount, B * N, partial, C, O, otiles);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum_segments(partial, dw, tcount, kWPairs, workers, C * O,
                             s);
}

}  // namespace

// K3. x, out: (B, N, C) contiguous, float32 (dtype 0) or bfloat16 (dtype
// 1); neigh: (B, N, 27) int32; w: (27, C) in x's dtype. vec != 0 selects
// the 16-byte vector path (C a multiple of 16 / sizeof(element), pointers
// 16-byte aligned). sms: the card's SM count (grid cap). Returns
// cudaError_t.
extern "C" int octree_dwconv_fwd(const void* x, const void* neigh,
                                 const void* w, void* out, int B, int N, int C,
                                 int dtype, int vec, int sms, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_dw<float, 4>(x, nb, w, out, B, N, C, 0, sms, s)
               : launch_dw<float, 1>(x, nb, w, out, B, N, C, 0, sms, s);
  if (dtype == 1)
    return vec ? launch_dw<bf16, 8>(x, nb, w, out, B, N, C, 0, sms, s)
               : launch_dw<bf16, 1>(x, nb, w, out, B, N, C, 0, sms, s);
  return cudaErrorInvalidValue;
}

// K5. x: (B, N, C); neigh: (B, N, 27) int32; w: (27, C, O) and bias: (O,)
// or null, in x's dtype; out: (B, N, O). tc != 0 runs the tensor-core body
// (bf16, C and O multiples of 16, 16-byte aligned pointers), else the
// CUDA-core body. Returns cudaError_t.
extern "C" int octree_conv_fwd(const void* x, const void* neigh, const void* w,
                               const void* bias, void* out, int B, int N,
                               int C, int O, int dtype, int tc, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc)
    return dtype == 1
               ? launch_conv_tc(x, nb, w, bias, out, B, N, C, O, 0, s)
               : cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_conv<float>(x, nb, w, bias, out, B, N, C, O, 0, s);
  if (dtype == 1)
    return launch_conv<bf16>(x, nb, w, bias, out, B, N, C, O, 0, s);
  return cudaErrorInvalidValue;
}

// K4, the backward of octree_dwconv_fwd. x, dy: (B, N, C); w: (27, C) in
// x's dtype. dx (null to skip) = dwconv(dy, neigh, w[::-1]), the stencil
// flip identity (neigh[m, k] = n <=> neigh[n, 26 - k] = m; every padding
// row of neigh is -1), by K3's body reading w flipped. dw (27, C) float32
// over the tap lists tdst, tsrc (27, B*N) int32 and tcount (27,) int32,
// through partial (workers + 27, C) float32 scratch. vec as for
// octree_dwconv_fwd, for x and dy. Returns cudaError_t.
extern "C" int octree_dwconv_bwd(const void* x, const void* neigh,
                                 const void* w, const void* dy, void* dx,
                                 const void* tdst, const void* tsrc,
                                 const void* tcount, void* partial, void* dw,
                                 int B, int N, int C, int workers, int dtype,
                                 int vec, int sms, void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  const int* td = static_cast<const int*>(tdst);
  const int* ts = static_cast<const int*>(tsrc);
  const int* tc = static_cast<const int*>(tcount);
  float* pt = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (workers < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dwconv_bwd<float>(x, nb, w, dy, dx, td, ts, tc, pt, out, B, N, C,
                             workers, vec, sms, s);
  if (dtype == 1)
    return dwconv_bwd<bf16>(x, nb, w, dy, dx, td, ts, tc, pt, out, B, N, C,
                            workers, vec, sms, s);
  return cudaErrorInvalidValue;
}

// K6, the backward of octree_conv_fwd (without db, a plain sum the caller
// takes). x: (B, N, C); dy: (B, N, O); w: (27, C, O) in x's dtype. dx (null
// to skip) = conv(dy, neigh, w[::-1] transposed), read in place. dw (27,
// C, O) float32. tc != 0: the tensor-core bodies (bf16, C and O multiples
// of 16), dw over the tap lists through partial (parts + 27, C, O) with
// parts workers; else the CUDA-core bodies, dw through partial (parts, 27,
// C, O) with parts row splits, and the tap lists unused. Returns
// cudaError_t.
extern "C" int octree_conv_bwd(const void* x, const void* neigh, const void* w,
                               const void* dy, void* dx, const void* tdst,
                               const void* tsrc, const void* tcount,
                               void* partial, void* dw, int B, int N, int C,
                               int O, int parts, int dtype, int tc, int sms,
                               void* stream) {
  const int* nb = static_cast<const int*>(neigh);
  float* pt = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts < 1 || parts > 65535) return cudaErrorInvalidValue;
  if (tc)
    return dtype == 1 ? conv_bwd_tc(x, nb, w, dy, dx,
                                    static_cast<const int*>(tdst),
                                    static_cast<const int*>(tsrc),
                                    static_cast<const int*>(tcount), pt, out,
                                    B, N, C, O, parts, s)
                      : cudaErrorInvalidValue;
  if (dtype == 0)
    return conv_bwd_cc<float>(x, nb, w, dy, dx, pt, out, B, N, C, O, parts,
                              sms, s);
  if (dtype == 1)
    return conv_bwd_cc<bf16>(x, nb, w, dy, dx, pt, out, B, N, C, O, parts,
                             sms, s);
  return cudaErrorInvalidValue;
}
