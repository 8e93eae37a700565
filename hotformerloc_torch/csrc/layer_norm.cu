// LayerNorm over the last axis of a contiguous (M, C) tensor, forward, for
// Hopper (sm_90a):
//
//   y[r, c] = (x[r, c] - mean_r) * rstd_r * w[c] + b[c]
//   mean_r  = sum_c x[r, c] / C
//   rstd_r  = 1 / sqrt(sum_c (x[r, c] - mean_r)^2 / C + eps)
//
// x, w, b and y in fp32 or bf16 (one dtype), the statistics and the
// arithmetic in fp32, one rounding to y's dtype: the function of aten's
// native_layer_norm. mean and rstd (fp32, one per row) are written only
// when the caller passes them (the backward, aten's
// native_layer_norm_backward, reads them).
//
// It replaces no TPU kernel: the JAX package's LayerNorm is flax's, which
// XLA fuses. It was added because every LayerNorm of the port (the blocks'
// norm1 / norm2 and CPE norms, the stem's and down-convs' norms, RTSA's and
// the pooling's) ran aten's vectorized_layer_norm_kernel, the largest plain
// kernel of the serving forward, at about a fifth of its bytes bound on the
// model's shapes (C = 32 to 256, 64-512 bytes a row in bf16): aten spends a
// whole block on each row, so a narrow row leaves most of the block idle.
//
// Bound on the H100: bytes. A row is read once and written once, and the
// arithmetic (about 8 operations a value) is far below the card's rate. So
// the design keeps enough bytes in flight and moves each byte once:
//
// - A row is spread over L lanes (the least power of two that holds its
//   16-byte vectors, at most 32), one vector a lane, or P vectors a lane
//   above 32 vectors (C > 256 in bf16, > 128 in fp32): a warp holds 32 / L
//   rows at once, so a narrow row takes a few lanes and not a block. The
//   launch plan (ops/kernels/norm.py: layer_norm_plan) derives L and P from
//   C; another plan is refused. A width that is no multiple of a vector, or
//   a pointer off 16 bytes, runs the same algorithm on single values.
// - Statistics by shuffle-xor inside the L-lane group, in two passes over
//   the registers (the mean, then the centred sum of squares): one read of
//   memory, no cancellation of E[x^2] - E[x]^2.
// - Each lane loads its slice of w and b into registers once, before a
//   grid-stride loop over row groups on a persistent grid (3 blocks of 8
//   warps an SM, as many as fit the registers of 4 vectors a lane in
//   flight without spilling); each iteration issues U independent row-group loads (U P = 4
//   vectors a lane, 64 bytes) before its first reduction.
// - x is read with ld.global.nc without L1 allocation, y written with
//   streaming stores (st.global.cs): neither is touched again here. w and
//   b go through L1, since every warp reads them.
// - 32-bit offsets where M C < 2^31. No shared memory, no atomics, one
//   launch, and a fixed order of additions: the result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;        // 8 warps a block
constexpr int kBlocksPerSM = 3;      // the persistent grid, 24 warps an SM
constexpr int kMaxPerLane = 8;       // vectors a lane, so C <= 256 vectors

// ld.global.nc without L1 allocation: a value read once
__device__ __forceinline__ uint4 ld_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_once(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short ld_once(const unsigned short* p) {
  unsigned short v;
  asm volatile("ld.global.nc.L1::no_allocate.b16 %0, [%1];\n"
               : "=h"(v)
               : "l"(p));
  return v;
}
// streaming (evict-first) stores: the output is not read again here
__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_stream(uint32_t* p, uint32_t v) {
  asm volatile("st.global.cs.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_stream(unsigned short* p,
                                          unsigned short v) {
  asm volatile("st.global.cs.b16 [%0], %1;\n" ::"l"(p), "h"(v) : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// two floats rounded to nearest even bf16, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// The unit a lane moves: E values of T as one load (Raw), read once (ld),
// through L1 (ldg), stored streaming (st), and converted to and from fp32.
template <typename T, int E> struct Unit;

template <> struct Unit<float, 4> {          // 16-byte vector of fp32
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw ld(const float* p) {
    return ld_once(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw ldg(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void st(float* p, Raw r) {
    st_stream(reinterpret_cast<uint4*>(p), r);
  }
  static __device__ __forceinline__ void get(Raw r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ Raw put(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Unit<bf16, 8> {           // 16-byte vector of bf16
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw ld(const bf16* p) {
    return ld_once(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw ldg(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void st(bf16* p, Raw r) {
    st_stream(reinterpret_cast<uint4*>(p), r);
  }
  static __device__ __forceinline__ void get(Raw r, float (&f)[8]) {
    f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z); f[5] = bf16_hi(r.z);
    f[6] = bf16_lo(r.w); f[7] = bf16_hi(r.w);
  }
  static __device__ __forceinline__ Raw put(const float (&f)[8]) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
};

template <> struct Unit<float, 1> {          // one fp32
  typedef uint32_t Raw;
  static __device__ __forceinline__ Raw ld(const float* p) {
    return ld_once(reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ Raw ldg(const float* p) {
    return __float_as_uint(__ldg(p));
  }
  static __device__ __forceinline__ void st(float* p, Raw r) {
    st_stream(reinterpret_cast<uint32_t*>(p), r);
  }
  static __device__ __forceinline__ void get(Raw r, float (&f)[1]) {
    f[0] = __uint_as_float(r);
  }
  static __device__ __forceinline__ Raw put(const float (&f)[1]) {
    return __float_as_uint(f[0]);
  }
};

template <> struct Unit<bf16, 1> {           // one bf16
  typedef unsigned short Raw;
  static __device__ __forceinline__ Raw ld(const bf16* p) {
    return ld_once(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ Raw ldg(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void st(bf16* p, Raw r) {
    st_stream(reinterpret_cast<unsigned short*>(p), r);
  }
  static __device__ __forceinline__ void get(Raw r, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  static __device__ __forceinline__ Raw put(const float (&f)[1]) {
    return static_cast<Raw>(pack_bf16(f[0], 0.0f) & 0xffffu);
  }
};

// Row groups a warp loads before reducing: U P = 4 vectors a lane (one
// above P = 4, where a lane already holds P).
__host__ __device__ constexpr int unroll_of(int P) {
  return P >= 4 ? 1 : 4 / P;
}

// x, y: (M, C) contiguous; w, b: (C,); mean, rstd: (M,) fp32 or both null.
// Lanes of a row: ``lanes`` (a power of two); E values a unit, units =
// C / E, lane ``sub`` of a row holding units sub + j lanes, j < P. Warp k
// of the grid takes row groups k, k + nwarps, ... (a group: the 32 / lanes
// consecutive rows the warp holds at once), U of them an iteration.
template <typename T, int E, int P, bool WIDE>
__global__ void __launch_bounds__(kThreads, P >= 4 ? 1 : kBlocksPerSM)
    layer_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ b, T* __restrict__ y,
                           float* __restrict__ mean, float* __restrict__ rstd,
                           int M, int C, int lanes, float eps) {
  typedef Unit<T, E> V;
  typedef typename V::Raw Raw;
  typedef typename std::conditional<WIDE, long long, int>::type Idx;
  constexpr int U = unroll_of(P);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int rows_per_group = 32 / lanes;
  const int row_in = lane / lanes;
  const int units = C / E;
  const int groups = (M + rows_per_group - 1) / rows_per_group;
  const int nwarps = gridDim.x * (kThreads / 32);
  const float fc = static_cast<float>(C);

  Raw wr[P], br[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int v = sub + j * lanes;
    if (v < units) {
      wr[j] = V::ldg(w + v * E);
      br[j] = V::ldg(b + v * E);
    } else {
      wr[j] = Raw();
      br[j] = Raw();
    }
  }

  for (int g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); g < groups;
       g += U * nwarps) {
    Raw xr[U][P];
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = (g + u * nwarps) * rows_per_group + row_in;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int v = sub + j * lanes;
        xr[u][j] = row[u] < M && v < units
                       ? V::ld(x + static_cast<Idx>(row[u]) * C + v * E)
                       : Raw();
      }
    }
    // pass 1: the mean (absent units read as 0)
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = 0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float f[E];
        V::get(xr[u][j], f);
#pragma unroll
        for (int e = 0; e < E; ++e) s[u] += f[e];
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    // pass 2: the centred sum of squares, from the same registers
    float mu[U], q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mu[u] = s[u] / fc;
      q[u] = 0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (sub + j * lanes < units) {
          float f[E];
          V::get(xr[u][j], f);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float d = f[e] - mu[u];
            q[u] = fmaf(d, d, q[u]);
          }
        }
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        q[u] += __shfl_xor_sync(0xffffffffu, q[u], off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float rs = rsqrtf(q[u] / fc + eps);
      if (row[u] >= M) continue;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int v = sub + j * lanes;
        if (v < units) {
          float f[E], fw[E], fb[E];
          V::get(xr[u][j], f);
          V::get(wr[j], fw);
          V::get(br[j], fb);
#pragma unroll
          for (int e = 0; e < E; ++e)
            f[e] = fmaf((f[e] - mu[u]) * rs, fw[e], fb[e]);
          V::st(y + static_cast<Idx>(row[u]) * C + v * E, V::put(f));
        }
      }
      if (mean != nullptr && sub == 0) {
        mean[row[u]] = mu[u];
        rstd[row[u]] = rs;
      }
    }
  }
}

template <typename T, int E, int P>
int launch(const void* x, const void* w, const void* b, void* y, void* mean,
           void* rstd, int M, int C, int lanes, bool wide, float eps,
           int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  float* mt = static_cast<float*>(mean);
  float* rt = static_cast<float*>(rstd);
  if (wide)
    layer_norm_rows_kernel<T, E, P, true><<<blocks, kThreads, 0, s>>>(
        xt, wt, bt, yt, mt, rt, M, C, lanes, eps);
  else
    layer_norm_rows_kernel<T, E, P, false><<<blocks, kThreads, 0, s>>>(
        xt, wt, bt, yt, mt, rt, M, C, lanes, eps);
  return cudaGetLastError();
}

template <typename T, int E>
int launch_per_lane(const void* x, const void* w, const void* b, void* y,
                    void* mean, void* rstd, int M, int C, int lanes,
                    int per_lane, bool wide, float eps, int blocks,
                    cudaStream_t s) {
  switch (per_lane) {
#define LN_CASE(P)                                                       \
  case P:                                                                \
    return launch<T, E, P>(x, w, b, y, mean, rstd, M, C, lanes, wide, eps, \
                           blocks, s);
    LN_CASE(1)
    LN_CASE(2)
    LN_CASE(4)
    LN_CASE(8)
#undef LN_CASE
    default: return cudaErrorInvalidValue;
  }
}

int pow2_at_least(long long n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

}  // namespace

// x, y: (M, C) contiguous of ``dtype`` (0 fp32, 1 bf16); w, b: (C,) of the
// same dtype; mean, rstd: (M,) fp32, both given or both null. The plan
// (ops/kernels/norm.py: layer_norm_plan): ``vec`` values a unit (16 bytes,
// every pointer 16-byte aligned and C a multiple; else 1), ``lanes`` the
// least power of two >= the units of a row up to 32, ``per_lane`` the least
// power of two with 32 per_lane >= units (at most 8), ``unroll`` as
// unroll_of, ``wide`` for M C >= 2^31, blocks of ``threads`` = 256, 1 to
// enough for every row group; another plan is refused. M < 2^30.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mean, void* rstd, long long M,
                              int C, float eps, int dtype, int vec, int lanes,
                              int per_lane, int unroll, int wide, int threads,
                              long long blocks, void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  const int full = 16 / esz;
  if ((dtype != 0 && dtype != 1) || M < 1 || M >= (1LL << 30) || C < 1 ||
      (vec != 1 && vec != full) || C % vec ||
      (mean == nullptr) != (rstd == nullptr))
    return cudaErrorInvalidValue;
  if (vec > 1 && ((uintptr_t)x % 16 || (uintptr_t)w % 16 ||
                  (uintptr_t)b % 16 || (uintptr_t)y % 16))
    return cudaErrorInvalidValue;
  const long long units = C / vec;
  const int want_lanes = units >= 32 ? 32 : pow2_at_least(units);
  const int want_per_lane = pow2_at_least((units + 31) / 32);
  const long long groups = (M + 32 / want_lanes - 1) / (32 / want_lanes);
  const long long warps = (groups + unroll - 1) / unroll;
  const long long most = (warps + threads / 32 - 1) / (threads / 32);
  if (want_per_lane > kMaxPerLane || lanes != want_lanes ||
      per_lane != want_per_lane || unroll != unroll_of(per_lane) ||
      wide != (M * C >= (1LL << 31)) || threads != kThreads || blocks < 1 ||
      blocks > most)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), nb = static_cast<int>(blocks);
  if (dtype == 0)
    return vec == 1 ? launch_per_lane<float, 1>(x, w, b, y, mean, rstd, m, C,
                                                lanes, per_lane, wide, eps,
                                                nb, s)
                    : launch_per_lane<float, 4>(x, w, b, y, mean, rstd, m, C,
                                                lanes, per_lane, wide, eps,
                                                nb, s);
  return vec == 1 ? launch_per_lane<bf16, 1>(x, w, b, y, mean, rstd, m, C,
                                             lanes, per_lane, wide, eps, nb, s)
                  : launch_per_lane<bf16, 8>(x, w, b, y, mean, rstd, m, C,
                                             lanes, per_lane, wide, eps, nb,
                                             s);
}
