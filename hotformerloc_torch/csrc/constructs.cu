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
// about 1 MB moved or 10 MFLOP). Bound on the H100: bytes for all but the
// three products, whose operation counts are still below a microsecond.
//
// The three products (headloop, packbias, dk) share one tensor-core body,
// window_product_kernel: a block per 16 output rows of a window, whose
// head slices of q and k ((T, hd) bf16 each) are staged in shared memory
// by 16-byte cp.async, T padded to the fragment (16 rows) with zero rows,
// and multiplied on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the
// fragments of window_attn.cu. dk contracts over T, so it takes both
// operands with ldmatrix.trans. Each head's product sums into its own fp32
// accumulator, and the heads are added in head order, as k_headloop does.
// The output rows go through shared memory and out as contiguous stores. A
// window's whole product is a few dozen mma, so the launch is the cost.
//
// dtab runs as one thread-block cluster (dtab_cluster_kernel): each
// block stages its share of the (idx, g) rows by cp.async, sorts them by
// bin and sums each bin (within a bin the rows' order follows integer
// atomics, so the order of those fp32 sums is free), then block r reads
// slice r of every block's bins through distributed shared memory, adds
// them in block-rank order and writes its slice once: no float atomics,
// no memset, one launch.
//
// softmax keeps a row in its warp's registers (softmax_kernel: one read
// and one expf per value). onehot4d and pad write their outputs as flat
// runs of 16-byte streaming stores on launch plans from
// ops/kernels/constructs.py (onehot_plan, pad_plan): onehot4d loads each
// row's index once and shares it by shuffles, pad finds a vector's four
// sources with 32-bit arithmetic. The other three are the plainest
// correct kernel: one thread per output element.
//
// floor_empty_kernel and floor_chain_kernel replace no TPU kernel: they
// measure the card's floor for the constructs (an empty launch; one
// dependent load pair, index then the row it names, and a store), which
// the probe tool reports beside the constructs' times.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

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

// PTX helpers: 16-byte cp.async, ldmatrix and mma.sync.m16n8k16 (row.col,
// bf16 in, fp32 accumulate). Fragment layouts (g = lane / 4, c = lane % 4):
// A rows g and g + 8, k columns 2c, 2c + 1 (regs 0, 1) and 2c + 8, 2c + 9
// (regs 2, 3); B k rows 2c.. and 2c + 8.., column g; C rows g (regs 0, 1)
// and g + 8 (regs 2, 3), columns 2c, 2c + 1.
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most n of this thread's committed groups are pending
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
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

constexpr int kProductWarps = 4;

// Stages columns [0, width) of rows [0, T) of a (T, C) bf16 tile into
// shared rows of ld elements by 16-byte cp.async; rows [T, Tp) are zeroed.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int T,
                                           int Tp, int C, int width,
                                           int ld) {
  const int cpr = width / 8;
  for (int i = threadIdx.x; i < Tp * cpr; i += blockDim.x) {
    const int t = i / cpr, c = (i - t * cpr) * 8;
    if (t < T)
      cp_async16(dst + t * ld + c, src + (size_t)t * C + c);
    else
      *reinterpret_cast<uint4*>(dst + t * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

// The products of (WT, T, C) bf16 q and k, an (M, M) fp32 output per
// window w:
//   kContractT false (M = T): out[w,i,j] = sum_{h<nh} sum_{d<hd}
//     q[w,i,h*hd+d] k[w,j,h*hd+d];
//   kContractT true (M = hd, nh = 1): out[w,a,b] = sum_t q[w,t,a] k[w,t,b].
// grid (WT, ceil(M / 16)): block (w, y) computes output rows [16y, 16y +
// 16) of window w, a warp a 16 x 16 tile at a time. Dynamic shared memory:
// the staged q rows (16, or all Tp when contracting over T) and k rows
// (Tp) of nh * hd + 8 bf16 (the pad keeps ldmatrix free of bank
// conflicts), then the 16 x M fp32 output rows, written out contiguously.
template <bool kContractT>
__global__ void __launch_bounds__(kProductWarps * 32)
window_product_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      float* __restrict__ out, int T, int C, int hd,
                      int nh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tp = (T + 15) & ~15;
  const int ld = nh * hd + 8;
  const int M = kContractT ? hd : T;
  const int m0 = 16 * blockIdx.y;
  const int qrows = kContractT ? Tp : 16;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + qrows * ld;
  float* os = reinterpret_cast<float*>(ks + Tp * ld);
  const size_t base = (size_t)blockIdx.x * T * C;
  if (kContractT)
    stage_rows(qs, q + base, T, Tp, C, hd, ld);
  else
    stage_rows(qs, q + base + (size_t)m0 * C, min(16, T - m0), 16, C,
               nh * hd, ld);
  stage_rows(ks, k + base, T, Tp, C, nh * hd, ld);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int steps = kContractT ? Tp / 16 : hd / 16;
  for (int n0 = 16 * warp; n0 < M; n0 += 16 * kProductWarps) {
    float acc[2][4] = {};
    for (int h = 0; h < nh; ++h) {
      float part[2][4] = {};
      for (int kk = 0; kk < steps; ++kk) {
        uint32_t a[4], b[4];
        if (kContractT) {
          // A[a][t] = q[t][a] and B[t][b] = k[t][b]: transposed 8 x 8
          // blocks of the staged rows
          const int mi = lane >> 3;
          ldsm_x4_t(a, qs + (16 * kk + (lane & 7) + 8 * (mi >> 1)) * ld +
                           m0 + 8 * (mi & 1));
          ldsm_x4_t(b, ks + (16 * kk + (lane & 7) + 8 * (mi & 1)) * ld +
                           n0 + 8 * (mi >> 1));
        } else {
          const int col = h * hd + 16 * kk;
          ldsm_x4(a, qs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + col +
                         8 * (lane >> 4));
          ldsm_x4(b, ks + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + col +
                         8 * ((lane >> 3) & 1));
        }
        mma16816(part[0], a, b[0], b[1]);
        mma16816(part[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * j + 2 * c + (e & 1);
        if (col < M) os[(g + 8 * (e >> 1)) * M + col] = acc[j][e];
      }
  }
  __syncthreads();
  const int n = min(16, M - m0) * M;
  float* ob = out + ((size_t)blockIdx.x * M + m0) * M;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ob[i] = os[i];
}

template <bool kContractT>
cudaError_t launch_product(const void* q, const void* k, void* out, int WT,
                           int T, int C, int hd, int nh, cudaStream_t s) {
  if (WT < 1 || T < 1 || hd < 16 || hd % 16 || C % 8 || nh * hd > C ||
      (kContractT && nh != 1))
    return cudaErrorInvalidValue;
  const int Tp = (T + 15) & ~15;
  const int M = kContractT ? hd : T;
  const size_t smem = sizeof(bf16) * (size_t)((kContractT ? Tp : 16) + Tp) *
                          (nh * hd + 8) +
                      sizeof(float) * 16 * (size_t)M;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_product_kernel<kContractT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)WT, (unsigned)((M + 15) / 16));
  window_product_kernel<kContractT><<<grid, kProductWarps * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<float*>(out), T, C, hd, nh);
  return cudaGetLastError();
}

__global__ void reshape_kernel(const int* __restrict__ idx,
                               float* __restrict__ out, long long n) {
  GRID_STRIDE(i, n) out[i] = (float)idx[i];
}

// ld.global.nc without L1 allocation: an index read once
__device__ __forceinline__ int ld_once(const int* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p));
  return v;
}
// streaming (evict-first) stores: the output is not read again here
__device__ __forceinline__ void st_stream(float4* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_stream(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

template <int VEC> struct Unit;       // VEC floats moved as one
template <> struct Unit<4> {
  typedef float4 type;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Unit<1> {
  typedef float type;
  __device__ static float zero() { return 0.f; }
};

// out[i, :] = float(bf16(tab[idx[i], :])), 0 where idx[i] is off the
// table. The output is total = rows * u units of VEC floats (u = H / VEC;
// VEC = 4, 16-byte vectors, when H % 4 == 0, else VEC = 1), < 2^31. A
// warp writes the flat span of 32 * U units from s = 32 U * warp, whose
// rows start at row0: the plan keeps 32 U < 31 u + 2, so the span touches
// at most 32 rows, lane l loads row0 + l's index (once, without L1
// allocation) and each unit takes its row's index from that lane by a
// shuffle. Table rows are read through L1 (231 rows of 64 bytes at the
// probe: every row is read ~80 times), rounded to bf16 in registers, and
// the units leave as streaming stores after all loads are issued.
// Offsets are 32-bit. Bound: the output's bytes (1.18 MB at the probe).
template <int VEC, int U>
__global__ void __launch_bounds__(128)
onehot4d_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                float* __restrict__ out, unsigned R, unsigned u,
                unsigned total) {
  typedef typename Unit<VEC>::type V;
  const unsigned lane = threadIdx.x & 31;
  const unsigned s = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32 * U;
  if (s >= total) return;                      // the whole warp together
  const unsigned row0 = s / u, lead = s - row0 * u;
  int r = -1;
  if (lane * u <= lead + 32 * U - 1 && (size_t)(row0 + lane) * u < total)
    r = ld_once(idx + row0 + lane);
  // lane's k-th unit: flat s + lane + 32 k = row row0 + rel, unit v
  const unsigned q32 = 32 / u, r32 = 32 - q32 * u;
  unsigned rel = (lead + lane) / u;
  unsigned v = lead + lane - rel * u;
  const V* tv = reinterpret_cast<const V*>(tab);
  V buf[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const unsigned sr = (unsigned)__shfl_sync(0xffffffffu, r, rel & 31);
    buf[k] = Unit<VEC>::zero();
    if (s + lane + 32 * k < total && sr < R)
      buf[k] = round_bf16(__ldg(tv + sr * u + v));
    v += r32;
    rel += q32;
    if (v >= u) {
      v -= u;
      ++rel;
    }
  }
  V* ov = reinterpret_cast<V*>(out);
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const unsigned f = s + lane + 32 * k;
    if (f < total) st_stream(ov + f, buf[k]);
  }
}

template <int VEC, int U>
cudaError_t launch_onehot(const void* idx, const void* tab, void* out,
                          unsigned R, unsigned u, unsigned total,
                          int threads, long long blocks, cudaStream_t s) {
  onehot4d_kernel<VEC, U><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(tab),
      static_cast<float*>(out), R, u, total);
  return cudaGetLastError();
}

constexpr int kMaxCluster = 16;      // non-portable cluster size limit

// Dynamic shared memory of a dtab block: its R * H fp32 bins (cluster
// slices of chunk bins), R + 1 row counts and R cursors, then its share of
// per rows of idx, their order by bin, and g; each part padded to 16
// bytes.
inline int dtab_chunk(int H, int R, int cluster) {
  return (int)((((long long)R * H + cluster - 1) / cluster + 3) & ~3LL);
}
inline size_t dtab_smem(int H, int R, int per, int cluster) {
  return sizeof(float) * ((size_t)cluster * dtab_chunk(H, R, cluster) +
                          ((2 * (size_t)R + 1 + 3) & ~(size_t)3) +
                          (size_t)per * (2 + H));
}

// count 4-byte words from global src (16-byte aligned) to shared dst:
// 16-byte cp.async, the tail word by word.
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int count) {
  const int nv = count / 4;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async16(static_cast<uint4*>(dst) + i,
               static_cast<const uint4*>(src) + i);
  for (int i = 4 * nv + threadIdx.x; i < count; i += blockDim.x)
    static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[i];
}

// One cluster. Block r stages rows [r*per, (r+1)*per) of (idx, g) by
// cp.async, sorts them by bin (a counting sort on shared-memory integer
// atomics) and sums each of its R * H bins over its rows, one thread per
// bin. Then it reads bins slice r of every block through distributed
// shared memory, sums them in block-rank order and writes that slice of
// out once. per is a multiple of 4, so each share starts 16-byte aligned.
__global__ void __launch_bounds__(1024)
dtab_cluster_kernel(const int* __restrict__ idx, const float* __restrict__ g,
                    float* __restrict__ out, int n, int H, int R, int per,
                    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int nb = R * H;
  float* bins = reinterpret_cast<float*>(smem_raw);     // cs * chunk
  int* start = reinterpret_cast<int*>(bins + cs * chunk);  // R + 1
  int* cursor = start + R + 1;                           // R
  int* is = start + ((2 * R + 1 + 3) & ~3);              // per
  int* order = is + per;                                 // per
  float* gs = reinterpret_cast<float*>(order + per);     // per * H
  const int e0 = rank * per;
  const int rows = max(0, min(per, n - e0));
  // two cp.async groups: the indices, which the sort needs, then g,
  // which arrives while the rows are sorted
  stage_words(is, idx + e0, rows);
  cp_async_commit();
  stage_words(gs, g + (size_t)e0 * H, rows * H);
  cp_async_commit();
  for (int i = threadIdx.x; i <= R; i += blockDim.x) start[i] = 0;
  cp_async_wait<1>();
  __syncthreads();
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    const int r = is[e];
    if (r >= 0 && r < R) atomicAdd(&start[r + 1], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {              // start[r] = rows of bins below r
    int carry = 0;
    for (int i0 = 1; i0 <= R; i0 += 32) {
      const int i = i0 + (int)threadIdx.x;
      int v = i <= R ? start[i] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if ((int)threadIdx.x >= o) v += u;
      }
      if (i <= R) start[i] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += blockDim.x) cursor[i] = start[i];
  __syncthreads();
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    const int r = is[e];
    if (r >= 0 && r < R) order[atomicAdd(&cursor[r], 1)] = e;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int r = i / H, h = i - r * H;
    float acc = 0.f;
    for (int p = start[r]; p < start[r + 1]; ++p)
      acc += round_bf16(gs[order[p] * H + h]);
    bins[i] = acc;
  }
  cluster.sync();                      // every block's bins are complete
  for (int o = threadIdx.x; o < chunk; o += blockDim.x) {
    const int i = rank * chunk + o;
    if (i >= nb) break;
    float acc = 0.f;
    for (int s = 0; s < cs; ++s) acc += cluster.map_shared_rank(bins, s)[i];
    out[i] = acc;
  }
  cluster.sync();                      // keep the bins while others read
}

// (WT, K, K) -> (WT, P, P), P = K + G, G leading zero rows and columns.
// The output is one flat run of total = WT * P * P floats (< 2^31):
// thread t writes floats [4t, 4t + 4) as one 16-byte streaming store, and
// the thread past the last whole vector the total % 4 floats of the tail
// one by one. A thread finds its first float's (w, r, j) by two 32-bit
// divides and steps through the other three; it issues their loads, read
// through L1 (neighbouring vectors share input rows), before its store.
// Bound: the output's bytes (77 KB at the probe), far below a launch.
__global__ void __launch_bounds__(128)
pad_kernel(const float* __restrict__ in, float* __restrict__ out, unsigned K,
           unsigned G, unsigned total) {
  const unsigned f0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (f0 >= total) return;
  const unsigned P = K + G, PP = P * P;
  unsigned w = f0 / PP;
  const unsigned rem = f0 - w * PP;
  unsigned r = rem / P, j = rem - r * P;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = 0.f;
    if (r >= G && j >= G && f0 + e < total)
      v[e] = __ldg(in + (w * K + r - G) * K + j - G);
    if (++j == P) {
      j = 0;
      if (++r == P) {
        r = 0;
        ++w;
      }
    }
  }
  if (f0 + 4 <= total) {
    st_stream(reinterpret_cast<float4*>(out + f0),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 3; ++e)
      if (f0 + e < total) st_stream(out + f0 + e, v[e]);
  }
}

// The card's floor for the constructs; neither replaces a TPU kernel.
// floor_empty_kernel: a launch of one block that does nothing.
// floor_chain_kernel: per thread the constructs' shortest dependent
// chain, an index load (without L1 allocation), the 16-byte row it names
// (through L1) and one streaming store; launched as one warp, or as one
// 4-warp block on each SM.
__global__ void floor_empty_kernel() {}

__global__ void __launch_bounds__(128)
floor_chain_kernel(const int* __restrict__ idx, const float4* __restrict__ x,
                   float4* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  st_stream(out + t, __ldg(x + ld_once(idx + t)));
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

// One warp a row, P values a lane held in registers (32 * P >= L <=
// 1024): each value read once, one expf each, the max and the sum by five
// shuffles each. The plan (ops/kernels/constructs.py:softmax_plan) picks P
// from L, in blocks of 4 warps: the probe's 392 rows of 49 (2 values a
// lane) are 98 blocks. On the H100 at the probe's shapes, rows shared by
// 8 or 16 lanes (shallower shuffles, several rows a warp) were slower,
// and so were smaller blocks that reach every SM.
template <int P>
__global__ void __launch_bounds__(128)
softmax_kernel(const float* __restrict__ in, float* __restrict__ out,
               long long rows, int L) {
  const int lane = threadIdx.x & 31;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;                       // the whole warp together
  const float* x = in + r * L;
  float v[P];
  float m = __int_as_float(0xff800000);        // -inf
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < L ? __ldg(x + j) : __int_as_float(0xff800000);
    m = fmaxf(m, v[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    v[k] = lane + 32 * k < L ? expf(v[k] - m) : 0.f;
    sum += v[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float inv = 1.f / sum;
  float* y = out + r * L;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (lane + 32 * k < L) __stcs(y + lane + 32 * k, v[k] * inv);
}

template <int P>
cudaError_t launch_softmax(const void* in, void* out, long long rows, int L,
                           int threads, long long blocks, cudaStream_t s) {
  softmax_kernel<P><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const float*>(in), static_cast<float*>(out), rows, L);
  return cudaGetLastError();
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

}  // namespace

// Every entry point launches on `stream` and returns cudaError_t.

// q, k: (WT, T, C) bf16; out: (WT, T, T) fp32 over two heads of hd lanes.
extern "C" int construct_headloop(const void* q, const void* k, void* out,
                                  int WT, int T, int C, int hd,
                                  void* stream) {
  return launch_product<false>(q, k, out, WT, T, C, hd, 2,
                               static_cast<cudaStream_t>(stream));
}

// idx: n int32; out: n fp32.
extern "C" int construct_reshape(const void* idx, void* out, long long n,
                                 void* stream) {
  reshape_kernel<<<blocks_for(n, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<float*>(out), n);
  return cudaGetLastError();
}

// idx: rows int32; tab: (R, H) fp32; out: (rows, H) fp32, tab and out
// 16-byte aligned when vec is 4. The plan (ops/kernels/constructs.py:
// onehot_plan, on gather.take_plan): vec 4 when H % 4 == 0, else 1;
// per_lane units a lane (1, 2, 4 or 8, with 32 per_lane < 31 H / vec +
// 2); blocks of 128 threads, as many as cover the rows * H / vec units;
// another plan is refused.
extern "C" int construct_onehot4d(const void* idx, const void* tab, void* out,
                                  long long rows, int H, int R, int vec,
                                  int per_lane, int threads, long long blocks,
                                  void* stream) {
  if (rows < 1 || H < 1 || R < 1 || vec != (H % 4 == 0 ? 4 : 1) ||
      threads != 128)
    return cudaErrorInvalidValue;
  const long long u = H / vec, total = rows * u;
  const long long warps = (total + 32LL * per_lane - 1) / (32LL * per_lane);
  if (rows * H > 0x7fffffffLL || (long long)R * H > 0x7fffffffLL ||
      32LL * per_lane >= 31 * u + 2 ||
      blocks != (warps + 3) / 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ONEHOT_CASE(V, P)                                                  \
  if (vec == V && per_lane == P)                                           \
    return launch_onehot<V, P>(idx, tab, out, (unsigned)R, (unsigned)u,    \
                               (unsigned)total, threads, blocks, s);
  ONEHOT_CASE(4, 1) ONEHOT_CASE(4, 2) ONEHOT_CASE(4, 4) ONEHOT_CASE(4, 8)
  ONEHOT_CASE(1, 1) ONEHOT_CASE(1, 2) ONEHOT_CASE(1, 4) ONEHOT_CASE(1, 8)
#undef ONEHOT_CASE
  return cudaErrorInvalidValue;
}

// idx: n int32; g: (n, H) fp32, both 16-byte aligned; out: (R, H) fp32,
// written whole. One cluster of `cluster` blocks of `threads` threads,
// each holding per rows (a multiple of 4 with cluster * per >= n); its
// bins and rows must fit a block's opt-in shared memory (the wrapper's
// dtab_plan).
extern "C" int construct_dtab(const void* idx, const void* g, void* out,
                              long long n, int H, int R, int cluster,
                              int threads, int per, void* stream) {
  if (n < 1 || H < 1 || R < 1 || n * H >= (1LL << 31) || cluster < 1 ||
      cluster > kMaxCluster || threads < H || threads > 1024 ||
      threads % 32 || per % 4 || (long long)per * cluster < n)
    return cudaErrorInvalidValue;
  const int chunk = dtab_chunk(H, R, cluster);
  const size_t smem = dtab_smem(H, R, per, cluster);
  cudaError_t e = cudaFuncSetAttribute(
      dtab_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(dtab_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dtab_cluster_kernel,
                         static_cast<const int*>(idx),
                         static_cast<const float*>(g),
                         static_cast<float*>(out), (int)n, H, R, per,
                         chunk);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// in: (WT, K, K) fp32; out: (WT, K+G, K+G) fp32, 16-byte aligned. The
// plan (ops/kernels/constructs.py:pad_plan): blocks of 128 threads, a
// thread per 16-byte vector of the output and one more for a tail of
// fewer than 4 floats; another plan is refused.
extern "C" int construct_pad(const void* in, void* out, int WT, int K, int G,
                             int threads, long long blocks, void* stream) {
  if (WT < 1 || K < 1 || G < 0 || threads != 128)
    return cudaErrorInvalidValue;
  const long long total = (long long)WT * (K + G) * (K + G);
  if (total > 0x7fffffffLL || blocks != ((total + 3) / 4 + 127) / 128)
    return cudaErrorInvalidValue;
  pad_kernel<<<(unsigned)blocks, threads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), (unsigned)K,
      (unsigned)G, (unsigned)total);
  return cudaGetLastError();
}

// One block of 32 threads that does nothing.
extern "C" int construct_floor_empty(void* stream) {
  floor_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// idx: threads * blocks int32 row numbers of x; x: (rows, 4) fp32, 16-byte
// aligned; out: (threads * blocks, 4) fp32. threads is 32 (one warp) or
// 128 (4-warp blocks).
extern "C" int construct_floor_chain(const void* idx, const void* x, void* out,
                                     int threads, int blocks, void* stream) {
  if ((threads != 32 && threads != 128) || blocks < 1)
    return cudaErrorInvalidValue;
  floor_chain_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float4*>(x),
      static_cast<float4*>(out));
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

// in, out: (rows, L) fp32. The plan (ops/kernels/constructs.py:
// softmax_plan): per_lane values a lane (a power of two up to 32, 32 *
// per_lane >= L), blocks of threads (a multiple of 32, at most 128), as
// many as give every row its warp; another plan is refused.
extern "C" int construct_softmax(const void* in, void* out, long long rows,
                                 int L, int per_lane, int threads,
                                 long long blocks, void* stream) {
  if (rows < 1 || L < 1 || 32LL * per_lane < L || threads < 32 ||
      threads > 128 || threads % 32 ||
      blocks != (rows + threads / 32 - 1) / (threads / 32) ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_lane) {
#define SOFTMAX_CASE(P) \
  case P:               \
    return launch_softmax<P>(in, out, rows, L, threads, blocks, s);
    SOFTMAX_CASE(1)
    SOFTMAX_CASE(2)
    SOFTMAX_CASE(4)
    SOFTMAX_CASE(8)
    SOFTMAX_CASE(16)
    SOFTMAX_CASE(32)
#undef SOFTMAX_CASE
    default: return cudaErrorInvalidValue;
  }
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
  return launch_product<true>(q, k, out, WT, T, C, hd, 1,
                              static_cast<cudaStream_t>(stream));
}

// q, k: (WT, T, C) bf16; out: (WT, T, T) fp32 over the first hd lanes.
extern "C" int construct_packbias(const void* q, const void* k, void* out,
                                  int WT, int T, int C, int hd,
                                  void* stream) {
  return launch_product<false>(q, k, out, WT, T, C, hd, 1,
                               static_cast<cudaStream_t>(stream));
}
