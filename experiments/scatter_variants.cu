// Variants of the iblt_apply / iblt_encode scatter, timed against each other
// on the card by scatter_variants.py (which builds this file).  Not part of
// the package: the kernels it ships are in src/repro_torch/csrc.
//
//   prior_*         the forms iblt_apply.cu and iblt_encode.cu had before
//                   csrc/scatter.cuh, for the padded-slot isolation runs
//   words_kernel    a warp per item with a lane per word, L + 3 words a row
//                   in shared memory as three arrays: three atomic
//                   instructions a slot (kLanes 0), or lanes on slots
//                   (kLanes 1); flushed by atomics (kFlush 0) or by
//                   cp.reduce.async.bulk (kFlush 1)
//   v4_kernel<1>    the shipped layout with part of the table spread over a
//                   thread block cluster's distributed shared memory
//   scatter.cuh     the shipped body, launched at an explicit H and grid
//   tuned_kernel    the shipped body with an L2 prefetch of the items ahead
//                   and row 0 kept in registers
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cstdint>

#include "../src/repro_torch/csrc/scatter.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void put(uint32_t* sums, uint32_t* checks,
                                    int32_t* counts, long long j, int L,
                                    int l, uint32_t v, int32_t w) {
  if (l < L) atomicXor(sums + j * L + l, v);
  else if (l < L + 2) atomicXor(checks + 2 * j + (l - L), v);
  else if (l == L + 2) atomicAdd(counts + j, w);
}

__device__ __forceinline__ void bulk(void* g, const void* s, unsigned bytes,
                                     int add) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], "
        "[%1], %2;" ::"l"(g), "r"(sa), "r"(bytes) : "memory");
  else
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.xor.b32 [%0], "
        "[%1], %2;" ::"l"(g), "r"(sa), "r"(bytes) : "memory");
}

// The form iblt_apply.cu had before csrc/scatter.cuh: one thread per
// (item, slot), every valid slot L + 3 global atomics on its row.
__global__ void prior_apply_kernel(const uint32_t* __restrict__ items,
                                   const int32_t* __restrict__ idxs,
                                   const uint32_t* __restrict__ chks,
                                   const int32_t* __restrict__ sides,
                                   long long n, int K, int L,
                                   const int32_t* __restrict__ unit,
                                   const int32_t* __restrict__ m_units,
                                   long long stride,
                                   uint32_t* __restrict__ sums,
                                   uint32_t* __restrict__ checks,
                                   int32_t* __restrict__ counts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * K) return;
  const long long i = t / K;
  const int32_t side = sides[i];
  const int32_t u = unit[i];
  long long j = idxs[t];
  if (side == 0 || j < 0 || j >= m_units[u]) return;
  j += (long long)u * stride;
  const uint32_t* w = items + i * L;
  uint32_t* dst = sums + j * L;
  for (int l = 0; l < L; ++l) atomicXor(dst + l, w[l]);
  atomicXor(checks + 2 * j, chks[2 * i]);
  atomicXor(checks + 2 * j + 1, chks[2 * i + 1]);
  atomicAdd(counts + j, side);
}

// The form iblt_encode.cu had before csrc/scatter.cuh: one thread per item,
// the first `hot` rows (48 KB) in shared memory, colder rows L + 3 global
// atomics per slot, one flush per block.
__global__ void prior_encode_kernel(const uint32_t* __restrict__ items,
                                    const int32_t* __restrict__ idxs,
                                    const uint32_t* __restrict__ chks,
                                    long long n, int K, int L, long long m,
                                    int hot, uint32_t* __restrict__ sums,
                                    uint32_t* __restrict__ checks,
                                    int32_t* __restrict__ counts) {
  extern __shared__ uint32_t tab[];
  const int W = L + 3;
  for (int t = threadIdx.x; t < hot * W; t += blockDim.x) tab[t] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t* w = items + i * L;
    const uint32_t c0 = chks[2 * i], c1 = chks[2 * i + 1];
    const int32_t* row = idxs + i * K;
    for (int k = 0; k < K; ++k) {
      const long long j = row[k];
      if (j < 0 || j >= m) continue;
      if (j < hot) {
        uint32_t* s = tab + j * W;
        for (int l = 0; l < L; ++l) atomicXor(s + l, w[l]);
        atomicXor(s + L, c0);
        atomicXor(s + L + 1, c1);
        atomicAdd(s + L + 2, 1u);
      } else {
        uint32_t* dst = sums + j * L;
        for (int l = 0; l < L; ++l) atomicXor(dst + l, w[l]);
        atomicXor(checks + 2 * j, c0);
        atomicXor(checks + 2 * j + 1, c1);
        atomicAdd(counts + j, 1);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < hot * W; t += blockDim.x) {
    const uint32_t v = tab[t];
    if (v == 0) continue;
    const long long j = t / W;
    const int c = t % W;
    if (c < L) atomicXor(sums + j * L + c, v);
    else if (c < L + 2) atomicXor(checks + 2 * j + (c - L), v);
    else atomicAdd(counts + j, (int32_t)v);
  }
}

// kLanes 0: lanes on words (a warp per item); 1: lanes on slots.
// kFlush 0: nonzero words by global atomics; 1: bulk reduce.
template <int kLanes, int kFlush>
__global__ void __launch_bounds__(1024, 1) words_kernel(
    const uint32_t* __restrict__ items, const int32_t* __restrict__ idxs,
    const uint32_t* __restrict__ chks, const int32_t* __restrict__ weights,
    const int32_t* __restrict__ unit, const int32_t* __restrict__ limits,
    long long m, long long n, int K, int L, long long stride, int hot,
    uint32_t* __restrict__ sums, uint32_t* __restrict__ checks,
    int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = L + 3;
  const long long lo = n * blockIdx.x / gridDim.x;
  const long long hi = n * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int home = unit ? unit[lo] : 0;
  const long long home_lim = limits ? limits[home] : m;
  const int rows = (int)(hot < home_lim ? hot : home_lim);
  uint32_t* s_sums = smem;
  uint32_t* s_checks = smem + (size_t)hot * L;
  int32_t* s_counts = (int32_t*)(smem + (size_t)hot * (L + 2));
  for (int t = threadIdx.x; t < rows * L; t += blockDim.x) s_sums[t] = 0;
  for (int t = threadIdx.x; t < 2 * rows; t += blockDim.x) s_checks[t] = 0;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) s_counts[t] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (long long i = lo + (threadIdx.x >> 5); i < hi; i += nw) {
    const int32_t w = weights ? weights[i] : 1;
    if (w == 0) continue;
    const int u = unit ? unit[i] : 0;
    const long long lim = limits ? limits[u] : m;
    const bool at_home = u == home;
    const long long base = (long long)u * stride;
    const int32_t* row = idxs + i * K;
    if (kLanes == 0) {
      for (int c0 = 0; c0 < W; c0 += 32) {
        const int l = c0 + lane;
        const uint32_t v = l < L ? items[i * L + l]
                                 : l < L + 2 ? chks[2 * i + l - L] : 0u;
        for (int s0 = 0; s0 < K; s0 += 32) {
          const int k = s0 + lane;
          const long long jj = k < K ? row[k] : -1;
          unsigned mask = __ballot_sync(kFull, jj >= 0 && jj < lim);
          while (mask) {
            const int b = __ffs(mask) - 1;
            mask &= mask - 1;
            const long long j = __shfl_sync(kFull, jj, b);
            if (l < W) {
              if (at_home && j < rows)
                put(s_sums, s_checks, s_counts, j, L, l, v, w);
              else
                put(sums, checks, counts, base + j, L, l, v, w);
            }
          }
        }
      }
    } else {
      for (int s0 = 0; s0 < K; s0 += 32) {
        const int k = s0 + lane;
        const long long jj = k < K ? row[k] : -1;
        const bool valid = jj >= 0 && jj < lim;
        if (!__any_sync(kFull, valid)) continue;
        const bool in_smem = valid && at_home && jj < rows;
        for (int c0 = 0; c0 < W; c0 += 32) {
          const int l0 = c0 + lane;
          const uint32_t mine = l0 < L ? items[i * L + l0]
                                       : l0 < L + 2 ? chks[2 * i + l0 - L] : 0u;
          const int cw = W - c0 < 32 ? W - c0 : 32;
          for (int q = 0; q < cw; ++q) {
            const uint32_t v = __shfl_sync(kFull, mine, q);
            if (!valid) continue;
            if (in_smem)
              put(s_sums, s_checks, s_counts, jj, L, c0 + q, v, w);
            else
              put(sums, checks, counts, base + jj, L, c0 + q, v, w);
          }
        }
      }
    }
  }
  __syncthreads();
  const long long hb = (long long)home * stride;
  if (kFlush == 0) {
    for (int t = threadIdx.x; t < rows * L; t += blockDim.x) {
      const uint32_t v = s_sums[t];
      if (v) atomicXor(sums + hb * L + t, v);
    }
    for (int t = threadIdx.x; t < 2 * rows; t += blockDim.x) {
      const uint32_t v = s_checks[t];
      if (v) atomicXor(checks + 2 * hb + t, v);
    }
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int32_t v = s_counts[t];
      if (v) atomicAdd(counts + hb + t, v);
    }
  } else {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && rows > 0) {
      bulk(sums + hb * L, s_sums, 4u * rows * L, 0);
      bulk(checks + 2 * hb, s_checks, 8u * rows, 0);
      bulk(counts + hb, s_counts, 4u * rows, 1);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// The shipped layout (rows of L sum and 2 check words side by side, counts
// apart and added lane per slot).  Rows [0, H1) local; with kDist, rows
// [H1, H1 + C*H2) spread over the cluster: d = j - H1 lives in rank d % C
// at local row H1 + d / C.
template <int kDist>
__global__ void __launch_bounds__(1024, 1) v4_kernel(
    const uint32_t* __restrict__ items, const int32_t* __restrict__ idxs,
    const uint32_t* __restrict__ chks, const int32_t* __restrict__ weights,
    const int32_t* __restrict__ unit, const int32_t* __restrict__ limits,
    long long m, long long n, int K, int L, long long stride, int H1, int H2,
    uint32_t* __restrict__ sums, uint32_t* __restrict__ checks,
    int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int V = L + 2, HT = H1 + H2;
  uint32_t* tab = smem;
  int32_t* cnt = (int32_t*)(smem + (size_t)HT * V);
  int C = 1, rank = 0;
  long long lo, hi, hlo;
  if (kDist) {
    cg::cluster_group cl = cg::this_cluster();
    C = (int)cl.num_blocks(); rank = (int)cl.block_rank();
    const long long ncl = gridDim.x / C, cid = blockIdx.x / C;
    const long long clo = n * cid / ncl, chi = n * (cid + 1) / ncl;
    lo = clo + (chi - clo) * rank / C;
    hi = clo + (chi - clo) * (rank + 1) / C;
    hlo = clo < chi ? clo : -1;
  } else {
    lo = n * blockIdx.x / gridDim.x;
    hi = n * (blockIdx.x + 1) / gridDim.x;
    if (lo >= hi) return;
    hlo = lo;
  }
  const int home = (unit && hlo >= 0) ? unit[hlo] : 0;
  const long long hlim = limits ? limits[home] : m;
  const int rl = (int)(H1 < hlim ? H1 : hlim);
  const long long rt = (long long)H1 + (long long)C * H2 < hlim
                           ? (long long)H1 + (long long)C * H2 : hlim;
  for (int t = threadIdx.x; t < HT * V; t += blockDim.x) tab[t] = 0;
  for (int t = threadIdx.x; t < HT; t += blockDim.x) cnt[t] = 0;
  if (kDist) cg::this_cluster().sync(); else __syncthreads();
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (long long i = lo + (threadIdx.x >> 5); i < hi; i += nw) {
    const int32_t w = weights ? weights[i] : 1;
    if (w == 0) continue;
    const int u = unit ? unit[i] : 0;
    const int lim = (int)(limits ? limits[u] : m);
    const bool at_home = u == home;
    const long long base = (long long)u * stride;
    const int32_t* row = idxs + i * K;
    for (int c0 = 0; c0 < V; c0 += 32) {
      const int l = c0 + lane;
      const uint32_t v = l < L ? items[i * L + l]
                               : l < V ? chks[2 * i + l - L] : 0u;
      for (int s0 = 0; s0 < K; s0 += 32) {
        const int k = s0 + lane;
        const int jj = k < K ? row[k] : -1;
        const bool valid = jj >= 0 && jj < lim;
        if (c0 == 0 && valid) {
          if (at_home && jj < rl) {
            atomicAdd(cnt + jj, w);
          } else if (kDist && at_home && jj < rt) {
            const int d = jj - H1;
            atomicAdd(cg::this_cluster().map_shared_rank(cnt, d % C) + H1 +
                          d / C, w);
          } else {
            atomicAdd(counts + base + jj, w);
          }
        }
        unsigned mask = __ballot_sync(kFull, valid);
        while (mask) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1;
          const int j = __shfl_sync(kFull, jj, b);
          if (l >= V) continue;
          if (at_home && j < rl) {
            atomicXor(tab + j * V + l, v);
          } else if (kDist && at_home && j < rt) {
            const int d = j - H1;
            atomicXor(cg::this_cluster().map_shared_rank(tab, d % C) +
                          (H1 + d / C) * V + l, v);
          } else if (l < L) {
            atomicXor(sums + (base + j) * L + l, v);
          } else {
            atomicXor(checks + 2 * (base + j) + (l - L), v);
          }
        }
      }
    }
  }
  if (kDist) cg::this_cluster().sync(); else __syncthreads();
  const long long hb = (long long)home * stride;
  for (int t = threadIdx.x; t < HT * V; t += blockDim.x) {
    const uint32_t v = tab[t];
    if (!v) continue;
    const int r = t / V, c = t - r * V;
    long long j;
    if (r < H1) j = r;
    else j = H1 + (long long)(r - H1) * C + rank;
    if (j >= (r < H1 ? rl : rt)) continue;
    if (c < L) atomicXor(sums + (hb + j) * L + c, v);
    else atomicXor(checks + 2 * (hb + j) + (c - L), v);
  }
  for (int t = threadIdx.x; t < HT; t += blockDim.x) {
    const int32_t v = cnt[t];
    if (!v) continue;
    const long long j = t < H1 ? t : H1 + (long long)(t - H1) * C + rank;
    atomicAdd(counts + hb + j, v);
  }
}


// The shipped body with two additions under test: kPrefetch > 0 prefetches
// into L2 the rows of the item kPrefetch turns ahead of this warp's, and
// kRow0 keeps row 0 (every chain's first slot) in a register per lane,
// added to the shared table once per warp (one chunk of words only).
template <int kPrefetch, bool kRow0>
__global__ void __launch_bounds__(1024, 1) tuned_kernel(const scatter::Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int L = a.L, V = L + 2;
  uint32_t* tab = smem;
  int32_t* cnt = (int32_t*)(smem + (size_t)a.hot * V);
  const long long lo = a.n * blockIdx.x / gridDim.x;
  const long long hi = a.n * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int home = a.unit ? a.unit[lo] : 0;
  const long long home_lim = a.limits ? a.limits[home] : a.m;
  const int rows = (int)(home_lim < 0 ? 0 : home_lim < a.hot ? home_lim
                                                              : a.hot);
  for (int t = threadIdx.x; t < rows * V; t += blockDim.x) tab[t] = 0;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) cnt[t] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const bool row0 = kRow0 && V <= 32 && rows > 0;
  uint32_t acc0 = 0;
  int32_t cnt0 = 0;
  for (long long i = lo + (threadIdx.x >> 5); i < hi; i += nw) {
    if (kPrefetch > 0) {
      const long long p = i + (long long)kPrefetch * nw;
      if (p < hi) {
        const char* row = lane < 4 ? (const char*)(a.idxs + p * a.K)
                                   : (const char*)(a.items + p * L);
        const char* end = lane < 4 ? (const char*)(a.idxs + (p + 1) * a.K)
                                   : (const char*)(a.items + (p + 1) * L);
        const char* src = row + 128 * (lane & 3);
        if (lane < 8 && src < end)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(src));
      }
    }
    const int32_t w = a.weights ? a.weights[i] : 1;
    if (w == 0) continue;
    const int u = a.unit ? a.unit[i] : 0;
    const long long lim = a.limits ? a.limits[u] : a.m;
    const bool at_home = u == home;
    const long long base = (long long)u * a.stride;
    const int32_t* row = a.idxs + i * a.K;
    for (int c0 = 0; c0 < V; c0 += 32) {
      const int l = c0 + lane;
      const uint32_t v = l < L ? a.items[i * L + l]
                               : l < V ? a.chks[2 * i + (l - L)] : 0u;
      for (int s0 = 0; s0 < a.K; s0 += 32) {
        const int k = s0 + lane;
        const int jj = k < a.K ? row[k] : -1;
        const bool valid = jj >= 0 && jj < lim;
        if (c0 == 0 && valid) {
          if (row0 && at_home && jj == 0) cnt0 += w;
          else if (at_home && jj < rows) atomicAdd(cnt + jj, w);
          else atomicAdd(a.counts + base + jj, w);
        }
        unsigned mask = __ballot_sync(kFull, valid);
        while (mask) {
          const int j = __shfl_sync(kFull, jj, __ffs(mask) - 1);
          mask &= mask - 1;
          if (l >= V) continue;
          if (row0 && at_home && j == 0) acc0 ^= v;
          else if (at_home && j < rows) atomicXor(tab + j * V + l, v);
          else if (l < L) atomicXor(a.sums + (base + j) * L + l, v);
          else atomicXor(a.checks + 2 * (base + j) + (l - L), v);
        }
      }
    }
  }
  if (row0) {
    if (lane < V && acc0) atomicXor(tab + lane, acc0);
    if (cnt0) atomicAdd(cnt, cnt0);
  }
  __syncthreads();
  const long long hb = (long long)home * a.stride;
  for (int t = threadIdx.x; t < rows * V; t += blockDim.x) {
    const uint32_t v = tab[t];
    if (v == 0) continue;
    const int r = t / V, c = t - r * V;
    if (c < L) atomicXor(a.sums + (hb + r) * L + c, v);
    else atomicXor(a.checks + 2 * (hb + r) + (c - L), v);
  }
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int32_t v = cnt[t];
    if (v != 0) atomicAdd(a.counts + hb + t, v);
  }
}

}  // namespace

extern "C" int sv_info(int C, long long smem, int* out) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncSetAttribute(v4_kernel<1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (C > 8)
    cudaFuncSetAttribute(v4_kernel<1>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(C * 64);
  out[2] = 0;
  cudaOccupancyMaxActiveClusters(&out[2], (void*)v4_kernel<1>, &cfg);
  return (int)cudaGetLastError();
}

extern "C" int sv_prior_apply(const void* items, const void* idxs,
                              const void* chks, const void* sides,
                              long long n, int K, int L, const void* unit,
                              const void* m_units, long long stride,
                              void* sums, void* checks, void* counts,
                              void* stream) {
  const long long total = n * (long long)K;
  if (total <= 0) return 0;
  prior_apply_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)items, (const int32_t*)idxs, (const uint32_t*)chks,
      (const int32_t*)sides, n, K, L, (const int32_t*)unit,
      (const int32_t*)m_units, stride, (uint32_t*)sums, (uint32_t*)checks,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int sv_prior_encode(const void* items, const void* idxs,
                               const void* chks, long long n, int K, int L,
                               long long m, void* sums, void* checks,
                               void* counts, void* stream) {
  if (n <= 0 || K <= 0 || m <= 0) return 0;
  const long long fit = 48 * 1024 / (4LL * (L + 3));
  const int hot = (int)(m < fit ? m : fit);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (n + 255) / 256;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  prior_encode_kernel<<<(unsigned)blocks, 256, (size_t)hot * (L + 3) * 4,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)items, (const int32_t*)idxs, (const uint32_t*)chks, n,
      K, L, m, hot, (uint32_t*)sums, (uint32_t*)checks, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// variant 0: words_kernel<0, 0>; 1: words_kernel<0, 1>; 2:
// words_kernel<1, 0> (all with a table of H1 rows); 3: the shipped body
// with H = H1; 4: v4_kernel<1>, H1 local rows and H2 distributed rows a
// block in clusters of C (grid = the clusters that fit); 5, 6:
// tuned_kernel prefetching 1 or 2 items ahead; 7: tuned_kernel with row 0
// in registers; 8: both (2 ahead).
extern "C" int sv_variant(int variant, const void* items, const void* idxs,
                          const void* chks, const void* weights,
                          const void* unit, const void* limits, long long m,
                          long long n, int K, int L, long long stride,
                          int H1, int H2, int grid, int C, void* sums,
                          void* checks, void* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(H1 + H2) * (L + 3) * 4;
  if (variant <= 2) {
    auto kernel = variant == 0 ? words_kernel<0, 0>
                  : variant == 1 ? words_kernel<0, 1> : words_kernel<1, 0>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, 1024, smem, st>>>(
        (const uint32_t*)items, (const int32_t*)idxs, (const uint32_t*)chks,
        (const int32_t*)weights, (const int32_t*)unit, (const int32_t*)limits,
        m, n, K, L, stride, H1, (uint32_t*)sums, (uint32_t*)checks,
        (int32_t*)counts);
    return (int)cudaGetLastError();
  }
  if (variant >= 3 && variant != 4) {
    scatter::Args a{};
    a.items = (const uint32_t*)items;
    a.idxs = (const int32_t*)idxs;
    a.chks = (const uint32_t*)chks;
    a.weights = (const int32_t*)weights;
    a.unit = (const int32_t*)unit;
    a.limits = (const int32_t*)limits;
    a.m = m;
    a.n = n;
    a.K = K;
    a.L = L;
    a.stride = stride;
    a.hot = H1;
    a.sums = (uint32_t*)sums;
    a.checks = (uint32_t*)checks;
    a.counts = (int32_t*)counts;
    auto kernel = variant == 3 ? scatter::scatter_kernel<scatter::kApply>
                  : variant == 5 ? tuned_kernel<1, false>
                  : variant == 6 ? tuned_kernel<2, false>
                  : variant == 7 ? tuned_kernel<0, true>
                                 : tuned_kernel<2, true>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, scatter::kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaFuncSetAttribute(v4_kernel<1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (C > 8)
    cudaFuncSetAttribute(v4_kernel<1>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(C * 64);
  int ncl = 0;
  cudaOccupancyMaxActiveClusters(&ncl, (void*)v4_kernel<1>, &cfg);
  if (ncl <= 0) return -1;
  cfg.gridDim = dim3(ncl * C);
  cfg.stream = st;
  cudaLaunchKernelEx(&cfg, v4_kernel<1>, (const uint32_t*)items,
                     (const int32_t*)idxs, (const uint32_t*)chks,
                     (const int32_t*)weights, (const int32_t*)unit,
                     (const int32_t*)limits, m, n, K, L, stride, H1, H2,
                     (uint32_t*)sums, (uint32_t*)checks, (int32_t*)counts);
  return (int)cudaGetLastError();
}
