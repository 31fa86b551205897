// Variants of the map_indices kernel, timed against each other on the card
// by map_indices_variants.py (which builds this file).  Not part of the
// package: the kernel it ships is src/repro_torch/csrc/map_indices.cu.
//
//   prior_kernel<V>  the form map_indices.cu had before map_indices.cuh:
//                    one thread per item in 128-thread blocks, each storing
//                    its K indices at a stride of K words
//                    V = 0  as is
//                    V = 1  the same index bytes stored coalesced: slot k
//                           of item i at k * n + i (column-major), so a
//                           warp store covers 32 consecutive words
//                    V = 2  the chain only: a seed from the item number, no
//                           item loads, no SipHash
//                    V = 3  SipHash only: loads and both hashes, no chain
//                           and no index stores (the seed is folded into
//                           the checksum so that it stays live)
//   mv_launch        the shipped body itself (mapidx::launch) at an
//                    explicit shape: bn items a block, G lanes an item
//   var_kernel       a copy of the shipped body with the
//                    knobs that were measured: the items staged in shared
//                    memory in one coalesced pass, no checksum (as the
//                    decode, which discards it, could launch it), ring
//                    depths other than the shipped 4, G = 8 lanes, and the
//                    two SipHashes of a one-lane item as two siphash24
//                    calls instead of one siphash24_x2.  Timed at the
//                    shipped settings too, so that what the copying itself
//                    moves in code generation shows.
#include <cuda_runtime.h>
#include <cstdint>

#include "../src/repro_torch/csrc/map_indices.cuh"

namespace {

template <int V>
__global__ void prior_kernel(const uint32_t* __restrict__ items, long long n,
                             int L, int nbytes, int K, long long m,
                             uint64_t k0, uint64_t k1, uint64_t mk0,
                             uint64_t mk1, int32_t* __restrict__ idx_out,
                             uint32_t* __restrict__ chk_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* w = items + i * L;
  uint64_t chk, s;
  if (V == 2) {
    uint64_t z = (uint64_t)i * 0x9E3779B97F4A7C15ULL + 0x632BE59BD9B4E019ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    s = (z ^ (z >> 31)) | 1ULL;
    chk = s;
  } else {
    chk = repro_torch::siphash24(w, L, nbytes, k0, k1);
    s = repro_torch::siphash24(w, L, nbytes, mk0, mk1) | 1ULL;
  }
  if (V == 3) {
    chk ^= s;
    chk_out[2 * i] = (uint32_t)(chk >> 32);
    chk_out[2 * i + 1] = (uint32_t)chk;
    return;
  }
  chk_out[2 * i] = (uint32_t)(chk >> 32);
  chk_out[2 * i + 1] = (uint32_t)chk;

  int32_t* row = V == 1 ? idx_out + i : idx_out + i * (long long)K;
  const long long step = V == 1 ? n : 1;
  long long cur = 0;
  int k = 0;
  for (; k < K && cur < m; ++k) {
    row[k * step] = (int32_t)cur;
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    const float rbits = (float)(uint32_t)(s >> 40);
    const float r = __fmul_rn(rbits, 5.9604644775390625e-08f);
    const float t = __fdiv_rn(1.0f, __fsqrt_rn(__fsub_rn(1.0f, r)));
    const float u = __fsub_rn(t, 1.0f);
    const float f = __fadd_rn(__ll2float_rn(cur), 1.5f);
    long long g = (long long)ceilf(__fmul_rn(f, u));
    if (g < 1) g = 1;
    cur = cur + g < m ? cur + g : m;
  }
  for (; k < K; ++k) row[k * step] = (int32_t)m;
}

template <int G, int kDepth, bool kStage, bool kChk, bool kPair>
__global__ void __launch_bounds__(128) var_kernel(mapidx::Args a) {
  using mapidx::jump_to;
  using mapidx::jump_u;
  using mapidx::xs64;
  using mapidx::xs64_n;
  constexpr int R = kDepth / G > 1 ? kDepth / G : 1;  // ring rounds
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x % G;
  const int r = threadIdx.x / G;
  const long long i0 = (long long)blockIdx.x * a.bn;
  const int nb = (int)(a.n - i0 < a.bn ? a.n - i0 : a.bn);
  const bool live = r < nb;
  const int K = a.K;
  const long long g0 = i0 * K;
  int32_t* tile = smem + (g0 & 3);
  const unsigned gmask =
      G == 1 ? 1u : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
  uint64_t chk = 0, seed = 0;
  auto hash = [&](const uint32_t* w) {
    if (G == 1 && kChk && kPair) {
      repro_torch::siphash24_x2(w, a.L, a.nbytes, a.k0, a.k1, a.mk0, a.mk1, chk, seed);
    } else if (G == 1) {
      if (kChk) chk = repro_torch::siphash24(w, a.L, a.nbytes, a.k0, a.k1);
      seed = repro_torch::siphash24(w, a.L, a.nbytes, a.mk0, a.mk1);
    } else {  // lane 0 the checksum, the others the seed
      const bool ck = kChk && lane == 0;
      const uint64_t h = repro_torch::siphash24(
          w, a.L, a.nbytes, ck ? a.k0 : a.mk0, ck ? a.k1 : a.mk1);
      chk = h;
      seed = __shfl_sync(gmask, h, 1, G);
    }
    if (kChk && lane == 0)
      reinterpret_cast<uint2*>(a.chk)[i0 + r] =
          make_uint2((uint32_t)(chk >> 32), (uint32_t)chk);
  };
  if (kStage) {  // the block's items into shared memory, then the tile
    uint32_t* st = reinterpret_cast<uint32_t*>(smem);
    const uint32_t* src = a.items + i0 * a.L;
    for (int t = threadIdx.x; t < nb * a.L; t += blockDim.x) st[t] = src[t];
    __syncthreads();
    if (live) hash(st + r * a.L);
    __syncthreads();
  }
  if (live) {
    // 1. checksum and seed
    if (!kStage) hash(a.items + (i0 + r) * a.L);

    // 2. the chain into the tile
    int32_t* row = tile + r * K;
    uint64_t s = xs64(seed | 1ULL);
    for (int q = 0; q < lane; ++q) s = xs64(s);
    float ring[R];
#pragma unroll
    for (int d = 0; d < R; ++d) {
      ring[d] = jump_u(s);
      s = xs64_n<G>(s);
    }
    long long cur = 0;
    int k = 0;
    for (; k < K; k += R * G) {
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const float mine = ring[d];
        ring[d] = jump_u(s);  // the jump R * G further on
        s = xs64_n<G>(s);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int t = k + d * G + q;
          const float u = G == 1 ? mine : __shfl_sync(gmask, mine, q, G);
          if (q == lane && t < K) row[t] = (int32_t)cur;
          cur = jump_to(cur, u, a.m);
        }
      }
      if (cur >= a.m) {
        k += R * G;
        break;
      }
    }
    for (k += lane; k < K; k += G) row[k] = (int32_t)a.m;
  }
  __syncthreads();

  // 3. the tile as one span
  int32_t* dst = a.idx + g0;
  const int total = nb * K;
  int pre = (int)((4 - (g0 & 3)) & 3);
  if (pre > total) pre = total;
  const int nv = (total - pre) / 4;
  for (int t = threadIdx.x; t < pre; t += blockDim.x) dst[t] = tile[t];
  const int4* s4 = reinterpret_cast<const int4*>(tile + pre);
  int4* d4 = reinterpret_cast<int4*>(dst + pre);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) d4[v] = s4[v];
  for (int t = pre + 4 * nv + threadIdx.x; t < total; t += blockDim.x)
    dst[t] = tile[t];
}

template <int G, int kDepth, bool kStage, bool kChk, bool kPair>
int launch_var(const mapidx::Args& a, size_t smem, cudaStream_t stream) {
  auto* kernel = var_kernel<G, kDepth, kStage, kChk, kPair>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return (int)set;
  const long long blocks = (a.n + a.bn - 1) / a.bn;
  kernel<<<(unsigned)blocks, a.bn * G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One knob at a time away from the shipped settings (depth 4, items read
// from device memory, checksum, siphash24_x2 on one lane).
template <int G>
int launch_var_g(const mapidx::Args& a, int depth, int stage, int chk,
                 int pair, size_t smem, cudaStream_t st) {
  if (!pair)
    return depth == 4 && !stage && chk
               ? launch_var<G, 4, false, true, false>(a, smem, st)
               : (int)cudaErrorInvalidValue;
  if (stage)
    return depth == 4 && chk ? launch_var<G, 4, true, true, true>(a, smem, st)
                             : (int)cudaErrorInvalidValue;
  if (!chk)
    return depth == 4 ? launch_var<G, 4, false, false, true>(a, smem, st)
                      : (int)cudaErrorInvalidValue;
  switch (depth) {
    case 1: return launch_var<G, 1, false, true, true>(a, smem, st);
    case 2: return launch_var<G, 2, false, true, true>(a, smem, st);
    case 4: return launch_var<G, 4, false, true, true>(a, smem, st);
    case 8: return launch_var<G, 8, false, true, true>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

mapidx::Args make_args(const void* items, long long n, int L, int nbytes,
                       int K, long long m, uint64_t k0, uint64_t k1,
                       uint64_t mk0, uint64_t mk1, void* idx_out,
                       void* chk_out, int bn) {
  mapidx::Args a{};
  a.items = (const uint32_t*)items;
  a.n = n;
  a.L = L;
  a.nbytes = nbytes;
  a.K = K;
  a.m = m;
  a.k0 = k0;
  a.k1 = k1;
  a.mk0 = mk0;
  a.mk1 = mk1;
  a.idx = (int32_t*)idx_out;
  a.chk = (uint32_t*)chk_out;
  a.bn = bn;
  return a;
}

}  // namespace

extern "C" int mv_prior(int variant, const void* items, long long n, int L,
                        int nbytes, int K, long long m, uint64_t k0,
                        uint64_t k1, uint64_t mk0, uint64_t mk1,
                        void* idx_out, void* chk_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto* kernel = prior_kernel<0>;
  switch (variant) {
    case 0: kernel = prior_kernel<0>; break;
    case 1: kernel = prior_kernel<1>; break;
    case 2: kernel = prior_kernel<2>; break;
    case 3: kernel = prior_kernel<3>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)items, n, L, nbytes, K, m, k0, k1, mk0, mk1,
      (int32_t*)idx_out, (uint32_t*)chk_out);
  return (int)cudaGetLastError();
}

// The shipped body at an explicit shape: bn items a block, G lanes an item,
// smem bytes.
extern "C" int mv_launch(int lanes, const void* items, long long n, int L,
                         int nbytes, int K, long long m, uint64_t k0,
                         uint64_t k1, uint64_t mk0, uint64_t mk1,
                         void* idx_out, void* chk_out, int bn,
                         long long smem, void* stream) {
  if (n <= 0) return 0;
  return mapidx::launch(make_args(items, n, L, nbytes, K, m, k0, k1, mk0,
                                  mk1, idx_out, chk_out, bn),
                        lanes, (size_t)smem, (cudaStream_t)stream);
}

// The copy: lanes G, ring depth, items staged or not, checksum or not,
// siphash24_x2 or two siphash24 calls on one lane, at an explicit shape.
extern "C" int mv_body(int lanes, int depth, int stage, int chk, int pair,
                       const void* items, long long n, int L, int nbytes,
                       int K, long long m, uint64_t k0, uint64_t k1,
                       uint64_t mk0, uint64_t mk1, void* idx_out,
                       void* chk_out, int bn, long long smem, void* stream) {
  if (n <= 0) return 0;
  const mapidx::Args a = make_args(items, n, L, nbytes, K, m, k0, k1, mk0,
                                   mk1, idx_out, chk_out, bn);
  const size_t bytes = (size_t)smem;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_var_g<1>(a, depth, stage, chk, pair, bytes, st);
    case 2: return launch_var_g<2>(a, depth, stage, chk, pair, bytes, st);
    case 4: return launch_var_g<4>(a, depth, stage, chk, pair, bytes, st);
    case 8: return launch_var_g<8>(a, depth, stage, chk, pair, bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
