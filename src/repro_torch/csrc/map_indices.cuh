// The body of the map_indices kernel (map_indices.cu says what it replaces,
// what bounds it and why it is shaped so).
//
// A block takes `bn` consecutive items with G lanes each:
//   1. each item's checksum and mapping seed: both SipHashes side by side
//      on one lane (G = 1), or one on each of two lanes (G >= 2), reading
//      the item's words straight from device memory;
//   2. each item walks its chain into a (bn, K) index tile in shared
//      memory.  The index-free part of a jump (xorshift64, sqrt, division)
//      is computed kDepth jumps ahead into a ring, spread over the item's G
//      lanes, so only the index-dependent step stays on the recurrence.
//      After saturation the recurrence keeps writing m, so the jumps carry
//      no branch; the chain is left once every kDepth jumps;
//   3. the block writes its tile as one contiguous span of bn * K words,
//      16 bytes a store.
// With `count` set, the kernel reads the number of live items from device
// memory: a block past it returns at once, and rows past it are not
// written (the decode's waves launch over a fixed number of slots).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "siphash.cuh"

namespace mapidx {

struct Args {
  const uint32_t* items;  // (n, L) words
  long long n;
  int L, nbytes, K;
  long long m;
  uint64_t k0, k1;        // checksum key
  uint64_t mk0, mk1;      // mapping key
  int32_t* idx;           // (n, K) indices, pad = m
  uint32_t* chk;          // (n, 2) (hi, lo) checksums
  int bn;                 // items a block; a block has bn * G threads
  const long long* count; // live items, or null: all n
};

__device__ __forceinline__ uint64_t xs64(uint64_t s) {
  s ^= s << 13;
  s ^= s >> 7;
  s ^= s << 17;
  return s;
}

template <int N>
__device__ __forceinline__ uint64_t xs64_n(uint64_t s) {
#pragma unroll
  for (int i = 0; i < N; ++i) s = xs64(s);
  return s;
}

// The index-free part of a jump from the state after its xorshift step:
// u = (1 - r)^(-1/2) - 1, r the top 24 bits of the state over 2^24.
__device__ __forceinline__ float jump_u(uint64_t s) {
  const float rbits = (float)(uint32_t)(s >> 40);
  const float r = __fmul_rn(rbits, 5.9604644775390625e-08f);  // * 2^-24
  const float t = __fdiv_rn(1.0f, __fsqrt_rn(__fsub_rn(1.0f, r)));
  return __fsub_rn(t, 1.0f);
}

// The index-dependent part: cur + max(1, ceil((cur + 1.5) * u)), saturated
// at m.  Walked in int64, so a jump past int32 ends the chain at m.
__device__ __forceinline__ long long jump_to(long long cur, float u,
                                             long long m) {
  const float f = __fadd_rn(__ll2float_rn(cur), 1.5f);
  long long g = (long long)ceilf(__fmul_rn(f, u));
  if (g < 1) g = 1;
  return cur + g < m ? cur + g : m;
}

constexpr int kDepth = 4;  // jumps the ring runs ahead

// Shared 32-bit words a block's index tile needs: 3 words of slack align
// the tile with the output.
inline long long tile_words(int bn, int K) { return 3 + (long long)bn * K; }

template <int G>
__global__ void __launch_bounds__(128) map_kernel(Args a) {
  static_assert(G == 1 || G == 2 || G == 4, "lanes an item");
  constexpr int R = kDepth / G;  // ring rounds
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x % G;
  const int r = threadIdx.x / G;
  const long long i0 = (long long)blockIdx.x * a.bn;
  const long long n = a.count && *a.count < a.n ? *a.count : a.n;
  if (i0 >= n) return;  // the whole block: no barrier is left waiting
  const int nb = (int)(n - i0 < a.bn ? n - i0 : a.bn);
  const bool live = r < nb;
  const int K = a.K;
  const long long g0 = i0 * K;
  int32_t* tile = smem + (g0 & 3);
  if (live) {
    // 1. checksum and seed
    const uint32_t* w = a.items + (i0 + r) * a.L;
    const unsigned gmask =
        G == 1 ? 1u : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
    uint64_t chk, seed;
    if (G == 1) {
      repro_torch::siphash24_x2(w, a.L, a.nbytes, a.k0, a.k1, a.mk0, a.mk1,
                                chk, seed);
    } else {  // lane 0 the checksum, the others the seed
      const uint64_t h = repro_torch::siphash24(
          w, a.L, a.nbytes, lane == 0 ? a.k0 : a.mk0,
          lane == 0 ? a.k1 : a.mk1);
      chk = h;
      seed = __shfl_sync(gmask, h, 1, G);
    }
    if (lane == 0)
      reinterpret_cast<uint2*>(a.chk)[i0 + r] =
          make_uint2((uint32_t)(chk >> 32), (uint32_t)chk);

    // 2. the chain into the tile.  Jump t uses the state after t + 1
    // xorshift steps; lane j computes the u of the jumps t = j (mod G).
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

  // 3. the tile as one span: scalar words up to 16-byte alignment, then
  // 16 bytes a store, then the tail
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

// Launch the body at lanes G on `stream`: bn items a block, `smem` bytes of
// dynamic shared memory.  Returns the cudaError_t of the launch; a shape the
// card refuses (too much shared memory) is refused here, never run.
inline int launch(const Args& a, int lanes, size_t smem, cudaStream_t stream) {
  void (*kernel)(Args);
  switch (lanes) {
    case 1: kernel = map_kernel<1>; break;
    case 2: kernel = map_kernel<2>; break;
    case 4: kernel = map_kernel<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (a.bn <= 0 || (long long)a.bn * lanes > 128 ||
      (long long)smem < 4 * tile_words(a.bn, a.K))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return (int)set;
  const long long blocks = (a.n + a.bn - 1) / a.bn;
  kernel<<<(unsigned)blocks, a.bn * lanes, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mapidx
