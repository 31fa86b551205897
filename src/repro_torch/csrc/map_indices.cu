// map_indices: per-item keyed checksum + mapping-PRNG seed + the first K
// skip-sampled mapped indices (paper §4.2).
//
// Replaces the Pallas kernel repro/kernels/map_indices.py::map_indices
// (body `_kernel`).  The body is map_indices.cuh.
//
// What bounds it on this card: the bytes, n * (L + K + 2) * 4, at an
// encode's 10^6 items, which it reaches within ~1.5x; at a decode's waves
// of a few thousand items, the launch and each item's serial chain.  The
// first form (one thread per item, each storing its K indices at a stride
// of K words, so every warp store touched 32 sectors) spent most of its
// time on those stores: made coalesced, the same kernel took 0.38 instead
// of 1.39 ms at n = 10^6, K = 66, and 0.018 instead of 0.039 ms at a
// decode's first wave of 25,488 items; its SipHashes alone took 0.10
// and 0.006 ms (experiments/map_indices_variants.py, PERF.md).  So:
//   - tile stores: a block builds its items' (bn, K) index tile, pads
//     included, in shared memory and writes it as one contiguous span,
//     16 bytes a store;
//   - the index-free part of each jump (xorshift64, sqrt, division) runs
//     kDepth jumps ahead of the index-dependent step in a ring with no
//     branch inside, so consecutive jumps overlap;
//   - both SipHashes side by side on one lane (siphash24_x2: 14 % faster
//     than two siphash24 calls at an encode), or on two lanes where an
//     item has more;
//   - lanes per item: a wave too small to fill the card gives each item G
//     lanes, which split its SipHashes and its ring (G = 4 is ~10 %
//     faster than G = 2 at waves of 500 and 2,000 items).  The launch
//     shape (bn, G, shared bytes) comes from the wrapper
//     (kernels/map_indices.py::launch_shape), from n and the card.
// Measured and left out: staging the items in shared memory, ring depths
// 1, 2 and 8, G = 8, and a launch without the checksum for the decode.
//
// Bit-exactness with the host chain (repro.core.mapping._jump_np): the fp32
// steps use the explicitly rounded intrinsics, built with -fmad=false, so no
// FMA contraction or approximate sqrt / reciprocal can change a bit.  The
// index is walked in int64 and saturated at m, so a jump beyond int32 (m
// above ~5.2e5) ends the chain at m instead of wrapping negative; only
// 0 <= idx < m is ever valid, pad slots hold m.
#include <cuda_runtime.h>
#include <cstdint>

#include "map_indices.cuh"

extern "C" int map_indices_launch(const void* items, long long n, int L,
                                  int nbytes, int K, long long m,
                                  uint64_t k0, uint64_t k1, uint64_t mk0,
                                  uint64_t mk1, void* idx_out, void* chk_out,
                                  int bn, int lanes, long long smem,
                                  const void* count, void* stream) {
  if (n <= 0) return 0;
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
  a.count = (const long long*)count;
  return mapidx::launch(a, lanes, (size_t)smem, (cudaStream_t)stream);
}
