// SipHash-2-4 on native 64-bit integers, shared by the map_indices and
// purity_scan kernels so that the encoder-side and decoder-side hashes are
// bit-identical by construction (the role repro/kernels/common.py plays for
// the Pallas kernels).
//
// The message is the L little-endian 32-bit words of one item, packed two
// to a 64-bit block; the final block carries a leftover word (odd L) and
// `nbytes & 0xff` in its top byte -- exactly repro.core.hashing.siphash24.
// The TPU version emulates each u64 as a (hi, lo) pair of u32 lanes; Hopper
// has 64-bit integer ALUs, so no emulation here.
#pragma once

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ void sipround(uint64_t& v0, uint64_t& v1,
                                         uint64_t& v2, uint64_t& v3) {
  v0 += v1; v1 = rotl64(v1, 13); v1 ^= v0; v0 = rotl64(v0, 32);
  v2 += v3; v3 = rotl64(v3, 16); v3 ^= v2;
  v0 += v3; v3 = rotl64(v3, 21); v3 ^= v0;
  v2 += v1; v1 = rotl64(v1, 17); v1 ^= v2; v2 = rotl64(v2, 32);
}

// SipHash-2-4 of the L words at `w` under key (k0, k1).
__device__ __forceinline__ uint64_t siphash24(const uint32_t* __restrict__ w,
                                              int L, int nbytes,
                                              uint64_t k0, uint64_t k1) {
  uint64_t v0 = k0 ^ 0x736F6D6570736575ULL;
  uint64_t v1 = k1 ^ 0x646F72616E646F6DULL;
  uint64_t v2 = k0 ^ 0x6C7967656E657261ULL;
  uint64_t v3 = k1 ^ 0x7465646279746573ULL;
  const int full = L / 2;
  for (int i = 0; i < full; ++i) {
    const uint64_t m = (uint64_t)w[2 * i] | ((uint64_t)w[2 * i + 1] << 32);
    v3 ^= m;
    sipround(v0, v1, v2, v3);
    sipround(v0, v1, v2, v3);
    v0 ^= m;
  }
  uint64_t b = (uint64_t)(nbytes & 0xFF) << 56;
  if (L & 1) b |= (uint64_t)w[L - 1];
  v3 ^= b;
  sipround(v0, v1, v2, v3);
  sipround(v0, v1, v2, v3);
  v0 ^= b;
  v2 ^= 0xFFULL;
  sipround(v0, v1, v2, v3);
  sipround(v0, v1, v2, v3);
  sipround(v0, v1, v2, v3);
  sipround(v0, v1, v2, v3);
  return v0 ^ v1 ^ v2 ^ v3;
}

// SipHash-2-4 of the same L words under two keys, (a0, a1) -> ha and
// (b0, b1) -> hb: the two round chains are independent, so one thread runs
// them side by side and each word is read once.  Equal to two siphash24
// calls bit for bit.
__device__ __forceinline__ void siphash24_x2(const uint32_t* __restrict__ w,
                                             int L, int nbytes, uint64_t a0,
                                             uint64_t a1, uint64_t b0,
                                             uint64_t b1, uint64_t& ha,
                                             uint64_t& hb) {
  uint64_t v0 = a0 ^ 0x736F6D6570736575ULL, x0 = b0 ^ 0x736F6D6570736575ULL;
  uint64_t v1 = a1 ^ 0x646F72616E646F6DULL, x1 = b1 ^ 0x646F72616E646F6DULL;
  uint64_t v2 = a0 ^ 0x6C7967656E657261ULL, x2 = b0 ^ 0x6C7967656E657261ULL;
  uint64_t v3 = a1 ^ 0x7465646279746573ULL, x3 = b1 ^ 0x7465646279746573ULL;
  const int full = L / 2;
  for (int i = 0; i < full; ++i) {
    const uint64_t m = (uint64_t)w[2 * i] | ((uint64_t)w[2 * i + 1] << 32);
    v3 ^= m;
    x3 ^= m;
    sipround(v0, v1, v2, v3);
    sipround(x0, x1, x2, x3);
    sipround(v0, v1, v2, v3);
    sipround(x0, x1, x2, x3);
    v0 ^= m;
    x0 ^= m;
  }
  uint64_t b = (uint64_t)(nbytes & 0xFF) << 56;
  if (L & 1) b |= (uint64_t)w[L - 1];
  v3 ^= b;
  x3 ^= b;
  sipround(v0, v1, v2, v3);
  sipround(x0, x1, x2, x3);
  sipround(v0, v1, v2, v3);
  sipround(x0, x1, x2, x3);
  v0 ^= b;
  x0 ^= b;
  v2 ^= 0xFFULL;
  x2 ^= 0xFFULL;
  for (int r = 0; r < 4; ++r) {
    sipround(v0, v1, v2, v3);
    sipround(x0, x1, x2, x3);
  }
  ha = v0 ^ v1 ^ v2 ^ v3;
  hb = x0 ^ x1 ^ x2 ^ x3;
}

}  // namespace repro_torch
