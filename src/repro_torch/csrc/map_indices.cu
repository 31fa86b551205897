// map_indices: per-item keyed checksum + mapping-PRNG seed + the first K
// skip-sampled mapped indices (paper §4.2).
//
// Replaces the Pallas kernel repro/kernels/map_indices.py::map_indices
// (body `_kernel`).  One thread per item.
//
// What bounds it on this card: integer work.  Two SipHash-2-4 passes over
// the item's L words (~(L + 6) sip rounds each) and up to K xorshift64 +
// fp32 jump steps, against (L + 2K + 2) * 4 bytes of memory traffic per
// item.  The design keeps the whole chain in registers, uses native u64
// (the TPU kernel emulates u64 as u32 pairs), and stops a chain as soon as
// it reaches m, writing the remaining pad slots without further jumps.
//
// Bit-exactness with the host chain (repro.core.mapping._jump_np): the fp32
// steps use the explicitly rounded intrinsics, so no FMA contraction or
// approximate sqrt / reciprocal can change a bit.  The index is walked in
// int64 and saturated at m, so a jump beyond int32 (m above ~5.2e5) ends the
// chain at m instead of wrapping negative; only 0 <= idx < m is ever valid,
// pad slots hold m.
#include <cuda_runtime.h>
#include <cstdint>

#include "siphash.cuh"

namespace {

__global__ void map_indices_kernel(const uint32_t* __restrict__ items,
                                   long long n, int L, int nbytes, int K,
                                   long long m, uint64_t k0, uint64_t k1,
                                   uint64_t mk0, uint64_t mk1,
                                   int32_t* __restrict__ idx_out,
                                   uint32_t* __restrict__ chk_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* w = items + i * L;
  const uint64_t chk = repro_torch::siphash24(w, L, nbytes, k0, k1);
  uint64_t s = repro_torch::siphash24(w, L, nbytes, mk0, mk1) | 1ULL;
  chk_out[2 * i] = (uint32_t)(chk >> 32);
  chk_out[2 * i + 1] = (uint32_t)chk;

  int32_t* row = idx_out + i * (long long)K;
  long long cur = 0;
  int k = 0;
  for (; k < K && cur < m; ++k) {
    row[k] = (int32_t)cur;
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    const float rbits = (float)(uint32_t)(s >> 40);        // top 24 bits
    const float r = __fmul_rn(rbits, 5.9604644775390625e-08f);  // * 2^-24
    const float t = __fdiv_rn(1.0f, __fsqrt_rn(__fsub_rn(1.0f, r)));
    const float u = __fsub_rn(t, 1.0f);
    const float f = __fadd_rn(__ll2float_rn(cur), 1.5f);
    long long g = (long long)ceilf(__fmul_rn(f, u));
    if (g < 1) g = 1;
    cur = cur + g < m ? cur + g : m;
  }
  for (; k < K; ++k) row[k] = (int32_t)m;
}

}  // namespace

extern "C" int map_indices_launch(const void* items, long long n, int L,
                                  int nbytes, int K, long long m,
                                  uint64_t k0, uint64_t k1, uint64_t mk0,
                                  uint64_t mk1, void* idx_out, void* chk_out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  map_indices_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)items, n, L, nbytes, K, m, k0, k1, mk0, mk1,
      (int32_t*)idx_out, (uint32_t*)chk_out);
  return (int)cudaGetLastError();
}
