// purity_scan: is each coded symbol pure (it holds exactly one item)?
//
// Replaces the Pallas kernel repro/kernels/peel.py::purity_scan (bodies
// `_purity_kernel` / `_purity_body`).  One thread per symbol: a symbol is
// pure when its count is nonzero and the keyed SipHash-2-4 of its sum words
// equals its stored (hi, lo) checksum; the output is the sign of its count
// there and 0 elsewhere.
//
// What bounds it on this card: integer work of one SipHash per non-empty
// symbol (~(L + 6) sip rounds) against (L + 4) * 4 bytes read per symbol.
// The design skips the hash for empty symbols (count 0 cannot be pure),
// which late in a decode is most of them, and shares siphash.cuh with
// map_indices so checksums agree with the encoder's by construction.
#include <cuda_runtime.h>
#include <cstdint>

#include "siphash.cuh"

namespace {

__global__ void purity_scan_kernel(const uint32_t* __restrict__ sums,
                                   const uint32_t* __restrict__ checks,
                                   const int32_t* __restrict__ counts,
                                   long long mp, int L, int nbytes,
                                   uint64_t k0, uint64_t k1,
                                   int32_t* __restrict__ side) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mp) return;
  const int32_t c = counts[i];
  int32_t out = 0;
  if (c != 0) {
    const uint64_t h = repro_torch::siphash24(sums + i * L, L, nbytes, k0, k1);
    if ((uint32_t)(h >> 32) == checks[2 * i] &&
        (uint32_t)h == checks[2 * i + 1]) {
      out = c > 0 ? 1 : -1;
    }
  }
  side[i] = out;
}

}  // namespace

extern "C" int purity_scan_launch(const void* sums, const void* checks,
                                  const void* counts, long long mp, int L,
                                  int nbytes, uint64_t k0, uint64_t k1,
                                  void* side, void* stream) {
  if (mp <= 0) return 0;
  const int threads = 128;
  const long long blocks = (mp + threads - 1) / threads;
  purity_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sums, (const uint32_t*)checks, (const int32_t*)counts,
      mp, L, nbytes, k0, k1, (int32_t*)side);
  return (int)cudaGetLastError();
}
