// iblt_encode: the encoder's coded-symbol accumulation (paper §4).  For each
// symbol j: the XOR of the items and checksums mapped there, and their count.
//
// Replaces the Pallas kernel repro/kernels/iblt_encode.py::iblt_encode
// (bodies `_kernel` and `_tree_xor`).  The TPU has no scatter, so that kernel
// runs a (symbol tile, item block) grid with the item axis innermost: it
// builds a dense (items x symbols) equality mask per tile and reduces the
// masked items with a log2 XOR tree, carrying each output tile across the
// sequential grid.  Hopper blocks run in no order, but it has 32-bit
// atomicXor / atomicAdd, so this kernel scatters instead, with the body of
// scatter.cuh that iblt_apply.cu shares: weight +1, one unit, limit m.
//
// What bounds it, and the design: scatter.cuh.  At n = 10^6, m = 20,480
// every block walks ~7,600 items, so its shared table takes the card's
// whole opt-in shared memory (2,235 rows at L = 23): the shared atomics of
// the ~14.5 slots an item below that row and the global atomics, each on
// one row's consecutive words, of the ~4.4 slots an item past it bound it.
//
// The outputs must be zeroed by the caller; only 0 <= idx < m counts (pad
// slots hold m).
#include <cuda_runtime.h>
#include <cstdint>

#include "scatter.cuh"

extern "C" int iblt_encode_launch(const void* items, const void* idxs,
                                  const void* chks, long long n, int K,
                                  int L, long long m, void* sums,
                                  void* checks, void* counts, void* stream) {
  if (m <= 0) return 0;
  scatter::Args a{};
  a.items = (const uint32_t*)items;
  a.idxs = (const int32_t*)idxs;
  a.chks = (const uint32_t*)chks;
  a.m = m;
  a.n = n;
  a.K = K;
  a.L = L;
  a.sums = (uint32_t*)sums;
  a.checks = (uint32_t*)checks;
  a.counts = (int32_t*)counts;
  return scatter::launch<scatter::kEncode>(a, m, (cudaStream_t)stream);
}
