// iblt_apply: the signed coded-symbol delta of a set of items over their
// mapped-index chains -- the chain removal of one peel wave.
//
// Replaces the Pallas kernel repro/kernels/peel.py::iblt_apply (body
// `_apply_kernel`).  The TPU has no scatter, so that kernel builds a dense
// (items x symbols) mask per tile and reduces it with an XOR tree.  Hopper
// has 32-bit atomicXor / atomicAdd, so this kernel scatters instead: each
// slot whose index is valid (0 <= idx < m_u) of an item whose side is
// nonzero XORs the item's L words and 2 checksum words into that symbol
// and adds the side to its count.
//
// It serves U decode units at once (a plain decode is U = 1): the units lie
// end to end on the symbol axis, `stride` rows each.  Item i belongs to unit
// unit[i], only its slots with 0 <= j < m_units[unit[i]] count, and symbol j
// goes to row unit[i] * stride + j.
//
// `count`, where given, is the number of live items, on the card: a wave
// of the decode launches over its fixed slots and compacts the items it
// recovers to the front, so the host never reads how many there are.
//
// The outputs are a delta, not an in-place update: the wrapper passes
// zeroed sums / checks / counts, and the caller XORs the first two into its
// residual and subtracts the counts.
//
// What bounds it, and the design: scatter.cuh, shared with iblt_encode.cu.
// The atomics bound it, above all those on the first rows, which every
// chain visits.  A warp walks one item's slots with a lane on each word,
// and each block keeps the hot first rows of its stripe's home unit in
// shared memory and flushes them once.
#include <cuda_runtime.h>
#include <cstdint>

#include "scatter.cuh"

extern "C" int iblt_apply_launch(const void* items, const void* idxs,
                                 const void* chks, const void* sides,
                                 long long n, int K, int L,
                                 const void* unit, const void* m_units,
                                 long long stride, void* sums, void* checks,
                                 void* counts, const void* count,
                                 void* stream) {
  scatter::Args a{};
  a.items = (const uint32_t*)items;
  a.idxs = (const int32_t*)idxs;
  a.chks = (const uint32_t*)chks;
  a.weights = (const int32_t*)sides;
  a.unit = (const int32_t*)unit;
  a.limits = (const int32_t*)m_units;
  a.m = stride;
  a.n = n;
  a.K = K;
  a.L = L;
  a.stride = stride;
  a.sums = (uint32_t*)sums;
  a.checks = (uint32_t*)checks;
  a.counts = (int32_t*)counts;
  a.count = (const long long*)count;
  return scatter::launch<scatter::kApply>(a, stride, (cudaStream_t)stream);
}
