// iblt_apply: the signed coded-symbol delta of a set of items over their
// mapped-index chains -- the chain removal of one peel wave.
//
// Replaces the Pallas kernel repro/kernels/peel.py::iblt_apply (body
// `_apply_kernel`).  The TPU has no scatter, so that kernel builds a dense
// (items x symbols) mask per tile and reduces it with an XOR tree.  Hopper
// has 32-bit atomicXor / atomicAdd, so this kernel scatters instead: one
// thread per (item, slot) whose index is valid (0 <= idx < m) and whose side
// is nonzero XORs the item's L words and 2 checksum words into that symbol
// and adds the side to its count.  XOR and integer addition do not depend on
// order, so the result is bit-identical whatever order the atomics land in.
//
// The outputs are a delta, not an in-place update: the wrapper passes
// zeroed sums / checks / counts, and the caller XORs the first two into its
// residual and subtracts the counts.
//
// What bounds it on this card: memory traffic -- reading n * K indices and,
// for the ~2 ln m valid slots per item, L + 3 atomics on scattered symbols;
// the zeroed outputs are written once by the wrapper.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void iblt_apply_kernel(const uint32_t* __restrict__ items,
                                  const int32_t* __restrict__ idxs,
                                  const uint32_t* __restrict__ chks,
                                  const int32_t* __restrict__ sides,
                                  long long n, int K, int L, long long m,
                                  uint32_t* __restrict__ sums,
                                  uint32_t* __restrict__ checks,
                                  int32_t* __restrict__ counts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * K) return;
  const long long i = t / K;
  const int32_t side = sides[i];
  const long long j = idxs[t];
  if (side == 0 || j < 0 || j >= m) return;
  const uint32_t* w = items + i * L;
  uint32_t* dst = sums + j * L;
  for (int l = 0; l < L; ++l) atomicXor(dst + l, w[l]);
  atomicXor(checks + 2 * j, chks[2 * i]);
  atomicXor(checks + 2 * j + 1, chks[2 * i + 1]);
  atomicAdd(counts + j, side);
}

}  // namespace

extern "C" int iblt_apply_launch(const void* items, const void* idxs,
                                 const void* chks, const void* sides,
                                 long long n, int K, int L, long long m,
                                 void* sums, void* checks, void* counts,
                                 void* stream) {
  const long long total = n * (long long)K;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  iblt_apply_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)items, (const int32_t*)idxs, (const uint32_t*)chks,
      (const int32_t*)sides, n, K, L, m, (uint32_t*)sums,
      (uint32_t*)checks, (int32_t*)counts);
  return (int)cudaGetLastError();
}
