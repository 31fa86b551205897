// iblt_encode: the encoder's coded-symbol accumulation (paper §4).  For each
// symbol j: the XOR of the items and checksums mapped there, and their count.
//
// Replaces the Pallas kernel repro/kernels/iblt_encode.py::iblt_encode
// (bodies `_kernel` and `_tree_xor`).  The TPU has no scatter, so that kernel
// runs a (symbol tile, item block) grid with the item axis innermost: it
// builds a dense (items x symbols) equality mask per tile and reduces the
// masked items with a log2 XOR tree, carrying each output tile across the
// sequential grid.  Hopper blocks run in no order, but it has 32-bit
// atomicXor / atomicAdd, so this kernel scatters instead.  XOR and integer
// addition do not depend on order, so the result is bit-identical whatever
// order the atomics land in.
//
// What bounds it on this card: the atomics, not the bytes.  Every item maps
// to symbol 0 and about half of them to symbol 1 (rho(j) ~ 1/(1 + j/2)), so
// a plain one-thread-per-slot scatter puts n atomics on each of symbol 0's
// L + 3 words, all serialised at one L2 address.  The design keeps the
// first H symbols -- the hot rows -- in shared memory: each block walks a
// stripe of items (one thread per item, its K slots in order), accumulates
// hot-row slots with shared-memory atomics, sends the colder rows straight
// to device memory, and at the end flushes its nonzero hot words with one
// global atomic each.  H is as many rows of L + 3 words as fit in 48 KB.
//
// The outputs must be zeroed by the caller; only 0 <= idx < m counts (pad
// slots hold m).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;

__global__ void iblt_encode_kernel(const uint32_t* __restrict__ items,
                                   const int32_t* __restrict__ idxs,
                                   const uint32_t* __restrict__ chks,
                                   long long n, int K, int L, long long m,
                                   int hot, uint32_t* __restrict__ sums,
                                   uint32_t* __restrict__ checks,
                                   int32_t* __restrict__ counts) {
  // hot rows: [L sum words | 2 check words | count] per symbol j < hot
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
    if (v == 0) continue;   // XOR / add of zero changes nothing
    const long long j = t / W;
    const int c = t % W;
    if (c < L) {
      atomicXor(sums + j * L + c, v);
    } else if (c < L + 2) {
      atomicXor(checks + 2 * j + (c - L), v);
    } else {
      atomicAdd(counts + j, (int32_t)v);
    }
  }
}

}  // namespace

extern "C" int iblt_encode_launch(const void* items, const void* idxs,
                                  const void* chks, long long n, int K,
                                  int L, long long m, void* sums,
                                  void* checks, void* counts, void* stream) {
  if (n <= 0 || K <= 0 || m <= 0) return 0;
  const long long fit = kSharedBytes / (4LL * (L + 3));
  const int hot = (int)(m < fit ? m : fit);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // a few blocks per SM: enough to fill the card, few enough that the
  // hot-row flushes (one per block) stay small against the item work
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 4LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  iblt_encode_kernel<<<(unsigned)blocks, kThreads,
                       (size_t)hot * (L + 3) * 4, (cudaStream_t)stream>>>(
      (const uint32_t*)items, (const int32_t*)idxs, (const uint32_t*)chks, n,
      K, L, m, hot, (uint32_t*)sums, (uint32_t*)checks, (int32_t*)counts);
  return (int)cudaGetLastError();
}
