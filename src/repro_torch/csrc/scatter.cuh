// scatter.cuh: the one scatter body behind iblt_apply.cu and iblt_encode.cu.
//
// Both kernels compute the same function.  For every item i whose weight
// w_i is nonzero, and every slot k of its chain whose index j = idxs[i][k]
// satisfies 0 <= j < limit(i): XOR the item's L words into row base(i) + j
// of `sums`, its two checksum words into `checks`, and add w_i to `counts`.
// iblt_encode is the case w = +1, one unit, limit m.  iblt_apply passes the
// sides as weights, each item's unit (base = unit * stride) and each unit's
// prefix m_units[unit] as its limit, and may pass `count`, the number of
// live items read from device memory: the items past it are skipped.  XOR and integer addition do not depend
// on order, so the result is bit-identical whatever order the atomics land
// in.  The outputs must be zeroed by the caller.
//
// What bounds it on this card: the atomics, not the bytes.  Every chain
// starts at row 0 and row j receives about n / (1 + j/2) items, so a plain
// scatter serialises n atomics on each of row 0's L + 3 words, and the
// colder rows still cost one global atomic per word.  On an H100 global
// atomics on one row's consecutive words retire several times faster than
// on scattered rows, and a shared-memory table absorbs the hot rows faster
// still (PERF.md has the measurements).  The design:
//
// - A warp takes one item, and lane l holds word l of its L + 2 item and
//   checksum words (in chunks of 32 for wide items).  The warp walks the
//   item's valid slots, so each atomic instruction covers one row's
//   consecutive words: no shared-memory bank conflicts, and a global
//   atomic instruction touches a few sectors instead of 32 rows.  The
//   count is added lane-per-slot, once per 32 slots: a chain never repeats
//   a row, so no two lanes collide.
// - A persistent grid of at most one block per SM; each block walks a
//   contiguous stripe of items and keeps rows [0, H) of its stripe's first
//   unit (its "home" unit) in shared memory, the L + 2 words of a row side
//   by side so one atomic instruction covers them, the counts apart.  Slots
//   of other units and rows >= H go straight to global atomics, so any
//   order of `unit` is exact; the decode passes sorted units, so nearly
//   every item is home.  At the end each block flushes its nonzero hot
//   words with one global atomic each.
// - H is sized before the launch from the card and the launch's shape:
//   four times the items a block walks (rows past that receive less than
//   about one item a block, so the flush would cost what it saves), at
//   least 512, at most what the card's opt-in shared memory holds
//   (2,235 rows at L = 23 on an H100) and at most the rows a unit has.
//   Where not one row of L + 3 words fits (items of ~227 KB), H is 0 and
//   every slot goes global.
//
// Tried on the card and slower (experiments/scatter_variants.py, PERF.md):
// lanes on slots, a bulk-reduce flush (cp.reduce.async.bulk), part or all
// of the table spread over a thread block cluster's distributed shared
// memory, one block per unit, an L2 prefetch of the next items, and row 0
// kept in registers.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace scatter {
namespace {   // each library holds its own copy

constexpr int kThreads = 1024;
constexpr int kMinHot = 512;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint32_t* items;   // (n, L)
  const int32_t* idxs;     // (n, K)
  const uint32_t* chks;    // (n, 2)
  const int32_t* weights;  // (n,), or null: every weight is +1
  const int32_t* unit;     // (n,), or null: every item is in unit 0
  const int32_t* limits;   // (U,) prefix of each unit, or null: limit m
  long long m, n;
  int K, L;
  long long stride;        // rows between consecutive units
  int hot;                 // H, rows of the shared table
  uint32_t* sums;          // (rows, L)
  uint32_t* checks;        // (rows, 2)
  int32_t* counts;         // (rows,)
  const long long* count;  // live items (a prefix), read on the card, or
                           // null: all n
};

// The including library passes its tag, so a trace of the card tells
// iblt_apply's launches (scatter_kernel<0>) from iblt_encode's (<1>).
constexpr int kApply = 0, kEncode = 1;

template <int kLib>
__global__ void __launch_bounds__(kThreads, 1) scatter_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int L = a.L, V = L + 2;
  uint32_t* tab = smem;                                 // (H, L + 2)
  int32_t* cnt = (int32_t*)(smem + (size_t)a.hot * V);  // (H,)
  const long long n = a.count && *a.count < a.n ? *a.count : a.n;
  const long long lo = n * blockIdx.x / gridDim.x;
  const long long hi = n * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int home = a.unit ? a.unit[lo] : 0;
  const long long home_lim = a.limits ? a.limits[home] : a.m;
  const int rows = (int)(home_lim < 0 ? 0 : home_lim < a.hot ? home_lim
                                                              : a.hot);
  for (int t = threadIdx.x; t < rows * V; t += blockDim.x) tab[t] = 0;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) cnt[t] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (long long i = lo + (threadIdx.x >> 5); i < hi;
       i += blockDim.x >> 5) {
    const int32_t w = a.weights ? a.weights[i] : 1;
    if (w == 0) continue;
    const int u = a.unit ? a.unit[i] : 0;
    const long long lim = a.limits ? a.limits[u] : a.m;
    const bool at_home = u == home;
    const long long base = (long long)u * a.stride;
    const int32_t* row = a.idxs + i * a.K;
    for (int c0 = 0; c0 < V; c0 += 32) {
      const int l = c0 + lane;
      const uint32_t v = l < L ? a.items[i * L + l]
                               : l < V ? a.chks[2 * i + (l - L)] : 0u;
      for (int s0 = 0; s0 < a.K; s0 += 32) {
        const int k = s0 + lane;
        const int jj = k < a.K ? row[k] : -1;
        const bool valid = jj >= 0 && jj < lim;
        if (c0 == 0 && valid) {      // the count, lane per slot
          if (at_home && jj < rows) atomicAdd(cnt + jj, w);
          else atomicAdd(a.counts + base + jj, w);
        }
        unsigned mask = __ballot_sync(kFull, valid);
        while (mask) {               // the words, lane per word
          const int j = __shfl_sync(kFull, jj, __ffs(mask) - 1);
          mask &= mask - 1;
          if (l >= V) continue;
          if (at_home && j < rows) atomicXor(tab + j * V + l, v);
          else if (l < L) atomicXor(a.sums + (base + j) * L + l, v);
          else atomicXor(a.checks + 2 * (base + j) + (l - L), v);
        }
      }
    }
  }
  __syncthreads();

  // XOR / add of zero changes nothing: flush the nonzero words only
  const long long hb = (long long)home * a.stride;
  for (int t = threadIdx.x; t < rows * V; t += blockDim.x) {
    const uint32_t v = tab[t];
    if (v == 0) continue;
    const int r = t / V, c = t - r * V;
    if (c < L) atomicXor(a.sums + (hb + r) * L + c, v);
    else atomicXor(a.checks + 2 * (hb + r) + (c - L), v);
  }
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int32_t v = cnt[t];
    if (v != 0) atomicAdd(a.counts + hb + t, v);
  }
}

// Size the grid and H from the card, launch on `stream`, and return the
// launch's cudaError_t.  `max_rows` bounds H: the rows one unit has.
template <int kLib>
inline int launch(Args a, long long max_rows, cudaStream_t stream) {
  if (a.n <= 0 || a.K <= 0) return 0;
  int device = 0, sms = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const long long warps = kThreads / 32;
  long long grid = (a.n + warps - 1) / warps;
  if (grid > sms) grid = sms;
  const long long fit = optin / (4LL * (a.L + 3));
  long long hot = 4 * ((a.n + grid - 1) / grid);
  if (hot < kMinHot) hot = kMinHot;
  if (hot > max_rows) hot = max_rows;
  if (hot > fit) hot = fit;
  a.hot = (int)hot;
  const size_t smem = (size_t)hot * (a.L + 3) * 4;
  const cudaError_t set = cudaFuncSetAttribute(
      scatter_kernel<kLib>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (set != cudaSuccess) return (int)set;
  scatter_kernel<kLib><<<(unsigned)grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scatter
