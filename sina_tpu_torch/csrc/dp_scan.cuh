// The block-wide insertion prefix-min shared by the profile DP and the graph
// DP (profile_dp.cu, graph_dp.cu), with one barrier per DP row.
//
// Each thread owns L consecutive query lanes and has, for the row being
// computed, the minimum `tot` of its lanes' insertion candidates, the minimum
// `part` over all but its last lane, and its last lane's value `last` (U). A
// thread then needs three things from the threads before it:
//   excl: min tot over the threads before it (the run entering its lanes),
//   tail: min cand over every lane before the previous thread's last lane,
//         = min(excl of the previous thread, part of the previous thread),
//   prev_last: the previous thread's `last`.
// Two levels, arranged so that little waits on the barrier: before it, each
// warp reduces its total and its tail (min over all but its last lane) with
// one warp-reduce instruction each and publishes them with its last lane's
// `last`; after it, each warp reduces the published totals of the warps
// before it (again one instruction each) while its lanes scan their own
// warp with shuffles, the two independent of each other. The published
// values are double-buffered by the caller's row parity, so the next row's
// writes cannot overtake a slow warp's reads of this row's: a warp writes
// buffer p again only after the barrier of the row between.
//
// The warp reductions run on order-preserving integer keys of the floats
// (min over keys = min over values). Minima are exact in any order, so the
// result is bit-equal to a serial scan.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dp {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 32;
constexpr int kKeyInf = 0x7F800000;  // key(+inf)

// order-preserving int of a float (not NaN): f < g <=> key(f) < key(g)
__device__ __forceinline__ int key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float unkey(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

struct ScanSlots {
  int tot[2][kMaxWarps];   // keys
  int tail[2][kMaxWarps];  // keys
  float last[2][kMaxWarps];
};

struct ScanOut {
  float excl;       // min tot over threads < t (inf for thread 0)
  float tail;       // min cand over lanes before thread t-1's last lane (inf for t <= 0)
  float prev_last;  // `last` of thread t-1 (unspecified for thread 0)
};

// Publishes, waits at the block barrier, reads. Every thread of the block
// must call it; blockDim.x / 32 <= 32.
__device__ __forceinline__ ScanOut block_min_scan(float tot, float part, float last,
                                                  ScanSlots& s, int buf, int warp, int wl) {
  const float inf = CUDART_INF_F;
  const int wtot = __reduce_min_sync(kFull, key(tot));
  const int wtail = __reduce_min_sync(kFull, key(wl < 31 ? tot : part));
  if (wl == 31) {
    s.tot[buf][warp] = wtot;
    s.tail[buf][warp] = wtail;
    s.last[buf][warp] = last;
  }
  __syncthreads();
  // the totals of the warps before this one, and before the one before
  const int pk = s.tot[buf][wl];  // read only below `warp`
  const int wp = __reduce_min_sync(kFull, wl < warp ? pk : kKeyInf);
  const int wpm = __reduce_min_sync(kFull, wl + 1 < warp ? pk : kKeyInf);
  // this warp's own inclusive scan, its exclusive, the previous lane's
  float li = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, li, off);
    if (wl >= off) li = fminf(li, o);
  }
  float le = __shfl_up_sync(kFull, li, 1);
  if (wl == 0) le = inf;
  const float le1 = __shfl_up_sync(kFull, le, 1);  // inf at lane 1
  const float pp = __shfl_up_sync(kFull, part, 1);
  const float pl = __shfl_up_sync(kFull, last, 1);
  const float before = unkey(wp);  // inf for warp 0
  ScanOut r;
  r.excl = fminf(before, le);
  if (wl > 0) {
    r.tail = fminf(before, fminf(le1, pp));
    r.prev_last = pl;
  } else if (warp > 0) {
    r.tail = fminf(unkey(wpm), unkey(s.tail[buf][warp - 1]));
    r.prev_last = s.last[buf][warp - 1];
  } else {
    r.tail = inf;
    r.prev_last = inf;
  }
  return r;
}

}  // namespace dp
