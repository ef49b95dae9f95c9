// The bounded insertion track's trailing-window minimum with one block
// barrier (--insertion forbid): for each query position i of a DP row,
// min(cand[i-R .. i-1]) with BIG left of position 0, R = clip(budget, 1, M)
// block-uniform for the row, BIG everywhere where the budget is below 1.
//
// This is the construction of profile_dp.cu's forbid mode (van Herk /
// Gil-Werman: segments of R lanes, a segmented forward and backward
// min-scan, each reader adding the carries of the warps left of what it
// reads; profile_dp.cu's header comment and PERF.md tell its design and its
// measurements), for the dense graph DP (graph_dense.cu), where the row is
// a graph node. profile_dp.cu keeps its own copy in its source, which
// forbid_variants.py edits by text to build its variants. Here the lane count
// may also be 32 (query widths up to 16,384 at 512 threads), and the caller
// turns the insertion start at the lane left of the thread's first into its
// own I (the dense DP multiplies and adds in one rounding, the profile DP
// adds).
//
// Minima are exact in any order, so the result is bit-equal to the plain
// version's sparse table (ops/align_kernel.py _windowed_min).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dp_scan.cuh"

namespace fw {

constexpr float kBig = 1e6f;

// The block exchange, in dynamic shared memory behind the two S rows,
// double-buffered by row parity: each warp's warp-local P at its
// last lane (fwd) and the one before (plast), its warp-local S at its first
// lane (bwd) and the U of its last lane
struct ForbidSlots {
  float fwd[2][dp::kMaxWarps];
  float bwd[2][dp::kMaxWarps];
  float ulast[2][dp::kMaxWarps];
  float plast[2][dp::kMaxWarps];
};

// The S rows: each behind a guard of BIG for the window starts
// left of lane 0 (down to -1 - 32 K where R <= 32 K; wider windows clamp to
// -1), filled once
__host__ __device__ constexpr int guard_floats(int K) { return 32 * K + 4; }
__host__ __device__ constexpr int srow_floats(int lanes, int K) { return guard_floats(K) + lanes; }

// The carries from the warps for windows wider than a warp's lanes (R > 32
// K; under 2% of the profile path's real columns), out of the row loop's
// code (inlined, it slowed the narrower windows' columns of the profile DP
// on the card: forbid_variants.py, inline_wide): lane l of each warp stands
// for warp l, and Fw[l] (P at warp l's last lane) and Bw[l] (S at its first lane) come from segmented scans
// over the warps' slots, as the lanes were scanned over the threads.
// Returns cw = Fw[warp-1], pw2 = Fw[warp-2] (where lane wlane0-2's segment
// starts before the previous warp: cross2), bA = Bw[wlo+1], bB = Bw[wlo+2].
struct WideCarries {
  float cw, pw2, bA, bB;
};
template <int K>
__device__ __noinline__ WideCarries wide_carries(const ForbidSlots& fs, int par, int R,
                                                 uint32_t rdiv, int warp, int wl, int nwarps,
                                                 int wlo, bool cross2) {
  constexpr int W = 32 * K;
  const float inf = CUDART_INF_F;
  const bool live = wl < nwarps;
  float F = live ? fs.fwd[par][wl] : inf;
  float Bv = live ? fs.bwd[par][wl] : inf;
  const int fl = wl * W, ll = fl + W - 1;
  auto divR = [&](int n) { return R == 1 ? n : (int)__umulhi((unsigned)n, rdiv); };
  const int sl = divR(ll) * R;          // start of the segment of warp wl's last lane
  const int el = divR(fl) * R + R - 1;  // end of the segment of its first lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float fo = __shfl_up_sync(dp::kFull, F, off);
    const float bo = __shfl_down_sync(dp::kFull, Bv, off);
    if (ll - off * W >= sl) F = fminf(F, fo);
    if (fl + off * W <= el) Bv = fminf(Bv, bo);
  }
  const float f1 = __shfl_sync(dp::kFull, F, max(warp - 1, 0));
  const float f2 = __shfl_sync(dp::kFull, F, max(warp - 2, 0));
  WideCarries c;
  c.cw = warp > 0 ? f1 : inf;
  c.pw2 = cross2 ? f2 : inf;
  c.bA = __shfl_sync(dp::kFull, Bv, min(wlo + 1, 31));
  c.bB = __shfl_sync(dp::kFull, Bv, min(wlo + 2, 31));
  return c;
}

// rdiv = ceil(2^32 / R) for R >= 2, 0 for R = 1, so that n / R =
// __umulhi(n, rdiv) exactly for 0 <= n < 2^16 (the error n * (rdiv - 2^32 /
// R) / 2^32 < 2^-16 stays under 1/R >= 2^-14).
//
// The insertion start at each lane of the thread: prefix[k] for lane
// lane0+k, and at lane lane0-1 (pprev0; the caller makes its I), with lane
// lane0-1's U (uprev0), for a row whose budget is `budget` (block-uniform;
// rdiv its divisor, see above). Every thread of the block calls it, and it
// passes the block barrier once. s_S is the row's S row at lane 0, behind a
// guard of 32 K + 4 floats of BIG (one of two rows, by row parity, as are
// the slots: a thread writes row j+2's S row and slots only after barrier
// j+1, which no thread passes before it has read row j's).
//
// The segments are [s*R, s*R + R): a thread knows from its lane numbers
// alone whether another thread's lanes share a segment with its own, so the
// segmented scans across the warp are plain min-scans whose steps skip a
// neighbour in another segment. Lane x's window minimum is min(P[x], S[y])
// with y = x-R+1 and both global; S[y] spans y to the end e of y's
// segment, e <= x. Before the barrier each thread makes P and S warp-local
// and writes S to the row. After it, P[x] takes the carry cw (P at lane
// wlane0-1) where x's segment started before the own warp, i.e. x < pe, and
// S[y] the carry from the warps after y's up to e. For R <= 32 K, cw is the
// previous warp's fwd slot and the only S carry is the own warp's
// first-lane S, where y's segment reaches into the own warp: sw <= y <
// wlane0, sw the start of the segment of the warp's first lane. Wider
// windows take both from wide_carries. Window starts left of lane 0 read
// the guard's BIG, as the reference pads them.
template <int K>
__device__ __forceinline__ void forbid_prefix(const float (&cand)[K], float ulast, int budget,
                                              uint32_t rdiv, int M, int lane0, int t, int warp,
                                              int wl, int nwarps, int par, float* s_S,
                                              ForbidSlots& fs, float (&prefix)[K],
                                              float& uprev0, float& pprev0) {
  constexpr int W = 32 * K;  // lanes a warp
  constexpr int lgW = K == 4 ? 7 : K == 8 ? 8 : K == 16 ? 9 : 10;
  const float inf = CUDART_INF_F;
  const bool bounded = budget >= 1;  // block-uniform: no divergence below
  const int R = bounded ? min(budget, M) : 1;
  // n / R for 0 <= n < 2^16 (rdiv)
  auto divR = [&](int n) { return R == 1 ? n : (int)__umulhi((unsigned)n, rdiv); };
  const int wlane0 = lane0 - wl * K;  // the warp's first lane
  int sw = wlane0, pe = wlane0;
  int pl[K + 3];  // each lane's place in its segment (0: it starts one), lanes lane0-2 .. lane0+K
  float px[K + 1];  // warp-local P at lanes lane0-2 .. lane0+K-2, where the windows end
  float bown = inf;  // the own warp's first-lane S
  if (bounded) {
    sw = divR(wlane0) * R;
    pe = sw < wlane0 ? sw + R : wlane0;
    const int r0 = lane0 - divR(lane0) * R;
    bool head[K];
    pl[1] = r0 == 0 ? R - 1 : r0 - 1;
    pl[0] = pl[1] == 0 ? R - 1 : pl[1] - 1;
    int r = r0;
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      pl[k + 2] = r;
      if (k < K) head[k] = r == 0;
      if (++r == R) r = 0;
    }
    const int s_last = lane0 + K - 1 - pl[K + 1];  // start of lane lane0+K-1's segment
    const int e_first = lane0 - r0 + R - 1;        // end of lane lane0's
    float P[K], S[K];  // the segmented forward and backward minima
    float pr = cand[0];
    P[0] = pr;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      pr = head[k] ? cand[k] : fminf(pr, cand[k]);
      P[k] = pr;
    }
    float sr = cand[K - 1];
    S[K - 1] = sr;
#pragma unroll
    for (int k = K - 2; k >= 0; --k) {
      sr = head[k + 1] ? cand[k] : fminf(sr, cand[k]);
      S[k] = sr;
    }
    // inclusive scans over the warp's threads: fi the minimum over the
    // lanes up to this thread's last in that lane's segment, bi over the
    // lanes from this thread's first on in its segment. A segment touches
    // at most reach + 1 threads, and after the rounds below each scan
    // covers reach of them (the neighbour's scan below adds the last), so
    // the rounds stop there; a shuffle from past the warp's edge returns
    // the thread's own value, which changes nothing.
    const int reach = (R + K - 2) / K;
    float fi = P[K - 1], bi = S[0];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off >= reach) break;
      const float fo = __shfl_up_sync(dp::kFull, fi, off);
      const float bo = __shfl_down_sync(dp::kFull, bi, off);
      if (lane0 + K - 1 - off * K >= s_last) fi = fminf(fi, fo);
      if (lane0 + off * K <= e_first) bi = fminf(bi, bo);
    }
    // warp-local P and S: the carries from the warp's other threads
    const float fe = __shfl_up_sync(dp::kFull, fi, 1);
    const float be = __shfl_down_sync(dp::kFull, bi, 1);
    float c = head[0] || wl == 0 ? inf : fe;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (head[k]) c = inf;
      P[k] = fminf(P[k], c);
    }
    c = pl[K + 2] == 0 || wl == 31 ? inf : be;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      S[k] = fminf(S[k], c);
      if (head[k]) c = inf;
    }
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      *reinterpret_cast<float4*>(s_S + lane0 + k) =
          make_float4(S[k], S[k + 1], S[k + 2], S[k + 3]);
    }
    if (wl == 31) {
      fs.fwd[par][warp] = P[K - 1];
      fs.plast[par][warp] = P[K - 2];
    }
    if (wl == 0) fs.bwd[par][warp] = bi;
    bown = __shfl_sync(dp::kFull, bi, 0);
    px[0] = __shfl_up_sync(dp::kFull, P[K - 2], 1);
    px[1] = __shfl_up_sync(dp::kFull, P[K - 1], 1);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) px[k + 2] = P[k];
  }
  if (wl == 31) fs.ulast[par][warp] = ulast;
  const float ul = __shfl_up_sync(dp::kFull, ulast, 1);
  __syncthreads();
  uprev0 = t == 0 ? kBig : (wl > 0 ? ul : fs.ulast[par][warp - 1]);
  if (!bounded) {
#pragma unroll
    for (int k = 0; k < K; ++k) prefix[k] = kBig;
    pprev0 = kBig;
    return;
  }
  // window i ends at lane x = lane0-2+i and starts at y = yb+i; a warp's
  // first thread takes P at lanes lane0-2 and lane0-1 (the previous warp's)
  // whole from the slots, so its first two windows take no cw
  const int yb = lane0 - 1 - R;
  float win[K + 1];
  if (R <= W) {
    // every lane a window reads lies in its end's warp or the one before:
    // P at the previous warp's last lanes is warp-local there
    const float cw = warp > 0 ? fs.fwd[par][warp - 1] : inf;
    if (wl == 0) {
      px[0] = warp > 0 ? fs.plast[par][warp - 1] : inf;
      px[1] = cw;
    }
    const float* row = s_S + yb;  // at least -1 - W: in the guard
#pragma unroll
    for (int i = 0; i <= K; ++i) {
      const float s = (unsigned)(yb + i - sw) < (unsigned)(wlane0 - sw) ? fminf(row[i], bown)
                                                                         : row[i];
      const bool take = lane0 - 2 + i < pe && (i >= 2 || wl > 0);
      win[i] = fminf(s, take ? fminf(px[i], cw) : px[i]);
    }
  } else {
    const int wlo = max(yb, 0) >> lgW;  // the warp of the first window start
    const WideCarries c =
        wide_carries<K>(fs, par, R, rdiv, warp, wl, nwarps, wlo, pl[0] > W - 2);
    if (wl == 0) {
      px[0] = warp > 0 ? fminf(fs.plast[par][warp - 1], c.pw2) : inf;
      px[1] = c.cw;
    }
#pragma unroll
    for (int i = 0; i <= K; ++i) {
      const int x = lane0 - 2 + i, y = yb + i;
      const int wy = max(y, 0) >> lgW;
      // y's segment (ending at x - pl[i+1]) reaches past y's warp
      const bool need = y >= 0 && x - pl[i + 1] >= (wy + 1) * W;
      const float s = s_S[max(y, -1)];
      const float sc = need ? fminf(s, wy == wlo ? c.bA : c.bB) : s;
      const bool take = x < pe && (i >= 2 || wl > 0);
      win[i] = fminf(sc, take ? fminf(px[i], c.cw) : px[i]);
    }
  }
  pprev0 = win[0];
#pragma unroll
  for (int k = 0; k < K; ++k) prefix[k] = lane0 + k == 0 ? kBig : win[k + 1];
}

}  // namespace fw
