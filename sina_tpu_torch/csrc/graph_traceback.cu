// Distance-coded graph traceback over the graph DP's backpointer plane.
//
// Replaces the device loop sina_tpu/ops/graph_pallas.py traceback_device_dist
// (a while_loop run under vmap by graph_dp_pallas_packed). From the best cell
// (best_j, best_i) it walks the seven-state machine RESOLVE / CHAIN / DECIDE /
// INS / RESOLVE_NE / CHAIN_NE / DONE of graph_pallas.py:338-414 and writes
// emit[b, i] = j, the graph node that consumed query base i (-1 = none),
// straight into a (B, M) int32 array. Predecessors are j - distance, clamped
// at 0 (graph_pallas.py:371-372, 383-384).
//
// What bounds it: latency. Each query's walk is a chain of dependent steps,
// up to N + 2M + 8 of them (about 3,100 in the longest of the main path's
// walks at N=4096, M=1536), each reading one two-byte cell of its (N, M)
// plane (12.6 MB) and the start flag of a node, with a few integer
// operations; the bytes are no limit. Read straight from device memory, a
// step would cost one or two L2 or HBM round trips (a node is 2M bytes from
// the next, the walk jumps back by up to 31 nodes, and the flag is a second
// dependent load): the window below keeps the walk in shared memory, where a
// step costs its chain of dependent instructions on the one walking thread,
// and the window copies add the rest. chip_smoke.py phase 3
// times the kernel warm (launched again and again on one plane, so the path
// sits in L2) and cold (L2 flushed before each launch): the main path's walk
// follows the DP, whose 1.6 GB plane has passed through L2, so it finds most
// of its path cold. Only the window copies read device memory, so the two
// times agree.
//
// Design: one block per query, so all walks run at once on separate SMs. The
// block fills its emit row with -1 (coalesced), then stages a window of its
// plane in shared memory: kTJ nodes x kTI query positions whose far corner is
// the current cell (the walk never moves to a higher node or position), each
// node's positions copied with 16-byte cp.async where the nodes are 16-byte
// aligned (M % 8 == 0), 4-byte where 4-byte aligned (M even), else one cell
// at a time; beside it the window's nodes' start flags. One thread walks the
// state machine on the window (see walk) until the next cell, or a deletion
// step's target node, lies outside it: a jump of up to 31 nodes is tested at
// its target. The block then stages the window at the current cell and the
// walk goes on. It stops at DONE; done[b] records whether it got there
// within N + 2M + 8 steps (the wrapper raises otherwise). Reads clamp indices
// the way a JAX gather does; the state keeps the unclamped (j, i).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "traceback_window.cuh"

namespace {

constexpr int kResolve = 0;
constexpr int kChain = 1;  // deletion chain, then resolve
constexpr int kDecide = 2;
constexpr int kIns = 3;
constexpr int kResolveNe = 4;  // resolve without emitting
constexpr int kChainNe = 5;    // deletion chain, then resolve without emitting
constexpr int kDone = 6;
constexpr int kCodeEdge = 0;
constexpr int kCodeMatch = 1;
constexpr int kCodeDel = 2;
constexpr int kCodeIns = 3;
constexpr int kThreads = 256;
// the window: kTJ nodes x kTI query positions of int16 (80 KB); the main
// path's walk moves ~1.7 nodes a base, so both edges last ~150 bases
constexpr int kTJ = 256;
constexpr int kTI = 160;
constexpr int kWindowBytes = kTJ * kTI * (int)sizeof(int16_t);

struct Walk {
  int j, i, state;
  int rem;  // steps left before the cap
};

// Walks from w on the window (nodes [j0, j0 + ncols) x positions
// [i0, i0 + nrows), node c at win + c * kTI, its start flag at fwin[c])
// until DONE, the step cap or a cell outside the window; returns the state
// there. Where no read clamps and no edge test but the start flag can fire
// (0 <= j < N, 0 < i < M, kept so by every move inside the window), tight
// loops take the three runs that make up nearly all of a walk, keeping the
// cell and its node's flag in registers while (j, i) stays put: matched
// bases (RESOLVE then DECIDE on one cell, two steps a base, back by the match
// distance), deletion chains (back by the deletion distance a step) and
// insertion runs (a position a step). Elsewhere, and at each run's end, one
// general step follows the reference's rules.
__device__ __forceinline__ Walk walk(const int16_t* win, const uint8_t* fwin, Walk w, int j0,
                                     int i0, int ncols, int nrows, int N, int M,
                                     int32_t* row) {
  int j = w.j, i = w.i, state = w.state, rem = w.rem;
  while (rem > 0 && state != kDone) {
    int wj = min(max(j, 0), N - 1) - j0;
    int wi = min(max(i, 0), M - 1) - i0;
    if ((unsigned)wj >= (unsigned)ncols || (unsigned)wi >= (unsigned)nrows) break;
    int cell = win[wj * kTI + wi];
    bool start = fwin[wj];
    if (j >= 0 && j < N && i >= 1 && i < M) {
      for (;;) {
        const int code = cell & 3;
        if (state == kResolve || state == kResolveNe) {
          if (code == kCodeMatch && !start) {
            int md = (cell >> 2) & 0x1F;
            if (wj < md || wi < 2 || rem < 2) break;
            if (state == kResolve) row[i] = j;
            for (;;) {
              j -= md, wj -= md, --i, --wi;
              rem -= 2;
              cell = win[wj * kTI + wi];
              start = fwin[wj];
              md = (cell >> 2) & 0x1F;
              if ((cell & 3) != kCodeMatch || start || wj < md || wi < 2 || rem < 2) break;
              row[i] = j;
            }
            state = kResolve;
          } else {
            if (rem < 1) break;
            const bool is_del = code == kCodeDel && !start;
            if (state == kResolve && !is_del) row[i] = j;
            state = is_del ? (state == kResolve ? kChain : kChainNe) : kDecide;
            --rem;
          }
        } else if (state == kChain || state == kChainNe) {
          int dd = (cell >> 7) & 0x1F;
          if (wj < dd || rem < 1) break;
          bool stop;
          do {
            stop = (cell >> 12) & 1;
            j -= dd, wj -= dd, --rem;
            cell = win[wj * kTI + wi];
            start = fwin[wj];
            stop = stop || start;
            dd = (cell >> 7) & 0x1F;
          } while (!stop && wj >= dd && rem >= 1);
          if (stop) state = state == kChain ? kResolve : kResolveNe;
        } else if (state == kDecide) {
          if (start || code == kCodeEdge || rem < 1) break;
          if (code == kCodeMatch) {
            const int md = (cell >> 2) & 0x1F;
            if (wj < md || wi < 2) break;
            j -= md, wj -= md, --i, --wi;
            cell = win[wj * kTI + wi];
            start = fwin[wj];
            state = kResolve;
          } else {
            state = code == kCodeIns ? kIns : kChainNe;
          }
          --rem;
        } else if (state == kIns) {
          if (wi < 2 || rem < 1) break;
          bool open;
          do {
            open = (cell >> 13) & 1;
            --i, --wi, --rem;
            row[i] = j;
            cell = win[wj * kTI + wi];
          } while (!open && wi >= 2 && rem >= 1);
          if (open) state = kDecide;
        } else {
          break;
        }
      }
      // the loop leaves (j, i), the state, the cell and its flag consistent
      if (rem == 0) break;
    }
    const int code = cell & 3;
    const bool at_edge = (i == 0) || start;
    if (state == kResolve || state == kResolveNe) {
      const bool is_del = code == kCodeDel && !at_edge;
      if (state == kResolve && !is_del && i >= 0 && i < M) row[i] = j;
      state = is_del ? (state == kResolve ? kChain : kChainNe) : kDecide;
    } else if (state == kChain || state == kChainNe) {
      const int ddist = (cell >> 7) & 0x1F;
      const int pj = max(ddist > 0 ? j - ddist : j, 0);
      // the target's flag decides the stop: outside the window, stage the
      // window here and take the step again there
      const int wp = min(pj, N - 1) - j0;
      if ((unsigned)wp >= (unsigned)ncols) break;
      if (((cell >> 12) & 1) || fwin[wp]) state = state == kChain ? kResolve : kResolveNe;
      j = pj;
    } else if (state == kDecide) {
      const bool fin = at_edge || code == kCodeEdge;
      const bool is_m = code == kCodeMatch;
      if (is_m && !fin) {
        const int mdist = (cell >> 2) & 0x1F;
        j = max(mdist > 0 ? j - mdist : j, 0);
        i -= 1;
      }
      state = fin ? kDone : (is_m ? kResolve : (code == kCodeIns ? kIns : kChainNe));
    } else if (state == kIns) {
      const int ni = i - 1;
      if (ni < 0) {
        state = kDone;
      } else {
        i = ni;
        if (i < M) row[i] = j;
        state = (cell >> 13) & 1 ? kDecide : kIns;
      }
    } else {
      state = kDone;
    }
    --rem;
  }
  return Walk{j, i, state, rem};
}

template <int V>
__global__ void __launch_bounds__(kThreads)
graph_traceback_kernel(const int16_t* __restrict__ bp, const int32_t* __restrict__ best_j,
                       const int32_t* __restrict__ best_i, const uint8_t* __restrict__ flags,
                       int32_t* __restrict__ emit, int32_t* __restrict__ done, int N, int M) {
  extern __shared__ __align__(16) int16_t win[];
  __shared__ uint8_t fwin[kTJ];
  __shared__ Walk s_walk;
  const int b = blockIdx.x;
  int32_t* row = emit + (long long)b * M;
  for (int i = threadIdx.x; i < M; i += kThreads) row[i] = -1;
  if (threadIdx.x == 0) s_walk = Walk{best_j[b], best_i[b], kResolve, N + 2 * M + 8};
  __syncthreads();

  const int16_t* plane = bp + (long long)b * N * M;  // node j at plane + j * M
  const uint8_t* fl = flags + (long long)b * N;
  for (;;) {
    // every thread reads the walk's state after the barrier, so all take
    // the same branch here and meet at the same barriers below
    const Walk w = s_walk;
    if (w.state == kDone || w.rem == 0) break;
    const int jj = min(max(w.j, 0), N - 1);
    const int ii = min(max(w.i, 0), M - 1);
    const int j0 = max(jj - kTJ + 1, 0);
    const int i0 = sina_tb::first_row(ii, kTI);
    const int ncols = jj - j0 + 1;
    const int nrows = min(i0 + kTI, M) - i0;
    for (int c = threadIdx.x; c < ncols; c += kThreads) fwin[c] = fl[j0 + c] & 1;
    sina_tb::stage<int16_t, V, kThreads>(win, kTI, plane + (long long)j0 * M + i0, M, ncols,
                                         nrows);
    __syncthreads();
    if (threadIdx.x == 0) s_walk = walk(win, fwin, w, j0, i0, ncols, nrows, N, M, row);
    __syncthreads();
  }
  if (threadIdx.x == 0) done[b] = s_walk.state == kDone ? 1 : 0;
}

const void* kernel_for(int v) {
  switch (v) {
    case 8: return reinterpret_cast<const void*>(&graph_traceback_kernel<8>);
    case 2: return reinterpret_cast<const void*>(&graph_traceback_kernel<2>);
    default: return reinterpret_cast<const void*>(&graph_traceback_kernel<1>);
  }
}

}  // namespace

// The launch plan for a plane at bp with M query positions: out[0..6] =
// threads, window nodes, window query positions, bytes a window copy moves
// at once, dynamic and static shared memory bytes a block, registers a
// thread. Returns a cudaError_t.
extern "C" int sina_graph_traceback_plan(const void* bp, int M, long long* out) {
  const int v = sina_tb::copy_elems(bp, M, 2);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_for(v));
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = kTJ;
  out[2] = kTI;
  out[3] = v * (long long)sizeof(int16_t);
  out[4] = kWindowBytes;
  out[5] = (long long)attr.sharedSizeBytes;
  out[6] = attr.numRegs;
  return 0;
}

// bp (B, N, M) int16; best_j, best_i (B,) int32; flags (B, N) uint8 (bit 0 =
// start node); emit (B, M) int32; done (B,) int32. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a step cap N + 2M + 8 past INT_MAX).
extern "C" int sina_graph_traceback(const void* bp, const void* best_j, const void* best_i,
                                    const void* flags, void* emit, void* done, int B, int N,
                                    int M, void* stream) {
  if (B == 0 || M == 0 || N == 0) return 0;
  if ((long long)N + 2LL * M + 8 > INT_MAX) return (int)cudaErrorInvalidValue;
  const int16_t* bp_p = static_cast<const int16_t*>(bp);
  const int32_t* bj_p = static_cast<const int32_t*>(best_j);
  const int32_t* bi_p = static_cast<const int32_t*>(best_i);
  const uint8_t* fl_p = static_cast<const uint8_t*>(flags);
  int32_t* emit_p = static_cast<int32_t*>(emit);
  int32_t* done_p = static_cast<int32_t*>(done);
  void* args[] = {&bp_p, &bj_p, &bi_p, &fl_p, &emit_p, &done_p, &N, &M};
  const void* fn = kernel_for(sina_tb::copy_elems(bp, M, 2));
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kWindowBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel(fn, dim3(B), dim3(kThreads), args, (size_t)kWindowBytes,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
