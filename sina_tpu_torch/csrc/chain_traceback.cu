// Chain traceback over the compact profile-DP backpointer plane.
//
// Replaces the device loop sina_tpu/ops/profile_pallas.py chain_traceback_log
// (a fori_loop, run under vmap by sina_tpu/ops/profile.py _profile_pallas_fn)
// together with the host scatter sina_tpu/ops/profile.py _unpack_log_result:
// the walk writes emit[b, i] = j, the profile column that consumed query base
// i, straight into a (B, M) int32 array (-1 = base not consumed). The
// step-indexed log existed only because a per-lane scatter was slow on the
// TPU.
//
// What bounds it: latency. Each query's walk is a chain of dependent steps,
// up to C + 2M + 8 of them (about 3,900 in the longest of the main path's
// walks at C=2048, M=1536), each reading one byte of a C*B*M plane (403 MB
// at B=128) and doing a few integer operations; the bytes (one a step) are no
// limit. Read straight from device memory, a step would cost an L2 or HBM
// round trip (moving to the previous column jumps B*M bytes): the window
// below keeps the walk in shared memory, where a step costs its chain of
// dependent instructions on the one walking thread, and the window copies
// add the rest. chip_smoke.py phase 3 times the kernel warm (launched again
// and again on one plane, so the path sits in L2) and cold (L2 flushed
// before each launch): the main path's walk follows the DP, whose plane has
// passed through L2, so it finds most of its path cold. Only the window
// copies read device memory, so the two times agree.
//
// Design: one block per query, so all walks run at once on separate SMs. The
// block fills its emit row with -1 (coalesced), then stages a window of its
// plane in shared memory: kTJ columns x kTI query positions whose far corner
// is the current cell (the walk never moves to a higher column or position),
// each column's positions copied with 16-byte cp.async where the plane's
// columns are 16-byte aligned (M % 16 == 0), 4-byte where 4-byte aligned,
// else byte by byte. One thread walks the state machine (resolve, chain,
// decide, insertion, done) on the window (see walk) until the next cell lies
// outside it; the block then stages the window at that cell and the walk
// goes on. It stops at DONE or after C + 2M + 8 steps: the reference's
// remaining loop steps are idle. Reads clamp indices the way a JAX gather
// does; the state keeps the unclamped (j, i).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "traceback_window.cuh"

namespace {

constexpr int kResolve = 0;
constexpr int kChain = 1;     // deletion chain, then resolve
constexpr int kDecide = 2;
constexpr int kIns = 3;
constexpr int kChainNe = 5;   // deletion chain, then decide
constexpr int kDone = 6;
constexpr int kCodeEdge = 0;
constexpr int kCodeMatch = 1;
constexpr int kCodeDel = 2;
constexpr int kCodeIns = 3;
constexpr int kThreads = 256;
// the window: kTJ columns x kTI query positions (48 KB); the main path's
// walk moves ~1.4 columns a base, so both edges last ~180 bases
constexpr int kTJ = 256;
constexpr int kTI = 192;
constexpr int kWindowBytes = kTJ * kTI;

struct Walk {
  int j, i, state;
  int rem;  // steps left before the cap
};

// One step of the state machine on `cell`, the cell at (j, i) (clamped):
// the reference's rules for any state, position and edge.
__device__ __forceinline__ void step(int cell, int& j, int& i, int& state, int M, int32_t* row) {
  const int code = cell & 3;
  const bool at_edge = (i == 0) || (j == 0);
  int ei = -1;
  const int ej = j;
  if (state == kResolve || state == 4) {
    const bool is_del = code == kCodeDel && !at_edge;
    state = is_del ? kChain : kDecide;
    ei = is_del ? -1 : i;
  } else if (state == kChain || state == kChainNe) {
    const int pj = max(j - 1, 0);
    if (((cell >> 2) & 1) || pj == 0) state = state == kChain ? kResolve : kDecide;
    j = pj;
  } else if (state == kDecide) {
    const bool done = at_edge || code == kCodeEdge;
    const bool is_m = code == kCodeMatch;
    if (is_m && !done) {
      j -= 1;
      i -= 1;
    }
    state = done ? kDone : (is_m ? kResolve : (code == kCodeIns ? kIns : kChainNe));
  } else if (state == kIns) {
    const int ni = i - 1;
    const bool done = ni < 0;
    i = max(ni, 0);
    state = done ? kDone : (((cell >> 3) & 1) ? kDecide : kIns);
    ei = done ? -1 : i;
  } else {
    state = kDone;
  }
  if (ei >= 0 && ei < M) row[ei] = ej;
}

// Walks from w on the window (columns [j0, j0 + ncols) x positions
// [i0, i0 + nrows), column c at win + c * kTI) until DONE, the step cap or
// a cell outside the window; returns the state there. Where no read clamps
// and no edge test can fire (0 < j < C, 0 < i < M, kept so by every move
// inside the window), tight loops take the three runs that make up nearly
// all of a walk, each reading the next cell by a pointer step and keeping it
// in a register while (j, i) stays put: matched bases on the diagonal
// (RESOLVE then DECIDE on one cell, two steps a base), deletion chains (a
// column a step) and insertion runs (a position a step). Elsewhere, and at
// each run's end, one general step follows the reference's rules.
__device__ __forceinline__ Walk walk(const uint8_t* win, Walk w, int j0, int i0, int ncols,
                                     int nrows, int C, int M, int32_t* row) {
  int j = w.j, i = w.i, state = w.state, rem = w.rem;
  while (rem > 0 && state != kDone) {
    int wj = min(max(j, 0), C - 1) - j0;
    int wi = min(max(i, 0), M - 1) - i0;
    if ((unsigned)wj >= (unsigned)ncols || (unsigned)wi >= (unsigned)nrows) break;
    const uint8_t* p = win + wj * kTI + wi;
    int cell = *p;
    if (j >= 1 && j < C && i >= 1 && i < M) {
      for (;;) {
        const int code = cell & 3;
        if (state == kResolve) {
          if (code == kCodeMatch) {
            if (wj < 2 || wi < 2 || rem < 2) break;
            do {
              row[i] = j;
              --j, --i, --wj, --wi;
              rem -= 2;
              p -= kTI + 1;
              cell = *p;
            } while ((cell & 3) == kCodeMatch && wj >= 2 && wi >= 2 && rem >= 2);
          } else {
            if (rem < 1) break;
            if (code != kCodeDel) row[i] = j;
            state = code == kCodeDel ? kChain : kDecide;
            --rem;
          }
        } else if (state == kChain || state == kChainNe) {
          if (wj < 2 || rem < 1) break;
          bool stop;  // (column 0 lies beyond j - 1 here)
          do {
            stop = (cell >> 2) & 1;
            --j, --wj, --rem;
            p -= kTI;
            cell = *p;
          } while (!stop && wj >= 2 && rem >= 1);
          if (stop) state = state == kChain ? kResolve : kDecide;
        } else if (state == kDecide) {
          if (code == kCodeEdge || rem < 1) break;
          if (code == kCodeMatch) {
            if (wj < 2 || wi < 2) break;
            --j, --i, --wj, --wi;
            p -= kTI + 1;
            cell = *p;
            state = kResolve;
          } else {
            state = code == kCodeIns ? kIns : kChainNe;
          }
          --rem;
        } else if (state == kIns) {
          if (wi < 2 || rem < 1) break;
          bool open;
          do {
            open = (cell >> 3) & 1;
            --i, --wi, --rem;
            row[i] = j;
            p -= 1;
            cell = *p;
          } while (!open && wi >= 2 && rem >= 1);
          if (open) state = kDecide;
        } else {
          break;
        }
      }
      // the loop leaves (j, i), the state and the cell consistent
      if (rem == 0) break;
    }
    step(cell, j, i, state, M, row);
    --rem;
  }
  return Walk{j, i, state, rem};
}

template <int V>
__global__ void __launch_bounds__(kThreads)
chain_traceback_kernel(const uint8_t* __restrict__ bp, const int32_t* __restrict__ best_c,
                       const int32_t* __restrict__ best_i, int32_t* __restrict__ emit, int B,
                       int C, int M) {
  extern __shared__ __align__(16) uint8_t win[];
  __shared__ Walk s_walk;
  const int b = blockIdx.x;
  int32_t* row = emit + (long long)b * M;
  for (int i = threadIdx.x; i < M; i += kThreads) row[i] = -1;
  if (threadIdx.x == 0) s_walk = Walk{best_c[b], best_i[b], kResolve, C + 2 * M + 8};
  __syncthreads();

  const long long cstride = (long long)B * M;  // column j at plane + j * cstride
  const uint8_t* plane = bp + (long long)b * M;
  for (;;) {
    // every thread reads the walk's state after the barrier, so all take
    // the same branch here and meet at the same barriers below
    const Walk w = s_walk;
    if (w.state == kDone || w.rem == 0) break;
    const int jj = min(max(w.j, 0), C - 1);
    const int ii = min(max(w.i, 0), M - 1);
    const int j0 = max(jj - kTJ + 1, 0);
    const int i0 = sina_tb::first_row(ii, kTI);
    const int ncols = jj - j0 + 1;
    const int nrows = min(i0 + kTI, M) - i0;
    sina_tb::stage<uint8_t, V, kThreads>(win, kTI, plane + j0 * cstride + i0, cstride, ncols,
                                         nrows);
    __syncthreads();
    if (threadIdx.x == 0) s_walk = walk(win, w, j0, i0, ncols, nrows, C, M, row);
    __syncthreads();
  }
}

const void* kernel_for(int v) {
  switch (v) {
    case 16: return reinterpret_cast<const void*>(&chain_traceback_kernel<16>);
    case 4: return reinterpret_cast<const void*>(&chain_traceback_kernel<4>);
    default: return reinterpret_cast<const void*>(&chain_traceback_kernel<1>);
  }
}

}  // namespace

// The launch plan for a plane at bp with M query positions: out[0..6] =
// threads, window columns, window query positions, bytes a window copy
// moves at once, dynamic and static shared memory bytes a block, registers
// a thread. Returns a cudaError_t.
extern "C" int sina_chain_traceback_plan(const void* bp, int M, long long* out) {
  const int v = sina_tb::copy_elems(bp, M, 1);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_for(v));
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = kTJ;
  out[2] = kTI;
  out[3] = v;
  out[4] = kWindowBytes;
  out[5] = (long long)attr.sharedSizeBytes;
  out[6] = attr.numRegs;
  return 0;
}

// bp (C, B, M) uint8; best_c, best_i (B,) int32; emit (B, M) int32.
// Returns cudaGetLastError() (cudaErrorInvalidValue for C < 1 or a step cap
// C + 2M + 8 past INT_MAX).
extern "C" int sina_chain_traceback(const void* bp, const void* best_c, const void* best_i,
                                    void* emit, int B, int C, int M, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (C < 1 || (long long)C + 2LL * M + 8 > INT_MAX) return (int)cudaErrorInvalidValue;
  const uint8_t* bp_p = static_cast<const uint8_t*>(bp);
  const int32_t* bc_p = static_cast<const int32_t*>(best_c);
  const int32_t* bi_p = static_cast<const int32_t*>(best_i);
  int32_t* emit_p = static_cast<int32_t*>(emit);
  void* args[] = {&bp_p, &bc_p, &bi_p, &emit_p, &B, &C, &M};
  const void* fn = kernel_for(sina_tb::copy_elems(bp, M, 1));
  // the window and the static walk state pass the 48 KB a block gets
  // without opting in
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kWindowBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel(fn, dim3(B), dim3(kThreads), args, (size_t)kWindowBytes,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
