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
// What bounds it: latency. Each query's walk is a chain of dependent two-byte
// loads from its (N, M) plane (12.6 MB at N=4096, M=1536), up to N + 2M + 8
// steps with a few integer operations each.
//
// Design: one block per query, so all walks run at once on separate SMs. The
// block fills its emit row with -1 (coalesced), then one thread walks the
// state machine and stops at DONE; done[b] records whether it got there
// within N + 2M + 8 steps (the wrapper raises otherwise). Reads clamp indices
// the way a JAX gather does.

#include <cstdint>
#include <cuda_runtime.h>

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
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
graph_traceback_kernel(const int16_t* __restrict__ bp, const int32_t* __restrict__ best_j,
                       const int32_t* __restrict__ best_i, const uint8_t* __restrict__ flags,
                       int32_t* __restrict__ emit, int32_t* __restrict__ done, int N, int M) {
  const int b = blockIdx.x;
  int32_t* row = emit + (long long)b * M;
  for (int i = threadIdx.x; i < M; i += kThreads) row[i] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int16_t* plane = bp + (long long)b * N * M;
  const uint8_t* fl = flags + (long long)b * N;
  int j = best_j[b];
  int i = best_i[b];
  int state = kResolve;
  const long long steps = (long long)N + 2LL * M + 8;
  for (long long step = 0; step < steps && state != kDone; ++step) {
    const int jj = min(max(j, 0), N - 1);
    const int ii = min(max(i, 0), M - 1);
    const int cell = plane[(long long)jj * M + ii];
    const int code = cell & 3;
    const int mdist = (cell >> 2) & 0x1F;
    const int ddist = (cell >> 7) & 0x1F;
    const bool dopen = (cell >> 12) & 1;
    const bool iopen = (cell >> 13) & 1;
    const bool at_edge = (i == 0) || (fl[jj] & 1);
    switch (state) {
      case kResolve:
      case kResolveNe: {
        const bool is_del = code == kCodeDel && !at_edge;
        if (state == kResolve && !is_del && i >= 0 && i < M) row[i] = j;
        state = is_del ? (state == kResolve ? kChain : kChainNe) : kDecide;
        break;
      }
      case kChain:
      case kChainNe: {
        const int pj = max(ddist > 0 ? j - ddist : j, 0);
        const bool stop = dopen || (fl[min(pj, N - 1)] & 1);
        if (stop) state = state == kChain ? kResolve : kResolveNe;
        j = pj;
        break;
      }
      case kDecide: {
        const bool fin = at_edge || code == kCodeEdge;
        const bool is_m = code == kCodeMatch;
        if (is_m && !fin) {
          j = max(mdist > 0 ? j - mdist : j, 0);
          i -= 1;
        }
        state = fin ? kDone : (is_m ? kResolve : (code == kCodeIns ? kIns : kChainNe));
        break;
      }
      case kIns: {
        const int ni = i - 1;
        if (ni < 0) {
          state = kDone;
        } else {
          i = ni;
          if (i < M) row[i] = j;
          state = iopen ? kDecide : kIns;
        }
        break;
      }
      default:
        state = kDone;
        break;
    }
  }
  done[b] = state == kDone ? 1 : 0;
}

}  // namespace

// bp (B, N, M) int16; best_j, best_i (B,) int32; flags (B, N) uint8 (bit 0 =
// start node); emit (B, M) int32; done (B,) int32. Returns cudaGetLastError().
extern "C" int sina_graph_traceback(const void* bp, const void* best_j, const void* best_i,
                                    const void* flags, void* emit, void* done, int B, int N,
                                    int M, void* stream) {
  if (B == 0 || M == 0 || N == 0) return 0;
  graph_traceback_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(bp), static_cast<const int32_t*>(best_j),
      static_cast<const int32_t*>(best_i), static_cast<const uint8_t*>(flags),
      static_cast<int32_t*>(emit), static_cast<int32_t*>(done), N, M);
  return (int)cudaGetLastError();
}
