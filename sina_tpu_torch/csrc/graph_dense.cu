// The graph engine's dense-predecessor route: the POA graph DP over every
// predecessor slot of a node, and its traceback, one block per query.
//
// Replaces sina_tpu/ops/align_kernel.py poa_dp_costs (the XLA fori_loop over
// nodes that poa_dp_batch(window=None) and poa_dp_subst_batch run, with the
// cost set-ups poa_dp, poa_dp_forbid and poa_dp_subst and, for --insertion
// forbid, _windowed_min) and traceback_device (the seven-state while_loop
// walk). The reference sends a graph bucket there when its largest
// predecessor distance is 32 or more (sina_tpu/align.py:1051), which
// graph_dp.cu's 5-bit distance fields cannot hold. Same function as the
// plain versions ops/align_kernel.py poa_dp_dense and traceback_dense, bit
// for bit.
//
// Backpointers are slot-coded uint16 cells (as int16), (B, N, M): bits 0-1
// code (0 edge, 1 match, 2 deletion, 3 insertion), 2-4 match predecessor
// slot, 5-7 deletion predecessor slot, 8 deletion opened, 9 insertion opened.
//
// What bounds the DP: the recurrence over nodes is sequential, one block per
// query, and a node's work per query position (~24 operations, plus ~11 for
// each predecessor slot probed) is bound by its instruction count and its
// latency chain on one SM; the bytes are the 2-byte backpointer plane, written
// once (1.6 GB at B = 128, N = 4096, M = 1536). The design keeps the node loop
// off barriers other than the one scan barrier a node:
//
// - The V and D rows of the last K nodes (K = the bucket's largest
//   predecessor distance + 1, given by the caller, so 33 or more; a
//   predecessor K or more nodes back fails a device-side assert, which
//   the next synchronising call raises) live in a per-query ring in global
//   memory (L2-resident for the recent rows; shared
//   memory holds 16 rows at most at M = 1536): node j's row sits in slot
//   (j + 1) mod K, and a predecessor p < j is read from slot (p + 1) mod K.
//   A slot of -1 or of a node not yet computed (p >= j) reads no row and
//   stands for BIG, as the plain version's virtual row 0 and its unwritten
//   rows do.
// - Each thread owns L consecutive query positions and reads and writes ring
//   rows only at its own lanes, so the ring needs no barrier. The one value a
//   lane needs from its left neighbour's predecessor rows, V at lane i0-1, is
//   recomputed by the thread from the scan results and kept in its own ring
//   column (as in graph_dp.cu).
// - The slot probe keeps the first minimum (strict <, slots ascending), as
//   the plain version's argmins do. Every V and D value is at most BIG, so a
//   slot that reads no row (BIG) can only tie with a real one: after the
//   first real slot it cannot win and is skipped; before it, it is probed
//   with BIG (a node with no predecessors records slot 0).
// - The insertion prefix-min is a running min in the thread plus the
//   two-level block scan of dp_scan.cuh: one barrier a node. The bounded one
//   (forbid) is a sparse table in shared memory (log2 R doubling rounds, R
//   block-uniform per node), one barrier a round.
// - The substitution factor is a function of the node's and the query
//   position's IUPAC masks: a 16 x 16 table in shared memory, built once per
//   block in the reference's f32 operations. The per-node costs arrive in one
//   64-byte record (with the node's eight predecessor slots), loaded a node
//   ahead.
//
// Rounding: the insertion candidate and Irow are multiply-adds rounded once,
// as the reference's compiled core contracts them to FMA: a double fma of an
// exact f32 product, rounded to f32, the value the plain version's _fma
// computes. The match cost is a separately rounded product plus an add (the
// reference precomputes it). All other f32 arithmetic keeps the plain
// version's order through explicit round-to-nearest intrinsics (the library
// is built with --fmad=false).
//
// What bounds the traceback: latency. One thread walks each query (one block
// a query, the rest of the block fills the emit row with -1), up to N + 2M + 8
// dependent steps, each reading a two-byte cell, a start flag and, on a move,
// a predecessor slot from device memory.

#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dp_scan.cuh"

namespace {

constexpr float kBig = 1e6f;
constexpr int kCodeEdge = 0;
constexpr int kCodeMatch = 1;
constexpr int kCodeDel = 2;
constexpr int kCodeIns = 3;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSlots = 8;  // predecessor slots a node record holds
// query positions a thread owns at the main path's widths (M <= 2048), as
// graph_dp.cu
constexpr int kDefaultLanes = 4;
constexpr int kTbThreads = 128;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
// a * b + c rounded to f32 once, a * b exact in double
__device__ __forceinline__ float fma_d(double a, double b, float c) {
  return __double2float_rn(__fma_rn(a, b, (double)c));
}

struct DenseArgs {
  const int4* table;     // (B, N, 4) int4 = per-node record, see ops/align_kernel.py
  const uint8_t* qmask;  // (B, M)
  const int32_t* qlen;   // (B,)
  const float* smat;     // (B, 16)
  int16_t* bp;           // (B, N, M)
  float* best;           // (B, 8)
  float* ring;           // (B, K, stride)
  int N, M, Mp, K, stride;
  int aspace, matrix;
  float match, mismatch;
};

// (v, j, lane) lexicographic "less"
__device__ __forceinline__ bool lex_less(float v, int j, int i, float bv, int bj, int bi) {
  return v < bv || (v == bv && (j < bj || (j == bj && i < bi)));
}

// L packed int16 cells -> one 2L-byte store
template <int L>
__device__ __forceinline__ void store_cells(int16_t* dst, const uint32_t (&w)[L / 2]) {
  if constexpr (L == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < L / 2; k += 4) {
      *reinterpret_cast<uint4*>(dst + 2 * k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads) graph_dense_kernel(DenseArgs a) {
  extern __shared__ float s_tab[];  // forbid's sparse table: two rows of Mp
  __shared__ float s_sfac[256];     // substitution factor by (node mask, query mask)
  __shared__ dp::ScanSlots s_scan;
  __shared__ float s_rv[kMaxWarps];
  __shared__ int s_rj[kMaxWarps];
  __shared__ int s_ri[kMaxWarps];
  __shared__ float s_c1v;
  __shared__ int s_c1j;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = t >> 5;
  const int wl = t & 31;
  const int nwarps = nthreads >> 5;
  const int i0 = t * L;
  const int M = a.M, Mp = a.Mp, K = a.K, N = a.N, stride = a.stride;
  const int ql = a.qlen[b];
  const int q1 = ql - 1;
  float* ring = a.ring + (long long)b * K * stride;
  const int4* tab = a.table + (long long)b * N * 4;
  int16_t* bpb = a.bp + (long long)b * N * M;
  const bool vec_store = (M % L == 0) && i0 + L <= M;

  // the substitution factor for each pair of IUPAC masks: the scheme's
  // match/mismatch value, or with the matrix scheme the mean of S[l, r] over
  // the letter pairs (poa_dp_subst), in the plain version's f32 order
  for (int e = t; e < 256; e += nthreads) {
    const int nm = e >> 4, q = e & 15;
    float v;
    if (a.matrix) {
      const float* S = a.smat + (long long)b * 16;
      float pq = 0.0f, pn = 0.0f, numer = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) pq = add(pq, (float)((q >> r) & 1));
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float sql = 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) sql = add(sql, mul(S[4 * l + r], (float)((q >> r) & 1)));
        const float bl = (float)((nm >> l) & 1);
        numer = add(numer, mul(bl, sql));
        pn = add(pn, bl);
      }
      v = __fdiv_rn(numer, fmaxf(mul(pn, pq), 1.0f));
    } else {
      v = (nm & q) ? a.match : a.mismatch;
    }
    s_sfac[e] = v;
  }

  int qoff[L];  // the query mask at each lane: its column in s_sfac
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = i0 + k;
    qoff[k] = i < M ? a.qmask[(long long)b * M + i] & 15 : 0;
  }
  if (t == 0) {
    s_c1v = kBig;
    s_c1j = 0;
  }
  __syncthreads();  // s_sfac

  float c1v = kBig;  // candidate 1: the owner of lane ql-1
  int c1j = 0;
  float c2v[L];  // candidate 2: per lane, end nodes
  int c2j[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    c2v[k] = kBig;
    c2j[k] = 0;
  }

  int4 n0 = tab[0], n1 = tab[1], n2 = tab[2], n3 = tab[3];  // node 0's record
  int cur = 1 % K;   // the slot of row j + 1 (node j)
  int parity = 0;    // nodes mod 2: the scan's buffer
  for (int j = 0; j < N; ++j) {
    const int4 r0 = n0, r1 = n1, r2 = n2, r3 = n3;
    if (j + 1 < N) {
      const int4* nx = tab + 4LL * (j + 1);
      n0 = nx[0];
      n1 = nx[1];
      n2 = nx[2];
      n3 = nx[3];
    }
    const float subw = __int_as_float(r0.x);
    const float dgo = __int_as_float(r0.y);
    const float dge = __int_as_float(r0.z);
    const float gio = __int_as_float(r0.w);
    const float gie = __int_as_float(r1.x);
    const double gie_d = (double)gie;
    const int nmask = r1.y & 0xF;
    const int flags = (r1.y >> 8) & 0xFF;
    const int budget = r1.z;
    const bool startb = flags & 1;
    const bool endb = flags & 2;
    const bool validb = flags & 4;
    const int preds[kSlots] = {r2.x, r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w};
    const float* sfrow = s_sfac + 16 * nmask;

    // the slot probe: first minimum over the slots (strict <), a slot that
    // reads no row standing for BIG
    float vmin[L], dmin[L];
    int ms[L], ds[L];
    bool dop[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      vmin[k] = CUDART_INF_F;
      dmin[k] = CUDART_INF_F;
      ms[k] = 0;
      ds[k] = 0;
      dop[k] = false;
    }
    float vml = CUDART_INF_F;  // lane i0-1
    int msl = 0;
    bool seen = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int p = preds[s];
      const bool real = p >= 0 && p < j;
      if (!real && seen) continue;  // BIG cannot beat a real slot's value
      float Vp[L], Dp[L];
      float vl = kBig;
      if (real) {
        seen = true;
        // row p + 1 sits d = j - p slots before row j + 1; a ring of K
        // rows holds d < K only (the caller's maxd + 1): a farther row is
        // overwritten, so reading any slot would give a wrong answer
        const int d = j - p;
        assert(d < K && "graph_dense: a predecessor lies beyond the ring (maxd too small)");
        int ps = cur - d;
        if (ps < 0) ps += K;
        const float* row = ring + (long long)ps * stride;
#pragma unroll
        for (int k = 0; k < L; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + i0 + k);
          const float4 w = *reinterpret_cast<const float4*>(row + Mp + i0 + k);
          Vp[k] = v.x; Vp[k + 1] = v.y; Vp[k + 2] = v.z; Vp[k + 3] = v.w;
          Dp[k] = w.x; Dp[k + 1] = w.y; Dp[k + 2] = w.z; Dp[k + 3] = w.w;
        }
        vl = row[2 * Mp + t];
      } else {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          Vp[k] = kBig;
          Dp[k] = kBig;
        }
      }
      if (vl < vml) {
        vml = vl;
        msl = s;
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (Vp[k] < vmin[k]) {
          vmin[k] = Vp[k];
          ms[k] = s;
        }
        const float do_ = add(Vp[k], dgo);
        const float de_ = add(Dp[k], dge);
        const float dc = fminf(do_, de_);
        if (dc < dmin[k]) {
          dmin[k] = dc;
          ds[k] = s;
          dop[k] = do_ < de_;  // the reference opens only on strict <
        }
      }
    }

    float U[L], cand[L], ugio[L], Drow[L];
    int bits[L];
    float part = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + k;
      const float base = (startb || i == 0) ? 1.0f : kBig;
      Drow[k] = fminf(base, dmin[k]);
      // the match reads the best predecessor at lane i-1 (BIG / slot 0 left
      // of lane 0)
      const float vsh = k == 0 ? (t > 0 ? vml : kBig) : vmin[k - 1];
      const int msh = k == 0 ? (t > 0 ? msl : 0) : ms[k - 1];
      const float mc = add(vsh, mul(sfrow[qoff[k]], subw));
      // U with reference tie priority: edge keeps ties vs D; M strict
      float u = base;
      int code = kCodeEdge;
      if (dmin[k] < u) {
        u = dmin[k];
        code = kCodeDel;
      }
      if (mc < u) {
        u = mc;
        code = kCodeMatch;
      }
      U[k] = u;
      bits[k] = code | (msh << 2) | (ds[k] << 5) | (dop[k] ? 1 << 8 : 0);
      ugio[k] = add(u, gio);
      cand[k] = fma_d(-(double)(i + 1), gie_d, ugio[k]);
      if (k < L - 1) part = fminf(part, cand[k]);
    }
    const float tot = fminf(part, cand[L - 1]);
    const dp::ScanOut sc = dp::block_min_scan(tot, part, U[L - 1], s_scan, parity, warp, wl);
    parity ^= 1;

    // prefix[k]: the insertion value's start at lane i0+k; pprev: at lane i0-1
    float prefix[L];
    float pprev = kBig;
    if (!a.aspace) {
      // unbounded runs: min(cand[0..i-1], 1), the edge seed
      float run = sc.excl;  // min cand over lanes < i0
      if (t > 0) pprev = fminf(sc.tail, 1.0f);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        prefix[k] = fminf(run, 1.0f);
        run = fminf(run, cand[k]);
      }
    } else {
      // bounded runs, no edge seed (--insertion forbid, mesh.h:403-437):
      // prefix[i] = min(cand[i-R .. i-1]) with BIG left of lane 0, R =
      // clip(budget, 1, M), BIG where budget < 1 (_windowed_min);
      // sparse-table doubling over two shared buffers. The scan's barrier
      // separates the previous node's table reads from these writes.
      float* tcur = s_tab;
      float* tnxt = s_tab + Mp;
#pragma unroll
      for (int k = 0; k < L; ++k) tcur[i0 + k] = cand[k];
      const int R = min(max(budget, 1), M);
      const int lv = 31 - __clz(R);
      for (int s = 0; s < lv; ++s) {
        __syncthreads();
        const int sh = 1 << s;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const int x = i0 + k;
          tnxt[x] = fminf(tcur[x], x >= sh ? tcur[x - sh] : kBig);
        }
        float* tmp = tcur;
        tcur = tnxt;
        tnxt = tmp;
      }
      __syncthreads();
      const int off = R - (1 << lv);
      // wm(x) = min(cand[x-R+1 .. x])
      auto wm = [&](int x) {
        const int y = x - off;
        return fminf(tcur[x], y >= 0 ? tcur[y] : kBig);
      };
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = i0 + k;
        prefix[k] = (budget < 1 || i == 0) ? kBig : wm(i - 1);
      }
      if (t > 0) pprev = (budget < 1 || i0 - 1 == 0) ? kBig : wm(i0 - 2);
    }

    // lane i0-1 (the previous thread's last lane): its I and U, and so its V
    float iprev = kBig, uprev = kBig;
    if (t > 0) {
      iprev = fma_d((double)(i0 - 1), gie_d, pprev);
      uprev = sc.prev_last;
    }
    const float vleft = (iprev <= uprev) ? iprev : uprev;
    float uprev_gio = add(uprev, gio);

    float Vrow[L];
    uint32_t cells[L / 2];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const float irow = fma_d((double)(i0 + k), gie_d, prefix[k]);
      // opened at i (vs extended): U[i-1]+go <= I[i-1]+ge
      const bool ins_opened = uprev_gio <= add(iprev, gie);
      const bool take_i = irow <= U[k];  // ties -> insertion
      Vrow[k] = take_i ? irow : U[k];
      const uint32_t cell = (uint32_t)((take_i ? kCodeIns : (bits[k] & 3)) | (bits[k] & ~3) |
                                       (ins_opened ? 1 << 9 : 0)) & 0xFFFFu;
      if (k & 1) {
        cells[k >> 1] |= cell << 16;
      } else {
        cells[k >> 1] = cell;
      }
      iprev = irow;
      uprev_gio = ugio[k];
    }
    int16_t* bp_row = bpb + (long long)j * M;
    if (vec_store) {
      store_cells<L>(bp_row + i0, cells);
    } else {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (i0 + k < M) bp_row[i0 + k] = (int16_t)(cells[k >> 1] >> (16 * (k & 1)));
      }
    }
    float* out_row = ring + (long long)cur * stride;
#pragma unroll
    for (int k = 0; k < L; k += 4) {
      *reinterpret_cast<float4*>(out_row + i0 + k) =
          make_float4(Vrow[k], Vrow[k + 1], Vrow[k + 2], Vrow[k + 3]);
      *reinterpret_cast<float4*>(out_row + Mp + i0 + k) =
          make_float4(Drow[k], Drow[k + 1], Drow[k + 2], Drow[k + 3]);
    }
    out_row[2 * Mp + t] = vleft;

    // running best-cell candidates (mesh.h:569-592), strict < (the earliest j)
    if (validb) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = i0 + k;
        if (i == q1 && Vrow[k] < c1v) {
          c1v = Vrow[k];
          c1j = j;
        }
        if (endb && i < ql && Vrow[k] < c2v[k]) {
          c2v[k] = Vrow[k];
          c2j[k] = j;
        }
      }
    }
    cur = cur + 1 == K ? 0 : cur + 1;
  }

  // reduce: c2 by (v, j, lane), lowest first (the earliest j, then the
  // lowest lane, as the plain version's running row argmins)
  float v = CUDART_INF_F;
  int vj = 0x7FFFFFFF, vi = 0x7FFFFFFF;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = i0 + k;
    if (i < M && lex_less(c2v[k], c2j[k], i, v, vj, vi)) {
      v = c2v[k];
      vj = c2j[k];
      vi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(dp::kFull, v, off);
    const int oj = __shfl_down_sync(dp::kFull, vj, off);
    const int oi = __shfl_down_sync(dp::kFull, vi, off);
    if (lex_less(ov, oj, oi, v, vj, vi)) {
      v = ov;
      vj = oj;
      vi = oi;
    }
  }
  if (wl == 0) {
    s_rv[warp] = v;
    s_rj[warp] = vj;
    s_ri[warp] = vi;
  }
  if (q1 >= i0 && q1 < i0 + L) {
    s_c1v = c1v;
    s_c1j = c1j;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (lex_less(s_rv[w], s_rj[w], s_ri[w], v, vj, vi)) {
        v = s_rv[w];
        vj = s_rj[w];
        vi = s_ri[w];
      }
    }
    float* out = a.best + (long long)b * 8;
    out[0] = s_c1v;
    out[1] = (float)s_c1j;
    out[2] = v;
    out[3] = (float)vj;
    out[4] = (float)vi;
    out[5] = 0.0f;
    out[6] = 0.0f;
    out[7] = 0.0f;
  }
}

// kDefaultLanes, doubled until a block stays within kMaxThreads (M <= 2048
// at 4 lanes, 4096 at 8, 8192 at 16, 16384 at 32)
int lanes_for(int M) {
  int L = kDefaultLanes;
  while (M > L * kMaxThreads && L < 32) L *= 2;
  return L;
}

int threads_for(int M, int L) { return ((M + L - 1) / L + 31) / 32 * 32; }

const void* kernel_for(int L) {
  switch (L) {
    case 4: return reinterpret_cast<const void*>(&graph_dense_kernel<4>);
    case 8: return reinterpret_cast<const void*>(&graph_dense_kernel<8>);
    case 16: return reinterpret_cast<const void*>(&graph_dense_kernel<16>);
    case 32: return reinterpret_cast<const void*>(&graph_dense_kernel<32>);
    default: return nullptr;
  }
}

struct Plan {
  int lanes, threads, dyn_smem, static_smem, regs, Mp, stride;
};

cudaError_t make_plan(int M, int aspace, Plan* p) {
  if (M <= 0 || M > 32 * kMaxThreads) return cudaErrorInvalidValue;
  p->lanes = lanes_for(M);
  p->threads = threads_for(M, p->lanes);
  if (p->threads > kMaxThreads) return cudaErrorInvalidValue;
  p->Mp = p->threads * p->lanes;
  p->stride = 2 * p->Mp + p->threads;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_for(p->lanes));
  if (e != cudaSuccess) return e;
  p->dyn_smem = aspace ? 2 * p->Mp * (int)sizeof(float) : 0;
  p->static_smem = (int)attr.sharedSizeBytes;
  p->regs = attr.numRegs;
  return cudaSuccess;
}

// The walk of traceback_device over one query's slot-coded plane: from the
// best cell, RESOLVE / CHAIN / DECIDE / INS / RESOLVE_NE / CHAIN_NE / DONE
// (align_kernel.py:616-714), writing row[i] = j for each consumed query base
// in step order; returns whether it reached DONE within `steps` steps.
// Indices below 0 wrap once, as the plain version's tensor indexing does.
__device__ bool walk_dense(const int16_t* plane, const int32_t* pr, const uint8_t* st, int j,
                           int i, int N, int M, int P, long long steps, int32_t* row) {
  constexpr int kResolve = 0, kChain = 1, kDecide = 2, kIns = 3;
  constexpr int kResolveNe = 4, kChainNe = 5, kDone = 6;
  int state = kResolve;
  for (long long s = 0; s < steps && state != kDone; ++s) {
    const int jj = j < 0 ? j + N : j;
    const int ii = i < 0 ? i + M : i;
    const int cell = plane[(long long)jj * M + ii];
    const int code = cell & 3;
    const bool at_edge = i == 0 || st[jj];
    if (state == kResolve || state == kResolveNe) {
      const bool is_del = code == kCodeDel && !at_edge;
      if (state == kResolve && !is_del && i >= 0 && i < M) row[i] = j;
      state = is_del ? (state == kResolve ? kChain : kChainNe) : kDecide;
    } else if (state == kChain || state == kChainNe) {
      int pc = pr[(long long)jj * P + min((cell >> 5) & 7, P - 1)];
      if (pc < 0) pc = j;
      if (((cell >> 8) & 1) || st[pc < 0 ? pc + N : pc]) {
        state = state == kChain ? kResolve : kResolveNe;
      }
      j = pc;
    } else if (state == kDecide) {
      if (at_edge || code == kCodeEdge) {
        state = kDone;
      } else if (code == kCodeMatch) {
        int pm = pr[(long long)jj * P + min((cell >> 2) & 7, P - 1)];
        j = pm < 0 ? j : pm;
        i -= 1;
        state = kResolve;
      } else {
        state = code == kCodeIns ? kIns : kChainNe;
      }
    } else {  // kIns
      if (i - 1 < 0) {
        state = kDone;
      } else {
        i -= 1;
        if (i < M) row[i] = j;
        state = (cell >> 9) & 1 ? kDecide : kIns;
      }
    }
  }
  return state == kDone;
}

__global__ void __launch_bounds__(kTbThreads)
graph_dense_traceback_kernel(const int16_t* __restrict__ bp, const int32_t* __restrict__ best_j,
                             const int32_t* __restrict__ best_i, const int32_t* __restrict__ preds,
                             const uint8_t* __restrict__ start, int32_t* __restrict__ emit,
                             int32_t* __restrict__ done, int N, int M, int P) {
  const int b = blockIdx.x;
  int32_t* row = emit + (long long)b * M;
  for (int i = threadIdx.x; i < M; i += kTbThreads) row[i] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool fin = walk_dense(bp + (long long)b * N * M, preds + (long long)b * N * P,
                              start + (long long)b * N, best_j[b], best_i[b], N, M, P,
                              (long long)N + 2LL * M + 8, row);
  done[b] = fin ? 1 : 0;
}

}  // namespace

// The DP's launch plan for M query positions, forbid mode or not: out[0..5]
// = lanes a thread, threads, floats of a ring row (V, D and each thread's V
// at the lane left of its own: the wrapper allocates K of them a query),
// dynamic and static shared memory bytes a block, registers a thread.
// Returns a cudaError_t.
extern "C" int sina_graph_dp_dense_plan(int M, int aspace, long long* out) {
  Plan p;
  const cudaError_t e = make_plan(M, aspace, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.lanes;
  out[1] = p.threads;
  out[2] = p.stride;
  out[3] = p.dyn_smem;
  out[4] = p.static_smem;
  out[5] = p.regs;
  return 0;
}

// table (B, N, 16) int32: subw, dgo, dge, gio, gie (float32 bits), mask |
// flags << 8 (flags: 1 start, 2 end, 4 real node), insertion budget, 0, and
// eight predecessor slots (-1 = none); qmask (B, M) uint8; qlen (B,) int32;
// smat (B, 16) float32 (read only with matrix != 0); bp (B, N, M) int16;
// best (B, 8) float32 (v1, j1, v2, j2, i2); ring: B * K * the plan's out[2]
// floats, K greater than every predecessor distance j - p (a device-side
// assert otherwise). 1 <= M <= 16384.
// Returns cudaGetLastError() (cudaErrorInvalidValue for unsupported shapes).
extern "C" int sina_graph_dp_dense(const void* table, const void* qmask, const void* qlen,
                                   const void* smat, void* bp, void* best, void* ring, int B,
                                   int N, int M, int K, int aspace, int matrix, float match,
                                   float mismatch, void* stream) {
  if (B == 0) return 0;
  if (N <= 0 || K < 1 || ring == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(M, aspace, &p);
  if (e != cudaSuccess) return (int)e;
  DenseArgs a;
  a.table = static_cast<const int4*>(table);
  a.qmask = static_cast<const uint8_t*>(qmask);
  a.qlen = static_cast<const int32_t*>(qlen);
  a.smat = static_cast<const float*>(smat);
  a.bp = static_cast<int16_t*>(bp);
  a.best = static_cast<float*>(best);
  a.ring = static_cast<float*>(ring);
  a.N = N;
  a.M = M;
  a.Mp = p.Mp;
  a.K = K;
  a.stride = p.stride;
  a.aspace = aspace;
  a.matrix = matrix;
  a.match = match;
  a.mismatch = mismatch;
  const void* fn = kernel_for(p.lanes);
  if (p.dyn_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.dyn_smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&a};
  e = cudaLaunchKernel(fn, dim3(B), dim3(p.threads), args, (size_t)p.dyn_smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The traceback's launch plan: out[0..2] = threads a block (one walks),
// static shared memory bytes, registers a thread. Returns a cudaError_t.
extern "C" int sina_graph_traceback_dense_plan(long long* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(&graph_dense_traceback_kernel));
  if (e != cudaSuccess) return (int)e;
  out[0] = kTbThreads;
  out[1] = (long long)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  return 0;
}

// bp (B, N, M) int16 slot-coded; best_j, best_i (B,) int32; preds (B, N, P)
// int32 (-1 = none); start (B, N) uint8 (bool); emit (B, M) int32; done (B,)
// int32. Returns cudaGetLastError().
extern "C" int sina_graph_traceback_dense(const void* bp, const void* best_j, const void* best_i,
                                          const void* preds, const void* start, void* emit,
                                          void* done, int B, int N, int M, int P, void* stream) {
  if (B == 0) return 0;
  if (N <= 0 || M <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int16_t* bp_p = static_cast<const int16_t*>(bp);
  const int32_t* bj_p = static_cast<const int32_t*>(best_j);
  const int32_t* bi_p = static_cast<const int32_t*>(best_i);
  const int32_t* pr_p = static_cast<const int32_t*>(preds);
  const uint8_t* st_p = static_cast<const uint8_t*>(start);
  int32_t* emit_p = static_cast<int32_t*>(emit);
  int32_t* done_p = static_cast<int32_t*>(done);
  void* args[] = {&bp_p, &bj_p, &bi_p, &pr_p, &st_p, &emit_p, &done_p, &N, &M, &P};
  const cudaError_t e =
      cudaLaunchKernel(reinterpret_cast<const void*>(&graph_dense_traceback_kernel), dim3(B),
                       dim3(kTbThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
