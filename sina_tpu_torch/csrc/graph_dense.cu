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
// off device memory and off barriers other than the one a node:
//
// - Each thread owns L consecutive query positions and reads and writes the
//   rows of earlier nodes only at its own lanes, so no row needs a barrier.
//   The one value a lane needs from its left neighbour's predecessor rows, V
//   at lane i0-1, is recomputed by the thread from the scan results and kept
//   in its own column of each row (as in graph_dp.cu).
// - Where a node's rows come from, by its distance d = j - p to the
//   predecessor p: d = 1 (nearly every node's first slot) from the thread's
//   registers, which still hold the last node's rows; 2 <= d <= S from a ring
//   of the last S rows in shared memory (S = as many rows as fit beside the
//   forbid buffers, at most the bucket's largest distance maxd: 16 rows of
//   13.8 KB at M = 1536); d > max(S, 1) from a per-query global scratch of
//   maxd + 1 rows (L2-resident), which only the rows some successor reads
//   from that far back are written to (the record's deep flag), and which is
//   not allocated where maxd <= max(S, 1). Such predecessors are rare (the
//   node after a long insertion), and they are read in place: loading their
//   rows a node ahead, into registers or into shared memory by cp.async,
//   made every node slower on the card (PERF.md). A predecessor farther back
//   than maxd fails a device-side assert, which the next synchronising call
//   raises. A slot of -1 or of a node not yet computed (p >= j) reads no row
//   and stands for BIG, as the plain version's virtual row 0 and its
//   unwritten rows do.
// - A node with no predecessors whose record equals the previous node's (the
//   record's repeat flag, computed per query by the host) has the previous
//   node's rows and changes no end candidate (strict <): it stores the kept
//   rows again, with no probe, no scan and no barrier. A bucket pads its
//   graphs with such nodes up to its node bucket (over a third of the
//   nodes of phase 18's buckets, PERF.md).
// - The slot probe keeps the first minimum (strict <, slots ascending), as
//   the plain version's argmins do. Every V and D value is at most BIG, so a
//   slot that reads no row (BIG) can only tie with a real one: after the
//   first real slot it cannot win and is skipped; before it, it is probed
//   with BIG (a node with no predecessors records slot 0).
// - The insertion prefix-min is a running min in the thread plus the
//   two-level block scan of dp_scan.cuh: one barrier a node. The bounded one
//   (forbid, a second instantiation of the kernel) is the segments-of-R
//   trailing-window minimum of forbid_window.cuh, also one barrier a node.
// - The substitution factor is a function of the node's and the query
//   position's IUPAC masks: a 16 x 16 table in shared memory, built once per
//   block in the reference's f32 operations. The per-node costs arrive in one
//   64-byte record (with the node's eight predecessor slots), staged in
//   shared memory with asynchronous copies a chunk of kRecChunk nodes ahead.
//
// Rounding: the insertion candidate and Irow are multiply-adds rounded once,
// as the reference's compiled core contracts them to FMA: a double fma of an
// exact f32 product, rounded to f32, the value the plain version's _fma
// computes. The match cost is a separately rounded product plus an add (the
// reference precomputes it). All other f32 arithmetic keeps the plain
// version's order through explicit round-to-nearest intrinsics (the library
// is built with --fmad=false).
//
// What bounds the traceback: latency. One thread walks each query's chain of
// dependent steps, up to N + 2M + 8 of them; the bytes are no limit. Its
// block stages a window of the plane in shared memory (traceback_window.cuh,
// as graph_traceback.cu does), with the window's nodes' start flags and
// predecessor slots beside the cells, so that a step reads only shared
// memory; see graph_dense_traceback_kernel.

#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dp_scan.cuh"
#include "forbid_window.cuh"
#include "traceback_window.cuh"

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
// node records staged in shared memory at a time, double-buffered
constexpr int kRecChunk = 32;
// the record's flags (bits 8-15 of its mask word)
constexpr int kFlagStart = 1;
constexpr int kFlagEnd = 2;  // an end node that is also real
constexpr int kFlagReal = 4;
constexpr int kFlagRepeat = 8;  // no predecessors, the previous node's record
constexpr int kFlagDeep = 16;   // a successor reads the row from the scratch

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
// a * b + c rounded to f32 once, a * b exact in double
__device__ __forceinline__ float fma_d(double a, double b, float c) {
  return __double2float_rn(__fma_rn(a, b, (double)c));
}

// 16-byte asynchronous copy global -> shared (no register holds the data)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// records of nodes [j0, j0 + kRecChunk) (those below N) into dst, one
// 16-byte quarter a thread at a time
__device__ __forceinline__ void stage_records(int4 (*dst)[4], const int4* tab, int j0, int N,
                                              int t, int nthreads) {
  for (int e = t; e < 4 * kRecChunk; e += nthreads) {
    if (j0 + (e >> 2) < N) cp_async16(&dst[e >> 2][e & 3], tab + 4LL * j0 + e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

struct DenseArgs {
  const int4* table;     // (B, N, 4) int4 = per-node record, see ops/align_kernel.py
  const uint8_t* qmask;  // (B, M)
  const int32_t* qlen;   // (B,)
  const float* smat;     // (B, 16)
  int16_t* bp;           // (B, N, M)
  float* best;           // (B, 8)
  float* scratch;        // (B, K, stride), or null where K = 0
  int N, M, Mp, stride;
  int S;     // rows of the shared ring
  int K;     // rows of the global scratch (maxd + 1, or 0)
  int maxd;  // the largest predecessor distance the caller allows
  int matrix;
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

// A row (V at Mp lanes, D at Mp lanes, each thread's V at the lane left of
// its own) at the thread's own lanes, in shared or global memory
template <int L>
__device__ __forceinline__ void load_row(const float* row, int Mp, int i0, int t, float (&V)[L],
                                         float (&D)[L], float& vl) {
#pragma unroll
  for (int k = 0; k < L; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + i0 + k);
    const float4 w = *reinterpret_cast<const float4*>(row + Mp + i0 + k);
    V[k] = v.x; V[k + 1] = v.y; V[k + 2] = v.z; V[k + 3] = v.w;
    D[k] = w.x; D[k + 1] = w.y; D[k + 2] = w.z; D[k + 3] = w.w;
  }
  vl = row[2 * Mp + t];
}
template <int L>
__device__ __forceinline__ void store_row(float* row, int Mp, int i0, int t, const float (&V)[L],
                                          const float (&D)[L], float vl) {
#pragma unroll
  for (int k = 0; k < L; k += 4) {
    *reinterpret_cast<float4*>(row + i0 + k) = make_float4(V[k], V[k + 1], V[k + 2], V[k + 3]);
    *reinterpret_cast<float4*>(row + Mp + i0 + k) =
        make_float4(D[k], D[k + 1], D[k + 2], D[k + 3]);
  }
  row[2 * Mp + t] = vl;
}
template <int L>
__device__ __forceinline__ void copy_row(float (&V)[L], float (&D)[L], float& vl,
                                         const float (&V0)[L], const float (&D0)[L], float vl0) {
#pragma unroll
  for (int k = 0; k < L; ++k) {
    V[k] = V0[k];
    D[k] = D0[k];
  }
  vl = vl0;
}

template <int L, bool kForbid>
__global__ void __launch_bounds__(kMaxThreads) graph_dense_kernel(DenseArgs a) {
  // [the ring: S rows of `stride` floats] [forbid: two S rows, the slots]
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ float s_sfac[256];  // substitution factor by (node mask, query mask)
  __shared__ dp::ScanSlots s_scan;
  __shared__ float s_rv[kMaxWarps];
  __shared__ int s_rj[kMaxWarps];
  __shared__ int s_ri[kMaxWarps];
  __shared__ float s_c1v;
  __shared__ int s_c1j;
  __shared__ int4 s_rec[2][kRecChunk][4];  // node records, by chunk parity

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = t >> 5;
  const int wl = t & 31;
  const int nwarps = nthreads >> 5;
  const int i0 = t * L;
  const int M = a.M, Mp = a.Mp, N = a.N, stride = a.stride;
  const int S = a.S, K = a.K, maxd = a.maxd;
  const int ql = a.qlen[b];
  const int q1 = ql - 1;
  float* ring = s_dyn;  // node p's row in slot p mod S
  float* scratch = a.scratch + (long long)b * K * stride;  // node p's in slot p mod K
  float* s_fb = s_dyn + S * stride;                       // forbid's S rows
  const int srow = fw::srow_floats(Mp, L);
  fw::ForbidSlots& fs = *reinterpret_cast<fw::ForbidSlots*>(s_fb + 2 * srow);
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
      const float* Sm = a.smat + (long long)b * 16;
      float pq = 0.0f, pn = 0.0f, numer = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) pq = add(pq, (float)((q >> r) & 1));
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float sql = 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) sql = add(sql, mul(Sm[4 * l + r], (float)((q >> r) & 1)));
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
  if constexpr (kForbid) {
    for (int e = t; e < fw::guard_floats(L); e += nthreads) {
      s_fb[e] = kBig;
      s_fb[srow + e] = kBig;
    }
  }

  int qoff[L];  // the query mask at each lane: its column in s_sfac
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = i0 + k;
    qoff[k] = i < M ? a.qmask[(long long)b * M + i] & 15 : 0;
  }
  const double lm1_d = (double)(i0 - 1);
  if (t == 0) {
    s_c1v = kBig;
    s_c1j = 0;
  }
  stage_records(s_rec[0], tab, 0, N, t, nthreads);
  stage_records(s_rec[1], tab, kRecChunk, N, t, nthreads);
  cp_async_wait_all();
  __syncthreads();  // s_sfac, the guards, the first two chunks of records

  float c1v = kBig;  // candidate 1: the owner of lane ql-1
  int c1j = 0;
  float c2v[L];  // candidate 2: per lane, end nodes
  int c2j[L];
  // the last node's rows (distance 1, and what a repeated node stores again)
  float Vrow[L], Drow[L];
  uint32_t cells[L / 2];
  float vleft = kBig;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    c2v[k] = kBig;
    c2j[k] = 0;
    Vrow[k] = kBig;
    Drow[k] = kBig;
  }
#pragma unroll
  for (int k = 0; k < L / 2; ++k) cells[k] = 0;

  int4 n0 = s_rec[0][0][0], n1 = s_rec[0][0][1], n2 = s_rec[0][0][2], n3 = s_rec[0][0][3];
  int cur = 0;     // j mod S: node j's slot in the ring
  int gcur = 0;    // j mod K: in the scratch
  int parity = 0;  // computed nodes mod 2: the scan's and the window's buffers
  for (int j = 0; j < N; ++j) {
    const int4 r0 = n0, r1 = n1, r2 = n2, r3 = n3;
    if (j % kRecChunk == kRecChunk - 1 && j + 1 < N) {
      // the next chunk's records have landed (all threads' copies), and
      // every read of this chunk's buffer is done (this node's record was
      // read a node ago): refill it with the chunk after the next
      cp_async_wait_all();
      __syncthreads();
      const int c = (j + 1) / kRecChunk + 1;
      if (c * kRecChunk < N) stage_records(s_rec[c & 1], tab, c * kRecChunk, N, t, nthreads);
    }
    if (j + 1 < N) {
      const int4* nx = s_rec[((j + 1) / kRecChunk) & 1][(j + 1) % kRecChunk];
      n0 = nx[0];
      n1 = nx[1];
      n2 = nx[2];
      n3 = nx[3];
    }
    const int flags = (r1.y >> 8) & 0xFF;
    int16_t* bp_row = bpb + (long long)j * M;

    // a repeated node (no predecessors, the previous node's record) stores
    // the kept rows and backpointers again
    if (!(flags & kFlagRepeat)) {
      const float subw = __int_as_float(r0.x);
      const float dgo = __int_as_float(r0.y);
      const float dge = __int_as_float(r0.z);
      const float gio = __int_as_float(r0.w);
      const float gie = __int_as_float(r1.x);
      const double gie_d = (double)gie;
      const int nmask = r1.y & 0xF;
      const int budget = r1.z;
      const bool startb = flags & kFlagStart;
      const int preds[kSlots] = {r2.x, r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w};
      const float* sfrow = s_sfac + 16 * nmask;

      // the slot probe: first minimum over the slots (strict <), a slot
      // that reads no row standing for BIG
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
          const int d = j - p;
          // a row farther back than maxd is not kept: reading any slot
          // would give a wrong answer
          assert(d <= maxd && "graph_dense: a predecessor lies beyond the ring (maxd too small)");
          if (d == 1) {
            copy_row<L>(Vp, Dp, vl, Vrow, Drow, vleft);
          } else if (d <= S) {
            int ps = cur - d;
            if (ps < 0) ps += S;
            load_row<L>(ring + ps * stride, Mp, i0, t, Vp, Dp, vl);
          } else {
            int gs = gcur - d;
            if (gs < 0) gs += K;
            load_row<L>(scratch + (long long)gs * stride, Mp, i0, t, Vp, Dp, vl);
          }
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

      float U[L], cand[L], ugio[L];
      int bits[L];
      float part = CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = i0 + k;
        const float base = (startb || i == 0) ? 1.0f : kBig;
        Drow[k] = fminf(base, dmin[k]);
        // the match reads the best predecessor at lane i-1 (BIG / slot 0
        // left of lane 0)
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

      // prefix[k]: the insertion value's start at lane i0+k; lane i0-1 (the
      // previous thread's last lane): its I and U, and so its V
      float prefix[L];
      float iprev = kBig, uprev = kBig;
      if constexpr (!kForbid) {
        const float tot = fminf(part, cand[L - 1]);
        const dp::ScanOut sc = dp::block_min_scan(tot, part, U[L - 1], s_scan, parity, warp, wl);
        // unbounded runs: min(cand[0..i-1], 1), the edge seed
        float run = sc.excl;  // min cand over lanes < i0
        if (t > 0) {
          iprev = fma_d(lm1_d, gie_d, fminf(sc.tail, 1.0f));
          uprev = sc.prev_last;
        }
#pragma unroll
        for (int k = 0; k < L; ++k) {
          prefix[k] = fminf(run, 1.0f);
          run = fminf(run, cand[k]);
        }
      } else {
        // bounded runs, no edge seed (--insertion forbid, mesh.h:403-437):
        // prefix[i] = min(cand[i-R .. i-1]) with BIG left of lane 0, R =
        // clip(budget, 1, M), BIG where budget < 1 (_windowed_min)
        float pprev;
        float* s_S = s_fb + parity * srow + fw::guard_floats(L);
        fw::forbid_prefix<L>(cand, U[L - 1], budget, (uint32_t)r1.w, M, i0, t, warp, wl,
                             nwarps, parity, s_S, fs, prefix, uprev, pprev);
        if (t > 0) iprev = fma_d(lm1_d, gie_d, pprev);
      }
      parity ^= 1;
      vleft = (iprev <= uprev) ? iprev : uprev;
      float uprev_gio = add(uprev, gio);

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

      // running best-cell candidates (mesh.h:569-592), strict < (the
      // earliest j)
      if (flags & kFlagReal) {
        const bool endb = flags & kFlagEnd;
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
    }

    if (vec_store) {
      store_cells<L>(bp_row + i0, cells);
    } else {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (i0 + k < M) bp_row[i0 + k] = (int16_t)(cells[k >> 1] >> (16 * (k & 1)));
      }
    }
    if (S > 0) {
      store_row<L>(ring + cur * stride, Mp, i0, t, Vrow, Drow, vleft);
      cur = cur + 1 == S ? 0 : cur + 1;
    }
    if (K > 0) {
      if (flags & kFlagDeep) {
        store_row<L>(scratch + (long long)gcur * stride, Mp, i0, t, Vrow, Drow, vleft);
      }
      gcur = gcur + 1 == K ? 0 : gcur + 1;
    }
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

template <int L>
const void* kernel_ptr(bool forbid) {
  return forbid ? reinterpret_cast<const void*>(&graph_dense_kernel<L, true>)
                : reinterpret_cast<const void*>(&graph_dense_kernel<L, false>);
}

const void* kernel_for(int L, bool forbid) {
  switch (L) {
    case 4: return kernel_ptr<4>(forbid);
    case 8: return kernel_ptr<8>(forbid);
    case 16: return kernel_ptr<16>(forbid);
    case 32: return kernel_ptr<32>(forbid);
    default: return nullptr;
  }
}

struct Plan {
  int lanes, threads, dyn_smem, static_smem, regs, Mp, stride, S, K;
};

// The shared ring holds as many rows as fit beside the static shared memory
// and forbid's buffers, and no more than maxd (every distance on chip); the
// scratch, maxd + 1 rows, exists only where a distance can exceed it.
cudaError_t make_plan(int M, int aspace, int maxd, Plan* p) {
  if (M <= 0 || M > 32 * kMaxThreads || maxd < 0) return cudaErrorInvalidValue;
  p->lanes = lanes_for(M);
  p->threads = threads_for(M, p->lanes);
  if (p->threads > kMaxThreads) return cudaErrorInvalidValue;
  p->Mp = p->threads * p->lanes;
  p->stride = 2 * p->Mp + p->threads;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel_for(p->lanes, aspace != 0));
  if (e != cudaSuccess) return e;
  const long long forbid =
      aspace ? 2LL * fw::srow_floats(p->Mp, p->lanes) * (long long)sizeof(float) +
                   (long long)sizeof(fw::ForbidSlots)
             : 0;
  const long long row = (long long)p->stride * (long long)sizeof(float);
  const long long room = (long long)optin - (long long)attr.sharedSizeBytes - forbid;
  if (room < 0) return cudaErrorInvalidValue;
  p->S = (int)(room / row < maxd ? room / row : maxd);
  p->K = maxd > (p->S > 1 ? p->S : 1) ? maxd + 1 : 0;
  p->dyn_smem = (int)(p->S * row + forbid);
  p->static_smem = (int)attr.sharedSizeBytes;
  p->regs = attr.numRegs;
  return cudaSuccess;
}

// The walk's window: kTJ nodes x kTI query positions of int16 (80 KB), with
// the nodes' start flags and predecessor slots beside it
constexpr int kTbThreads = 256;
constexpr int kTJ = 256;
constexpr int kTI = 160;
constexpr int kWindowBytes = kTJ * kTI * (int)sizeof(int16_t);

constexpr int kResolve = 0;
constexpr int kChain = 1;  // deletion chain, then resolve
constexpr int kDecide = 2;
constexpr int kIns = 3;
constexpr int kResolveNe = 4;  // resolve without emitting
constexpr int kChainNe = 5;    // deletion chain, then resolve without emitting
constexpr int kDone = 6;

struct Walk {
  int j, i, state;
  int rem;  // steps left before the cap
};

// The slot's predecessor of window node wj, or node j itself for a -1 slot
// (slots past P read the last one, as the plain version clamps them)
__device__ __forceinline__ int pred_of(const int32_t* pwin, int wj, int slot, int P, int j) {
  const int p = pwin[wj * kSlots + min(slot, P - 1)];
  return p < 0 ? j : p;
}

// The walk of traceback_device over one query's slot-coded plane, from w on
// the window (nodes [j0, j0 + ncols) x positions [i0, i0 + nrows), node c's
// cells at win + c * kTI, its start flag at fwin[c], its slots at pwin + c *
// kSlots), writing row[i] = j for each consumed query base in step order:
// RESOLVE / CHAIN / DECIDE / INS / RESOLVE_NE / CHAIN_NE / DONE
// (align_kernel.py:616-714). Returns the state where it reaches DONE, the
// step cap or a cell outside the window. Indices below 0 wrap once, as the
// plain version's tensor indexing does (cells are read at the wrapped index,
// clamped into the plane). Where no edge test but the start flag can fire
// (0 <= j < N, 0 < i < M, kept so by every move inside the window), tight
// loops take the three runs that make up nearly all of a walk, keeping the
// cell and its node's flag in registers: matched bases (RESOLVE then DECIDE
// on one cell, two steps a base, to the match slot's node), deletion chains
// (a node a step) and insertion runs (a position a step). A move is tested
// at its target: one to a node outside the window ends the loop. Elsewhere,
// and at each run's end, one general step follows the reference's rules;
// there a deletion step to a node outside the window reads that node's start
// flag from device memory (`st`), and the next cell lies outside, so the
// block stages the window anew there.
__device__ __forceinline__ Walk walk(const int16_t* win, const uint8_t* fwin, const int32_t* pwin,
                                     const uint8_t* st, Walk w, int j0, int i0, int ncols,
                                     int nrows, int N, int M, int P, int32_t* row) {
  int j = w.j, i = w.i, state = w.state, rem = w.rem;
  while (rem > 0 && state != kDone) {
    int wj = min(max(j < 0 ? j + N : j, 0), N - 1) - j0;
    int wi = min(max(i < 0 ? i + M : i, 0), M - 1) - i0;
    if ((unsigned)wj >= (unsigned)ncols || (unsigned)wi >= (unsigned)nrows) break;
    int cell = win[wj * kTI + wi];
    bool start = fwin[wj];
    if (j >= 0 && j < N && i >= 1 && i < M) {
      for (;;) {
        const int code = cell & 3;
        if (state == kResolve || state == kResolveNe) {
          if (code == kCodeMatch && !start) {
            int pm = pred_of(pwin, wj, (cell >> 2) & 7, P, j);
            if ((unsigned)(pm - j0) >= (unsigned)ncols || wi < 2 || rem < 2) break;
            if (state == kResolve) row[i] = j;
            for (;;) {
              wj = pm - j0, j = pm, --i, --wi;
              rem -= 2;
              cell = win[wj * kTI + wi];
              start = fwin[wj];
              if ((cell & 3) != kCodeMatch || start || wi < 2 || rem < 2) break;
              pm = pred_of(pwin, wj, (cell >> 2) & 7, P, j);
              if ((unsigned)(pm - j0) >= (unsigned)ncols) break;
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
          int pc = pred_of(pwin, wj, (cell >> 5) & 7, P, j);
          if ((unsigned)(pc - j0) >= (unsigned)ncols || rem < 1) break;
          bool stop;
          for (;;) {
            stop = ((cell >> 8) & 1) || fwin[pc - j0];
            wj = pc - j0, j = pc, --rem;
            cell = win[wj * kTI + wi];
            start = fwin[wj];
            if (stop || rem < 1) break;
            pc = pred_of(pwin, wj, (cell >> 5) & 7, P, j);
            if ((unsigned)(pc - j0) >= (unsigned)ncols) break;
          }
          if (stop) state = state == kChain ? kResolve : kResolveNe;
        } else if (state == kDecide) {
          if (start || code == kCodeEdge || rem < 1) break;
          if (code == kCodeMatch) {
            const int pm = pred_of(pwin, wj, (cell >> 2) & 7, P, j);
            if ((unsigned)(pm - j0) >= (unsigned)ncols || wi < 2) break;
            wj = pm - j0, j = pm, --i, --wi;
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
            open = (cell >> 9) & 1;
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
      if (rem == 0 || state == kDone) break;
    }
    const int code = cell & 3;
    const bool at_edge = (i == 0) || start;
    if (state == kResolve || state == kResolveNe) {
      const bool is_del = code == kCodeDel && !at_edge;
      if (state == kResolve && !is_del && i >= 0 && i < M) row[i] = j;
      state = is_del ? (state == kResolve ? kChain : kChainNe) : kDecide;
    } else if (state == kChain || state == kChainNe) {
      const int pc = pred_of(pwin, wj, (cell >> 5) & 7, P, j);
      const int pw = min(max(pc < 0 ? pc + N : pc, 0), N - 1);
      const bool pstart = (unsigned)(pw - j0) < (unsigned)ncols ? fwin[pw - j0] : st[pw] != 0;
      if (((cell >> 8) & 1) || pstart) state = state == kChain ? kResolve : kResolveNe;
      j = pc;
    } else if (state == kDecide) {
      if (at_edge || code == kCodeEdge) {
        state = kDone;
      } else if (code == kCodeMatch) {
        j = pred_of(pwin, wj, (cell >> 2) & 7, P, j);
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
    --rem;
  }
  return Walk{j, i, state, rem};
}

// One block a query: the block fills its emit row with -1 (coalesced), then
// stages a window of its plane whose far corner is the current cell (the
// walk never moves to a higher node or position), each node's positions
// copied with V-element cp.async (16 bytes where the nodes are 16-byte
// aligned, M % 8 == 0; 4 where M is even; else one cell), with the window's
// nodes' start flags and predecessor slots. Thread 0 walks on the window
// until it leaves it; the block then stages the window at the current cell.
// done[b] records whether the walk reached DONE within N + 2M + 8 steps.
template <int V>
__global__ void __launch_bounds__(kTbThreads)
graph_dense_traceback_kernel(const int16_t* __restrict__ bp, const int32_t* __restrict__ best_j,
                             const int32_t* __restrict__ best_i, const int32_t* __restrict__ preds,
                             const uint8_t* __restrict__ start, int32_t* __restrict__ emit,
                             int32_t* __restrict__ done, int N, int M, int P) {
  extern __shared__ __align__(16) int16_t win[];
  __shared__ int32_t pwin[kTJ * kSlots];
  __shared__ uint8_t fwin[kTJ];
  __shared__ Walk s_walk;
  const int b = blockIdx.x;
  int32_t* row = emit + (long long)b * M;
  for (int i = threadIdx.x; i < M; i += kTbThreads) row[i] = -1;
  if (threadIdx.x == 0) s_walk = Walk{best_j[b], best_i[b], kResolve, N + 2 * M + 8};
  __syncthreads();

  const int16_t* plane = bp + (long long)b * N * M;  // node j at plane + j * M
  const int32_t* pr = preds + (long long)b * N * P;
  const uint8_t* st = start + (long long)b * N;
  for (;;) {
    // every thread reads the walk's state after the barrier, so all take
    // the same branch here and meet at the same barriers below
    const Walk w = s_walk;
    if (w.state == kDone || w.rem == 0) break;
    const int jj = min(max(w.j < 0 ? w.j + N : w.j, 0), N - 1);
    const int ii = min(max(w.i < 0 ? w.i + M : w.i, 0), M - 1);
    const int j0 = max(jj - kTJ + 1, 0);
    const int i0 = sina_tb::first_row(ii, kTI);
    const int ncols = jj - j0 + 1;
    const int nrows = min(i0 + kTI, M) - i0;
    for (int c = threadIdx.x; c < ncols; c += kTbThreads) fwin[c] = st[j0 + c];
    for (int e = threadIdx.x; e < ncols * kSlots; e += kTbThreads) {
      const int s = e % kSlots;
      pwin[e] = s < P ? pr[(long long)(j0 + e / kSlots) * P + s] : -1;
    }
    sina_tb::stage<int16_t, V, kTbThreads>(win, kTI, plane + (long long)j0 * M + i0, M, ncols,
                                           nrows);
    __syncthreads();
    if (threadIdx.x == 0) s_walk = walk(win, fwin, pwin, st, w, j0, i0, ncols, nrows, N, M, P, row);
    __syncthreads();
  }
  if (threadIdx.x == 0) done[b] = s_walk.state == kDone ? 1 : 0;
}

const void* traceback_for(int v) {
  switch (v) {
    case 8: return reinterpret_cast<const void*>(&graph_dense_traceback_kernel<8>);
    case 2: return reinterpret_cast<const void*>(&graph_dense_traceback_kernel<2>);
    default: return reinterpret_cast<const void*>(&graph_dense_traceback_kernel<1>);
  }
}

}  // namespace

// The DP's launch plan for M query positions, forbid mode or not, and the
// largest predecessor distance maxd: out[0..7] = lanes a thread, threads,
// floats of a row (V, D and each thread's V at the lane left of its own),
// dynamic and static shared memory bytes a block, registers a thread, rows of
// the shared ring (S) and rows of the global scratch a query (K: maxd + 1
// where maxd > max(S, 1), else 0; the wrapper allocates B * K rows).
// Returns a cudaError_t.
extern "C" int sina_graph_dp_dense_plan(int M, int aspace, int maxd, long long* out) {
  Plan p;
  const cudaError_t e = make_plan(M, aspace, maxd, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.lanes;
  out[1] = p.threads;
  out[2] = p.stride;
  out[3] = p.dyn_smem;
  out[4] = p.static_smem;
  out[5] = p.regs;
  out[6] = p.S;
  out[7] = p.K;
  return 0;
}

// table (B, N, 16) int32: subw, dgo, dge, gio, gie (float32 bits), mask |
// flags << 8 (flags: 1 start, 2 real end node, 4 real node, 8 repeats the
// previous node, 16 a successor reads the row from more than max(S, 1) nodes
// back), the insertion budget, its window divisor (forbid_window.cuh: rdiv),
// and eight predecessor slots (-1 = none); qmask (B, M) uint8; qlen (B,)
// int32; smat (B, 16) float32 (read only with matrix != 0); bp (B, N, M)
// int16; best (B, 8) float32 (v1, j1, v2, j2, i2); scratch: B * K * the
// plan's out[2] floats, null where the plan's K is 0. maxd >= every
// predecessor distance j - p (a device-side assert otherwise). 1 <= M <=
// 16384. Returns cudaGetLastError() (cudaErrorInvalidValue for unsupported
// shapes or a scratch pointer that does not match the plan).
extern "C" int sina_graph_dp_dense(const void* table, const void* qmask, const void* qlen,
                                   const void* smat, void* bp, void* best, void* scratch, int B,
                                   int N, int M, int maxd, int aspace, int matrix, float match,
                                   float mismatch, void* stream) {
  if (B == 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(M, aspace, maxd, &p);
  if (e != cudaSuccess) return (int)e;
  if ((scratch == nullptr) != (p.K == 0)) return (int)cudaErrorInvalidValue;
  DenseArgs a;
  a.table = static_cast<const int4*>(table);
  a.qmask = static_cast<const uint8_t*>(qmask);
  a.qlen = static_cast<const int32_t*>(qlen);
  a.smat = static_cast<const float*>(smat);
  a.bp = static_cast<int16_t*>(bp);
  a.best = static_cast<float*>(best);
  a.scratch = static_cast<float*>(scratch);
  a.N = N;
  a.M = M;
  a.Mp = p.Mp;
  a.stride = p.stride;
  a.S = p.S;
  a.K = p.K;
  a.maxd = maxd;
  a.matrix = matrix;
  a.match = match;
  a.mismatch = mismatch;
  const void* fn = kernel_for(p.lanes, aspace != 0);
  // a block gets 48 KB of shared memory, static and dynamic together,
  // without opting in
  if (p.dyn_smem + p.static_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.dyn_smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&a};
  e = cudaLaunchKernel(fn, dim3(B), dim3(p.threads), args, (size_t)p.dyn_smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The traceback's launch plan for a plane at bp with M query positions:
// out[0..6] = threads (one walks), window nodes, window query positions,
// bytes a window copy moves at once, dynamic and static shared memory bytes
// a block, registers a thread. Returns a cudaError_t.
extern "C" int sina_graph_traceback_dense_plan(const void* bp, int M, long long* out) {
  const int v = sina_tb::copy_elems(bp, M, 2);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, traceback_for(v));
  if (e != cudaSuccess) return (int)e;
  out[0] = kTbThreads;
  out[1] = kTJ;
  out[2] = kTI;
  out[3] = v * (long long)sizeof(int16_t);
  out[4] = kWindowBytes;
  out[5] = (long long)attr.sharedSizeBytes;
  out[6] = attr.numRegs;
  return 0;
}

// bp (B, N, M) int16 slot-coded; best_j, best_i (B,) int32; preds (B, N, P)
// int32 (-1 = none), 1 <= P <= 8; start (B, N) uint8 (bool); emit (B, M)
// int32; done (B,) int32. Returns cudaGetLastError() (cudaErrorInvalidValue
// for unsupported shapes or a step cap N + 2M + 8 past INT_MAX).
extern "C" int sina_graph_traceback_dense(const void* bp, const void* best_j, const void* best_i,
                                          const void* preds, const void* start, void* emit,
                                          void* done, int B, int N, int M, int P, void* stream) {
  if (B == 0) return 0;
  if (N <= 0 || M <= 0 || P <= 0 || P > kSlots) return (int)cudaErrorInvalidValue;
  if ((long long)N + 2LL * M + 8 > INT_MAX) return (int)cudaErrorInvalidValue;
  const int16_t* bp_p = static_cast<const int16_t*>(bp);
  const int32_t* bj_p = static_cast<const int32_t*>(best_j);
  const int32_t* bi_p = static_cast<const int32_t*>(best_i);
  const int32_t* pr_p = static_cast<const int32_t*>(preds);
  const uint8_t* st_p = static_cast<const uint8_t*>(start);
  int32_t* emit_p = static_cast<int32_t*>(emit);
  int32_t* done_p = static_cast<int32_t*>(done);
  void* args[] = {&bp_p, &bj_p, &bi_p, &pr_p, &st_p, &emit_p, &done_p, &N, &M, &P};
  const void* fn = traceback_for(sina_tb::copy_elems(bp, M, 2));
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kWindowBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel(fn, dim3(B), dim3(kTbThreads), args, (size_t)kWindowBytes,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
