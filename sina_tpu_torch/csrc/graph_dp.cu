// POA graph DP (the mseq engine), one block per query.
//
// Replaces sina_tpu/ops/graph_pallas.py _graph_kernel (graph_dp_pallas_packed,
// with _windowed_min_rows for the bounded insertion track). Per graph node j,
// in topological order, and query position i it computes the substitution
// cost (IUPAC compatibility times the node's weight, or the mean of a 4x4
// substitution matrix over the letter pairs), the affine deletion track over
// the node's predecessors, the diagonal match from the best predecessor at
// i-1, and the Gotoh insertion track as a prefix-min over i (or, for
// --insertion forbid, a trailing-window min bounded by the node's insertion
// budget). It writes the uint16 backpointer plane in the reference's bit
// layout (bits 0-1 code, 2-6 match distance, 7-11 deletion distance, 12
// deletion opened, 13 insertion opened) as (B, N, M), and the running
// best-cell candidates of mesh.h:569-592 as (B, 8) float32 (v1, j1, v2, j2,
// i2); ops/graph_kernel.py decodes those.
//
// What bounds it: the recurrence over nodes is sequential, one block per
// query, and a node's work (~40 operations per query position: 27, and 11
// for each predecessor probed, among them three multiply-adds in double) is
// bound by its instruction count and its latency chain on one SM; the bytes
// are small (32 bytes of node record in, 2 bytes of backpointer out per lane
// and node: the plane at N=4096, B=128, M=1536 is 1.6 GB, written once). So
// the design keeps the node loop's latency off memory and barriers:
//
// - The ring of the last K node rows (V and D at each lane, plus each
//   thread's copy of V at the lane left of its own) lives in dynamic shared
//   memory, K = the bucket's largest predecessor distance + 1 (not a power
//   of two: the slot is a running index mod K). The predecessor probe visits
//   only the set bits of the node's distance mask, ascending, with <= (ties
//   keep the largest distance = the lowest predecessor id,
//   graph_pallas.py:196-221), and reads shared memory. Where the ring does
//   not fit (a deep ring at a wide M, or forbid mode's table beside it), the
//   same code runs with the ring in a per-query global scratch (L2-resident):
//   the template parameter kSharedRing is the ring's address space, chosen by
//   shape before the launch (sina_graph_dp_plan), never after a failure.
// - Each thread owns L consecutive query positions and reads and writes ring
//   rows only at its own lanes, so the ring needs no barrier. The one value a
//   lane needs from its left neighbour's predecessor rows, V at lane i0-1, is
//   recomputed by the thread from the scan results and kept in its own ring
//   column.
// - The insertion prefix-min is a running min in the thread plus the
//   two-level block scan of dp_scan.cuh: one barrier a node. The bounded one
//   (forbid) is a sparse table (log2 R doubling rounds in shared memory, R
//   block-uniform per node), one barrier a round.
// - The substitution factor is a function of the node's and the query
//   position's IUPAC masks: a 16 x 16 table in shared memory (in double),
//   built once per block in the reference's operations.
// - A node with no predecessors whose record equals the previous node's has
//   the previous node's rows and changes no best cell (strict <): it stores
//   the kept rows again, without a barrier. A bucket pads its graphs with
//   such nodes up to a power of two.
// - The node records are staged in shared memory with asynchronous copies,
//   a chunk ahead, so the node loop never waits on a global load.
// - The backpointers of a thread go out as one 2L-byte vector store.
//
// Three multiply-adds are rounded once, as the reference's compiled kernel
// contracts them to FMA: each is a double fma of an exact f32 product (so
// equal to the double product plus the addend, rounded once) rounded to f32,
// the same value the plain PyTorch version computes. All other f32
// arithmetic keeps the reference's order through explicit round-to-nearest
// intrinsics (the library is built with --fmad=false).

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
constexpr int kMaxRing = 32;
// node records staged in shared memory at a time: the loop never waits on
// a global load, on the repeated padding nodes least of all
constexpr int kRecChunk = 32;
// query positions a thread owns at the main path's widths (M <= 2048); chosen
// on the card between 4 (384 threads at M = 1536) and 8 (PERF.md)
constexpr int kDefaultLanes = 4;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
// a * b + c rounded to f32 once, a * b exact in double
__device__ __forceinline__ float fma_d(double a, double b, float c) {
  return __double2float_rn(__fma_rn(a, b, (double)c));
}

struct GraphArgs {
  const int4* table;     // (B, N, 2) int4 = per-node record, see ops/graph_kernel.py
  const uint8_t* qmask;  // (B, M)
  const int32_t* qlen;   // (B,)
  const float* smat;     // (B, 16)
  int16_t* bp;           // (B, N, M)
  float* best;           // (B, 8)
  float* ring;           // global-ring route: (B, K, stride); else unused
  int N, M, Mp, K, stride;
  int aspace, matrix;
  float match, mismatch;
};

// 16-byte asynchronous copy global -> shared (no register holds the data)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// records of nodes [j0, j0 + kRecChunk) (those below N) into dst, one
// 16-byte half a thread at a time
__device__ __forceinline__ void stage_records(int4 (*dst)[2], const int4* tab, int j0, int N, int t,
                                              int nthreads) {
  for (int e = t; e < 2 * kRecChunk; e += nthreads) {
    if (j0 + (e >> 1) < N) cp_async16(&dst[e >> 1][e & 1], tab + 2LL * j0 + e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// (v, j, lane) lexicographic "less"
__device__ __forceinline__ bool lex_less(float v, int j, int i, float bv, int bj, int bi) {
  return v < bv || (v == bv && (j < bj || (j == bj && i < bi)));
}

__device__ __forceinline__ bool same_record(int4 a0, int4 a1, int4 b0, int4 b1) {
  return a0.x == b0.x && a0.y == b0.y && a0.z == b0.z && a0.w == b0.w && a1.x == b1.x &&
         a1.y == b1.y && a1.z == b1.z && a1.w == b1.w;
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

template <int L, bool kSharedRing>
__global__ void __launch_bounds__(kMaxThreads) graph_dp_kernel(GraphArgs a) {
  extern __shared__ float4 s_dyn4[];  // [ring, if kSharedRing] [forbid's sparse table]
  __shared__ double s_sfac[256];      // substitution factor by (node mask, query mask)
  __shared__ dp::ScanSlots s_scan;
  __shared__ float s_rv[kMaxWarps];
  __shared__ int s_rj[kMaxWarps];
  __shared__ int s_ri[kMaxWarps];
  __shared__ float s_c1v;
  __shared__ int s_c1j;
  // node records, staged kRecChunk at a time, double-buffered
  __shared__ int4 s_rec[2][kRecChunk][2];

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
  float* s_dyn = reinterpret_cast<float*>(s_dyn4);
  float* ring = kSharedRing ? s_dyn : a.ring + (long long)b * K * stride;
  float* s_tab = kSharedRing ? s_dyn + K * stride : s_dyn;
  const int4* tab = a.table + (long long)b * N * 2;
  int16_t* bpb = a.bp + (long long)b * N * M;
  const bool vec_store = (M % L == 0) && i0 + L <= M;

  // the substitution factor for each pair of IUPAC masks: the scheme's
  // match/mismatch value, or with the matrix scheme the mean of S[l, r] over
  // the letter pairs (graph_pallas.py:131-146, 177-188), in its f32 order
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
        pn = add(pn, bl);
        numer = add(numer, mul(bl, sql));
      }
      v = __fdiv_rn(numer, fmaxf(mul(pn, pq), 1.0f));
    } else {
      v = (nm & q) ? a.match : a.mismatch;
    }
    s_sfac[e] = (double)v;
  }

  int qoff[L];       // the query mask at each lane: its column in s_sfac
  double lane_d[L];  // i as double
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = i0 + k;
    qoff[k] = i < M ? a.qmask[(long long)b * M + i] & 15 : 0;
    lane_d[k] = (double)i;
  }
  const double lm1_d = (double)(i0 - 1);
  for (int s = 0; s < K; ++s) {
    float* row = ring + s * stride;
#pragma unroll
    for (int k = 0; k < L; k += 4) {
      *reinterpret_cast<float4*>(row + i0 + k) = make_float4(kBig, kBig, kBig, kBig);
      *reinterpret_cast<float4*>(row + Mp + i0 + k) = make_float4(kBig, kBig, kBig, kBig);
    }
    row[2 * Mp + t] = kBig;
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
  // the last computed node's rows, stored again for a repeated node
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

  stage_records(s_rec[0], tab, 0, N, t, nthreads);
  int4 p0 = make_int4(0, 0, 0, 0), p1 = p0;  // node j-1's record
  int slot = 0;      // j mod K
  int parity = 0;    // computed nodes mod 2: the scan's buffer
  for (int j = 0; j < N; ++j) {
    const int jj = j % kRecChunk;
    if (jj == 0) {
      // this chunk's records have landed (all threads' copies), and every
      // read of the other buffer (the previous chunk's) is done: refill it
      // with the next chunk
      cp_async_wait_all();
      __syncthreads();
      if (j + kRecChunk < N) {
        stage_records(s_rec[(j / kRecChunk + 1) & 1], tab, j + kRecChunk, N, t, nthreads);
      }
    }
    const int4* rec = s_rec[(j / kRecChunk) & 1][jj];
    const int4 r0 = rec[0];
    const int4 r1 = rec[1];
    float* out_row = ring + slot * stride;
    int16_t* bp_row = bpb + (long long)j * M;

    if (j > 0 && r1.y == 0 && same_record(r0, r1, p0, p1)) {
      // a repeated node (no predecessors, the previous node's record)
#pragma unroll
      for (int k = 0; k < L; k += 4) {
        *reinterpret_cast<float4*>(out_row + i0 + k) =
            make_float4(Vrow[k], Vrow[k + 1], Vrow[k + 2], Vrow[k + 3]);
        *reinterpret_cast<float4*>(out_row + Mp + i0 + k) =
            make_float4(Drow[k], Drow[k + 1], Drow[k + 2], Drow[k + 3]);
      }
      out_row[2 * Mp + t] = vleft;
      if (vec_store) {
        store_cells<L>(bp_row + i0, cells);
      } else {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (i0 + k < M) bp_row[i0 + k] = (int16_t)(cells[k >> 1] >> (16 * (k & 1)));
        }
      }
    } else {
      const float subw = __int_as_float(r0.x);
      const float dgo = __int_as_float(r0.y);
      const float dge = __int_as_float(r0.z);
      const float gio = __int_as_float(r0.w);
      const float gie = __int_as_float(r1.x);
      const double subw_d = (double)subw;
      const double gie_d = (double)gie;
      unsigned predbits = (unsigned)r1.y;
      const int nmask = r1.z & 0xF;
      const int flags = (r1.z >> 8) & 0xFF;
      const int budget = r1.w;
      const bool startb = flags & 1;
      const bool endb = flags & 2;
      const bool validb = flags & 4;
      const double* sfrow = s_sfac + 16 * nmask;

      // predecessor probe over the set distances, ascending, <= on ties
      float vmin[L], dmin[L];
      int md[L], dd[L];
      bool dop[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        vmin[k] = kBig;
        dmin[k] = kBig;
        md[k] = 0;
        dd[k] = 0;
        dop[k] = false;
      }
      float vml = kBig;  // lane i0-1
      int mdl = 0;
      while (predbits) {
        const int d = __ffs(predbits) - 1;
        predbits &= predbits - 1;
        int ps = slot - d;
        if (ps < 0) ps += K;
        const float* row = ring + ps * stride;
        float Vp[L], Dp[L];
#pragma unroll
        for (int k = 0; k < L; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + i0 + k);
          const float4 w = *reinterpret_cast<const float4*>(row + Mp + i0 + k);
          Vp[k] = v.x; Vp[k + 1] = v.y; Vp[k + 2] = v.z; Vp[k + 3] = v.w;
          Dp[k] = w.x; Dp[k + 1] = w.y; Dp[k + 2] = w.z; Dp[k + 3] = w.w;
        }
        const float vl = row[2 * Mp + t];
        if (vl <= vml) {
          vml = vl;
          mdl = d;
        }
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (Vp[k] <= vmin[k]) {
            vmin[k] = Vp[k];
            md[k] = d;
          }
          const float do_ = add(Vp[k], dgo);
          const float de_ = add(Dp[k], dge);
          const float dc = fminf(do_, de_);
          if (dc <= dmin[k]) {
            dmin[k] = dc;
            dd[k] = d;
            dop[k] = do_ < de_;
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
        // the match reads the best predecessor at lane i-1 (BIG / 0 left of lane 0)
        const float vsh = k == 0 ? (t > 0 ? vml : kBig) : vmin[k - 1];
        const int msh = k == 0 ? (t > 0 ? mdl : 0) : md[k - 1];
        const float mc = fma_d(sfrow[qoff[k]], subw_d, vsh);
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
        bits[k] = code | (msh << 2) | (dd[k] << 7) | (dop[k] ? 1 << 12 : 0);
        ugio[k] = add(u, gio);
        cand[k] = fma_d(-(lane_d[k] + 1.0), gie_d, ugio[k]);
        if (k < L - 1) part = fminf(part, cand[k]);
      }
      const float tot = fminf(part, cand[L - 1]);
      const dp::ScanOut sc =
          dp::block_min_scan(tot, part, U[L - 1], s_scan, parity, warp, wl);
      parity ^= 1;

      // prefix[k]: the insertion value's start at lane i0+k; pprev: at lane i0-1
      float prefix[L];
      float pprev = kBig;
      if (!a.aspace) {
        // unbounded runs: min(cand[0..i-1], 1) (graph_pallas.py:251-259)
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
        // clip(budget, 1, M), BIG where budget < 1 (graph_pallas.py:79-104,
        // 242-250); sparse-table doubling over two shared buffers. The
        // scan's barrier separates the previous node's table reads from
        // these writes.
        float* cur = s_tab;
        float* nxt = s_tab + Mp;
#pragma unroll
        for (int k = 0; k < L; ++k) cur[i0 + k] = cand[k];
        const int R = min(max(budget, 1), M);
        const int lv = 31 - __clz(R);
        for (int s = 0; s < lv; ++s) {
          __syncthreads();
          const int sh = 1 << s;
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const int x = i0 + k;
            nxt[x] = fminf(cur[x], x >= sh ? cur[x - sh] : kBig);
          }
          float* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
        __syncthreads();
        const int off = R - (1 << lv);
        // wm(x) = min(cand[x-R+1 .. x])
        auto wm = [&](int x) {
          const int y = x - off;
          return fminf(cur[x], y >= 0 ? cur[y] : kBig);
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
        iprev = fma_d(lm1_d, gie_d, pprev);
        uprev = sc.prev_last;
      }
      vleft = (iprev <= uprev) ? iprev : uprev;
      float uprev_gio = add(uprev, gio);

#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float irow = fma_d(lane_d[k], gie_d, prefix[k]);
        // opened at i (vs extended): U[i-1]+go <= I[i-1]+ge
        const bool ins_opened = uprev_gio <= add(iprev, gie);
        const bool take_i = irow <= U[k];  // ties -> insertion
        Vrow[k] = take_i ? irow : U[k];
        const uint32_t cell = (uint32_t)((take_i ? kCodeIns : (bits[k] & 3)) | (bits[k] & ~3) |
                                         (ins_opened ? 1 << 13 : 0)) & 0xFFFFu;
        if (k & 1) {
          cells[k >> 1] |= cell << 16;
        } else {
          cells[k >> 1] = cell;
        }
        iprev = irow;
        uprev_gio = ugio[k];
      }
      if (vec_store) {
        store_cells<L>(bp_row + i0, cells);
      } else {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (i0 + k < M) bp_row[i0 + k] = (int16_t)(cells[k >> 1] >> (16 * (k & 1)));
        }
      }

#pragma unroll
      for (int k = 0; k < L; k += 4) {
        *reinterpret_cast<float4*>(out_row + i0 + k) =
            make_float4(Vrow[k], Vrow[k + 1], Vrow[k + 2], Vrow[k + 3]);
        *reinterpret_cast<float4*>(out_row + Mp + i0 + k) =
            make_float4(Drow[k], Drow[k + 1], Drow[k + 2], Drow[k + 3]);
      }
      out_row[2 * Mp + t] = vleft;

      // running best-cell candidates, strict < (the earliest j)
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
    }
    p0 = r0;
    p1 = r1;
    slot = slot + 1 == K ? 0 : slot + 1;
  }

  // reduce: c2 by (v, j, lane), lowest first (graph_pallas.py:298-330)
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

template <int L, bool kShared>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&graph_dp_kernel<L, kShared>);
}

const void* kernel_for(int L, bool shared) {
  switch (L) {
    case 4: return shared ? kernel_ptr<4, true>() : kernel_ptr<4, false>();
    case 8: return shared ? kernel_ptr<8, true>() : kernel_ptr<8, false>();
    case 16: return shared ? kernel_ptr<16, true>() : kernel_ptr<16, false>();
    case 32: return shared ? kernel_ptr<32, true>() : kernel_ptr<32, false>();
    default: return nullptr;
  }
}

struct Plan {
  int lanes, threads, shared_ring, dyn_smem, static_smem, regs, Mp, stride, kmax;
};

cudaError_t make_plan(int M, int K, int aspace, Plan* p) {
  if (M <= 0 || M > 32 * kMaxThreads || K < 2 || K > kMaxRing) return cudaErrorInvalidValue;
  p->lanes = lanes_for(M);
  p->threads = threads_for(M, p->lanes);
  if (p->threads > kMaxThreads) return cudaErrorInvalidValue;
  p->Mp = p->threads * p->lanes;
  p->stride = 2 * p->Mp + p->threads;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel_for(p->lanes, true));
  if (e != cudaSuccess) return e;
  const long long table = aspace ? 2LL * p->Mp * (long long)sizeof(float) : 0;
  const long long slot = (long long)p->stride * (long long)sizeof(float);
  // the deepest ring that fits beside the static shared memory and the table
  const long long room = (long long)optin - (long long)attr.sharedSizeBytes - table;
  p->kmax = (int)(room < 0 ? 0 : room / slot < kMaxRing ? room / slot : kMaxRing);
  p->shared_ring = K <= p->kmax;
  if (!p->shared_ring) {
    e = cudaFuncGetAttributes(&attr, kernel_for(p->lanes, false));
    if (e != cudaSuccess) return e;
  }
  p->dyn_smem = (int)((p->shared_ring ? K * slot : 0) + table);
  p->static_smem = (int)attr.sharedSizeBytes;
  p->regs = attr.numRegs;
  return cudaSuccess;
}

}  // namespace

// The launch plan for M query positions, ring depth K and forbid mode or
// not: out[0..7] = lanes a thread, threads, ring in
// shared memory (1) or in the global scratch (0), dynamic and static shared
// memory bytes a block, registers a thread, floats of global ring scratch a
// query needs on the global route (0 on the shared one), and the largest K
// whose ring fits shared memory. Returns a cudaError_t.
extern "C" int sina_graph_dp_plan(int M, int K, int aspace, long long* out) {
  Plan p;
  const cudaError_t e = make_plan(M, K, aspace, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.lanes;
  out[1] = p.threads;
  out[2] = p.shared_ring;
  out[3] = p.dyn_smem;
  out[4] = p.static_smem;
  out[5] = p.regs;
  out[6] = p.shared_ring ? 0 : (long long)K * p.stride;
  out[7] = p.kmax;
  return 0;
}

// table (B, N, 8) int32: subw, dgo, dge, gio, gie (float32 bits), predbits,
// mask | flags << 8, insertion budget; qmask (B, M) uint8; qlen (B,) int32;
// smat (B, 16) float32 (read only with matrix != 0); bp (B, N, M) int16;
// best (B, 8) float32; ring: null on the shared-ring route, else B times
// the plan's out[6] floats. 2 <= K <= 32 exceeds the largest predecessor
// distance; 1 <= M <= 16384. Returns cudaGetLastError() (cudaErrorInvalidValue
// for unsupported shapes or a ring pointer that does not match the plan).
extern "C" int sina_graph_dp(const void* table, const void* qmask, const void* qlen,
                             const void* smat, void* bp, void* best, void* ring, int B, int N,
                             int M, int K, int aspace, int matrix, float match, float mismatch,
                             void* stream) {
  if (B == 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(M, K, aspace, &p);
  if (e != cudaSuccess) return (int)e;
  if ((ring == nullptr) != (p.shared_ring != 0)) return (int)cudaErrorInvalidValue;
  GraphArgs a;
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
  const void* fn = kernel_for(p.lanes, p.shared_ring != 0);
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
