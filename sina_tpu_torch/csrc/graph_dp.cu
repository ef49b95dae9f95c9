// POA graph DP (the mseq engine), one block per query.
//
// Replaces sina_tpu/ops/graph_pallas.py _graph_kernel (graph_dp_pallas_packed,
// with _windowed_min_rows for the bounded insertion track). Per graph node j,
// in topological order, and query position i it computes the substitution
// cost in-kernel (IUPAC compatibility times the node's weight, or the mean of
// a 4x4 substitution matrix over the letter pairs), the affine deletion track
// over the node's predecessors, the diagonal match from the best predecessor
// at i-1, and the Gotoh insertion track as a prefix-min over i (or, for
// --insertion forbid, a trailing-window min bounded by the node's insertion
// budget). It writes the uint16 backpointer plane in the reference's bit
// layout (bits 0-1 code, 2-6 match distance, 7-11 deletion distance, 12
// deletion opened, 13 insertion opened) as (B, N, M), and the running
// best-cell candidates of mesh.h:569-592 as (B, 8) float32 (v1, j1, v2, j2,
// i2); ops/graph_kernel.py decodes those.
//
// What bounds it: the recurrence over nodes is sequential, and each node does
// ~60 f32 operations per query position, one block-wide prefix-min (two
// barriers) and a dependent read of its predecessors' rows. The bytes are
// small: 32 bytes of node scalars in, 2 bytes of backpointer out per lane and
// node (the plane at N=4096, B=128, M=1536 is 1.6 GB, written once). So it is
// bound by barrier and memory latency, with B blocks in flight.
//
// Design: the TPU's sequential grid axis over nodes becomes a loop inside the
// block. The TPU kept a (K, B, M) ring of the last K V and D rows in VMEM; a
// query's ring (K x M x 2 x 4 B = 384 KB at K=32, M=1536) does not fit an SM's
// shared memory, so it lives in a per-query global scratch (L2-resident). Each
// thread owns L consecutive query positions and reads and writes ring rows
// only at its own lanes, so the ring needs no barrier. The one value a lane
// needs from its left neighbour's predecessor rows, V at lane i0-1, is
// recomputed by the thread itself from the scan results (as the profile DP
// does) and kept in its own ring column. The predecessor probe visits only
// the set bits of the node's distance mask, ascending, with <= (ties keep the
// largest distance = the lowest predecessor id, graph_pallas.py:196-221). The
// insertion prefix-min is a running min in the thread plus one block scan; the
// bounded one is a sparse table (log2 R doubling rounds in shared memory, R
// block-uniform per node). Three multiply-adds are rounded once, as the
// reference's compiled kernel contracts them to FMA: each is computed in
// double (the f32 product is exact there) and rounded to f32, the same
// operations the plain PyTorch version does, so the two agree bit for bit. All
// other f32 arithmetic keeps the reference's order through explicit
// round-to-nearest intrinsics (the library is built with --fmad=false).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 1e6f;
constexpr int kCodeEdge = 0;
constexpr int kCodeMatch = 1;
constexpr int kCodeDel = 2;
constexpr int kCodeIns = 3;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
// a * b + c, rounded to f32 once after an exact product
__device__ __forceinline__ float fma_d(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

struct GraphArgs {
  const int4* table;     // (B, N, 2) int4 = per-node record, see ops/graph_kernel.py
  const uint8_t* qmask;  // (B, M)
  const int32_t* qlen;   // (B,)
  const float* smat;     // (B, 16)
  int16_t* bp;           // (B, N, M)
  float* best;           // (B, 8)
  float* ring;           // (B, K, 2 * Mp + threads)
  int N, M, Mp, K;
  int aspace, matrix;
  float match, mismatch;
};

// (v, j, lane) lexicographic "less"
__device__ __forceinline__ bool lex_less(float v, int j, int i, float bv, int bj, int bi) {
  return v < bv || (v == bv && (j < bj || (j == bj && i < bi)));
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads) graph_dp_kernel(GraphArgs a) {
  extern __shared__ float s_tab[];  // aspace: two Mp-float sparse-table levels
  __shared__ float s_part[2][kMaxThreads];   // min cand over a thread's first L-1 lanes
  __shared__ float s_lastU[2][kMaxThreads];  // U of a thread's last lane
  __shared__ float s_incl[kMaxThreads];      // inclusive scan of per-thread cand minima
  __shared__ float s_wmin[kMaxWarps];
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
  const int M = a.M, Mp = a.Mp, K = a.K, N = a.N;
  const int ql = a.qlen[b];
  const int q1 = ql - 1;
  const long long stride = 2LL * Mp + nthreads;  // floats per ring slot
  float* ringb = a.ring + (long long)b * K * stride;
  const int4* tab = a.table + (long long)b * N * 2;
  int16_t* bpb = a.bp + (long long)b * N * M;

  int qm[L];
  float pq[L], sq[4][L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = i0 + k;
    qm[k] = i < M ? a.qmask[(long long)b * M + i] : 0;
    pq[k] = 0.0f;
  }
  if (a.matrix) {
    // Sq[l][i] = sum_r S[l, r] * bit_r(q_i) and the query letter counts
    // (graph_pallas.py:131-146)
    const float* S = a.smat + (long long)b * 16;
#pragma unroll
    for (int k = 0; k < L; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pq[k] = add(pq[k], (float)((qm[k] >> r) & 1));
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc = add(acc, mul(S[4 * l + r], (float)((qm[k] >> r) & 1)));
        sq[l][k] = acc;
      }
    }
  }
  for (int s = 0; s < K; ++s) {
    float* row = ringb + s * stride;
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

  float c1v = kBig;  // candidate 1: the owner of lane ql-1
  int c1j = 0;
  float c2v[L];  // candidate 2: per lane, end nodes
  int c2j[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    c2v[k] = kBig;
    c2j[k] = 0;
  }

  int4 r0 = tab[0];
  int4 r1 = tab[1];
  for (int j = 0; j < N; ++j) {
    const int buf = j & 1;
    // the next node's record, loaded while this node computes
    const int jn = j + 1 < N ? j + 1 : j;
    const int4 n0 = tab[2 * jn];
    const int4 n1 = tab[2 * jn + 1];
    const float subw = __int_as_float(r0.x);
    const float dgo = __int_as_float(r0.y);
    const float dge = __int_as_float(r0.z);
    const float gio = __int_as_float(r0.w);
    const float gie = __int_as_float(r1.x);
    unsigned predbits = (unsigned)r1.y;
    const int nmask = r1.z & 0xFF;
    const int flags = (r1.z >> 8) & 0xFF;
    const int budget = r1.w;
    const bool startb = flags & 1;
    const bool endb = flags & 2;
    const bool validb = flags & 4;

    // the substitution cost's factor; Mc multiplies it by subw
    float sfac[L];
    if (a.matrix) {
      float pn = 0.0f;
      float bl[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        bl[l] = (float)((nmask >> l) & 1);
        pn = add(pn, bl[l]);
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        float numer = 0.0f;
#pragma unroll
        for (int l = 0; l < 4; ++l) numer = add(numer, mul(bl[l], sq[l][k]));
        const float denom = fmaxf(mul(pn, pq[k]), 1.0f);
        sfac[k] = __fdiv_rn(numer, denom);
      }
    } else {
#pragma unroll
      for (int k = 0; k < L; ++k) sfac[k] = (nmask & qm[k] & 0xF) ? a.match : a.mismatch;
    }

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
      const float* row = ringb + ((j - d) & (K - 1)) * stride;
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

    float U[L], Drow[L], cand[L];
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
      const float mc = fma_d(sfac[k], subw, vsh);
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
      cand[k] = fma_d(-add((float)i, 1.0f), gie, add(u, gio));
      if (k < L - 1) part = fminf(part, cand[k]);
    }
    s_lastU[buf][t] = U[L - 1];

    // prefix[k]: the insertion value's start at lane i0+k; pprev: at lane i0-1
    float prefix[L];
    float pprev = kBig;
    if (!a.aspace) {
      // unbounded runs: min(cand[0..i-1], 1) (graph_pallas.py:251-259)
      const float tot = fminf(part, cand[L - 1]);
      s_part[buf][t] = part;
      float incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, incl, off);
        if (wl >= off) incl = fminf(incl, o);
      }
      if (wl == 31) s_wmin[warp] = incl;
      __syncthreads();
      for (int w = 0; w < warp; ++w) incl = fminf(incl, s_wmin[w]);
      s_incl[t] = incl;
      __syncthreads();
      float run = CUDART_INF_F;  // min cand over lanes < i0
      if (t > 0) {
        run = s_incl[t - 1];
        const float before_last = fminf(t > 1 ? s_incl[t - 2] : CUDART_INF_F, s_part[buf][t - 1]);
        pprev = fminf(before_last, 1.0f);
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        prefix[k] = fminf(run, 1.0f);
        run = fminf(run, cand[k]);
      }
    } else {
      // bounded runs, no edge seed (--insertion forbid, mesh.h:403-437):
      // prefix[i] = min(cand[i-R .. i-1]) with BIG left of lane 0, R =
      // clip(budget, 1, M), BIG where budget < 1 (graph_pallas.py:79-104,
      // 242-250); sparse-table doubling over two shared buffers
      __syncthreads();  // the previous node's table reads are done
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
      iprev = fma_d((float)(i0 - 1), gie, pprev);
      uprev = s_lastU[buf][t - 1];
    }
    const float vleft = (iprev <= uprev) ? iprev : uprev;

    float Vrow[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + k;
      const float irow = fma_d((float)i, gie, prefix[k]);
      // opened at i (vs extended): U[i-1]+go <= I[i-1]+ge
      const bool ins_opened = add(uprev, gio) <= add(iprev, gie);
      const bool take_i = irow <= U[k];  // ties -> insertion
      Vrow[k] = take_i ? irow : U[k];
      const int cell = (take_i ? kCodeIns : (bits[k] & 3)) | (bits[k] & ~3) | (ins_opened ? 1 << 13 : 0);
      if (i < M) bpb[(long long)j * M + i] = (int16_t)cell;
      iprev = irow;
      uprev = U[k];
    }

    float* row = ringb + (j & (K - 1)) * stride;
#pragma unroll
    for (int k = 0; k < L; k += 4) {
      *reinterpret_cast<float4*>(row + i0 + k) = make_float4(Vrow[k], Vrow[k + 1], Vrow[k + 2], Vrow[k + 3]);
      *reinterpret_cast<float4*>(row + Mp + i0 + k) = make_float4(Drow[k], Drow[k + 1], Drow[k + 2], Drow[k + 3]);
    }
    row[2 * Mp + t] = vleft;
    r0 = n0;
    r1 = n1;

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
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oj = __shfl_down_sync(kFull, vj, off);
    const int oi = __shfl_down_sync(kFull, vi, off);
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

// 4 lanes a thread up to M = 2048 (384 threads at the main path's 1536), more
// beyond, so that a block stays within 512 threads and 128 registers a thread
int lanes_per_thread(int M) {
  return M <= 4 * kMaxThreads ? 4 : M <= 8 * kMaxThreads ? 8 : M <= 16 * kMaxThreads ? 16 : 32;
}

int threads_for(int M) {
  const int L = lanes_per_thread(M);
  return ((M + L - 1) / L + 31) / 32 * 32;
}

template <int L>
cudaError_t launch(const GraphArgs& a, int B, int threads, cudaStream_t stream) {
  const size_t smem = a.aspace ? 2 * (size_t)a.Mp * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_dp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  graph_dp_kernel<L><<<B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of ring scratch one query needs: K slots of (V, D) rows over the
// block's lanes plus each thread's copy of V at the lane left of its own.
extern "C" long long sina_graph_dp_scratch(int M, int K) {
  const int threads = threads_for(M);
  return (long long)K * (2LL * threads * lanes_per_thread(M) + threads);
}

// table (B, N, 8) int32: subw, dgo, dge, gio, gie (float32 bits), predbits,
// mask | flags << 8, insertion budget; qmask (B, M) uint8; qlen (B,) int32;
// smat (B, 16) float32 (read only with matrix != 0); bp (B, N, M) int16;
// best (B, 8) float32; ring: B * sina_graph_dp_scratch(M, K) float32.
// K is a power of two above the largest predecessor distance, at most 32;
// 1 <= M <= 16384. Returns cudaGetLastError() (cudaErrorInvalidValue for
// unsupported shapes).
extern "C" int sina_graph_dp(const void* table, const void* qmask, const void* qlen,
                             const void* smat, void* bp, void* best, void* ring, int B, int N,
                             int M, int K, int aspace, int matrix, float match, float mismatch,
                             void* stream) {
  if (B == 0) return 0;
  if (M <= 0 || M > 32 * kMaxThreads || N <= 0 || K < 2 || K > 32 || (K & (K - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int L = lanes_per_thread(M);
  const int threads = threads_for(M);
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
  a.Mp = threads * L;
  a.K = K;
  a.aspace = aspace;
  a.matrix = matrix;
  a.match = match;
  a.mismatch = mismatch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 4) return (int)launch<4>(a, B, threads, s);
  if (L == 8) return (int)launch<8>(a, B, threads, s);
  if (L == 16) return (int)launch<16>(a, B, threads, s);
  return (int)launch<32>(a, B, threads, s);
}
