// Fused profile chain DP, one block per query row.
//
// Replaces sina_tpu/ops/profile_pallas.py _fused_kernel (chain_dp_pallas_fused),
// together with the quantised-profile unpack of sina_tpu/ops/profile.py
// _device_unpack_fgq and the dedup fam_idx gather in front of it. Per profile
// column j and query position i it computes the substitution cost from the 4
// quantised column frequencies and the query's IUPAC mask, the affine deletion
// track scaled by column occupancy, the diagonal match, the Gotoh insertion
// track as a prefix-min over i, and the running end-cell selection
// (mesh.h:569-592 tie order). Outputs: bp (C, B, M) uint8 (bits 0-1 code,
// bit 2 deletion opened, bit 3 insertion opened), best_c, best_i (B,) int32
// and raw (B,) float32.
//
// What bounds it: the recurrence over columns is sequential, one block per
// query row, and the bytes are small (6 profile bytes in and M backpointer
// bytes out per row and column: the whole bp plane at C=2048, B=128, M=1536
// is 403 MB). A column is bound by its instructions and their latency on
// one SM, so the design takes work and waits out of the column loop:
//
// - The substitution cost of a column depends on the query position only
//   through its 4-bit IUPAC mask: a column's 16 costs (BIG past the row's
//   last real column), with its two deletion costs, are computed once, in
//   the reference's operation order, into a shared-memory table, a chunk of
//   kChunk columns at a time, by all threads together: the profile's bytes
//   are staged there, off the column loop's dependency chain, and no thread
//   repeats another's column arithmetic. A lane reads its cost with one
//   shared load indexed by its mask.
// - The V and D rows stay in registers: each thread owns K consecutive query
//   positions, with their lane constants ((i+1)*ge, i*ge, the mask index)
//   computed once. The insertion prefix-min is a running min inside the
//   thread plus the two-level block scan of dp_scan.cuh: one barrier a
//   column. The lane shifts need only the neighbouring thread's last value.
// - The backpointer row goes out as one 4-byte store per 4 lanes.
// - End selection needs no per-column reduction: the candidate-1 cell is
//   owned by one thread, and the candidate-2 row argmin runs once, at column
//   c_real-1.
//
// All f32 arithmetic keeps the reference's operation order through explicit
// round-to-nearest intrinsics (the library is also built with --fmad=false),
// so nothing contracts to FMA and the results are bit-equal to the plain
// PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dp_scan.cuh"

namespace {

constexpr float kBig = 1e6f;
constexpr int kCodeMatch = 1;
constexpr int kCodeDel = 2;
constexpr int kCodeIns = 3;
constexpr int kChunk = 256;  // profile columns staged at a time
// query positions a thread owns at the main path's widths (M <= 2048); chosen
// on the card between 4 (384 threads at M = 1536) and 8 (PERF.md)
constexpr int kDefaultLanes = 4;

struct DpScalars {
  float go;             // gap open
  float ge;             // gap extend
  float m_minus_mm;     // f32(match - mismatch)
  float mm;             // mismatch
  float inv255;         // f32(1/255)
  float inv_gap_scale;  // f32(1/_gap_scale(params))
};

// one staged column: the substitution cost for each query IUPAC mask and
// the occupancy-scaled deletion open/extend costs
struct Column {
  float s[16];
  float dgo, dge, pad0, pad1;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// the most threads a block of K lanes a thread may have: 512 (128 registers
// a thread) up to 8 lanes, 1024 at 16 (M up to 16384)
#define SINA_PROFILE_MAX_THREADS(K) ((K) <= 8 ? 512 : 1024)

// columns [chunk * kChunk, +kChunk) of the row's profile into `dst`, one
// (column, query mask) entry a thread at a time, in the operations of
// profile_pallas.py:90-102 (the plain version's order)
__device__ __forceinline__ void stage_columns(Column* dst, const uint8_t* prof, int chunk, int C,
                                              int cr, const DpScalars& p, int t, int nthreads) {
  for (int e = t; e < kChunk * 16; e += nthreads) {
    const int c = e >> 4, m = e & 15;
    const int j = chunk * kChunk + c;
    if (j >= C) break;
    const uint8_t* col = prof + (long long)j * 6;
    const float f0 = mul((float)col[0], p.inv255);
    const float f1 = mul((float)col[1], p.inv255);
    const float f2 = mul((float)col[2], p.inv255);
    const float f3 = mul((float)col[3], p.inv255);
    const int16_t gq = (int16_t)((uint16_t)col[4] | ((uint16_t)col[5] << 8));
    const float gap = mul((float)gq, p.inv_gap_scale);
    const float occ = add(add(add(f0, f1), f2), f3);
    // the query side of mask m: 1/popcount and the per-letter weights
    const float cnt = (float)((m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1));
    const float inv = cnt > 0.0f ? __fdiv_rn(1.0f, fmaxf(cnt, 1.0f)) : 0.0f;
    const float qs = mul(cnt, inv);
    const float w0 = (m & 1) ? inv : 0.0f;
    const float w1 = ((m >> 1) & 1) ? inv : 0.0f;
    const float w2 = ((m >> 2) & 1) ? inv : 0.0f;
    const float w3 = ((m >> 3) & 1) ? inv : 0.0f;
    const float dot = add(add(add(mul(f0, w0), mul(f1, w1)), mul(f2, w2)), mul(f3, w3));
    dst[c].s[m] =
        j >= cr ? kBig : add(add(mul(p.m_minus_mm, dot), mul(mul(p.mm, occ), qs)), gap);
    if (m == 0) {
      dst[c].dgo = mul(p.go, occ);
      dst[c].dge = mul(p.ge, occ);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(SINA_PROFILE_MAX_THREADS(K))
profile_dp_kernel(const uint8_t* __restrict__ fgq, const int32_t* __restrict__ fam_idx,
                  const uint8_t* __restrict__ qmask, const int32_t* __restrict__ lens,
                  uint8_t* __restrict__ bp, int32_t* __restrict__ best_c,
                  int32_t* __restrict__ best_i, float* __restrict__ raw, int B, int C,
                  int M, DpScalars p) {
  // double-buffered by chunk parity: chunk c+1 is written while chunk c is read
  __shared__ Column s_col[2][kChunk];
  __shared__ dp::ScanSlots s_scan;
  __shared__ float s_rv[dp::kMaxWarps];
  __shared__ int s_ri[dp::kMaxWarps];
  __shared__ float s_b1v;
  __shared__ int s_b1j;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = t >> 5;
  const int wl = t & 31;
  const int nwarps = nthreads >> 5;
  const int lane0 = t * K;
  const int ql = lens[2 * b];
  const int cr = lens[2 * b + 1];
  const int q1 = ql - 1;
  const uint8_t* prof = fgq + (long long)(fam_idx ? fam_idx[b] : b) * C * 6;

  // lane constants: the byte offset of the lane's mask in a column's
  // costs, (i+1)*ge, i*ge
  int qb[K];
  float ge_i1[K], ge_i[K], Vp[K], Dp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane0 + k;
    qb[k] = 4 * (i < M ? qmask[(long long)b * M + i] & 15 : 0);
    ge_i1[k] = mul(add((float)i, 1.0f), p.ge);
    ge_i[k] = mul((float)i, p.ge);
    Vp[k] = kBig;
    Dp[k] = kBig;
  }
  const float ge_lm1 = mul((float)(lane0 - 1), p.ge);
  if (t == 0) {
    s_b1v = kBig;
    s_b1j = 0;
  }
  stage_columns(s_col[0], prof, 0, C, cr, p, t, nthreads);
  __syncthreads();

  float b1v = kBig, b2v = kBig;  // candidate 1 (owner of lane ql-1), candidate 2 (thread 0)
  int b1j = 0, b2i = 0;
  float vprev0 = kBig;  // previous column's V at lane lane0-1
  int chunk = 0, jc = 0;
  uint8_t* bp_row = bp + (long long)b * M + lane0;  // column j's row b, lane lane0

  for (int j = 0; j < C; ++j) {
    const Column& col = s_col[chunk & 1][jc];
    const float dgo = col.dgo;
    const float dge = col.dge;

    float U[K], cand[K], ugo[K];
    int bits[K];
    float part = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s =
          *reinterpret_cast<const float*>(reinterpret_cast<const char*>(col.s) + qb[k]);
      const float base = (j == 0 || lane0 + k == 0) ? 1.0f : kBig;
      const float d_open = add(Vp[k], dgo);
      const float d_ext = add(Dp[k], dge);
      const float dmin = fminf(d_open, d_ext);
      bits[k] = (d_open < d_ext) ? 4 : 0;
      Dp[k] = fminf(base, dmin);
      const float mc = add(k == 0 ? vprev0 : Vp[k - 1], s);
      float u = base;
      int code = 0;
      if (dmin < u) {
        u = dmin;
        code = kCodeDel;
      }
      if (mc < u) {
        u = mc;
        code = kCodeMatch;
      }
      U[k] = u;
      bits[k] |= code;
      ugo[k] = add(u, p.go);
      cand[k] = sub(ugo[k], ge_i1[k]);
      if (k < K - 1) part = fminf(part, cand[k]);
    }
    const float tot = fminf(part, cand[K - 1]);
    const dp::ScanOut sc =
        dp::block_min_scan(tot, part, U[K - 1], s_scan, j & 1, warp, wl);

    // the next chunk's columns: the buffer's previous reads (chunk-1) are
    // behind the barrier just passed, and its first read (column
    // (chunk+1)*kChunk) comes after at least one more barrier
    if (jc == 0 && (chunk + 1) * kChunk < C) {
      stage_columns(s_col[(chunk + 1) & 1], prof, chunk + 1, C, cr, p, t, nthreads);
    }

    // lane lane0-1 (the previous thread's last lane): its I and U
    float iprev0 = kBig, uprev0 = kBig;
    float run = CUDART_INF_F;  // min cand over lanes < lane0
    if (t > 0) {
      run = sc.excl;
      iprev0 = add(fminf(sc.tail, 1.0f), ge_lm1);
      uprev0 = sc.prev_last;
    }
    float Vrow[K];
    float iprev = iprev0;
    float uprev_go = add(uprev0, p.go);
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane0 + k;
      const float irow = add(fminf(run, 1.0f), ge_i[k]);
      run = fminf(run, cand[k]);
      const bool ins_opened = uprev_go <= add(iprev, p.ge);
      const bool take_i = irow <= U[k];
      Vrow[k] = take_i ? irow : U[k];
      // bits: the code in bits 0-1 (never kCodeIns), deletion opened in bit 2
      const int cell = (take_i ? bits[k] | kCodeIns : bits[k]) | (ins_opened ? 8 : 0);
      word |= (uint32_t)cell << (8 * (k & 3));
      if ((k & 3) == 3) {
        if (i < M) {
          *reinterpret_cast<uint32_t*>(bp_row + k - 3) = word;
        }
        word = 0;
      }
      iprev = irow;
      uprev_go = ugo[k];
    }
    vprev0 = (iprev0 <= uprev0) ? iprev0 : uprev0;

    // end-cell candidate 1: V at lane ql-1 over the real columns
    if (q1 >= lane0 && q1 < lane0 + K && q1 < M) {
      float v1 = kBig;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane0 + k == q1) v1 = fminf(Vrow[k], kBig);
      }
      if (j < cr && v1 < b1v) {
        b1v = v1;
        b1j = j;
      }
    }
    // end-cell candidate 2: row argmin over lanes < ql at the last real column
    if (j == cr - 1) {
      float v = CUDART_INF_F;
      int vi = 0x7FFFFFFF;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = lane0 + k;
        if (i < M) {
          const float c2 = i < ql ? Vrow[k] : kBig;
          if (c2 < v) {
            v = c2;
            vi = i;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(dp::kFull, v, off);
        const int oi = __shfl_down_sync(dp::kFull, vi, off);
        if (ov < v || (ov == v && oi < vi)) {
          v = ov;
          vi = oi;
        }
      }
      if (wl == 0) {
        s_rv[warp] = v;
        s_ri[warp] = vi;
      }
      __syncthreads();
      if (t == 0) {
        for (int w = 1; w < nwarps; ++w) {
          if (s_rv[w] < v || (s_rv[w] == v && s_ri[w] < vi)) {
            v = s_rv[w];
            vi = s_ri[w];
          }
        }
        b2v = v;
        b2i = vi;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) Vp[k] = Vrow[k];
    bp_row += (long long)B * M;
    if (++jc == kChunk) {
      jc = 0;
      ++chunk;
    }
  }

  __syncthreads();
  if (q1 >= lane0 && q1 < lane0 + K && q1 < M) {
    s_b1v = b1v;
    s_b1j = b1j;
  }
  __syncthreads();
  if (t == 0) {
    const bool use2 = b2v < s_b1v;
    best_c[b] = use2 ? cr - 1 : s_b1j;
    best_i[b] = use2 ? b2i : ql - 1;
    raw[b] = use2 ? b2v : s_b1v;
  }
}

// kDefaultLanes, doubled until the block fits (M <= 2048 at 4 lanes, 4096
// at 8, 16384 at 16)
int lanes_for(int M) {
  int K = kDefaultLanes;
  while (K < 16 && M > K * 512) K *= 2;
  return K;
}

int threads_for(int M, int K) { return ((M + K - 1) / K + 31) / 32 * 32; }

const void* kernel_for(int K) {
  switch (K) {
    case 4: return reinterpret_cast<const void*>(&profile_dp_kernel<4>);
    case 8: return reinterpret_cast<const void*>(&profile_dp_kernel<8>);
    case 16: return reinterpret_cast<const void*>(&profile_dp_kernel<16>);
    default: return nullptr;
  }
}


}  // namespace

// The launch plan for M query positions: out[0..3] = lanes a thread,
// threads, static shared memory bytes a block, registers a thread. Returns a
// cudaError_t (cudaErrorInvalidValue for an unsupported M).
extern "C" int sina_profile_dp_plan(int M, long long* out) {
  if (M % 4 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int K = lanes_for(M);
  const int threads = threads_for(M, K);
  if (threads > SINA_PROFILE_MAX_THREADS(K)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_for(K));
  if (e != cudaSuccess) return (int)e;
  out[0] = K;
  out[1] = threads;
  out[2] = (long long)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  return 0;
}

// fgq (U, C, 6) uint8; fam_idx (B,) int32 or null (row b reads profile b);
// qmask (B, M) uint8; lens (B, 2) int32 = (qlen, c_real); bp (C, B, M) uint8;
// best_c, best_i (B,) int32; raw (B,) float32. M % 4 == 0 and M <= 16384.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported M).
extern "C" int sina_profile_dp(const void* fgq, const void* fam_idx, const void* qmask,
                               const void* lens, void* bp, void* best_c, void* best_i,
                               void* raw, int B, int C, int M, float go, float ge,
                               float m_minus_mm, float mm, float inv255,
                               float inv_gap_scale, void* stream) {
  if (B == 0) return 0;
  if (M % 4 != 0 || M <= 0 || C < 0) return (int)cudaErrorInvalidValue;
  const int K = lanes_for(M);
  const int threads = threads_for(M, K);
  if (threads > SINA_PROFILE_MAX_THREADS(K)) return (int)cudaErrorInvalidValue;
  DpScalars p{go, ge, m_minus_mm, mm, inv255, inv_gap_scale};
  const uint8_t* fgq_p = static_cast<const uint8_t*>(fgq);
  const int32_t* fam_p = static_cast<const int32_t*>(fam_idx);
  const uint8_t* qm_p = static_cast<const uint8_t*>(qmask);
  const int32_t* lens_p = static_cast<const int32_t*>(lens);
  uint8_t* bp_p = static_cast<uint8_t*>(bp);
  int32_t* bc_p = static_cast<int32_t*>(best_c);
  int32_t* bi_p = static_cast<int32_t*>(best_i);
  float* raw_p = static_cast<float*>(raw);
  void* args[] = {&fgq_p, &fam_p, &qm_p, &lens_p, &bp_p, &bc_p, &bi_p, &raw_p, &B, &C, &M, &p};
  const cudaError_t e = cudaLaunchKernel(kernel_for(K), dim3(B), dim3(threads), args, 0,
                                         static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
