// Dense k-mer gather-sum:
//   S[b, s] = sum_l P[kmers[b, l], s]
// P is the (R+1, S) int8 incidence matrix (KmerIndex.dense, S padded to a
// multiple of 128 references); padding k-mers point at its all-zero last row.
// The output is (B, S) int32.
//
// Replaces sina_tpu/ops/kmer_kernel.py _pallas_kernel (kmer_scores_pallas),
// the scorer the JAX package's kmer_scores dispatch sends an int8 matrix to.
//
// What bounds it: device-memory bytes. Every query gathers L rows of S bytes
// (128 x 360 real k-mers x 16,384 B = 755 MB at a 16k-reference index),
// against one widening add per byte.
//
// Design: grid (16-byte column tiles of S) x B. A block serves one query: it
// stages that query's k-mer ids in shared memory (clamped into the matrix, as
// the packed kernel clamps them), so every thread reads the same id and the
// block reads one contiguous 4 KB tile of each gathered row, 16 bytes a thread
// (one 128-bit load). Each thread keeps 16 int32 column sums in registers and
// widens each int8 with a signed byte extract. The TPU's G = 8 row grouping
// and its SMEM batch chunking are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIdsPerChunk = 1024;

__device__ __forceinline__ void add_word(int32_t* acc, uint32_t w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j] += (int32_t)(int8_t)((w >> (8 * j)) & 0xFFu);
  }
}

__global__ void __launch_bounds__(kThreads)
kmer_dense_kernel(const int8_t* __restrict__ P, const int32_t* __restrict__ kmers,
                  int32_t* __restrict__ out, long long S, long long n_rows, int L) {
  __shared__ int32_t ids[kIdsPerChunk];
  const int b = blockIdx.y;
  const long long tile = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row_tiles = S / 16;
  const bool active = tile < row_tiles;
  int32_t acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0;
  const int4* rows = reinterpret_cast<const int4*>(P);

  for (int l0 = 0; l0 < L; l0 += kIdsPerChunk) {
    const int n = min(kIdsPerChunk, L - l0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      // an id outside [0, n_rows) (famfinder makes none) is clamped so
      // that it cannot read outside the matrix
      ids[i] = (int32_t)min(max((long long)kmers[(long long)b * L + l0 + i], 0LL), n_rows - 1);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int4 v = __ldg(rows + (long long)ids[i] * row_tiles + tile);
      add_word(acc + 0, (uint32_t)v.x);
      add_word(acc + 4, (uint32_t)v.y);
      add_word(acc + 8, (uint32_t)v.z);
      add_word(acc + 12, (uint32_t)v.w);
    }
  }
  if (!active) return;
  int4* dst = reinterpret_cast<int4*>(out + (long long)b * S + tile * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[q] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
}

}  // namespace

// P (n_rows, S) int8 with S % 16 == 0 and a 16-byte aligned base; kmers (B, L)
// int32; out (B, S) int32, 16-byte aligned. Returns cudaGetLastError().
extern "C" int sina_kmer_score_dense(const void* P, const void* kmers, void* out,
                                     long long S, long long n_rows, int B, int L,
                                     void* stream) {
  if (B == 0 || S == 0) return 0;
  const long long tiles = S / 16;
  const dim3 grid((unsigned)((tiles + kThreads - 1) / kThreads), (unsigned)B);
  kmer_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(P), static_cast<const int32_t*>(kmers),
      static_cast<int32_t*>(out), S, n_rows, L);
  return (int)cudaGetLastError();
}
