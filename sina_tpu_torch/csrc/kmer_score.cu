// Bitpacked k-mer gather-sum:
//   S[b, 8*byte + bit] = sum_l bit_(bit)(P[kmers[b, l], byte])
// P is the (R+1, Sb) uint8 incidence matrix (bit b of byte j = reference
// 8j+b, KmerIndex.dense_packed); padding k-mers point at its all-zero last
// row. Optional second output, the first stage of grouped_top_k:
//   gmax[b, byte] = max over bit of S[b, 8*byte + bit].
//
// Replaces sina_tpu/ops/kmer_kernel.py _pallas_kernel_packed
// (kmer_scores_packed_pallas) and _pallas_kernel_tiled
// (kmer_scores_packed_tiled_pallas): both compute this function over the
// same logical byte order, so one kernel over the flat matrix serves both.
//
// What bounds it: device-memory bytes. A query needs each distinct row it
// holds once (Sb = 12,544 bytes at the 100k-reference main path), and the
// scores are written once ((B, 8*Sb) int32, 51 MB at B = 128), against a few
// integer operations per byte.
//
// Design, against that bound:
// - Runs. A pre-pass (kmer_runs_kernel, one block a query) clamps the query's
//   ids into [0, R], sorts them in shared memory (bitonic, 4,096 ids at a
//   time; a longer query is sorted chunk by chunk) and writes its (row, count)
//   runs in ascending row order. A row is then gathered once a query however
//   often the query holds it (queries keep k-mer multiplicity): the ~150
//   padding ids of a full-length query become one read of the sink row.
// - Launch order. The scoring grid is (query, column tile) with the query the
//   fastest index, so the blocks that serve one tile for neighbouring queries
//   run side by side, each sweeping the matrix upward: a row that several
//   queries hold is read from device memory once and from L2 after that.
//   Random ids (chip_smoke.py phase 3) share few rows: 8% of the rows their
//   runs gather are another query's too. The queries of a real batch are
//   related rRNA genes and share many: a third in a steady main-path batch.
// - Loads. A thread owns V 32-bit words of each row: 4 (16-byte copies)
//   where Sb and P's address allow, else 1, chosen per launch. It
//   copies its words of 8 runs' rows at a time (a group) with cp.async into
//   a ring of 3 groups in shared memory, two groups ahead of the one it
//   counts: 16 copies in flight a thread. A tile is the row's chunks split
//   evenly over the fewest blocks of at most 128 threads (Sb = 12,544: 7
//   tiles of 112 16-byte chunks, none ragged).
// - Counting. The 8 rows' words go through a carry-save adder tree
//   (Harley-Seal) into bit-sliced counters of weights 1, 2 and 4; only its
//   weight-8 output is spread into 8-bit SWAR lanes (8 words, one per bit
//   position): ~6 integer operations per word and row instead of the 24 of
//   a SWAR add per row. A run of count c > 1 adds its row c & 7 times into
//   the bit-sliced counters and c >> 3 times into the lanes (one multiply-add
//   a bit). The lanes flush by the units they have taken in, before one could
//   pass 255, into wide counters held in the output itself (rare: a query of
//   360 distinct ids and a sink run of 150 takes 46 + 19 units); a run whose
//   count alone would pass that goes straight there.
//   The group maxima come from the final counts, already in registers.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// pre-pass: threads a block, ids sorted together (16 KB of shared memory)
constexpr int kSortThreads = 512;
constexpr int kSortChunk = 4096;
// scoring: threads a block at most, runs gathered together (one group),
// groups in a thread's ring in shared memory (kRing - 1 in flight while one
// is counted), runs staged in shared memory at a time (a multiple of kGroup)
constexpr int kMaxThreads = 128;
constexpr int kGroup = 8;
constexpr int kRing = 3;
constexpr int kStage = 512;
// a thread's 32 counts of one word as staged for the stores, padded so that
// 8 lanes' pieces fall in distinct banks
constexpr int kPiece = 36;
// an 8-bit SWAR lane counts units of 8 up to 255; a run of a larger count
// than kDirect would pass that alone
constexpr int kLaneMax = 255;
constexpr int kDirect = 8 * (kLaneMax - 1);
constexpr uint32_t kLow = 0x01010101u;

// Exclusive prefix sum of x over the block's kSortThreads threads; total
// gets the sum. Every thread must call it; sums holds 33 ints.
__device__ int block_exclusive_scan(int x, int* sums, int& total) {
  constexpr int kWarps = kSortThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? sums[lane] : 0;
    int winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += y;
    }
    if (lane < kWarps) sums[lane] = winc - w;
    if (lane == 31) sums[32] = winc;
  }
  __syncthreads();
  total = sums[32];
  return sums[warp] + inc - x;
}

// One block a query: its ids, clamped into [0, n_rows), sorted, as runs
// run_rows[b, r] (ascending within each chunk of kSortChunk ids) with
// run_counts[b, r] ids each; n_runs[b] runs in all.
__global__ void __launch_bounds__(kSortThreads)
kmer_runs_kernel(const int32_t* __restrict__ kmers, int L, long long n_rows,
                 int32_t* __restrict__ run_rows, int32_t* __restrict__ run_counts,
                 int32_t* __restrict__ n_runs) {
  __shared__ int32_t keys[kSortChunk];
  __shared__ int32_t heads[kSortChunk + 1];
  __shared__ int sums[33];
  const long long q = (long long)blockIdx.x * L;
  int base = 0;
  for (int l0 = 0; l0 < L; l0 += kSortChunk) {
    const int n = min(kSortChunk, L - l0);
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
    __syncthreads();  // the last chunk's runs are written
    for (int i = threadIdx.x; i < p2; i += kSortThreads) {
      keys[i] = i < n ? (int32_t)min(max((long long)kmers[q + l0 + i], 0LL), n_rows - 1)
                      : INT_MAX;
    }
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < p2; i += kSortThreads) {
          const int o = i ^ j;
          if (o > i) {
            const int32_t a = keys[i], c = keys[o];
            if ((a > c) == ((i & k) == 0)) {
              keys[i] = c;
              keys[o] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    // a run starts where the key changes; each thread scans a span
    const int per = (n + kSortThreads - 1) / kSortThreads;
    const int i0 = min((int)threadIdx.x * per, n), i1 = min(i0 + per, n);
    int mine = 0;
    for (int i = i0; i < i1; ++i) mine += (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
    int total;
    int r = block_exclusive_scan(mine, sums, total);
    for (int i = i0; i < i1; ++i) {
      if (i == 0 || keys[i] != keys[i - 1]) heads[r++] = i;
    }
    if (threadIdx.x == 0) heads[total] = n;
    __syncthreads();
    for (int t = threadIdx.x; t < total; t += kSortThreads) {
      run_rows[q + base + t] = keys[heads[t]];
      run_counts[q + base + t] = heads[t + 1] - heads[t];
    }
    base += total;
  }
  if (threadIdx.x == 0) n_runs[blockIdx.x] = base;
}

// full adder over 32 bit positions: a + b + c = sum + 2 * carry
__device__ __forceinline__ void csa(uint32_t& carry, uint32_t& sum, uint32_t a, uint32_t b,
                                    uint32_t c) {
  const uint32_t u = a ^ b;
  carry = (a & b) | (u & c);
  sum = u ^ c;
}

// the 8-bit lanes s[bit] (byte j of s[bit] counts bit 8j+bit) take in the
// bits of w, `times` each
__device__ __forceinline__ void lanes_add(uint32_t (&s)[8], uint32_t w, uint32_t times) {
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) s[bit] += ((w >> bit) & kLow) * times;
}

__device__ __forceinline__ int lane(uint32_t x, int j) { return (int)((x >> (8 * j)) & 0xFFu); }

// dst[8j + bit] = (dst[8j + bit] unless first) + scale * lane j of s[bit]:
// the 32 counts of one word, 16-byte aligned
__device__ __forceinline__ void wide_add(int32_t* dst, const uint32_t (&s)[8], int scale,
                                         bool first) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int4 v = make_int4(scale * lane(s[4 * h], j), scale * lane(s[4 * h + 1], j),
                         scale * lane(s[4 * h + 2], j), scale * lane(s[4 * h + 3], j));
      int4* p = reinterpret_cast<int4*>(dst + 8 * j + 4 * h);
      if (!first) {
        const int4 o = *p;
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      *p = v;
    }
  }
}

// Copies V words (4V bytes) from device memory to shared memory without
// passing through registers (cp.async; 16-byte copies bypass L1).
template <int V>
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint8_t* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of the thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int V>
__device__ __forceinline__ void load_shared(uint32_t (&w)[V], const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else {
    w[0] = *p;
  }
}

// Grid (B, tiles): block (b, t) scores query b on tile t, tile_chunks chunks
// of V words, one a thread. Each thread copies its own chunk of a group's 8
// rows into its slots of a ring of kRing groups in shared memory, kRing - 1
// groups ahead of the one it counts, and reads back only what it copied:
// the ring needs no barrier. All branches on runs are uniform over the block.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
kmer_score_kernel(const uint8_t* __restrict__ P, const int32_t* __restrict__ run_rows,
                  const int32_t* __restrict__ run_counts, const int32_t* __restrict__ n_runs,
                  int32_t* __restrict__ out, int32_t* __restrict__ gmax, long long Sb, int L,
                  int tile_chunks) {
  extern __shared__ __align__(16) uint32_t ring[];  // [kRing][kGroup][threads][V]
  __shared__ int32_t srow[kStage];
  __shared__ int32_t scnt[kStage];
  const int b = blockIdx.x;
  const long long chunk = (long long)blockIdx.y * tile_chunks + threadIdx.x;
  // a thread past the tile or the row copies nothing and stores nothing,
  // but reaches every barrier
  const long long n_chunks = Sb / (4 * V);
  const bool active = (int)threadIdx.x < tile_chunks && chunk < n_chunks;
  const uint8_t* col = P + chunk * 4 * V;
  int32_t* dst = out + (long long)b * 8 * Sb + chunk * 32 * V;
  uint32_t* mine = ring + threadIdx.x * V;
  const int slot_words = (int)blockDim.x * V;  // one row's chunks of the block
  const long long q = (long long)b * L;
  const int n = n_runs[b];

  uint32_t ones[V], twos[V], fours[V], lanes[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ones[v] = twos[v] = fours[v] = 0;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) lanes[v][bit] = 0;
  }
  int pending = 0;    // units of 8 the lanes took in since their last flush
  bool wide = false;  // the wide counters (in out) hold counts

  auto flush = [&]() {
    if (active) {
#pragma unroll
      for (int v = 0; v < V; ++v) wide_add(dst + 32 * v, lanes[v], 8, !wide);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) lanes[v][bit] = 0;
    }
    wide = true;
    pending = 0;
  };

  for (int r0 = 0; r0 < n; r0 += kStage) {
    const int m = min(kStage, n - r0);
    __syncthreads();  // the last stage's runs are read
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      srow[i] = run_rows[q + r0 + i];
      scnt[i] = run_counts[q + r0 + i];
    }
    __syncthreads();
    const int ng = (m + kGroup - 1) / kGroup;
    // every thread commits one group of copies per call, empty or not, so
    // that wait_copies counts the same groups in all threads
    auto issue = [&](int gi) {
      if (active && gi < ng) {
        uint32_t* slot = mine + (gi % kRing) * kGroup * slot_words;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int r = gi * kGroup + g;
          if (r < m) copy_async<V>(slot + g * slot_words, col + (long long)srow[r] * Sb);
        }
      }
      commit_copies();
    };
#pragma unroll
    for (int gi = 0; gi < kRing - 1; ++gi) issue(gi);
    for (int gi = 0; gi < ng; ++gi) {
      issue(gi + kRing - 1);
      wait_copies<kRing - 1>();  // group gi has landed
      const uint32_t* slot = mine + (gi % kRing) * kGroup * slot_words;
      unsigned single = 0, multi = 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int r = gi * kGroup + g;
        const int c = r < m ? scnt[r] : 0;
        single |= (unsigned)(c == 1) << g;
        multi |= (unsigned)(c > 1) << g;
      }
      if (pending == kLaneMax) flush();
      uint32_t x[kGroup][V];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if ((single >> g) & 1u) {
          load_shared<V>(x[g], slot + g * slot_words);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[g][v] = 0;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t t1a, t1b, t2a, t2b, f1a, f1b, e;
        csa(t1a, ones[v], ones[v], x[0][v], x[1][v]);
        csa(t1b, ones[v], ones[v], x[2][v], x[3][v]);
        csa(f1a, twos[v], twos[v], t1a, t1b);
        csa(t2a, ones[v], ones[v], x[4][v], x[5][v]);
        csa(t2b, ones[v], ones[v], x[6][v], x[7][v]);
        csa(f1b, twos[v], twos[v], t2a, t2b);
        csa(e, fours[v], fours[v], f1a, f1b);
        lanes_add(lanes[v], e, 1u);
      }
      ++pending;
      // the runs of count c > 1: c & 7 times into the bit-sliced counters,
      // c >> 3 times into the lanes, or straight into the wide counters
#pragma unroll 1
      for (int g = 0; multi >> g; ++g) {
        if (!((multi >> g) & 1u)) continue;
        const int c = scnt[gi * kGroup + g];
        uint32_t w[V];
        load_shared<V>(w, slot + g * slot_words);
        if (c > kDirect) {
          if (active) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              uint32_t s1[8];
#pragma unroll
              for (int bit = 0; bit < 8; ++bit) s1[bit] = (w[v] >> bit) & kLow;
              wide_add(dst + 32 * v, s1, c, !wide);
            }
          }
          wide = true;
          continue;
        }
        const int units = (c >> 3) + 1;
        if (pending + units > kLaneMax) flush();
        const uint32_t r = (uint32_t)c & 7u, q8 = (uint32_t)c >> 3;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const uint32_t x0 = (r & 1u) ? w[v] : 0u;
          const uint32_t x1 = (r & 2u) ? w[v] : 0u;
          const uint32_t x2 = (r & 4u) ? w[v] : 0u;
          const uint32_t c1 = ones[v] & x0;
          ones[v] ^= x0;
          uint32_t c2, c3;
          csa(c2, twos[v], twos[v], x1, c1);
          csa(c3, fours[v], fours[v], x2, c2);
          lanes_add(lanes[v], c3, 1u);
          lanes_add(lanes[v], w[v], q8);
        }
        pending += units;
      }
    }
    wait_copies<0>();  // only empty groups remain: the ring is free
  }

  // The final counts leave through shared memory as whole 128-byte lines:
  // each thread stages one word's 32 counts at a time in its warp's part of
  // the ring (free now), and 8 lanes store each staged thread's counts.
  __syncthreads();  // every thread's copies are consumed
  int32_t* stage = reinterpret_cast<int32_t*>(ring) + (threadIdx.x & ~31u) * kPiece;
  const int lane_id = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int c[32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const int pos = 8 * j + bit;
        c[pos] = 8 * lane(lanes[v][bit], j) + (int)((ones[v] >> pos) & 1u) +
                 2 * (int)((twos[v] >> pos) & 1u) + 4 * (int)((fours[v] >> pos) & 1u);
      }
    }
    if (wide && active) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int4 w = *reinterpret_cast<const int4*>(dst + 32 * v + 4 * k);
        c[4 * k] += w.x;
        c[4 * k + 1] += w.y;
        c[4 * k + 2] += w.z;
        c[4 * k + 3] += w.w;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      *reinterpret_cast<int4*>(stage + lane_id * kPiece + 4 * k) =
          make_int4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
    }
    if (gmax != nullptr && active) {
      int gm[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int mx = c[8 * j];
#pragma unroll
        for (int bit = 1; bit < 8; ++bit) mx = max(mx, c[8 * j + bit]);
        gm[j] = mx;
      }
      *reinterpret_cast<int4*>(gmax + (long long)b * Sb + chunk * 4 * V + 4 * v) =
          make_int4(gm[0], gm[1], gm[2], gm[3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = warp0 + 4 * i + (lane_id >> 3), k = lane_id & 7;
      const long long ch = (long long)blockIdx.y * tile_chunks + t;
      if (t < tile_chunks && ch < n_chunks) {
        *reinterpret_cast<int4*>(out + (long long)b * 8 * Sb + ch * 32 * V + 32 * v + 4 * k) =
            *reinterpret_cast<const int4*>(stage + (t - warp0) * kPiece + 4 * k);
      }
    }
    __syncwarp();
  }
}

struct Plan {
  int words;        // V: 32-bit words a thread copies from each row at once
  int tiles;        // column tiles of a row
  int tile_chunks;  // chunks of V words a tile
  int threads;      // threads a block (tile_chunks rounded up to a warp)
  int smem_bytes;   // dynamic shared memory a block: the ring, or the
                    // final counts' staging where that is larger
};

constexpr int smem_bytes(int words, int threads) {
  return std::max(kRing * kGroup * threads * 4 * words, threads * kPiece * 4);
}

// 16-byte copies where the row length and P's address allow, else 4-byte
// ones, and the row's chunks split evenly over the fewest tiles of at most
// kMaxThreads.
Plan make_plan(long long Sb, const void* P) {
  const unsigned long long addr = reinterpret_cast<unsigned long long>(P);
  Plan p;
  p.words = (Sb % 16 == 0 && addr % 16 == 0) ? 4 : 1;
  const long long chunks = Sb / (4 * p.words);
  p.tiles = (int)((chunks + kMaxThreads - 1) / kMaxThreads);
  p.tile_chunks = (int)((chunks + p.tiles - 1) / p.tiles);
  p.threads = (p.tile_chunks + 31) / 32 * 32;
  p.smem_bytes = smem_bytes(p.words, p.threads);
  return p;
}

const void* kernel_for(int words) {
  return words == 4 ? reinterpret_cast<const void*>(&kmer_score_kernel<4>)
                    : reinterpret_cast<const void*>(&kmer_score_kernel<1>);
}

// The ring can pass the 48 KB of shared memory a block gets without opting
// in. Each instantiation opts in once a device, at the most any of its
// plans takes, so a launch costs no attribute call.
template <int V>
cudaError_t allow_smem_once() {
  static std::atomic<unsigned long long> done{0};  // bit d: device d opted in
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(&kmer_score_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(V, kMaxThreads));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

cudaError_t allow_smem(int words) {
  return words == 4 ? allow_smem_once<4>() : allow_smem_once<1>();
}

}  // namespace

// The launch plan for rows of Sb bytes (Sb % 4 == 0) at P: out[0..12] =
// bytes a thread copies from a row at once, threads a block, chunks a tile,
// tiles a row, registers a thread, static and dynamic (the ring, or the
// final counts' staging) shared memory bytes a block, local (spilled) bytes
// a thread, blocks an SM the occupancy calculator allows, runs a group,
// groups a ring; the pre-pass's threads a block and ids it sorts together.
// Returns a cudaError_t.
extern "C" int sina_kmer_score_plan(long long Sb, const void* P, long long* out) {
  if (Sb <= 0 || Sb % 4) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(Sb, P);
  const void* fn = kernel_for(p.words);
  cudaError_t e = allow_smem(p.words);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, p.threads, p.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = 4 * p.words;
  out[1] = p.threads;
  out[2] = p.tile_chunks;
  out[3] = p.tiles;
  out[4] = attr.numRegs;
  out[5] = (long long)attr.sharedSizeBytes;
  out[6] = p.smem_bytes;
  out[7] = (long long)attr.localSizeBytes;
  out[8] = blocks;
  out[9] = kGroup;
  out[10] = kRing;
  out[11] = kSortThreads;
  out[12] = kSortChunk;
  return 0;
}

// P (n_rows, Sb) uint8 with Sb % 4 == 0 and a 4-byte aligned base; kmers
// (B, L) int32; out (B, 8*Sb) int32 and gmax (B, Sb) int32 (or null), both
// 16-byte aligned; scratch 2*B*L + B int32 (the runs). Returns
// cudaGetLastError().
extern "C" int sina_kmer_score(const void* P, const void* kmers, void* out, void* gmax,
                               void* scratch, long long Sb, long long n_rows, int B, int L,
                               void* stream) {
  if (B == 0 || Sb == 0) return 0;
  if (Sb % 4 || n_rows < 1 || L < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* run_rows = static_cast<int32_t*>(scratch);
  int32_t* run_counts = run_rows + (long long)B * L;
  int32_t* n_runs = run_counts + (long long)B * L;
  kmer_runs_kernel<<<B, kSortThreads, 0, s>>>(static_cast<const int32_t*>(kmers), L, n_rows,
                                               run_rows, run_counts, n_runs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Plan p = make_plan(Sb, P);
  e = allow_smem(p.words);
  if (e != cudaSuccess) return (int)e;
  const uint8_t* P_p = static_cast<const uint8_t*>(P);
  const int32_t* rows_p = run_rows;
  const int32_t* counts_p = run_counts;
  const int32_t* nr_p = n_runs;
  int32_t* out_p = static_cast<int32_t*>(out);
  int32_t* gmax_p = static_cast<int32_t*>(gmax);
  int tile_chunks = p.tile_chunks;
  void* args[] = {&P_p, &rows_p, &counts_p, &nr_p, &out_p, &gmax_p, &Sb, &L, &tile_chunks};
  e = cudaLaunchKernel(kernel_for(p.words), dim3((unsigned)B, (unsigned)p.tiles),
                       dim3((unsigned)p.threads), args, (size_t)p.smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* sina_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
