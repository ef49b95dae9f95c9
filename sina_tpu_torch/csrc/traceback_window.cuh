// The staged window of a traceback's backpointer plane, shared by
// chain_traceback.cu and graph_traceback.cu.
//
// A traceback walk only moves to lower columns (graph nodes) and lower query
// positions, so the cells of its next steps lie in a rectangle whose far
// corner is the current cell. The block copies that rectangle from device
// memory into shared memory, one line (a column or a node: consecutive query
// positions) after another, and the walking thread then reads each step's
// cell from shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sina_tb {

// The first query position of a window of `rows` positions that holds
// position ii: the window ends on the 16-element boundary above ii, so its
// start is 16-element aligned (or 0).
__device__ __forceinline__ int first_row(int ii, int rows) {
  return max((ii & ~15) + 16 - rows, 0);
}

// Copies ncols lines of nrows elements into win (line c at win + c * pitch);
// line c starts at src + c * stride. V elements a copy: 16 or 4 bytes by
// cp.async, or one element by a plain load. V must divide nrows, and src,
// stride and pitch must keep every copy V elements aligned (copy_elems). All
// threads of the block take part; the copies are complete when it returns,
// for the calling thread's own copies (a barrier then publishes them all).
template <typename T, int V, int kThreads>
__device__ __forceinline__ void stage(T* win, int pitch, const T* src, long long stride,
                                      int ncols, int nrows) {
  constexpr int kBytes = V * (int)sizeof(T);
  static_assert(kBytes == 16 || kBytes == 4 || V == 1, "a copy is 16 or 4 bytes, or one element");
  const int per = nrows / V;
  const int total = ncols * per;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int c = k / per;
    const int r = (k - c * per) * V;
    const T* g = src + c * stride + r;
    T* s = win + c * pitch + r;
    if constexpr (kBytes == 16) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(s);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g));
    } else if constexpr (kBytes == 4) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(s);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g));
    } else {
      *s = *g;
    }
  }
  if constexpr (kBytes >= 4) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// The widest copy (in elements of `elem` bytes) that keeps every copy
// aligned, for a plane at `plane` whose lines start at multiples of `line`
// elements from it (window rows start 16-element aligned): 16 bytes, else
// 4, else one element.
inline int copy_elems(const void* plane, long long line, int elem) {
  const unsigned long long addr = reinterpret_cast<unsigned long long>(plane);
  const long long bytes = line * elem;
  if (addr % 16 == 0 && bytes % 16 == 0) return 16 / elem;
  if (addr % 4 == 0 && bytes % 4 == 0) return 4 / elem;
  return 1;
}

}  // namespace sina_tb
