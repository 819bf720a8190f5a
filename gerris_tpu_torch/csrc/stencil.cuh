// Helpers shared by the face and projection kernels (projops.cu,
// predict.cu): ghost-cell reads in the kernels' BC encoding, and the
// bit-reproducible two-pass sum of a cell field.
//
// Ghost encoding per side, sides ordered (x lo, x hi, y lo, y hi):
// ghost = sgn * mirror + off, where the mirror of ghost layer k is interior
// layer k-1 counted from the boundary; periodic y wraps instead.  A corner
// ghost is built columns first, then rows from the column-padded row: the
// order of the TPU kernels' strip buffers (gerris_tpu/ops/pallas/
// predict.py:_kern_xy, projops.py:_ghost_rows_cols) and of the plain
// versions' _pad (ops/cuda/projops.py).
#pragma once

#include <cuda_runtime.h>

namespace gtt {
namespace {  // internal linkage: each source compiles its own copy

template <typename T>
struct Ghosts {
  T s[4];
  T o[4];
  int per_y;
};

template <typename T>
Ghosts<T> make_ghosts(const double* sgn, const double* off, int per_y) {
  Ghosts<T> g;
  for (int k = 0; k < 4; ++k) {
    g.s[k] = T(sgn[k]);
    g.o[k] = T(off[k]);
  }
  g.per_y = per_y;
  return g;
}

// u(i, j) of a contiguous (n0, n1) field for i in [-n0, 2 n0), j in
// [-n1, 2 n1) (the kernels read at most two ghost layers).
template <typename T>
__device__ __forceinline__ T at(const T* __restrict__ u, int i, int j,
                                int n0, int n1, const Ghosts<T>& g) {
  int col_side = -1, row_side = -1;
  if (j < 0) {
    if (g.per_y) j += n1;
    else { col_side = 2; j = -1 - j; }
  } else if (j >= n1) {
    if (g.per_y) j -= n1;
    else { col_side = 3; j = 2 * n1 - 1 - j; }
  }
  if (i < 0) { row_side = 0; i = -1 - i; }
  else if (i >= n0) { row_side = 1; i = 2 * n0 - 1 - i; }
  T v = u[(size_t)i * n1 + j];
  if (col_side >= 0) v = g.s[col_side] * v + g.o[col_side];
  if (row_side >= 0) v = g.s[row_side] * v + g.o[row_side];
  return v;
}

// Sum of one value per thread over the block, by a shared-memory tree over
// the flattened thread index (a fixed order, so a launch is reproducible
// bit for bit).  The block's thread count must be a power of two; ``red``
// holds one T per thread.  Every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  red[t] = v;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  return red[0];
}

// Block sums of the kernels' partials[] -> total[0], by one block in a
// fixed order: the second pass of the global sum.  No float atomics, so
// the sum of a given launch geometry is the same in every run.
constexpr int SUM_THREADS = 1024;

template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ partials, int n,
                                    T* __restrict__ total) {
  __shared__ T red[SUM_THREADS];
  T acc = T(0);
  for (int k = threadIdx.x; k < n; k += SUM_THREADS) acc += partials[k];
  const T s = block_sum(acc, red);
  if (threadIdx.x == 0) *total = s;
}

// The thread's cell and the flat index of its block.
struct Cell {
  int i, j, block;
  bool in;
};

__device__ __forceinline__ Cell this_cell(int n0, int n1) {
  Cell c;
  c.j = blockIdx.x * blockDim.x + threadIdx.x;
  c.i = blockIdx.y * blockDim.y + threadIdx.y;
  c.block = blockIdx.y * gridDim.x + blockIdx.x;
  c.in = c.i < n0 && c.j < n1;
  return c;
}

// Finish a cell-divergence output: the block's partial sum goes to
// partials[block] (every thread of the block calls this, in or out of
// the domain).
template <typename T>
__device__ void store_div(const Cell& c, T d, int n1, T* __restrict__ div,
                          T* __restrict__ partials, T* red) {
  if (c.in) div[(size_t)c.i * n1 + c.j] = d;
  const T s = block_sum(c.in ? d : T(0), red);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[c.block] = s;
}

// Launch geometry of the cell-per-thread kernels: (bx, by) threads, a
// power-of-two count of at most 1024.
inline bool block_ok(int bx, int by) {
  const int nt = bx * by;
  return bx > 0 && by > 0 && nt <= 1024 && (nt & (nt - 1)) == 0;
}

inline dim3 cell_grid(int n0, int n1, int bx, int by) {
  return dim3((n1 + bx - 1) / bx, (n0 + by - 1) / by);
}

template <typename T>
int launch_sum(const T* partials, int n, T* total, cudaStream_t stream) {
  sum_partials_kernel<T><<<1, SUM_THREADS, 0, stream>>>(partials, n, total);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gtt
