// Helpers shared by the kernels (rbgs.cu, projops.cu, predict.cu, bcg.cu):
// ghost-cell reads in the kernels' BC encoding, the haloed shared-memory
// tiles of the BCG kernels (K6, K7/K14) and their per-face expressions,
// the per-cell expressions that two kernels share (the residual, the MAC
// divergence, the projection's correction), and the bit-reproducible
// two-pass sum of a cell field.
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

#include <type_traits>

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
// [-n1, 2 n1) (the kernels read at most two ghost layers).  Each side's
// coefficients are read at a fixed index: a run-time index into a Ghosts
// held in the kernel's parameters would copy it to local memory.
template <typename T>
__device__ __forceinline__ T at(const T* __restrict__ u, int i, int j,
                                int n0, int n1, const Ghosts<T>& g) {
  bool c_lo = false, c_hi = false, r_lo = false, r_hi = false;
  if (j < 0) {
    if (g.per_y) j += n1;
    else { c_lo = true; j = -1 - j; }
  } else if (j >= n1) {
    if (g.per_y) j -= n1;
    else { c_hi = true; j = 2 * n1 - 1 - j; }
  }
  if (i < 0) { r_lo = true; i = -1 - i; }
  else if (i >= n0) { r_hi = true; i = 2 * n0 - 1 - i; }
  T v = u[(size_t)i * n1 + j];
  if (c_lo) v = g.s[2] * v + g.o[2];
  if (c_hi) v = g.s[3] * v + g.o[3];
  if (r_lo) v = g.s[0] * v + g.o[0];
  if (r_hi) v = g.s[1] * v + g.o[1];
  return v;
}

// The BCG stencils' haloed tile (K6 predict_xy, K7 advect2d_pair, K14
// advect2d): rows [r0, r0 + R) x columns [c0, c0 + C) of a contiguous
// (n0, n1) cell field into shared memory s (row stride ld), by all
// ``nt`` threads of the block (flat index t), ghosts resolved once here
// (at()), so the compute that follows reads shared memory only and
// is the same code in every block.  Cells beyond the H ghost layers (a
// tile larger than the grid) are set to 0: no output reads them.  A
// window inside the grid is read with plain loads, 16 bytes a thread
// where its rows are 16-byte aligned (c0, n1, C and ld multiples of
// 16 / sizeof(T), the field 16-byte aligned).
template <typename T, int R, int C>
__device__ __forceinline__ void load_tile(T* __restrict__ s, int ld,
                                          const T* __restrict__ u, int n0,
                                          int n1, int r0, int c0, int H,
                                          const Ghosts<T>& g, int t,
                                          int nt) {
  constexpr int VEC = 16 / sizeof(T);
  using V16 = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;
  if (r0 >= 0 && c0 >= 0 && r0 + R <= n0 && c0 + C <= n1) {
    if (C % VEC == 0 && c0 % VEC == 0 && n1 % VEC == 0 && ld % VEC == 0 &&
        reinterpret_cast<size_t>(u) % 16 == 0) {
      constexpr int CV = C / VEC;
      for (int k = t; k < R * CV; k += nt) {
        const int r = k / CV, c = (k % CV) * VEC;
        *reinterpret_cast<V16*>(s + r * ld + c) =
            __ldg(reinterpret_cast<const V16*>(u + (size_t)(r0 + r) * n1 +
                                               c0 + c));
      }
    } else {
      for (int k = t; k < R * C; k += nt) {
        const int r = k / C, c = k % C;
        s[r * ld + c] = __ldg(u + (size_t)(r0 + r) * n1 + c0 + c);
      }
    }
    return;
  }
  for (int k = t; k < R * C; k += nt) {
    const int r = k / C, c = k % C;
    const int i = r0 + r, j = c0 + c;
    s[r * ld + c] = (i >= -H && i < n0 + H && j >= -H && j < n1 + H)
                        ? at(u, i, j, n0, n1, g)
                        : T(0);
  }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The advecting cell velocities of K7/K14 at cells [r0, r0 + R) x
// [c0, c0 + C), the means of each cell's two MAC faces (ufx (n0 + 1, n1),
// ufy (n0, n1 + 1)) with the cell index clamped to the grid (edge-
// extended past the domain), into shared memory sx, sy (row stride C).
template <typename T, int R, int C>
__device__ __forceinline__ void load_face_means(
    T* __restrict__ sx, T* __restrict__ sy, const T* __restrict__ ufx,
    const T* __restrict__ ufy, int n0, int n1, int r0, int c0, int t,
    int nt) {
  for (int k = t; k < R * C; k += nt) {
    const int r = k / C, c = k % C;
    const int i = clampi(r0 + r, 0, n0 - 1), j = clampi(c0 + c, 0, n1 - 1);
    const size_t kx = (size_t)i * n1 + j;
    const size_t ky = (size_t)i * (n1 + 1) + j;
    sx[k] = T(0.5) * (__ldg(ufx + kx) + __ldg(ufx + kx + n1));
    sy[k] = T(0.5) * (__ldg(ufy + ky) + __ldg(ufy + ky + 1));
  }
}

// The same window of a cell field with the index clamped alike (Neumann-0
// ghosts: K7/K14's gmac cell gradient g), into s (row stride C).
template <typename T, int R, int C>
__device__ __forceinline__ void load_clamped(T* __restrict__ s,
                                             const T* __restrict__ u, int n0,
                                             int n1, int r0, int c0, int t,
                                             int nt) {
  for (int k = t; k < R * C; k += nt) {
    const int r = k / C, c = k % C;
    s[k] = __ldg(u + (size_t)clampi(r0 + r, 0, n0 - 1) * n1 +
                 clampi(c0 + c, 0, n1 - 1));
  }
}

// The BCG value of v at a cell extrapolated to its high (high = true) or
// low face along AXIS (reference: gfs_cell_advected_face_values,
// src/advection.c:58-99): vp = c + min((1 - unorm)/2, 0.5) gs, vm = c +
// max((-1 - unorm)/2, -0.5) gs, gs = (v[+1] - v[-1]) / 2, unorm = dt_h un,
// less dt_h vt (upwind difference) / 2, the side picked by the sign of
// the transverse velocity vt (0 when it is 0).  v points at the cell in
// a shared tile of row stride ld.  K6 (un = the cell's own component)
// and K7/K14 (un, vt the face means) share it.
template <typename T, int AXIS>
__device__ __forceinline__ T bcg_value(const T* v, int ld, T un, T vt, T dt_h,
                                       bool high) {
  const int sa = AXIS == 0 ? ld : 1;  // along the axis
  const int st = AXIS == 0 ? 1 : ld;  // transverse
  const T c = v[0];
  const T gs = T(0.5) * (v[sa] - v[-sa]);
  const T unorm = dt_h * un;
  const T val = high ? c + fmin((T(1) - unorm) / T(2), T(0.5)) * gs
                     : c + fmax((T(-1) - unorm) / T(2), T(-0.5)) * gs;
  T gdiff = T(0);
  if (vt > T(0))
    gdiff = c - v[-st];
  else if (vt < T(0))
    gdiff = v[st] - c;
  return val - dt_h * vt * gdiff / T(2);
}

// The Godunov choice on the face's normal velocity: the low cell's value
// if un > 0, the high cell's if un < 0, their mean if un = 0
template <typename T>
__device__ __forceinline__ T godunov(T un, T left, T right) {
  return un > T(0) ? left : (un < T(0) ? right : T(0.5) * (left + right));
}

// The residual of one cell, r = rhs - (L - dia) u = rhs - (nb - 4 c) / h2
// + dia c, from the sum of its four neighbours nb = up + dn + lf + rt
// (that order).  K1 (residual_restrict, with rhs - sub) and K11
// (residual) both compute a cell through this one expression, so K1's r0
// with sub = 0 is K11's bit for bit.
template <typename T>
__device__ __forceinline__ T residual_value(T rhs, T nb, T c, T h2, T dia) {
  return rhs - (nb - T(4) * c) / h2 + dia * c;
}

// The MAC divergence of cell (i, j) times ``scale``: x faces (n0 + 1,
// n1), y faces (n0, n1 + 1), contiguous.  K4 (divergence_mac) and K16
// (residual_restrict_div, whose rhs it is) compute a cell's face sum
// through this one expression; K16 fuses the scale with its - sub, so
// with sub = 0 (the fold route's) its r0 is K1's on K4's div bit for
// bit.
template <typename T>
__device__ __forceinline__ T divergence_sum(T x_lo, T x_hi, T y_lo, T y_hi) {
  return (x_hi - x_lo) + (y_hi - y_lo);
}

template <typename T>
__device__ __forceinline__ T mac_divergence(const T* __restrict__ ufx,
                                            const T* __restrict__ ufy, int i,
                                            int j, int n1, T scale) {
  const size_t fx = (size_t)i * n1 + j;
  const size_t fy = (size_t)i * (n1 + 1) + j;
  return divergence_sum(ufx[fx], ufx[fx + n1], ufy[fy], ufy[fy + 1]) * scale;
}

// The projection's correction of one cell (K5 correct_project, and K17
// prolong_relax_correct's epilogue) from p at the cell and its four
// neighbours up, dn, lf, rt (ghosts included): the face gradients, the
// cell's low x and y faces uf -= dt grad_f p (and the domain's last
// faces, i = n0 - 1 and j = n1 - 1), the cell gradient as the mean of its
// two face gradients, and with cells (uc != nullptr) U, V -= dt g.
template <typename T>
struct Correction {
  const T* ufx;
  const T* ufy;
  const T* uc;  // nullptr: no cells
  const T* vc;
  T* oufx;
  T* oufy;
  T* gx;
  T* gy;
  T* ouc;
  T* ovc;
  T dt, h;
};

template <typename T>
__device__ __forceinline__ void correct_cell(const Correction<T>& o, int i,
                                             int j, int n0, int n1, T pc,
                                             T up, T dn, T lf, T rt) {
  const size_t k = (size_t)i * n1 + j;
  const size_t ky = (size_t)i * (n1 + 1) + j;
  const T gx_lo = (pc - up) / o.h;
  const T gx_hi = (dn - pc) / o.h;
  const T gy_lo = (pc - lf) / o.h;
  const T gy_hi = (rt - pc) / o.h;
  o.oufx[k] = o.ufx[k] - o.dt * gx_lo;
  if (i == n0 - 1) o.oufx[k + n1] = o.ufx[k + n1] - o.dt * gx_hi;
  o.oufy[ky] = o.ufy[ky] - o.dt * gy_lo;
  if (j == n1 - 1) o.oufy[ky + 1] = o.ufy[ky + 1] - o.dt * gy_hi;
  const T cx = T(0.5) * (gx_lo + gx_hi);
  const T cy = T(0.5) * (gy_lo + gy_hi);
  o.gx[k] = cx;
  o.gy[k] = cy;
  if (o.uc) {
    o.ouc[k] = o.uc[k] - o.dt * cx;
    o.ovc[k] = o.vc[k] - o.dt * cy;
  }
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

// Raise a kernel's dynamic shared memory limit to the device's opt-in
// maximum (less its static shared memory), once per kernel and device: ``done`` is the launcher's own
// static table, by device.  The limit is a ceiling, not a reservation, so
// every launch of the kernel fits under it, and the host pays
// cudaFuncSetAttribute once instead of at every launch.
constexpr int MAX_DEVICES = 64;

inline cudaError_t allow_smem(const void* kernel, int* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  int bytes = 0;
  e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = 1;
  return e;
}

template <typename T>
int launch_sum(const T* partials, int n, T* total, cudaStream_t stream) {
  sum_partials_kernel<T><<<1, SUM_THREADS, 0, stream>>>(partials, n, total);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gtt
