// K13 rbgs_relax_3d for Hopper (sm_90a): the 3D multigrid smoother of
// gerris_tpu_torch/solvers/poisson.py (relax, and every upward level of a
// 3D correction, with the level's prolongation folded in).
//
// Replaces gerris_tpu/ops/pallas/rbgs3d.py:rbgs_relax_3d (_kernel3d):
// nsweeps red-black Gauss-Seidel sweeps (red = global (i+j+k) even, red
// half first) on (L7 - dia) u = rhs, with L7 the 7-point Laplacian, a
// scalar dia and homogeneous ghosts ghost = sgn * u per side, sides
// ordered (x lo, x hi, y lo, y hi, z lo, z hi), -1 Dirichlet and +1
// Neumann.  A cell's update is
//   new = (xm + xp + ym + yp + zm + zp - h2 * rhs) * inv_denom,
//   inv_denom = 1 / (6 + dia h2) (computed on the host, in double),
// then (1 - omega) * u + omega * new when omega != 1: the TPU kernel's
// multiply by the reciprocal, not the jnp route's division.  These
// expressions are written as the one-launch-per-half-sweep kernel that
// this one replaces wrote them, so that nvcc contracts them alike and
// the 3D step's results stay the same bit for bit.
//
// The start value is a given u, or (PROLONG) the trilinear prolongation
// of a coarse correction of (n0/2, n1/2, n2/2) cells, computed in the
// kernel as gerris_tpu_torch/solvers/poisson.py:prolong's 3D branch
// computes it: axis 0, then 1, then 2, each step 0.75 a + 0.25 nb with
// both products and the sum rounded (never an FMA), the fine cell 2c
// taking the low neighbour and 2c + 1 the high one, and at a domain edge
// nb = sgn * a + 0.0 of the partly prolonged array.  With `add` the
// result is add + du, one rounded add, written to `out` while du stays
// in its own buffer.
//
// Layout: a contiguous (n0, n1, n2) row-major field, axis 2 contiguous,
// any shape (even with PROLONG).  The TPU kernel's strips, their
// 2*nsweeps halo, the 128-lane padding of n2 and its plane limits were
// VMEM/DMA constraints, not semantics, and are not copied.
//
// Bound: device-memory bytes.  A sweep does ~10 flops per cell and no
// tensor-core work; the least a call must move is u (or the coarse
// correction), rhs and `add` in and the output out once.  The levels the
// 3D step smooths (32^3 to 128^3 float32: 0.4 to 24 MB) stay in the 50 MB
// L2 between half-sweeps, so what a half-sweep pays in practice is L2
// traffic, the latency of each thread's loads and the barrier between
// half-sweeps; one launch per half-sweep would add a launch each (2 *
// nsweeps a call), which the host pays far more than the card.
// Design: every half-sweep in one launch.  The grid is persistent: sized
// by occupancy and launched with cudaLaunchCooperativeKernel, so that
// every block is resident, with cooperative_groups' grid barrier between
// the half-sweeps.  du lives in device memory (L2 holds it).  Each block
// walks bricks of bi x bj rows, its warps on neighbouring rows, so that a
// row's y and x neighbours are mostly the block's own L1 lines; a warp
// covers 32 / group rows of a colour at a time, `group` lanes per row
// (every second cell of the row), so that rows shorter than 64 cells
// keep the lanes busy.  A half-sweep reads only the other colour (and
// each thread its own cell) and writes only its own colour, so updating
// in place needs no other barrier.  A prolonged start is placed by one
// pass and a barrier; the first half-sweep of a given u reads u and
// copies the other colour.  Measured on an H100, the whole level in one
// block's shared memory (where it fits, 32^3 float32) was several times
// slower than this grid, and so was a grid whose blocks each kept a tile
// of du in shared memory and exchanged only the tiles' faces between
// half-sweeps at 64^3 and 128^3 (a quarter of the occupancy for its
// placement and halo reads); a lane issuing four cells' loads before
// their stores spilled and was slower too.
//
// The launch goes on the caller's stream, allocates nothing, and the call
// returns the first CUDA error (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R3_THREADS_MAX = 512;

template <typename T>
struct R3Args {
  const T* src;  // PROLONG: the coarse correction; else the start u
  const T* rhs;
  const T* add;  // nullptr: none
  T* work;       // du between half-sweeps (out without add)
  T* out;
  T h2, inv_denom, w_old, w_new;  // w_old = 1 - omega, w_new = omega
  T sgn[6];
  int n0, n1, n2;
  int nsweeps, over;  // over: omega != 1
  int group;          // lanes per row: a power of two, at most 32
  int bi, bj;         // a brick's rows along axes 0 and 1
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// one prolongation step: 0.75 a + 0.25 nb, each product and the sum
// rounded; at a domain edge nb = sgn * a + 0.0 (the + 0.0 turns -0 into
// +0, as the torch route's ghost does)
template <typename T>
__device__ __forceinline__ T blend(T a, T nb) {
  return add_rn(mul_rn(T(0.75), a), mul_rn(T(0.25), nb));
}
template <typename T>
__device__ __forceinline__ T edge(T sgn, T a) {
  return add_rn(mul_rn(sgn, a), T(0));
}

// The trilinear prolongation at fine cell (i, j, k) of the coarse field c
// of (n0/2, n1/2, n2/2) cells: axis 0 at the (up to) four coarse (y, z)
// points that axis 1 needs, axis 1 at the (up to) two z points that axis
// 2 needs, then axis 2.  A neighbour index of -1 is a domain edge.
template <typename T>
__device__ __forceinline__ T prolong_at(const T* __restrict__ c, int i,
                                        int j, int k, const R3Args<T>& a) {
  const int m0 = a.n0 >> 1, m1 = a.n1 >> 1, m2 = a.n2 >> 1;
  const int c0 = i >> 1, c1 = j >> 1, c2 = k >> 1;
  const bool h0 = i & 1, h1 = j & 1, h2 = k & 1;
  const int d0 = h0 ? (c0 + 1 < m0 ? c0 + 1 : -1) : c0 - 1;
  const int d1 = h1 ? (c1 + 1 < m1 ? c1 + 1 : -1) : c1 - 1;
  const int d2 = h2 ? (c2 + 1 < m2 ? c2 + 1 : -1) : c2 - 1;
  const T g0 = h0 ? a.sgn[1] : a.sgn[0];
  const T g1 = h1 ? a.sgn[3] : a.sgn[2];
  const T g2 = h2 ? a.sgn[5] : a.sgn[4];
  const size_t plane = (size_t)m1 * m2;
  auto ax0 = [&](int y, int z) {
    const size_t q = (size_t)y * m2 + z;
    const T v = c[(size_t)c0 * plane + q];
    return blend(v, d0 >= 0 ? c[(size_t)d0 * plane + q] : edge(g0, v));
  };
  auto ax1 = [&](int z) {
    const T v = ax0(c1, z);
    return blend(v, d1 >= 0 ? ax0(d1, z) : edge(g1, v));
  };
  const T v = ax1(c2);
  return blend(v, d2 >= 0 ? ax1(d2) : edge(g2, v));
}

// A cell's red-black update from u (its own value and the other colour's
// neighbours, ghosts sgn * u at the domain's sides).
template <typename T>
__device__ __forceinline__ T relaxed(const T* u, size_t c, int i, int j,
                                     int k, T r, const R3Args<T>& a) {
  const size_t n2 = (size_t)a.n2;
  const size_t plane = (size_t)a.n1 * n2;
  const T uc = u[c];
  const T xm = i > 0 ? u[c - plane] : a.sgn[0] * uc;
  const T xp = i < a.n0 - 1 ? u[c + plane] : a.sgn[1] * uc;
  const T ym = j > 0 ? u[c - n2] : a.sgn[2] * uc;
  const T yp = j < a.n1 - 1 ? u[c + n2] : a.sgn[3] * uc;
  const T zm = k > 0 ? u[c - 1] : a.sgn[4] * uc;
  const T zp = k < a.n2 - 1 ? u[c + 1] : a.sgn[5] * uc;
  const T nb = xm + xp + ym + yp + zm + zp;
  T v = (nb - a.h2 * r) * a.inv_denom;
  if (a.over) v = a.w_old * uc + a.w_new * v;
  return v;
}

// f(i, j, k, c) for the block's cells: every cell (colour < 0) or those
// with (i + j + k) % 2 == colour, over the bricks blockIdx.x,
// blockIdx.x + gridDim.x, ... of bi x bj rows; a warp takes 32 / group
// rows at a time, `group` lanes on each.
template <typename T, typename F>
__device__ __forceinline__ void for_cells(const R3Args<T>& a, int colour,
                                          F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = a.group, rpw = 32 / g;
  const int sub = lane / g, x0 = lane - sub * g;
  const int step = colour < 0 ? 1 : 2;
  const int nbi = (a.n0 + a.bi - 1) / a.bi, nbj = (a.n1 + a.bj - 1) / a.bj;
  for (int b = blockIdx.x; b < nbi * nbj; b += gridDim.x) {
    const int bi = b / nbj, bj = b - bi * nbj;
    const int i0 = bi * a.bi, j0 = bj * a.bj;
    const int ni = min(a.bi, a.n0 - i0), nj = min(a.bj, a.n1 - j0);
    for (int r = warp * rpw + sub; r < ni * nj; r += nwarps * rpw) {
      const int ri = r / nj;
      const int i = i0 + ri, j = j0 + r - ri * nj;
      const int first = colour < 0 ? 0 : (i + j + colour) & 1;
      const size_t row = ((size_t)i * a.n1 + j) * a.n2;
      for (int k = first + step * x0; k < a.n2; k += step * g)
        f(i, j, k, row + k);
    }
  }
}

// The start value of cell (i, j, k)
template <typename T, bool PROLONG>
__device__ __forceinline__ T placed(const R3Args<T>& a, int i, int j, int k,
                                    size_t c) {
  if constexpr (PROLONG)
    return prolong_at(a.src, i, j, k, a);
  else
    return a.src[c];
}

// add + v, one rounded add (no contraction with v's last product)
template <typename T>
__device__ __forceinline__ T added(const R3Args<T>& a, size_t c, T v) {
  return a.add ? add_rn(a.add[c], v) : v;
}

// The smoother: du in device memory (work), a grid barrier between the
// half-sweeps.  work is never declared const __restrict__: other blocks
// write it between the barriers, so it must not be read through the
// non-coherent path.
template <typename T, bool PROLONG>
__global__ void __launch_bounds__(R3_THREADS_MAX)
    rbgs3d_grid_kernel(R3Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  T* w = a.work;
  if (a.nsweeps == 0) {
    for_cells(a, -1, [&](int i, int j, int k, size_t c) {
      a.out[c] = added(a, c, placed<T, PROLONG>(a, i, j, k, c));
    });
    return;
  }
  if constexpr (PROLONG) {
    for_cells(a, -1, [&](int i, int j, int k, size_t c) {
      w[c] = prolong_at(a.src, i, j, k, a);
    });
    grid.sync();
  }
  const int last = 2 * a.nsweeps - 1;
  for (int h = 0; h <= last; ++h) {
    const int colour = h & 1;
    // the first half-sweep of a given u reads u and copies the other
    // colour to work; the last with `add` writes add + du of every cell
    const bool copy = !PROLONG && h == 0;
    const bool fin = h == last && a.add != nullptr;
    const T* u = copy ? a.src : w;
    if (copy || fin) {
      for_cells(a, -1, [&](int i, int j, int k, size_t c) {
        if (((i + j + k) & 1) == colour) {
          const T v = relaxed(u, c, i, j, k, a.rhs[c], a);
          if (fin) a.out[c] = add_rn(a.add[c], v);
          else w[c] = v;
        } else if (fin) {
          a.out[c] = add_rn(a.add[c], w[c]);
        } else {
          w[c] = u[c];
        }
      });
    } else {
      for_cells(a, colour, [&](int i, int j, int k, size_t c) {
        w[c] = relaxed(u, c, i, j, k, a.rhs[c], a);
      });
    }
    if (h < last) grid.sync();
  }
}

// lanes per row: the least power of two >= a colour's cells in a row
int group_of(int n2) {
  const int nx = (n2 + 1) / 2;
  int g = 1;
  while (g < nx && g < 32) g <<= 1;
  return g;
}

// blocks that fit on the card at once, per device and thread count
// (cached: the occupancy query costs host time)
template <typename T, bool PROLONG>
cudaError_t grid_capacity(int threads, int* out) {
  static int cache[gtt::MAX_DEVICES][2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int slot = threads > 256;
  if (dev < gtt::MAX_DEVICES && cache[dev][slot]) {
    *out = cache[dev][slot];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rbgs3d_grid_kernel<T, PROLONG>, threads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  if (dev < gtt::MAX_DEVICES) cache[dev][slot] = *out;
  return cudaSuccess;
}

// One cooperative launch: at most `blocks` blocks (0: as many as fit on
// the card, and never more than there are bricks)
template <typename T, bool PROLONG>
int launch(R3Args<T> a, int blocks, int threads, cudaStream_t s) {
  if (a.bi < 1 || a.bj < 1 || (threads != 256 && threads != R3_THREADS_MAX))
    return (int)cudaErrorInvalidValue;
  a.group = group_of(a.n2);
  int cap = 0;
  cudaError_t e = grid_capacity<T, PROLONG>(threads, &cap);
  if (e != cudaSuccess) return (int)e;
  const int bricks =
      ((a.n0 + a.bi - 1) / a.bi) * ((a.n1 + a.bj - 1) / a.bj);
  int nb = cap < bricks ? cap : bricks;
  if (blocks > 0 && blocks < nb) nb = blocks;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)rbgs3d_grid_kernel<T, PROLONG>, dim3(nb), dim3(threads),
      args, 0, s);
}

template <typename T>
int launch_rbgs_relax_3d(void* const* ptr, int prolong, int n0, int n1,
                         int n2, int nsweeps, double h2, double inv_denom,
                         double omega, const double* sgn, int blocks,
                         int threads, int bi, int bj, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || nsweeps < 0 ||
      (prolong && (n0 | n1 | n2) & 1))
    return (int)cudaErrorInvalidValue;
  R3Args<T> a = {};
  a.src = (const T*)ptr[0];
  a.rhs = (const T*)ptr[1];
  a.add = (const T*)ptr[2];
  a.work = (T*)ptr[3];
  a.out = (T*)ptr[4];
  a.h2 = T(h2);
  a.inv_denom = T(inv_denom);
  a.w_old = T(1.0 - omega);
  a.w_new = T(omega);
  for (int q = 0; q < 6; ++q) a.sgn[q] = T(sgn[q]);
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.nsweeps = nsweeps;
  a.over = omega != 1.0;
  a.bi = bi;
  a.bj = bj;
  const cudaStream_t s = (cudaStream_t)stream;
  return prolong ? launch<T, true>(a, blocks, threads, s)
                 : launch<T, false>(a, blocks, threads, s);
}

}  // namespace

// The C interface (loaded with ctypes by gerris_tpu_torch/ops/cuda/rbgs3d.py):
// ptr is a host table of device pointers (src, rhs, add, work, out) to
// contiguous fields of the suffix's type: src the start u of (n0, n1, n2)
// cells, or with prolong = 1 the coarse correction of (n0/2, n1/2, n2/2)
// cells (n0, n1, n2 even); add NULL for none; work du's buffer (out when
// add is NULL); out distinct from src, rhs and add.  sgn is a host array
// of 6 ghost signs.  `threads` (256 or 512) a block, at most `blocks`
// blocks (0: as many as fit on the card), walking bricks of bi x bj rows.
// One launch.
#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_rbgs_relax_3d_##SUFFIX(                                  \
      void* const* ptr, int prolong, int n0, int n1, int n2, int nsweeps,     \
      double h2, double inv_denom, double omega, const double* sgn,           \
      int blocks, int threads, int bi, int bj, void* stream) {                \
    return launch_rbgs_relax_3d<T>(ptr, prolong, n0, n1, n2, nsweeps, h2,    \
                                   inv_denom, omega, sgn, blocks, threads,    \
                                   bi, bj, stream);                           \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
