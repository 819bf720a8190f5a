// BCG corrector advection kernels for Hopper (sm_90a): the advection
// increment of the velocity components with the MAC faces, launched by
// gerris_tpu_torch/models/ns.py:velocity_advection_diffusion, one
// component per launch (K14) or both in one launch (K7).
//
// Templated on float and double, behind the plain C interface of rbgs.cu
// (loaded with ctypes by gerris_tpu_torch/ops/cuda/bcg.py); a launch is
// on the caller's stream, allocates nothing and returns cudaGetLastError().
// CUDA C++ and not Triton: a small stencil, one build route and one
// library for the port, f64 on the same route as f32.
//
// ---------------------------------------------------------------------------
// K14 advect2d.
// Replaces gerris_tpu/ops/pallas/bcg.py:advect2d (_kernel/_advect_core
// without the rr fold), with its g, gp and oscale folds.
// Computes (reference: gfs_cell_advected_face_values src/advection.c:58-99,
// gfs_face_upwinded_value :267-345, gfs_face_advection_flux :356-385):
//   the advecting cell velocities, the means of each cell's two MAC faces,
//   edge-extended past the domain (ucx, ucy);
//   per cell and axis, the BCG values of v at the high and low face
//     vp = v + min((1 - unorm)/2, 0.5) gs,  vm = v + max((-1 - unorm)/2,
//     -0.5) gs,  gs = (v[+1] - v[-1]) / 2,  unorm = dt/h uc(axis),
//   less the transverse term dt/h vt (upwind difference) / 2 (vt the other
//   axis' uc, the side picked by its sign, 0 when it is 0);
//   per face, the Godunov choice on the MAC velocity uf: vp of the low cell
//   if uf > 0, vm of the high cell if uf < 0, their mean if uf = 0; less
//   dt/2 times the face mean of g (edge ghosts: the Neumann-0 gmac BC);
//   on the component's own axis, the Dirichlet values on the domain faces;
//   fv = -dt/h (d(uf F)/dx + d(uf F)/dy), then fv -= dt gp, and with oscale
//   out = oscale (v + fv) (the implicit-diffusion rhs), else out = fv.
// Ghost cells of v follow stencil.cuh (ghost = sgn * mirror + off, two
// layers deep, a corner ghost the row ghost of a column ghost).
// Bound: device-memory bytes (reads v, ufx, ufy, g, gp; writes out; at
// 2048^2 f32 ~101 MB, ~30 us at 3.35 TB/s).  ~250 flops per cell (8 BCG
// values, 4 Godunov choices and fluxes) against 24 bytes per cell in f32 is
// about 10 flops/byte, below the card's ~20 f32 flops/byte: still bytes.
// Design: one thread per cell computes the fluxes through its four faces;
// a face shared by two cells is computed by both, with the same expression,
// so both see the same value.  Every read comes from global memory (the
// 13-point neighbourhood from L1/L2), no shared-memory halo.
//
// ---------------------------------------------------------------------------
// K7 advect2d_pair: both components in one launch.
// Replaces gerris_tpu/ops/pallas/bcg.py:advect2d_pair (_kernel_pair), both
// modes: the rhs mode (K14's output for each component) and the rr_dia
// mode, where each component's output is the residual r0 = rhs - (L - dia)
// v of its implicit-diffusion system at initial guess v, with the
// system's 1-cell ghosts in the same sgn/off encoding, and its two 2x2
// pools r1, r2: the first K8a launch of the diffusion pair folded in.
// Bound: device-memory bytes (reads v0, v1, ufx, ufy, g0, g1, gp0, gp1,
// writes two outputs, plus r1 and r2 in rr_dia mode; ~0.050 / 0.053 ms at
// 2048^2 f32).  The faces are half of K14's bytes, and the pair reads them
// once for the two components: that shared face read is why the TPU
// kernel exists.
// Design: K14's per-cell code (advect_value) with each component's own K14
// arguments; a block computes one component, blockIdx.z picks it, as the K8
// pairs batch their systems (rbgs.cu).  The faces are then read twice, from
// L2: one thread per cell computing both components (the TPU kernel's
// shared face read) ran slower on the H100, where K14 is far from its bytes
// bound.  Each branch on blockIdx.z reads its component's arguments at a
// fixed index: gtt::at indexes the ghost encoding at run time, and a
// run-time component index would make every such read an indexed load.  In
// rr_dia mode the block's r0 tile goes to shared memory and the block
// writes r1 and r2 from there, as K1 does (rbgs.cu).  K14 keeps its own
// kernel: as the one-component case of K7's kernel (another argument
// layout) it ran slower on the H100.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using gtt::Cell;
using gtt::Ghosts;

template <typename T>
struct AdvectArgs {
  const T* v;
  const T* ufx;
  const T* ufy;
  const T* g;   // nullptr: no gmac face correction
  const T* gp;  // nullptr: no -dt gp
  int n0, n1;
  T dt, h, dt_h, oscale;
  int use_os;
  Ghosts<T> gv;
  int fb_axis;  // the component's axis, whose domain faces may be forced
  int fb_mask;  // bit 0: the low face is forced, bit 1: the high face
  T fb_lo, fb_hi;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the advecting cell velocities, edge-extended past the domain
template <typename T>
__device__ __forceinline__ T ucx(const AdvectArgs<T>& a, int i, int j) {
  i = clampi(i, 0, a.n0 - 1);
  j = clampi(j, 0, a.n1 - 1);
  const size_t k = (size_t)i * a.n1 + j;
  return T(0.5) * (a.ufx[k] + a.ufx[k + a.n1]);
}

template <typename T>
__device__ __forceinline__ T ucy(const AdvectArgs<T>& a, int i, int j) {
  i = clampi(i, 0, a.n0 - 1);
  j = clampi(j, 0, a.n1 - 1);
  const size_t k = (size_t)i * (a.n1 + 1) + j;
  return T(0.5) * (a.ufy[k] + a.ufy[k + 1]);
}

// g with Neumann-0 ghosts (edge values)
template <typename T>
__device__ __forceinline__ T gat(const AdvectArgs<T>& a, int i, int j) {
  return a.g[(size_t)clampi(i, 0, a.n0 - 1) * a.n1 + clampi(j, 0, a.n1 - 1)];
}

// BCG value of v at cell (i, j) extrapolated to its high (high = true) or
// low face along `axis`
template <typename T>
__device__ __forceinline__ T bcg_value(const AdvectArgs<T>& a, int axis,
                                       int i, int j, bool high) {
  const int di = axis == 0, dj = axis == 1;
  const T c = gtt::at(a.v, i, j, a.n0, a.n1, a.gv);
  const T gs = T(0.5) * (gtt::at(a.v, i + di, j + dj, a.n0, a.n1, a.gv) -
                         gtt::at(a.v, i - di, j - dj, a.n0, a.n1, a.gv));
  const T un = axis == 0 ? ucx(a, i, j) : ucy(a, i, j);
  const T unorm = a.dt_h * un;
  const T val = high ? c + fmin((T(1) - unorm) / T(2), T(0.5)) * gs
                     : c + fmax((T(-1) - unorm) / T(2), T(-0.5)) * gs;
  const T vt = axis == 0 ? ucy(a, i, j) : ucx(a, i, j);
  T gdiff = T(0);
  if (vt > T(0))
    gdiff = c - gtt::at(a.v, i - dj, j - di, a.n0, a.n1, a.gv);
  else if (vt < T(0))
    gdiff = gtt::at(a.v, i + dj, j + di, a.n0, a.n1, a.gv) - c;
  return val - a.dt_h * vt * gdiff / T(2);
}

// uf F through face f of `axis` (0..n along it) at cross index m
template <typename T>
__device__ __forceinline__ T flux(const AdvectArgs<T>& a, int axis, int f,
                                  int m) {
  const int n = axis == 0 ? a.n0 : a.n1;
  const T uf = axis == 0 ? a.ufx[(size_t)f * a.n1 + m]
                         : a.ufy[(size_t)m * (a.n1 + 1) + f];
  if (axis == a.fb_axis) {
    if (f == 0 && (a.fb_mask & 1)) return uf * a.fb_lo;
    if (f == n && (a.fb_mask & 2)) return uf * a.fb_hi;
  }
  const int i0 = axis == 0 ? f - 1 : m, j0 = axis == 0 ? m : f - 1;
  const int i1 = axis == 0 ? f : m, j1 = axis == 0 ? m : f;
  const T left = bcg_value(a, axis, i0, j0, true);
  const T right = bcg_value(a, axis, i1, j1, false);
  T F = uf > T(0) ? left : (uf < T(0) ? right : T(0.5) * (left + right));
  if (a.g) F = F - T(0.5) * (gat(a, i1, j1) + gat(a, i0, j0)) * a.dt / T(2);
  return uf * F;
}

// the component's output at cell (i, j): fv, or oscale (v + fv)
template <typename T>
__device__ __forceinline__ T advect_value(const AdvectArgs<T>& a, int i,
                                          int j) {
  const size_t k = (size_t)i * a.n1 + j;
  const T fx = flux(a, 0, i + 1, j) - flux(a, 0, i, j);
  const T fy = flux(a, 1, j + 1, i) - flux(a, 1, j, i);
  T fv = -a.dt * fx / a.h - a.dt * fy / a.h;
  if (a.gp) fv = fv - a.dt * a.gp[k];
  return a.use_os ? a.oscale * (a.v[k] + fv) : fv;
}

template <typename T>
__global__ void advect2d_kernel(AdvectArgs<T> a, T* __restrict__ out) {
  const Cell c = gtt::this_cell(a.n0, a.n1);
  if (!c.in) return;
  out[(size_t)c.i * a.n1 + c.j] = advect_value(a, c.i, c.j);
}

// K7: each component's K14 arguments, its outputs, and in rr_dia mode the
// diffusion system (L - dia) u = rhs
template <typename T>
struct PairArgs {
  AdvectArgs<T> c[2];
  T* out[2];
  T* r1[2];
  T* r2[2];
  T dia, h2;
};

constexpr int PAIR_BX = 32, PAIR_BY = 8;  // K7's block; rr_dia: its tile

// rr_dia mode: r0 = rhs - (L - dia) v at cell (i, j), K1's expression with
// sub = 0 (rbgs.cu:residual_restrict_kernel)
template <typename T>
__device__ __forceinline__ T residual(const AdvectArgs<T>& a, T rhs, T dia,
                                      T h2, int i, int j) {
  const T c = a.v[(size_t)i * a.n1 + j];
  const T nb = gtt::at(a.v, i - 1, j, a.n0, a.n1, a.gv) +
               gtt::at(a.v, i + 1, j, a.n0, a.n1, a.gv) +
               gtt::at(a.v, i, j - 1, a.n0, a.n1, a.gv) +
               gtt::at(a.v, i, j + 1, a.n0, a.n1, a.gv);
  return rhs - (nb - T(4) * c) / h2 + dia * c;
}

// rr_dia mode: the block's r0 tile (sr) -> its r1 and r2 tiles, the 2x2
// means rows first, then columns (K1's order)
template <typename T>
__device__ void pools(T (*sr)[PAIR_BX], int n1, T* __restrict__ r1,
                      T* __restrict__ r2) {
  constexpr int BX = PAIR_BX, BY = PAIR_BY;
  __shared__ T s1[BY / 2][BX / 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * BY, j0 = blockIdx.x * BX;
  __syncthreads();
  if (ty < BY / 2 && tx < BX / 2) {
    const T a = T(0.5) * (sr[2 * ty][2 * tx] + sr[2 * ty + 1][2 * tx]);
    const T b = T(0.5) * (sr[2 * ty][2 * tx + 1] + sr[2 * ty + 1][2 * tx + 1]);
    const T m = T(0.5) * (a + b);
    s1[ty][tx] = m;
    r1[(size_t)(i0 / 2 + ty) * (n1 / 2) + j0 / 2 + tx] = m;
  }
  __syncthreads();
  if (ty < BY / 4 && tx < BX / 4) {
    const T a = T(0.5) * (s1[2 * ty][2 * tx] + s1[2 * ty + 1][2 * tx]);
    const T b = T(0.5) * (s1[2 * ty][2 * tx + 1] + s1[2 * ty + 1][2 * tx + 1]);
    r2[(size_t)(i0 / 4 + ty) * (n1 / 4) + j0 / 4 + tx] = T(0.5) * (a + b);
  }
}

// One component of K7 at the block's cells; RR: the rr_dia mode, on a grid
// the PAIR_BX x PAIR_BY blocks tile
template <typename T, bool RR>
__device__ __forceinline__ void pair_component(const AdvectArgs<T>& a,
                                               T* __restrict__ out,
                                               T* __restrict__ r1,
                                               T* __restrict__ r2, T dia,
                                               T h2) {
  const Cell c = gtt::this_cell(a.n0, a.n1);
  if (!RR && !c.in) return;
  const size_t k = (size_t)c.i * a.n1 + c.j;
  const T v = advect_value(a, c.i, c.j);
  if constexpr (RR) {
    __shared__ T sr[PAIR_BY][PAIR_BX];
    const T r = residual(a, v, dia, h2, c.i, c.j);
    out[k] = r;
    sr[threadIdx.y][threadIdx.x] = r;
    pools(sr, a.n1, r1, r2);
  } else {
    out[k] = v;
  }
}

template <typename T, bool RR>
__global__ void advect2d_pair_kernel(PairArgs<T> p) {
  if (blockIdx.z == 0)
    pair_component<T, RR>(p.c[0], p.out[0], p.r1[0], p.r2[0], p.dia, p.h2);
  else
    pair_component<T, RR>(p.c[1], p.out[1], p.r1[1], p.r2[1], p.dia, p.h2);
}

template <typename T>
AdvectArgs<T> advect_args(const void* v, const void* ufx, const void* ufy,
                          const void* g, const void* gp, int n0, int n1,
                          double dt, double h, const double* sgn,
                          const double* off, int fb_axis, int fb_mask,
                          const double* fb, int use_os, double oscale) {
  return AdvectArgs<T>{(const T*)v,
                        (const T*)ufx,
                        (const T*)ufy,
                        (const T*)g,
                        (const T*)gp,
                        n0,
                        n1,
                        T(dt),
                        T(h),
                        T(dt / h),
                        T(oscale),
                        use_os,
                        gtt::make_ghosts<T>(sgn, off, 0),
                        fb_axis,
                        fb_mask,
                        T(fb[0]),
                        T(fb[1])};
}

template <typename T>
int launch_advect2d(const void* v, const void* ufx, const void* ufy,
                    const void* g, const void* gp, int n0, int n1, double dt,
                    double h, const double* sgn, const double* off,
                    int fb_axis, int fb_mask, const double* fb, int use_os,
                    double oscale, void* out, void* stream) {
  const int bx = 32, by = 8;
  const AdvectArgs<T> a =
      advect_args<T>(v, ufx, ufy, g, gp, n0, n1, dt, h, sgn, off, fb_axis,
                     fb_mask, fb, use_os, oscale);
  advect2d_kernel<T><<<gtt::cell_grid(n0, n1, bx, by), dim3(bx, by), 0,
                       (cudaStream_t)stream>>>(a, (T*)out);
  return (int)cudaGetLastError();
}

// Per-component arguments are host arrays of two entries (4 per component
// for sgn/off, 2 for fb); component 0 is along x, 1 along y.  rr != 0: the
// rr_dia mode, out = r0 and the pools r1, r2.  The C interface takes the
// device pointers as one host table: v, g, gp, out, r1, r2, two each.
template <typename T>
int launch_advect2d_pair(const void* const* v, const void* ufx,
                         const void* ufy, const void* const* g,
                         const void* const* gp, int n0, int n1, double dt,
                         double h, const double* sgn, const double* off,
                         const int* fb_mask, const double* fb, int use_os,
                         double oscale, int rr, double dia, double h2,
                         void* const* out, void* const* r1, void* const* r2,
                         void* stream) {
  if (rr && (n0 % PAIR_BY || n1 % PAIR_BX)) return (int)cudaErrorInvalidValue;
  PairArgs<T> p = {};
  for (int q = 0; q < 2; ++q) {
    p.c[q] = advect_args<T>(v[q], ufx, ufy, g[q], gp[q], n0, n1, dt, h,
                            sgn + 4 * q, off + 4 * q, q, fb_mask[q],
                            fb + 2 * q, use_os, oscale);
    p.out[q] = (T*)out[q];
    p.r1[q] = rr ? (T*)r1[q] : nullptr;
    p.r2[q] = rr ? (T*)r2[q] : nullptr;
  }
  p.dia = T(dia);
  p.h2 = T(h2);
  dim3 grid = gtt::cell_grid(n0, n1, PAIR_BX, PAIR_BY);
  grid.z = 2;
  const dim3 block(PAIR_BX, PAIR_BY);
  if (rr)
    advect2d_pair_kernel<T, true><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  else
    advect2d_pair_kernel<T, false><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_advect2d_##SUFFIX(                                       \
      const void* v, const void* ufx, const void* ufy, const void* g,         \
      const void* gp, int n0, int n1, double dt, double h, const double* sgn, \
      const double* off, int fb_axis, int fb_mask, const double* fb,          \
      int use_os, double oscale, void* out, void* stream) {                   \
    return launch_advect2d<T>(v, ufx, ufy, g, gp, n0, n1, dt, h, sgn, off,    \
                              fb_axis, fb_mask, fb, use_os, oscale, out,      \
                              stream);                                        \
  }                                                                           \
  extern "C" int gtt_advect2d_pair_##SUFFIX(                                  \
      void* const* ptr, const void* ufx, const void* ufy, int n0, int n1,     \
      double dt, double h, const double* sgn, const double* off,              \
      const int* fb_mask, const double* fb, int use_os, double oscale,        \
      int rr, double dia, double h2, void* stream) {                          \
    return launch_advect2d_pair<T>(ptr, ufx, ufy, ptr + 2, ptr + 4, n0, n1,   \
                                   dt, h, sgn, off, fb_mask, fb, use_os,      \
                                   oscale, rr, dia, h2, ptr + 6, ptr + 8,     \
                                   ptr + 10, stream);                         \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
