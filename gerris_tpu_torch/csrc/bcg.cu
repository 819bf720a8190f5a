// BCG corrector advection kernel for Hopper (sm_90a): the advection
// increment of one velocity component with the MAC faces, the one that
// gerris_tpu_torch/models/ns.py:velocity_advection_diffusion launches per
// component.
//
// Templated on float and double, behind the plain C interface of rbgs.cu
// (loaded with ctypes by gerris_tpu_torch/ops/cuda/bcg.py); the launch is
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

template <typename T>
__global__ void advect2d_kernel(AdvectArgs<T> a, T* __restrict__ out) {
  const Cell c = gtt::this_cell(a.n0, a.n1);
  if (!c.in) return;
  const int i = c.i, j = c.j;
  const size_t k = (size_t)i * a.n1 + j;
  const T fx = flux(a, 0, i + 1, j) - flux(a, 0, i, j);
  const T fy = flux(a, 1, j + 1, i) - flux(a, 1, j, i);
  T fv = -a.dt * fx / a.h - a.dt * fy / a.h;
  if (a.gp) fv = fv - a.dt * a.gp[k];
  out[k] = a.use_os ? a.oscale * (a.v[k] + fv) : fv;
}

template <typename T>
int launch_advect2d(const void* v, const void* ufx, const void* ufy,
                    const void* g, const void* gp, int n0, int n1, double dt,
                    double h, const double* sgn, const double* off,
                    int fb_axis, int fb_mask, const double* fb, int use_os,
                    double oscale, void* out, void* stream) {
  const int bx = 32, by = 8;
  const AdvectArgs<T> a{(const T*)v,
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
  advect2d_kernel<T><<<gtt::cell_grid(n0, n1, bx, by), dim3(bx, by), 0,
                       (cudaStream_t)stream>>>(a, (T*)out);
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
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
