// BCG predictor kernel for Hopper (sm_90a): both velocity components'
// predicted MAC faces of gerris_tpu_torch/models/ns.py:
// predicted_face_velocities in one launch.
//
// Templated on float and double, behind the plain C interface of rbgs.cu
// (loaded with ctypes by gerris_tpu_torch/ops/cuda/predict.py); the launch
// is on the caller's stream, allocates nothing and returns
// cudaGetLastError().  CUDA C++ and not Triton: a small stencil, one build
// route and one library for the port, f64 on the same route as f32.
//
// ---------------------------------------------------------------------------
// K6 predict_xy.
// Replaces gerris_tpu/ops/pallas/predict.py:predict_xy (_kern_xy), with
// the domain faces n0 of ufx and n1 of ufy that its wrapper appends.
// Computes (reference: src/timestep.c:681-717 with the CENTERED upwinding
// of gfs_cell_advected_face_values restricted to the component's axis):
//   per cell, the own-axis centred slope g = (u[+1] - u[-1]) / 2 and the
//   two-sided values
//     vp = u + min((1 - unorm)/2, 0.5) g,  vm = u + max((-1 - unorm)/2,
//     -0.5) g,  unorm = dt/h u,
//   less the transverse term dt/h v_t (upwind difference) / 2, whose side
//   is picked by the sign of the transverse velocity v_t (0 when v_t = 0);
//   per face, the Godunov choice on the centred normal velocity
//   un = (u[left] + u[right]) / 2: vp of the left cell if un > 0, vm of
//   the right cell if un < 0, their mean if un = 0;
//   faces 0 and n0 of ufx take fb_x, faces 0 and n1 of ufy take fb_y (or
//   the periodic value).
// Ghost cells follow stencil.cuh (ghost = sgn * mirror + off, two layers
// deep: row -2 = sgn u[1] + off); on the routes that take this kernel the
// second layer only feeds the Dirichlet faces, which are overwritten.
// Bound: device-memory bytes (reads U, V; writes ufx, ufy [, div]; at
// 2048^2 f32 ~67 MB, ~20 us at 3.35 TB/s).  ~30 flops per face against
// 8 bytes moved per face in f32 is far below the card's flop/byte ratio.
// Design: one thread per cell writes its two low faces (and the domain's
// last faces); every value comes from global memory, the 13-point
// neighbourhood from L1/L2, with no shared-memory halo.  With div_scale
// the thread also computes its two high faces (recomputed, the same
// expression, so the same values) for its cell's divergence, and the
// block partial sums follow projops.cu's two-pass scheme.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using gtt::Cell;
using gtt::Ghosts;

template <typename T>
struct PredictArgs {
  const T* u;
  const T* v;
  int n0, n1;
  T dt_h;
  Ghosts<T> gu, gv;
  T fbx_lo, fbx_hi, fby_lo, fby_hi;
};

// Predicted value of component a at cell (i, j) extrapolated to its high
// (high = true) or low face along `axis`; t is the transverse component.
template <typename T>
__device__ __forceinline__ T bcg_value(const T* a, const Ghosts<T>& ga,
                                       const T* t, const Ghosts<T>& gt,
                                       int n0, int n1, int axis, int i, int j,
                                       T dt_h, bool high) {
  const int di = axis == 0, dj = axis == 1;
  const T c = gtt::at(a, i, j, n0, n1, ga);
  const T g = T(0.5) * (gtt::at(a, i + di, j + dj, n0, n1, ga) -
                        gtt::at(a, i - di, j - dj, n0, n1, ga));
  const T unorm = dt_h * c;
  const T val = high ? c + fmin((T(1) - unorm) / T(2), T(0.5)) * g
                     : c + fmax((T(-1) - unorm) / T(2), T(-0.5)) * g;
  const T vt = gtt::at(t, i, j, n0, n1, gt);
  T gdiff = T(0);
  if (vt > T(0))
    gdiff = c - gtt::at(a, i - dj, j - di, n0, n1, ga);
  else if (vt < T(0))
    gdiff = gtt::at(a, i + dj, j + di, n0, n1, ga) - c;
  return val - dt_h * vt * gdiff / T(2);
}

template <typename T>
__device__ __forceinline__ T godunov(T un, T left, T right) {
  return un > T(0) ? left : (un < T(0) ? right : T(0.5) * (left + right));
}

// x face f (0..n0) of u at column j
template <typename T>
__device__ __forceinline__ T face_x(const PredictArgs<T>& a, int f, int j) {
  if (f == 0) return a.fbx_lo;
  if (f == a.n0) return a.fbx_hi;
  const T un = T(0.5) * (a.u[(size_t)(f - 1) * a.n1 + j] +
                         a.u[(size_t)f * a.n1 + j]);
  return godunov(un,
                 bcg_value(a.u, a.gu, a.v, a.gv, a.n0, a.n1, 0, f - 1, j,
                           a.dt_h, true),
                 bcg_value(a.u, a.gu, a.v, a.gv, a.n0, a.n1, 0, f, j, a.dt_h,
                           false));
}

// y face f (0..n1) of v at row i
template <typename T>
__device__ __forceinline__ T face_y(const PredictArgs<T>& a, int i, int f) {
  if (a.gv.per_y) {
    if (f == a.n1) f = 0;  // face n1 is face 0
  } else {
    if (f == 0) return a.fby_lo;
    if (f == a.n1) return a.fby_hi;
  }
  const T un = T(0.5) * (gtt::at(a.v, i, f - 1, a.n0, a.n1, a.gv) +
                         a.v[(size_t)i * a.n1 + f]);
  return godunov(un,
                 bcg_value(a.v, a.gv, a.u, a.gu, a.n0, a.n1, 1, i, f - 1,
                           a.dt_h, true),
                 bcg_value(a.v, a.gv, a.u, a.gu, a.n0, a.n1, 1, i, f, a.dt_h,
                           false));
}

template <typename T>
__global__ void predict_xy_kernel(PredictArgs<T> a, T div_scale,
                                  T* __restrict__ ufx, T* __restrict__ ufy,
                                  T* __restrict__ div,
                                  T* __restrict__ partials) {
  extern __shared__ unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const Cell c = gtt::this_cell(a.n0, a.n1);
  const int n1 = a.n1;
  T d = T(0);
  if (c.in) {
    const int i = c.i, j = c.j;
    const size_t k = (size_t)i * n1 + j;
    const size_t ky = (size_t)i * (n1 + 1) + j;
    const T fx_lo = face_x(a, i, j), fy_lo = face_y(a, i, j);
    ufx[k] = fx_lo;
    ufy[ky] = fy_lo;
    T fx_hi = T(0), fy_hi = T(0);
    if (div || i == a.n0 - 1) fx_hi = face_x(a, i + 1, j);
    if (div || j == n1 - 1) fy_hi = face_y(a, i, j + 1);
    if (i == a.n0 - 1) ufx[k + n1] = fx_hi;
    if (j == n1 - 1) ufy[ky + 1] = fy_hi;
    d = ((fx_hi - fx_lo) + (fy_hi - fy_lo)) * div_scale;
  }
  if (div) gtt::store_div(c, d, n1, div, partials, red);
}

template <typename T>
int launch_predict_xy(const void* u, const void* v, int n0, int n1,
                      double dt_h, const double* sgn_u, const double* off_u,
                      const double* sgn_v, const double* off_v, int per_y,
                      const double* fb, double div_scale, void* ufx,
                      void* ufy, void* div, void* partials, void* total,
                      void* stream) {
  const int bx = 32, by = 8;
  const PredictArgs<T> a{(const T*)u,
                         (const T*)v,
                         n0,
                         n1,
                         T(dt_h),
                         gtt::make_ghosts<T>(sgn_u, off_u, per_y),
                         gtt::make_ghosts<T>(sgn_v, off_v, per_y),
                         T(fb[0]),
                         T(fb[1]),
                         T(fb[2]),
                         T(fb[3])};
  const dim3 grid = gtt::cell_grid(n0, n1, bx, by);
  const size_t smem = div ? (size_t)bx * by * sizeof(T) : 0;
  predict_xy_kernel<T><<<grid, dim3(bx, by), smem, (cudaStream_t)stream>>>(
      a, T(div_scale), (T*)ufx, (T*)ufy, (T*)div, (T*)partials);
  const int e = (int)cudaGetLastError();
  if (e || !div) return e;
  return gtt::launch_sum<T>((const T*)partials, grid.x * grid.y, (T*)total,
                            (cudaStream_t)stream);
}

}  // namespace

#define GTT_EXPORT(SUFFIX, T)                                                \
  extern "C" int gtt_predict_xy_##SUFFIX(                                    \
      const void* u, const void* v, int n0, int n1, double dt_h,             \
      const double* sgn_u, const double* off_u, const double* sgn_v,         \
      const double* off_v, int per_y, const double* fb, double div_scale,    \
      void* ufx, void* ufy, void* div, void* partials, void* total,          \
      void* stream) {                                                        \
    return launch_predict_xy<T>(u, v, n0, n1, dt_h, sgn_u, off_u, sgn_v,     \
                                off_v, per_y, fb, div_scale, ufx, ufy, div,  \
                                partials, total, stream);                    \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
