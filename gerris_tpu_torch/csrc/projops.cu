// Projection kernels for Hopper (sm_90a): the MAC divergence before a
// projection's solve, its correction after it, and the face interpolation
// that feeds the approximate projection (gerris_tpu_torch/solvers/
// projection.py).
//
// Three kernels, each templated on float and double, behind the plain C
// interface of rbgs.cu (loaded with ctypes by gerris_tpu_torch/ops/cuda/
// projops.py); every launch is on the caller's stream, allocates nothing
// and returns cudaGetLastError():
//
//   divergence_mac   div = (dx ufx + dy ufy) * scale and its global sum;
//   correct_project  face gradients of p, uf -= dt grad_f p, the cell
//                    gradient (face mean) [, U, V -= dt g];
//   interp_faces     [u += dtv Gx, v += dtv Gy,] face means of the cells
//                    with the Dirichlet (or periodic) boundary faces
//                    [, the divergence of those faces and its sum].
//
// Layouts are logical: cells (n0, n1), x faces (n0+1, n1), y faces
// (n0, n1+1), all contiguous row-major.  One thread per cell; a cell's
// thread also writes the domain's last x face (i = n0-1) and last y face
// (j = n1-1).  All three are elementwise stencils of a few flops per value
// read: bytes between device memory and the SMs bound them on the H100,
// so each reads every input once from device memory (neighbour reads hit
// L1/L2) and keeps every intermediate in registers.  CUDA C++ and not
// Triton: they are small stencils, the port already has one build route
// and one library, and f64 stays on the same route as f32.
//
// The global sum of a divergence is two passes, per-block partial sums
// by a fixed-order tree, then one block that sums the partials in a fixed
// order (stencil.cuh): no float atomics, so a run is reproducible bit for
// bit and the compatibility mean can stay on the device as the solver's
// `sub` (no host sync).

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using gtt::Cell;
using gtt::Ghosts;

// ---------------------------------------------------------------------------
// K4 divergence_mac.
// Replaces gerris_tpu/ops/pallas/projops.py:divergence_mac (_kern_div).
// Bound: device-memory bytes (reads ufx and ufy, writes div; at 2048^2
// f32 ~50 MB, ~15 us at 3.35 TB/s).
// Design: one thread per cell; the block's partial sum by a shared-memory
// tree, then gtt::sum_partials_kernel.  The TPU kernel carried its strip
// sums out as one padded tile per grid step and let XLA add them; blocks
// of a GPU grid carry nothing, hence the second pass.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void divergence_mac_kernel(const T* __restrict__ ufx,
                                      const T* __restrict__ ufy, int n0,
                                      int n1, T scale, T* __restrict__ div,
                                      T* __restrict__ partials) {
  extern __shared__ unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const Cell c = gtt::this_cell(n0, n1);
  T d = T(0);
  if (c.in) {
    const size_t fx = (size_t)c.i * n1 + c.j;
    const size_t fy = (size_t)c.i * (n1 + 1) + c.j;
    d = ((ufx[fx + n1] - ufx[fx]) + (ufy[fy + 1] - ufy[fy])) * scale;
  }
  gtt::store_div(c, d, n1, div, partials, red);
}

// ---------------------------------------------------------------------------
// K5 correct_project.
// Replaces gerris_tpu/ops/pallas/projops.py:correct_project
// (_kern_correct), including the domain face n0 of ufx that its wrapper
// appends by hand.
// Bound: device-memory bytes (reads p, ufx, ufy [, U, V]; writes ufx',
// ufy', gx, gy [, U', V']; at 2048^2 f32 ~117 MB, ~35 us, and with the
// cells ~185 MB, ~55 us).
// Design: one thread per cell reads p's 5-point stencil with the static
// ghosts (gtt::at) and forms its four face gradients in registers: its
// low faces' corrected velocities, the domain's last faces, the cell
// gradient as the mean of the two face gradients, and the corrected cells.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void correct_project_kernel(
    const T* __restrict__ p, const T* __restrict__ ufx,
    const T* __restrict__ ufy, const T* __restrict__ uc,
    const T* __restrict__ vc, int n0, int n1, T dt, T h, Ghosts<T> g,
    T* __restrict__ oufx, T* __restrict__ oufy, T* __restrict__ gx,
    T* __restrict__ gy, T* __restrict__ ouc, T* __restrict__ ovc) {
  const Cell c = gtt::this_cell(n0, n1);
  if (!c.in) return;
  const int i = c.i, j = c.j;
  const size_t k = (size_t)i * n1 + j;
  const size_t ky = (size_t)i * (n1 + 1) + j;
  const T pc = p[k];
  const T gx_lo = (pc - gtt::at(p, i - 1, j, n0, n1, g)) / h;
  const T gx_hi = (gtt::at(p, i + 1, j, n0, n1, g) - pc) / h;
  const T gy_lo = (pc - gtt::at(p, i, j - 1, n0, n1, g)) / h;
  const T gy_hi = (gtt::at(p, i, j + 1, n0, n1, g) - pc) / h;
  oufx[k] = ufx[k] - dt * gx_lo;
  if (i == n0 - 1) oufx[k + n1] = ufx[k + n1] - dt * gx_hi;
  oufy[ky] = ufy[ky] - dt * gy_lo;
  if (j == n1 - 1) oufy[ky + 1] = ufy[ky + 1] - dt * gy_hi;
  const T cx = T(0.5) * (gx_lo + gx_hi);
  const T cy = T(0.5) * (gy_lo + gy_hi);
  gx[k] = cx;
  gy[k] = cy;
  if (uc) {
    ouc[k] = uc[k] - dt * cx;
    ovc[k] = vc[k] - dt * cy;
  }
}

// ---------------------------------------------------------------------------
// K9 interp_faces.
// Replaces gerris_tpu/ops/pallas/projops.py:interp_faces (_kern_interp).
// Bound: device-memory bytes (reads U, V [, Gx, Gy]; writes ufx, ufy
// [, U', V'] [, div]; at 2048^2 f32 with gp ~134 MB, ~40 us).
// Design: one thread per cell; the updated cell values u + dtv Gx of the
// neighbours are recomputed from the inputs (the same expression, so the
// same value) instead of being exchanged.  On the route that takes this
// kernel (ops/cuda/bcg.py:face_specs) the x faces 0 and n0 are Dirichlet
// and the y faces 0 and n1 Dirichlet or periodic, so no ghost cell reaches
// an output and the kernel needs no ghost encoding.
// ---------------------------------------------------------------------------
template <typename T>
struct InterpArgs {
  const T* u;
  const T* v;
  const T* gx;  // nullptr: no gc re-add
  const T* gy;
  T dtv;
  int n0, n1, per_y;
  T fbx_lo, fbx_hi, fby_lo, fby_hi;
};

template <typename T>
__device__ __forceinline__ T cell_u(const InterpArgs<T>& a, int i, int j) {
  const size_t k = (size_t)i * a.n1 + j;
  return a.gx ? a.u[k] + a.dtv * a.gx[k] : a.u[k];
}

template <typename T>
__device__ __forceinline__ T cell_v(const InterpArgs<T>& a, int i, int j) {
  const size_t k = (size_t)i * a.n1 + j;
  return a.gy ? a.v[k] + a.dtv * a.gy[k] : a.v[k];
}

// x face f (0..n0) at column j
template <typename T>
__device__ __forceinline__ T interp_x(const InterpArgs<T>& a, int f, int j) {
  if (f == 0) return a.fbx_lo;
  if (f == a.n0) return a.fbx_hi;
  return T(0.5) * (cell_u(a, f - 1, j) + cell_u(a, f, j));
}

// y face f (0..n1) at row i
template <typename T>
__device__ __forceinline__ T interp_y(const InterpArgs<T>& a, int i, int f) {
  if (a.per_y) {
    if (f == 0 || f == a.n1) return T(0.5) * (cell_v(a, i, a.n1 - 1) +
                                              cell_v(a, i, 0));
  } else {
    if (f == 0) return a.fby_lo;
    if (f == a.n1) return a.fby_hi;
  }
  return T(0.5) * (cell_v(a, i, f - 1) + cell_v(a, i, f));
}

template <typename T>
__global__ void interp_faces_kernel(InterpArgs<T> a, T div_scale,
                                    T* __restrict__ ufx, T* __restrict__ ufy,
                                    T* __restrict__ ou, T* __restrict__ ov,
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
    const T fx_lo = interp_x(a, i, j), fy_lo = interp_y(a, i, j);
    ufx[k] = fx_lo;
    ufy[ky] = fy_lo;
    T fx_hi = T(0), fy_hi = T(0);
    if (div || i == a.n0 - 1) fx_hi = interp_x(a, i + 1, j);
    if (div || j == n1 - 1) fy_hi = interp_y(a, i, j + 1);
    if (i == a.n0 - 1) ufx[k + n1] = fx_hi;
    if (j == n1 - 1) ufy[ky + 1] = fy_hi;
    if (a.gx) {
      ou[k] = cell_u(a, i, j);
      ov[k] = cell_v(a, i, j);
    }
    d = ((fx_hi - fx_lo) + (fy_hi - fy_lo)) * div_scale;
  }
  if (div) gtt::store_div(c, d, n1, div, partials, red);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
template <typename T>
int launch_divergence_mac(const void* ufx, const void* ufy, int n0, int n1,
                          double scale, int bx, int by, void* div,
                          void* partials, void* total, void* stream) {
  if (!gtt::block_ok(bx, by)) return (int)cudaErrorInvalidValue;
  const dim3 grid = gtt::cell_grid(n0, n1, bx, by);
  const size_t smem = (size_t)bx * by * sizeof(T);
  divergence_mac_kernel<T><<<grid, dim3(bx, by), smem,
                             (cudaStream_t)stream>>>(
      (const T*)ufx, (const T*)ufy, n0, n1, T(scale), (T*)div, (T*)partials);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return gtt::launch_sum<T>((const T*)partials, grid.x * grid.y, (T*)total,
                            (cudaStream_t)stream);
}

template <typename T>
int launch_correct_project(const void* p, const void* ufx, const void* ufy,
                           const void* uc, const void* vc, int n0, int n1,
                           double dt, double h, const double* sgn,
                           const double* off, int per_y, void* oufx,
                           void* oufy, void* gx, void* gy, void* ouc,
                           void* ovc, void* stream) {
  const dim3 block(32, 8);
  correct_project_kernel<T><<<gtt::cell_grid(n0, n1, 32, 8), block, 0,
                              (cudaStream_t)stream>>>(
      (const T*)p, (const T*)ufx, (const T*)ufy, (const T*)uc, (const T*)vc,
      n0, n1, T(dt), T(h), gtt::make_ghosts<T>(sgn, off, per_y), (T*)oufx,
      (T*)oufy, (T*)gx, (T*)gy, (T*)ouc, (T*)ovc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp_faces(const void* u, const void* v, const void* gx,
                        const void* gy, double dtv, int n0, int n1, int per_y,
                        const double* fb, double div_scale, void* ufx,
                        void* ufy, void* ou, void* ov, void* div,
                        void* partials, void* total, void* stream) {
  const int bx = 32, by = 8;
  const InterpArgs<T> a{(const T*)u, (const T*)v, (const T*)gx,
                        (const T*)gy, T(dtv), n0, n1, per_y,
                        T(fb[0]), T(fb[1]), T(fb[2]), T(fb[3])};
  const dim3 grid = gtt::cell_grid(n0, n1, bx, by);
  const size_t smem = div ? (size_t)bx * by * sizeof(T) : 0;
  interp_faces_kernel<T><<<grid, dim3(bx, by), smem,
                           (cudaStream_t)stream>>>(
      a, T(div_scale), (T*)ufx, (T*)ufy, (T*)ou, (T*)ov, (T*)div,
      (T*)partials);
  const int e = (int)cudaGetLastError();
  if (e || !div) return e;
  return gtt::launch_sum<T>((const T*)partials, grid.x * grid.y, (T*)total,
                            (cudaStream_t)stream);
}

}  // namespace

#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_divergence_mac_##SUFFIX(                                 \
      const void* ufx, const void* ufy, int n0, int n1, double scale, int bx, \
      int by, void* div, void* partials, void* total, void* stream) {         \
    return launch_divergence_mac<T>(ufx, ufy, n0, n1, scale, bx, by, div,     \
                                    partials, total, stream);                 \
  }                                                                           \
  extern "C" int gtt_correct_project_##SUFFIX(                                \
      const void* p, const void* ufx, const void* ufy, const void* uc,        \
      const void* vc, int n0, int n1, double dt, double h,                    \
      const double* sgn, const double* off, int per_y, void* oufx,            \
      void* oufy, void* gx, void* gy, void* ouc, void* ovc, void* stream) {   \
    return launch_correct_project<T>(p, ufx, ufy, uc, vc, n0, n1, dt, h, sgn, \
                                     off, per_y, oufx, oufy, gx, gy, ouc,     \
                                     ovc, stream);                            \
  }                                                                           \
  extern "C" int gtt_interp_faces_##SUFFIX(                                   \
      const void* u, const void* v, const void* gx, const void* gy,           \
      double dtv, int n0, int n1, int per_y, const double* fb,                \
      double div_scale, void* ufx, void* ufy, void* ou, void* ov, void* div,  \
      void* partials, void* total, void* stream) {                            \
    return launch_interp_faces<T>(u, v, gx, gy, dtv, n0, n1, per_y, fb,       \
                                  div_scale, ufx, ufy, ou, ov, div, partials, \
                                  total, stream);                             \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
