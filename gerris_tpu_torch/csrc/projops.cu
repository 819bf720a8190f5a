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
//   divergence_mac   div = (dx ufx + dy ufy) * scale and its global sum,
//                    in one launch;
//   correct_project  face gradients of p, uf -= dt grad_f p, the cell
//                    gradient (face mean) [, U, V -= dt g];
//   interp_faces     [u += dtv Gx, v += dtv Gy,] face means of the cells
//                    with the Dirichlet (or periodic) boundary faces
//                    [, the divergence of those faces and its sum].
//
// Layouts are logical: cells (n0, n1), x faces (n0+1, n1), y faces
// (n0, n1+1), all contiguous row-major.  K5 and K9 run one thread per
// cell (K4 a 4 x DIV_ROWS patch); a cell's thread also writes the
// domain's last x face (i = n0-1) and last y face (j = n1-1).  All
// three are elementwise stencils of a few flops per value read: bytes
// between device memory and the SMs bound them on the H100,
// so each reads every input once from device memory (neighbour reads hit
// L1/L2) and keeps every intermediate in registers.  CUDA C++ and not
// Triton: they are small stencils, the port already has one build route
// and one library, and f64 stays on the same route as f32.
//
// The global sum of a divergence is per-tile partial sums by a
// fixed-order tree, then the partials summed in a fixed order, by the last
// block of K4's launch, by a second launch after K9's (stencil.cuh): no
// float atomics on values, so a run is reproducible bit for bit and the
// compatibility mean can stay on the device as the solver's `sub` (no
// host sync).

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using gtt::Cell;
using gtt::Ghosts;

// ---------------------------------------------------------------------------
// K4 divergence_mac, in one launch.
// Replaces gerris_tpu/ops/pallas/projops.py:divergence_mac (_kern_div).
// Bound: device-memory bytes (reads ufx and ufy, writes div; at 2048^2
// f32 ~50 MB, ~15 us at 3.35 TB/s).
// Design: the global sum keeps the association of the two-pass sum it
// replaces (a tree over each DIV_COLS x DIV_ROWS tile of cells, the
// flattened thread order of a 32 x 8 block: its rows' steps, then its
// columns'; then 1024 strided accumulators over the tiles' partials and
// their tree), so div and total are the two-pass version's bit for bit,
// in one launch and with no shared-memory tree in the cell pass.  A warp
// takes a strip of 128 columns x DIV_ROWS rows, 4 columns a lane: 16-byte
// loads of ufx and stores of div where the rows are aligned, each row's
// low x faces carried from the row below; each tile's rows are summed in
// the lane's registers and its columns by shuffles across the tile's
// 8 lanes, then the lane's own 4.  The TPU kernel carried its strip
// sums out as one tile per grid step and let XLA add them; here the last
// block to arrive (an arrival count and __threadfence, as
// restrict_pyramid finishes its coarsest levels) sums the partials in the
// second pass's order, writes the total and resets the count for the
// next launch on the stream.
// ---------------------------------------------------------------------------
constexpr int DIV_ROWS = 8;        // rows of a sum tile
constexpr int DIV_COLS = 32;       // columns of a sum tile
constexpr int DIV_THREADS = 256;   // 8 warps, a strip each
constexpr int DIV_STRIP = 128;     // columns of a warp's strip

// four consecutive values of a row from column j0 (0 beyond n1), by one
// 16-byte load (two for double) where the row is aligned
__device__ __forceinline__ void load4(const float* __restrict__ p, int j0,
                                      int n1, bool vec, float v[4]) {
  if (vec && j0 + 3 < n1) {
    const float4 q = *reinterpret_cast<const float4*>(p + j0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    for (int e = 0; e < 4; ++e) v[e] = j0 + e < n1 ? p[j0 + e] : 0.0f;
  }
}

__device__ __forceinline__ void load4(const double* __restrict__ p, int j0,
                                      int n1, bool vec, double v[4]) {
  if (vec && j0 + 3 < n1) {
    const double2 q0 = *reinterpret_cast<const double2*>(p + j0);
    const double2 q1 = *reinterpret_cast<const double2*>(p + j0 + 2);
    v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
  } else {
    for (int e = 0; e < 4; ++e) v[e] = j0 + e < n1 ? p[j0 + e] : 0.0;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ p, int j0, int n1,
                                       bool vec, const float v[4]) {
  if (vec && j0 + 3 < n1) {
    *reinterpret_cast<float4*>(p + j0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < 4; ++e)
      if (j0 + e < n1) p[j0 + e] = v[e];
  }
}

__device__ __forceinline__ void store4(double* __restrict__ p, int j0, int n1,
                                       bool vec, const double v[4]) {
  if (vec && j0 + 3 < n1) {
    *reinterpret_cast<double2*>(p + j0) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + j0 + 2) = make_double2(v[2], v[3]);
  } else {
    for (int e = 0; e < 4; ++e)
      if (j0 + e < n1) p[j0 + e] = v[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(DIV_THREADS)
    divergence_mac_kernel(const T* __restrict__ ufx,
                          const T* __restrict__ ufy, int n0, int n1,
                          T scale, int vec, T* __restrict__ div,
                          T* __restrict__ partials, T* __restrict__ total,
                          unsigned int* count) {
  __shared__ T red[DIV_THREADS];
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  const int strips = (n1 + DIV_STRIP - 1) / DIV_STRIP;
  const int tiles_x = (n1 + DIV_COLS - 1) / DIV_COLS;
  const int tiles_y = (n0 + DIV_ROWS - 1) / DIV_ROWS;
  const int unit = blockIdx.x * (DIV_THREADS / 32) + (threadIdx.x >> 5);
  if (unit < strips * tiles_y) {  // the same for the whole warp
    const int R = unit / strips, C = unit - R * strips;
    const int i0 = R * DIV_ROWS, j0 = C * DIV_STRIP + 4 * lane;
    T d[DIV_ROWS][4], xl[4];
    load4(ufx + (size_t)i0 * n1, j0, n1, vec, xl);
#pragma unroll
    for (int r = 0; r < DIV_ROWS; ++r) {
      const int i = i0 + r;
      if (i < n0) {
        T xh[4], y[5];
        load4(ufx + (size_t)(i + 1) * n1, j0, n1, vec, xh);
        const T* yr = ufy + (size_t)i * (n1 + 1);
#pragma unroll
        for (int e = 0; e < 5; ++e) y[e] = j0 + e <= n1 ? yr[j0 + e] : T(0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[r][e] = j0 + e < n1
                        ? gtt::divergence_sum(xl[e], xh[e], y[e], y[e + 1]) *
                              scale
                        : T(0);
          xl[e] = xh[e];
        }
        store4(div + (size_t)i * n1, j0, n1, vec, d[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[r][e] = T(0);
      }
    }
    // the tile's tree: its rows (ty, ty + h) in the lane's registers ...
#pragma unroll
    for (int h = DIV_ROWS / 2; h >= 1; h >>= 1)
#pragma unroll
      for (int r = 0; r < h; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[r][e] += d[r + h][e];
    // ... then its columns (tx, tx + w): w / 4 lanes apart down to w = 4,
    // then the lane's own four
#pragma unroll
    for (int w = DIV_COLS / 2; w >= 4; w >>= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[0][e] += __shfl_down_sync(0xffffffffu, d[0][e], w >> 2);
    const T v = (d[0][0] + d[0][2]) + (d[0][1] + d[0][3]);
    const int g = DIV_COLS / 4;  // lanes of a tile row
    const int tc = C * (DIV_STRIP / DIV_COLS) + lane / g;
    if (lane % g == 0 && tc < tiles_x) partials[R * tiles_x + tc] = v;
  }
  // the last block to arrive sums the partials as sum_partials_kernel
  // does: 1024 strided accumulators, then their tree, whose first two
  // steps (1024 -> 512 -> 256) pair this thread's four
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int np = tiles_x * tiles_y, t = threadIdx.x;
  T acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    T x = T(0);
    for (int k = t + q * DIV_THREADS; k < np; k += gtt::SUM_THREADS)
      x += __ldcg(partials + k);
    acc[q] = x;
  }
  const T sum = gtt::block_sum((acc[0] + acc[2]) + (acc[1] + acc[3]), red);
  if (t == 0) {
    *total = sum;
    *count = 0u;
  }
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
// gradient as the mean of the two face gradients, and the corrected cells
// (gtt::correct_cell, which K17's epilogue shares).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void correct_project_kernel(const T* __restrict__ p, int n0,
                                       int n1, Ghosts<T> g,
                                       gtt::Correction<T> o) {
  const Cell c = gtt::this_cell(n0, n1);
  if (!c.in) return;
  const int i = c.i, j = c.j;
  gtt::correct_cell(o, i, j, n0, n1, p[(size_t)i * n1 + j],
                    gtt::at(p, i - 1, j, n0, n1, g),
                    gtt::at(p, i + 1, j, n0, n1, g),
                    gtt::at(p, i, j - 1, n0, n1, g),
                    gtt::at(p, i, j + 1, n0, n1, g));
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
bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// count: the launch's arrival count, 0 between launches
template <typename T>
int launch_divergence_mac(const void* ufx, const void* ufy, int n0, int n1,
                          double scale, void* div, void* partials,
                          void* total, void* count, void* stream) {
  if (n0 < 1 || n1 < 1) return (int)cudaErrorInvalidValue;
  const int units = (n1 + DIV_STRIP - 1) / DIV_STRIP *
                    ((n0 + DIV_ROWS - 1) / DIV_ROWS);
  const int warps = DIV_THREADS / 32;
  const int vec = n1 % 4 == 0 && aligned16(ufx) && aligned16(div);
  divergence_mac_kernel<T><<<(units + warps - 1) / warps, DIV_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const T*)ufx, (const T*)ufy, n0, n1, T(scale), vec, (T*)div,
      (T*)partials, (T*)total, (unsigned int*)count);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_correct_project(const void* p, const void* ufx, const void* ufy,
                           const void* uc, const void* vc, int n0, int n1,
                           double dt, double h, const double* sgn,
                           const double* off, int per_y, void* oufx,
                           void* oufy, void* gx, void* gy, void* ouc,
                           void* ovc, void* stream) {
  const dim3 block(32, 8);
  const gtt::Correction<T> o{(const T*)ufx, (const T*)ufy, (const T*)uc,
                             (const T*)vc,  (T*)oufx,       (T*)oufy,
                             (T*)gx,        (T*)gy,         (T*)ouc,
                             (T*)ovc,       T(dt),          T(h)};
  correct_project_kernel<T><<<gtt::cell_grid(n0, n1, 32, 8), block, 0,
                              (cudaStream_t)stream>>>(
      (const T*)p, n0, n1, gtt::make_ghosts<T>(sgn, off, per_y), o);
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
      const void* ufx, const void* ufy, int n0, int n1, double scale,         \
      void* div, void* partials, void* total, void* count, void* stream) {    \
    return launch_divergence_mac<T>(ufx, ufy, n0, n1, scale, div, partials,   \
                                    total, count, stream);                    \
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
