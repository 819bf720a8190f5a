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
// K7 advect2d_pair: both components in one launch.
// Replaces gerris_tpu/ops/pallas/bcg.py:advect2d_pair (_kernel_pair), both
// modes: the rhs mode (K14's output for each component) and the rr_dia
// mode, where each component's output is the residual r0 = rhs - (L - dia)
// v of its implicit-diffusion system at initial guess v, with the
// system's 1-cell ghosts in the same sgn/off encoding, and its two 2x2
// pools r1, r2: the first K8a launch of the diffusion pair folded in.
// K14 advect2d: one component.
// Replaces gerris_tpu/ops/pallas/bcg.py:advect2d (_kernel/_advect_core
// without the rr fold), with its g, gp and oscale folds.
// Computes (reference: gfs_cell_advected_face_values src/advection.c:58-99,
// gfs_face_upwinded_value :267-345, gfs_face_advection_flux :356-385):
//   the advecting cell velocities, the means of each cell's two MAC faces,
//   edge-extended past the domain (ucx, ucy);
//   per cell and axis, the BCG values of v at the high and low face
//   (gtt::bcg_value, un = uc along the axis, vt the other axis' uc);
//   per face, the Godunov choice on the MAC velocity uf, less dt/2 times
//   the face mean of g (edge ghosts: the Neumann-0 gmac BC); on the
//   component's own axis, the Dirichlet values on the domain faces;
//   fv = -dt/h (d(uf F)/dx + d(uf F)/dy), then fv -= dt gp, and with oscale
//   out = oscale (v + fv) (the implicit-diffusion rhs), else out = fv.
// Ghost cells of v follow stencil.cuh (ghost = sgn * mirror + off, two
// layers deep, a corner ghost the row ghost of a column ghost).
//
// The TPU kernel DMAs one 64-row strip with 8 halo rows of v0, v1, ufx,
// ufy, g0, g1 into VMEM once and computes both components from the same
// face buffers, whole-strip and vectorised (bcg.py:_advect_core).
// Bound: device-memory bytes (K7 reads v0, v1, ufx, ufy, g0, g1, gp0, gp1
// and writes two outputs, plus r1 and r2 in rr_dia mode: ~0.050 / 0.053
// ms at 2048^2 f32; K14 ~0.030).  ~75 flops per cell and component
// against 24 bytes per cell and component in f32 is below the card's
// ~20 f32 flops/byte.  What held the kernel from it was instructions: one
// thread per cell computed its four face fluxes, 8 BCG values per cell
// and component, each face twice (once by each neighbour), every value
// read through the ghost logic (~140 loads per cell from L1/L2).
// Design: one engine for K7 and K14 (a template on the component count
// NC), one block of 256 threads per TR x TC tile of cells:
//   1. load v of each component (halo 2, gtt::load_tile: ghosts resolved
//      once, 16-byte loads in the interior), the face means ucx, ucy (a
//      halo of 1, shared by the components) and g (halo 1, clamped) into
//      shared memory;
//   2. every x face flux (TR + 1) x TC and y face flux TR x (TC + 1) of
//      the tile once into shared memory, in one loop over the threads,
//      each face of each component from its two cells' BCG values (so
//      each BCG value is computed once), the components sharing the
//      face's uf and its cells' face means;
//   3. per cell, the flux differences, gp from device memory, oscale (v +
//      fv) (rr_dia: the residual from the tile's v, its r0 tile into
//      shared memory, then the pools per 2x2 and 4x4 group, K1's order).
// Every block runs the same compute code, edge or interior (the ghosts
// are in the tile), so a face on a block boundary gets the same value in
// both blocks and the results do not depend on the tile (ops/cuda/bcg.py:
// TILES; 16 x 32 by default: at 32 x 32 the f32 pair's 47 KB of shared
// memory held an SM to 4 blocks, at 16 x 32 it holds 8).  K14 is the
// NC = 1 instance, so K7 is two K14 launches bit for bit.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using gtt::Ghosts;

constexpr int TILE_THREADS = 256;

// The arguments of one launch of NC components
template <typename T, int NC>
struct TileArgs {
  const T* v[NC];
  const T* g[NC];   // nullptr: no gmac face correction
  const T* gp[NC];  // nullptr: no -dt gp
  T* out[NC];
  T* r1[NC];  // rr_dia mode: the pools of r0 = out
  T* r2[NC];
  const T* ufx;
  const T* ufy;
  Ghosts<T> gv[NC];
  T fb_lo[NC], fb_hi[NC];
  int fb_mask[NC];  // bit 0: the low face of the own axis is forced, bit 1
                    // the high face
  int axis0;        // the first component's axis (K7: 0, then 1)
  int n0, n1;
  T dt, h, dt_h, oscale, dia, h2;
  int use_os;
};

// Shared-memory layout of a tile, in elements of T: each component's v
// (rows i0 - 2 .. i0 + TR + 1, columns j0 - P .. j0 + TC + P - 1, P >= 2
// so that the rows are 16-byte aligned), ucx, ucy and each component's g
// (rows i0 - 1 .. i0 + TR, columns j0 - 1 .. j0 + TC), each component's
// x and y face fluxes.  rr_dia mode: the r0 tiles and their first pools
// take the place of ucx, ucy and g once the fluxes are done.
template <typename T, int NC, int TR, int TC>
struct Layout {
  static constexpr int P = 16 / sizeof(T);
  static constexpr int VR = TR + 4, VW = TC + 2 * P, V_SZ = VR * VW;
  static constexpr int UR = TR + 2, UW = TC + 2, U_SZ = UR * UW;
  static constexpr int FX_SZ = (TR + 1) * TC, FY_SZ = TR * (TC + 1);
  static constexpr int UCX = NC * V_SZ, UCY = UCX + U_SZ, G = UCY + U_SZ;
  static constexpr int FX = G + NC * U_SZ;
  static constexpr int SIZE = FX + NC * (FX_SZ + FY_SZ);
  static constexpr int R0 = UCX, S1 = R0 + NC * TR * TC;
  static_assert(S1 + NC * TR * TC / 4 <= FX, "r0 tiles overlap the fluxes");
  static_assert(TR % 4 == 0 && TC % 4 == 0, "pools want 4x4 groups");
  __host__ __device__ static constexpr int v(int q) { return q * V_SZ; }
  __host__ __device__ static constexpr int g(int q) { return G + q * U_SZ; }
  __host__ __device__ static constexpr int fx(int q) {
    return FX + q * (FX_SZ + FY_SZ);
  }
  __host__ __device__ static constexpr int fy(int q) {
    return fx(q) + FX_SZ;
  }
};

// uf F through one face along AXIS: uf the MAC velocity, vlo the low
// cell's v in the tile (the high cell at +1 along the axis, row stride
// VW), un and vt the two cells' face means along the axis and across it,
// g (nullptr: none) the low cell's g in its tile (the high cell at +su)
template <typename T, int AXIS, int VW>
__device__ __forceinline__ T face_flux(const T* vlo, const T (&un)[2],
                                       const T (&vt)[2], const T* g, int su,
                                       T uf, T dt, T dt_h) {
  constexpr int sa = AXIS == 0 ? VW : 1;
  const T left = gtt::bcg_value<T, AXIS>(vlo, VW, un[0], vt[0], dt_h, true);
  const T right =
      gtt::bcg_value<T, AXIS>(vlo + sa, VW, un[1], vt[1], dt_h, false);
  T F = gtt::godunov(uf, left, right);
  if (g) F = F - T(0.5) * (g[su] + g[0]) * dt / T(2);
  return uf * F;
}

// The flux of face k (row-major over x faces (TR + 1) x TC, or y faces
// TR x (TC + 1)) along AXIS of every component, into shared memory, if
// the face exists.  The components share the face's MAC velocity and its
// cells' face means.
template <typename T, int NC, int TR, int TC, int AXIS>
__device__ __forceinline__ void face_flux_at(const TileArgs<T, NC>& a, T* sm,
                                             int i0, int j0, int k) {
  using L = Layout<T, NC, TR, TC>;
  constexpr int FC = AXIS == 0 ? TC : TC + 1;
  constexpr int su = AXIS == 0 ? L::UW : 1;  // the high cell in ucx/ucy/g
  const int n0 = a.n0, n1 = a.n1;
  const int n = AXIS == 0 ? n0 : n1;
  const int r = k / FC, c = k % FC;
  const int i = i0 + r, j = j0 + c;
  if (AXIS == 0 ? (i > n0 || j >= n1) : (i >= n0 || j > n1)) return;
  const int f = AXIS == 0 ? i : j;
  // the low cell in the v tiles and in the ucx/ucy/g tiles
  const int sv = AXIS == 0 ? (r + 1) * L::VW + c + L::P
                           : (r + 2) * L::VW + c - 1 + L::P;
  const int su0 = AXIS == 0 ? r * L::UW + c + 1 : (r + 1) * L::UW + c;
  const T uf = AXIS == 0 ? __ldg(a.ufx + (size_t)i * n1 + j)
                         : __ldg(a.ufy + (size_t)i * (n1 + 1) + j);
  const T* ua = sm + (AXIS == 0 ? L::UCX : L::UCY);
  const T* ut = sm + (AXIS == 0 ? L::UCY : L::UCX);
  const T un[2] = {ua[su0], ua[su0 + su]};
  const T vt[2] = {ut[su0], ut[su0 + su]};
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const bool own = (NC == 2 ? q : a.axis0) == AXIS;  // forced faces
    T fl;
    if (own && f == 0 && (a.fb_mask[q] & 1))
      fl = uf * a.fb_lo[q];
    else if (own && f == n && (a.fb_mask[q] & 2))
      fl = uf * a.fb_hi[q];
    else
      fl = face_flux<T, AXIS, L::VW>(
          sm + L::v(q) + sv, un, vt, a.g[q] ? sm + L::g(q) + su0 : nullptr,
          su, uf, a.dt, a.dt_h);
    sm[(AXIS == 0 ? L::fx(q) : L::fy(q)) + k] = fl;
  }
}

// Every face flux of the tile, x faces then y faces in one loop over the
// block's threads (the x faces are whole warps: TC is a multiple of 32)
template <typename T, int NC, int TR, int TC>
__device__ __forceinline__ void face_fluxes(const TileArgs<T, NC>& a, T* sm,
                                            int i0, int j0, int t) {
  constexpr int NX = (TR + 1) * TC, NY = TR * (TC + 1);
  for (int k = t; k < NX + NY; k += TILE_THREADS) {
    if (k < NX)
      face_flux_at<T, NC, TR, TC, 0>(a, sm, i0, j0, k);
    else
      face_flux_at<T, NC, TR, TC, 1>(a, sm, i0, j0, k - NX);
  }
}

// rr_dia mode: the 2x2 means of an (R x C) tile s, rows first, then
// columns (K1's order), into the tile d (R/2 x C/2) and, where the group
// lies in the grid (rows < m0, columns < m1 of the pooled level), into
// dst at (r0, c0) with row stride ld
template <typename T, int R, int C>
__device__ __forceinline__ void pool_tile(const T* s, T* d, T* dst, int ld,
                                          int r0, int c0, int m0, int m1,
                                          int t) {
  constexpr int R2 = R / 2, C2 = C / 2;
  for (int k = t; k < R2 * C2; k += TILE_THREADS) {
    const int r = k / C2, c = k % C2;
    const T a = T(0.5) * (s[2 * r * C + 2 * c] + s[(2 * r + 1) * C + 2 * c]);
    const T b = T(0.5) * (s[2 * r * C + 2 * c + 1] +
                          s[(2 * r + 1) * C + 2 * c + 1]);
    const T m = T(0.5) * (a + b);
    if (d) d[k] = m;
    if (r0 + r < m0 && c0 + c < m1) dst[(size_t)(r0 + r) * ld + c0 + c] = m;
  }
}

template <typename T, int NC, bool RR, int TR, int TC>
__global__ void __launch_bounds__(TILE_THREADS)
    advect2d_kernel(const TileArgs<T, NC> a) {
  using L = Layout<T, NC, TR, TC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;
  const int n0 = a.n0, n1 = a.n1;
#pragma unroll
  for (int q = 0; q < NC; ++q)
    gtt::load_tile<T, L::VR, L::VW>(sm + L::v(q), L::VW, a.v[q], n0, n1,
                                    i0 - 2, j0 - L::P, 2, a.gv[q], t,
                                    TILE_THREADS);
  gtt::load_face_means<T, L::UR, L::UW>(sm + L::UCX, sm + L::UCY, a.ufx,
                                        a.ufy, n0, n1, i0 - 1, j0 - 1, t,
                                        TILE_THREADS);
#pragma unroll
  for (int q = 0; q < NC; ++q)
    if (a.g[q])
      gtt::load_clamped<T, L::UR, L::UW>(sm + L::g(q), a.g[q], n0, n1,
                                         i0 - 1, j0 - 1, t, TILE_THREADS);
  __syncthreads();
  face_fluxes<T, NC, TR, TC>(a, sm, i0, j0, t);
  __syncthreads();
  for (int k = t; k < TR * TC; k += TILE_THREADS) {
    const int r = k / TC, c = k % TC;
    const int i = i0 + r, j = j0 + c;
    if (i >= n0 || j >= n1) continue;
    const size_t kg = (size_t)i * n1 + j;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const T* fx = sm + L::fx(q);
      const T* fy = sm + L::fy(q);
      const T* v = sm + L::v(q) + (r + 2) * L::VW + c + L::P;
      const T dfx = fx[(r + 1) * TC + c] - fx[r * TC + c];
      const T dfy = fy[r * (TC + 1) + c + 1] - fy[r * (TC + 1) + c];
      T fv = -a.dt * dfx / a.h - a.dt * dfy / a.h;
      if (a.gp[q]) fv = fv - a.dt * __ldg(a.gp[q] + kg);
      T o = a.use_os ? a.oscale * (v[0] + fv) : fv;
      if constexpr (RR) {
        const T nb = v[-L::VW] + v[L::VW] + v[-1] + v[1];
        o = gtt::residual_value(o, nb, v[0], a.h2, a.dia);
        sm[L::R0 + q * TR * TC + k] = o;
      }
      a.out[q][kg] = o;
    }
  }
  if constexpr (RR) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NC; ++q)
      pool_tile<T, TR, TC>(sm + L::R0 + q * TR * TC,
                           sm + L::S1 + q * TR * TC / 4, a.r1[q], n1 / 2,
                           i0 / 2, j0 / 2, n0 / 2, n1 / 2, t);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NC; ++q)
      pool_tile<T, TR / 2, TC / 2>(sm + L::S1 + q * TR * TC / 4, nullptr,
                                   a.r2[q], n1 / 4, i0 / 4, j0 / 4, n0 / 4,
                                   n1 / 4, t);
  }
}

// the rr_dia mode's grids: whole tiles of the TPU kernel's and K1's
// 32 x 8 blocks (ops/cuda/bcg.py:RR_TILE)
constexpr int RR_COLS = 32, RR_ROWS = 8;

template <typename T, int NC, bool RR, int TR, int TC>
int launch_tile(const TileArgs<T, NC>& a, cudaStream_t stream) {
  static int smem_set[gtt::MAX_DEVICES];
  const size_t smem = Layout<T, NC, TR, TC>::SIZE * sizeof(T);
  auto kernel = advect2d_kernel<T, NC, RR, TR, TC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = gtt::allow_smem((const void*)kernel, smem_set);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.n1 + TC - 1) / TC, (a.n0 + TR - 1) / TR);
  kernel<<<grid, TILE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the tiles the wrappers take (ops/cuda/bcg.py:TILES)
template <typename T, int NC, bool RR>
int launch(const TileArgs<T, NC>& a, int tr, int tc, cudaStream_t stream) {
  if (tr == 32 && tc == 32) return launch_tile<T, NC, RR, 32, 32>(a, stream);
  if (tr == 16 && tc == 32) return launch_tile<T, NC, RR, 16, 32>(a, stream);
  if (tr == 16 && tc == 64) return launch_tile<T, NC, RR, 16, 64>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// Per-component arguments are host arrays, NC entries (4 per component for
// sgn/off, 2 for fb); component q's axis is axis0 + q.
template <typename T, int NC>
TileArgs<T, NC> tile_args(const void* const* v, const void* ufx,
                          const void* ufy, const void* const* g,
                          const void* const* gp, int n0, int n1, double dt,
                          double h, const double* sgn, const double* off,
                          int axis0, const int* fb_mask, const double* fb,
                          int use_os, double oscale, void* const* out) {
  TileArgs<T, NC> a = {};
  for (int q = 0; q < NC; ++q) {
    a.v[q] = (const T*)v[q];
    a.g[q] = (const T*)g[q];
    a.gp[q] = (const T*)gp[q];
    a.out[q] = (T*)out[q];
    a.gv[q] = gtt::make_ghosts<T>(sgn + 4 * q, off + 4 * q, 0);
    a.fb_mask[q] = fb_mask[q];
    a.fb_lo[q] = T(fb[2 * q]);
    a.fb_hi[q] = T(fb[2 * q + 1]);
  }
  a.ufx = (const T*)ufx;
  a.ufy = (const T*)ufy;
  a.axis0 = axis0;
  a.n0 = n0;
  a.n1 = n1;
  a.dt = T(dt);
  a.h = T(h);
  a.dt_h = T(dt / h);
  a.oscale = T(oscale);
  a.use_os = use_os;
  return a;
}

template <typename T>
int launch_advect2d(const void* v, const void* ufx, const void* ufy,
                    const void* g, const void* gp, int n0, int n1, double dt,
                    double h, const double* sgn, const double* off,
                    int fb_axis, int fb_mask, const double* fb, int use_os,
                    double oscale, void* out, int tr, int tc, void* stream) {
  const TileArgs<T, 1> a =
      tile_args<T, 1>(&v, ufx, ufy, &g, &gp, n0, n1, dt, h, sgn, off,
                      fb_axis, &fb_mask, fb, use_os, oscale, &out);
  return launch<T, 1, false>(a, tr, tc, (cudaStream_t)stream);
}

// rr != 0: the rr_dia mode, out = r0 and the pools r1, r2.  The C
// interface takes the device pointers as one host table: v, g, gp, out,
// r1, r2, two each.
template <typename T>
int launch_advect2d_pair(const void* const* v, const void* ufx,
                         const void* ufy, const void* const* g,
                         const void* const* gp, int n0, int n1, double dt,
                         double h, const double* sgn, const double* off,
                         const int* fb_mask, const double* fb, int use_os,
                         double oscale, int rr, double dia, double h2,
                         void* const* out, void* const* r1, void* const* r2,
                         int tr, int tc, void* stream) {
  if (rr && (n0 % RR_ROWS || n1 % RR_COLS)) return (int)cudaErrorInvalidValue;
  TileArgs<T, 2> a = tile_args<T, 2>(v, ufx, ufy, g, gp, n0, n1, dt, h, sgn,
                                     off, 0, fb_mask, fb, use_os, oscale,
                                     out);
  if (!rr) return launch<T, 2, false>(a, tr, tc, (cudaStream_t)stream);
  for (int q = 0; q < 2; ++q) {
    a.r1[q] = (T*)r1[q];
    a.r2[q] = (T*)r2[q];
  }
  a.dia = T(dia);
  a.h2 = T(h2);
  return launch<T, 2, true>(a, tr, tc, (cudaStream_t)stream);
}

}  // namespace

#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_advect2d_##SUFFIX(                                       \
      const void* v, const void* ufx, const void* ufy, const void* g,         \
      const void* gp, int n0, int n1, double dt, double h, const double* sgn, \
      const double* off, int fb_axis, int fb_mask, const double* fb,          \
      int use_os, double oscale, void* out, int tr, int tc, void* stream) {   \
    return launch_advect2d<T>(v, ufx, ufy, g, gp, n0, n1, dt, h, sgn, off,    \
                              fb_axis, fb_mask, fb, use_os, oscale, out, tr,  \
                              tc, stream);                                    \
  }                                                                           \
  extern "C" int gtt_advect2d_pair_##SUFFIX(                                  \
      void* const* ptr, const void* ufx, const void* ufy, int n0, int n1,     \
      double dt, double h, const double* sgn, const double* off,              \
      const int* fb_mask, const double* fb, int use_os, double oscale,        \
      int rr, double dia, double h2, int tr, int tc, void* stream) {          \
    return launch_advect2d_pair<T>(ptr, ufx, ufy, ptr + 2, ptr + 4, n0, n1,   \
                                   dt, h, sgn, off, fb_mask, fb, use_os,      \
                                   oscale, rr, dia, h2, ptr + 6, ptr + 8,     \
                                   ptr + 10, tr, tc, stream);                 \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
