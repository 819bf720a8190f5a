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
//
// The TPU kernel DMAs strips of U and V and builds their ghost rows and
// columns once per strip (predict.py:_kern_xy, ghost_cols).
// Bound: device-memory bytes (reads U, V; writes ufx, ufy [, div]; at
// 2048^2 f32 ~67 MB, ~20 us at 3.35 TB/s).  ~30 flops per face against
// 8 bytes moved per face in f32 is far below the card's flop/byte ratio.
// What held the kernel from it was instructions: one thread per cell
// computed its two low faces, each from two BCG values of five reads
// through the ghost logic, and wrote ufy rows that stride n1 + 1 with the
// domain's last faces by a branch in one lane.
// Design: one block of 256 threads per TR x TC tile of cells loads U and
// V (halo 2, gtt::load_tile: ghosts resolved once, periodic y wrapped,
// 16-byte loads in the interior) into shared memory, computes every x face
// (TR + 1) x TC and y face TR x (TC + 1) of the tile once into shared
// memory, each from its two cells' BCG values, then stores them as runs
// along the rows (ufx 16 bytes a thread where its rows are aligned; ufy's
// rows stride n1 + 1), the domain's last faces with the last tile's runs.
// Under periodic y, face n1 is computed from the wrapped halo, which holds
// face 0's cells: the same value.  Every block runs the same compute code
// (the ghosts are in the tile), so the faces do not depend on the tile.
// With div_scale the block also forms each cell's divergence from the
// faces in shared memory (gtt::mac_divergence's expression, so K4 on
// these faces gives the same div bit for bit), and the block partial sums
// follow projops.cu's two-pass scheme.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using gtt::Ghosts;

constexpr int TILE_THREADS = 256;

template <typename T>
struct PredictArgs {
  const T* u;
  const T* v;
  T* ufx;
  T* ufy;
  T* div;  // nullptr: no divergence
  T* partials;
  int n0, n1;
  T dt_h, div_scale;
  Ghosts<T> gu, gv;
  T fbx_lo, fbx_hi, fby_lo, fby_hi;
};

// Shared-memory layout of a tile, in elements of T: U and V (rows i0 - 2
// .. i0 + TR + 1, columns j0 - P .. j0 + TC + P - 1, 16-byte aligned
// rows), the x faces (TR + 1) x TC, the y faces TR x (TC + 1), the block
// sum's buffer.
template <typename T, int TR, int TC>
struct Layout {
  static constexpr int P = 16 / sizeof(T);
  static constexpr int VW = TC + 2 * P, V_SZ = (TR + 4) * VW;
  static constexpr int FX = 2 * V_SZ, FY = FX + (TR + 1) * TC;
  static constexpr int RED = FY + TR * (TC + 1);
  static constexpr int SIZE = RED + TILE_THREADS;
};

// ``rows`` rows of the tile's x faces (fx, row stride TC) into ufx (row
// stride n1) from face row i0, column j0 on: runs along the rows, 16
// bytes a thread where ufx's rows are 16-byte aligned
template <typename T, int TC>
__device__ __forceinline__ void store_x_faces(T* __restrict__ ufx, int n1,
                                              const T* __restrict__ fx,
                                              int i0, int j0, int rows,
                                              int t) {
  constexpr int VEC = 16 / sizeof(T);
  using V16 = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;
  if (TC % VEC == 0 && n1 % VEC == 0 &&
      reinterpret_cast<size_t>(ufx) % 16 == 0) {
    constexpr int CV = TC / VEC;
    for (int k = t; k < rows * CV; k += TILE_THREADS) {
      const int r = k / CV, c = (k % CV) * VEC;
      if (j0 + c < n1)
        *reinterpret_cast<V16*>(ufx + (size_t)(i0 + r) * n1 + j0 + c) =
            *reinterpret_cast<const V16*>(fx + r * TC + c);
    }
  } else {
    for (int k = t; k < rows * TC; k += TILE_THREADS) {
      const int r = k / TC, c = k % TC;
      if (j0 + c < n1) ufx[(size_t)(i0 + r) * n1 + j0 + c] = fx[k];
    }
  }
}

template <typename T, int TR, int TC>
__global__ void __launch_bounds__(TILE_THREADS)
    predict_xy_kernel(const PredictArgs<T> a) {
  using L = Layout<T, TR, TC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* su = sm;
  T* sv = sm + L::V_SZ;
  T* fx = sm + L::FX;
  T* fy = sm + L::FY;
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;
  const int n0 = a.n0, n1 = a.n1;
  gtt::load_tile<T, TR + 4, L::VW>(su, L::VW, a.u, n0, n1, i0 - 2,
                                   j0 - L::P, 2, a.gu, t, TILE_THREADS);
  gtt::load_tile<T, TR + 4, L::VW>(sv, L::VW, a.v, n0, n1, i0 - 2,
                                   j0 - L::P, 2, a.gv, t, TILE_THREADS);
  __syncthreads();
  // x faces f = i0 + r of u at column j0 + c (cells f - 1 and f), then
  // y faces f = j0 + c of v at row i0 + r (cells f - 1 and f), in one
  // loop over the block's threads (the x faces are whole warps)
  constexpr int NX = (TR + 1) * TC;
  for (int k = t; k < NX + TR * (TC + 1); k += TILE_THREADS) {
    if (k < NX) {
      const int r = k / TC, c = k % TC;
      const int f = i0 + r;
      if (f > n0 || j0 + c >= n1) continue;
      T val;
      if (f == 0) {
        val = a.fbx_lo;
      } else if (f == n0) {
        val = a.fbx_hi;
      } else {
        const int s = (r + 1) * L::VW + c + L::P;  // cell f - 1
        const T* ul = su + s;
        const T un = T(0.5) * (ul[0] + ul[L::VW]);
        val = gtt::godunov(
            un, gtt::bcg_value<T, 0>(ul, L::VW, ul[0], sv[s], a.dt_h, true),
            gtt::bcg_value<T, 0>(ul + L::VW, L::VW, ul[L::VW], sv[s + L::VW],
                                 a.dt_h, false));
      }
      fx[k] = val;
    } else {
      const int r = (k - NX) / (TC + 1), c = (k - NX) % (TC + 1);
      const int f = j0 + c;
      if (i0 + r >= n0 || f > n1) continue;
      T val;
      if (!a.gv.per_y && f == 0) {
        val = a.fby_lo;
      } else if (!a.gv.per_y && f == n1) {
        val = a.fby_hi;
      } else {
        const int s = (r + 2) * L::VW + c - 1 + L::P;  // cell f - 1
        const T* vl = sv + s;
        const T un = T(0.5) * (vl[0] + vl[1]);
        val = gtt::godunov(
            un, gtt::bcg_value<T, 1>(vl, L::VW, vl[0], su[s], a.dt_h, true),
            gtt::bcg_value<T, 1>(vl + 1, L::VW, vl[1], su[s + 1], a.dt_h,
                                 false));
      }
      fy[k - NX] = val;
    }
  }
  __syncthreads();
  // the tile's x faces i0 .. i0 + TR - 1, and face n0 in the last tile
  const int rows = i0 + TR >= n0 ? n0 - i0 + 1 : TR;
  store_x_faces<T, TC>(a.ufx, n1, fx, i0, j0, rows, t);
  // the tile's y faces j0 .. j0 + TC - 1, and face n1 in the last tile
  for (int k = t; k < TR * (TC + 1); k += TILE_THREADS) {
    const int r = k / (TC + 1), c = k % (TC + 1);
    const int i = i0 + r, f = j0 + c;
    if (i < n0 && f <= n1 && (c < TC || f == n1))
      a.ufy[(size_t)i * (n1 + 1) + f] = fy[k];
  }
  if (!a.div) return;
  T acc = T(0);
  for (int k = t; k < TR * TC; k += TILE_THREADS) {
    const int r = k / TC, c = k % TC;
    const int i = i0 + r, j = j0 + c;
    if (i >= n0 || j >= n1) continue;
    const int ky = r * (TC + 1) + c;
    const T d = ((fx[k + TC] - fx[k]) + (fy[ky + 1] - fy[ky])) * a.div_scale;
    a.div[(size_t)i * n1 + j] = d;
    acc += d;
  }
  const T s = gtt::block_sum(acc, sm + L::RED);
  if (t == 0) a.partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

template <typename T, int TR, int TC>
int launch_tile(const PredictArgs<T>& a, cudaStream_t stream) {
  static int smem_set[gtt::MAX_DEVICES];
  const size_t smem = Layout<T, TR, TC>::SIZE * sizeof(T);
  auto kernel = predict_xy_kernel<T, TR, TC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = gtt::allow_smem((const void*)kernel, smem_set);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.n1 + TC - 1) / TC, (a.n0 + TR - 1) / TR);
  kernel<<<grid, TILE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_predict_xy(const void* u, const void* v, int n0, int n1,
                      double dt_h, const double* sgn_u, const double* off_u,
                      const double* sgn_v, const double* off_v, int per_y,
                      const double* fb, double div_scale, void* ufx,
                      void* ufy, void* div, void* partials, void* total,
                      int tr, int tc, void* stream) {
  const PredictArgs<T> a{(const T*)u,
                         (const T*)v,
                         (T*)ufx,
                         (T*)ufy,
                         (T*)div,
                         (T*)partials,
                         n0,
                         n1,
                         T(dt_h),
                         T(div_scale),
                         gtt::make_ghosts<T>(sgn_u, off_u, per_y),
                         gtt::make_ghosts<T>(sgn_v, off_v, per_y),
                         T(fb[0]),
                         T(fb[1]),
                         T(fb[2]),
                         T(fb[3])};
  const cudaStream_t s = (cudaStream_t)stream;
  int e;
  // the tiles the wrapper takes (ops/cuda/bcg.py:TILES)
  if (tr == 32 && tc == 32) e = launch_tile<T, 32, 32>(a, s);
  else if (tr == 16 && tc == 32) e = launch_tile<T, 16, 32>(a, s);
  else if (tr == 16 && tc == 64) e = launch_tile<T, 16, 64>(a, s);
  else return (int)cudaErrorInvalidValue;
  if (e || !div) return e;
  const int nblocks = ((n1 + tc - 1) / tc) * ((n0 + tr - 1) / tr);
  return gtt::launch_sum<T>((const T*)partials, nblocks, (T*)total, s);
}

}  // namespace

#define GTT_EXPORT(SUFFIX, T)                                                \
  extern "C" int gtt_predict_xy_##SUFFIX(                                    \
      const void* u, const void* v, int n0, int n1, double dt_h,             \
      const double* sgn_u, const double* off_u, const double* sgn_v,         \
      const double* off_v, int per_y, const double* fb, double div_scale,    \
      void* ufx, void* ufy, void* div, void* partials, void* total, int tr,  \
      int tc, void* stream) {                                                \
    return launch_predict_xy<T>(u, v, n0, n1, dt_h, sgn_u, off_u, sgn_v,     \
                                off_v, per_y, fb, div_scale, ufx, ufy, div,  \
                                partials, total, tr, tc, stream);            \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
