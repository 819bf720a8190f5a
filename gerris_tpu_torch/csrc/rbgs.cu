// Multigrid kernels for Hopper (sm_90a): the fixed sawtooth cycle of
// gerris_tpu_torch/solvers/poisson.py:fused_cycle and its U+V pair
// (poisson.py:solve_fixed_batched), and the adaptive solve's residual,
// smoother and coarse cascade (poisson.py:correction, solve_relax).
//
// Nine kernels, each templated on float and double, behind a plain C
// interface (loaded with ctypes by gerris_tpu_torch/ops/cuda/rbgs.py):
//
//   residual_restrict  r0 = (rhs - sub) - (L - dia) u with static ghosts,
//                      r1 = pool(r0), r2 = pool(r1), in one launch;
//   restrict_pyramid   successive 2x2 mean pools of a level, every level in
//                      one launch (the cascades' and corrections'
//                      restriction; restrict2 is its one-level case);
//   prolong_relax      bilinear prolongation of a coarse correction (or
//                      du = 0) + nsweeps red-black Gauss-Seidel sweeps
//                      (+ u), in one launch;
//   residual           r = rhs - (L - dia) u, periodic on either axis;
//   rbgs_relax         nsweeps red-black sweeps from a given u, periodic
//                      on either axis, in one launch;
//   rbgs_relax_alpha   the same with face coefficients and a scalar or
//                      per-cell dia (div(alpha grad u) - dia u = rhs),
//                      from a given u or from a prolonged coarse
//                      correction (+ u);
//   coarse_block       a cascade's levels at and below 64^2 (du = 0 and
//                      sweeps at the coarsest, prolong + sweeps above),
//                      one block per system, in one launch;
//   residual_restrict_div  residual_restrict with rhs = div(uf) / dt formed
//                      from the MAC faces in the kernel;
//   prolong_relax_correct  prolong_relax (+ u) with the projection's
//                      correction by the result as its epilogue;
//   and the cascades (ops/cuda/rbgs.py:cascade_prolong_relax and
//   coarse_vcycle) are host sequences of one restrict_pyramid launch, one
//   coarse_block launch for the levels at and below 64^2, and
//   prolong_relax launches above.
//
// One sweep engine (pr_relax) runs every tiled red-black smoother: K3,
// K8c, K17, the K3 launches of K2, K8b and K12, K10 and K15.  Its
// compile-time parameters are the placement (the prolonged coarse
// correction or zero, or a given u), the coefficients (the constant
// 1 / (4 + dia h2), or face coefficients with a per-cell denominator)
// and periodic rows, so that no instance pays for another's branches.
//
// The first three, restrict_pyramid and coarse_block take a batch of 1 or
// 2 independent systems of one size (coarse_block one block per system):
// gridDim.z is the batch and blockIdx.z picks the system's pointers and
// scalars from a small struct passed by value.  A single solve launches
// with a batch of 1 (K1-K3); the U+V implicit-diffusion pair launches the
// same kernels with a batch of 2 (K8a-c, the TPU's *_pair kernels), so a
// system's output in the pair is the single launch's by construction.
// The ghost signs and the periodicity are shared by the batch, as in the
// TPU kernels; dia, sub and the ghost offsets are per system.
//
// Layouts are logical: a cell field is a contiguous (n0, n1) row-major
// array, axis 1 contiguous.  Ghost encoding per side: ghost =
// sgn * mirror + off, sides ordered (x lo, x hi, y lo, y hi); a periodic
// axis wraps instead.  Every launch is on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
//
// All are stencils with a few flops per loaded value and no tensor-core
// work: bytes moved between device memory and the SMs bound the fine
// levels on the H100, so each design keeps intermediates in shared memory
// and reads each input tile once; the coarse levels are bound by launches
// and by the barriers between serial half-sweeps.

#include <cuda_runtime.h>

#include <cmath>

#include "stencil.cuh"

namespace {

constexpr int MAX_BATCH = 2;
// residual_restrict's block: 32 x (rows / 4) threads, each owning a 4 x 4
// patch of r0, so a block covers rows x RR_COLS cells (rows 32 by
// default, 8 or 16 on request; the level's own size where it is
// smaller); its u tile's rows are RR_LD wide, the interior from column 4
// (16-byte aligned) with the halo at 3 and 4 + RR_COLS
constexpr int RR_ROWS = 32;
constexpr int RR_COLS = 128;
constexpr int RR_LD = RR_COLS + 8;

// One system of a residual_restrict launch.  K16 (residual_restrict_div)
// forms the rhs from the MAC faces ufx, ufy instead of reading rhs.
template <typename T>
struct RRSystem {
  const T* u;
  const T* rhs;
  const T* ufx;
  const T* ufy;
  T div_scale;   // 1 / (dt h)
  const T* sub;  // one value in device memory, or nullptr for 0
  T dia;
  T off[4];
  T* r0;
  T* r1;
  T* r2;
};

template <typename T>
struct RRArgs {
  RRSystem<T> sys[MAX_BATCH];
  T h2;
  int n0, n1;
  T sgn[4];
  int per_y;
  int vec;  // every field's pointer 16-byte aligned: vector loads, stores
};

// One system of a sweep-engine launch (pr_relax).
template <typename T>
struct PRSystem {
  // PL_PROLONG: the coarse correction, prolonged at placement (nullptr:
  // start from du = 0); PL_GIVEN: the start value
  const T* src;
  const T* rhs;
  const T* u;  // nullptr: return du, else u + du
  T* out;
  T inv_denom;  // CF_CONST: 1 / (4 + dia h2)
};

template <typename T>
struct PRArgs {
  PRSystem<T> sys[MAX_BATCH];
  int n0, n1, tile, halo, nsweeps;
  T h2, omega, one_m_omega;
  int use_omega;
  T sgn[4];
  int per_y;
};

// The sweep engine's placement of the start value, and its coefficients
enum Place { PL_PROLONG, PL_GIVEN };
enum Coef { CF_CONST, CF_FACES };

// The face coefficients of a CF_FACES engine (K15): ax ((n0+1) x n1), ay
// (n0 x (n1+1)), and a cell dia or (dia == nullptr) the scalar dia_s
template <typename T>
struct PRFaces {
  const T* ax;
  const T* ay;
  const T* dia;
  T dia_s;
};

// the 2x2 mean of a cell's children a = (2i, 2j), b = (2i, 2j + 1),
// c = (2i + 1, 2j), d = (2i + 1, 2j + 1): rows first, then columns
template <typename T>
__device__ __forceinline__ T mean4(T a, T b, T c, T d) {
  const T x = T(0.5) * (a + c);
  const T y = T(0.5) * (b + d);
  return T(0.5) * (x + y);
}

// Four consecutive cells from or to device or shared memory, by 16-byte
// vectors where `vec` (the address 16-byte aligned), else one by one;
// two by one 8-byte (float) or 16-byte (double) vector
__device__ __forceinline__ void ld4(const float* p, float* v, bool vec) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    for (int e = 0; e < 4; ++e) v[e] = p[e];
  }
}
__device__ __forceinline__ void ld4(const double* p, double* v, bool vec) {
  if (vec) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    const double2 r = *reinterpret_cast<const double2*>(p + 2);
    v[0] = q.x, v[1] = q.y, v[2] = r.x, v[3] = r.y;
  } else {
    for (int e = 0; e < 4; ++e) v[e] = p[e];
  }
}
__device__ __forceinline__ void st4(float* p, const float* v, bool vec) {
  if (vec) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else for (int e = 0; e < 4; ++e) p[e] = v[e];
}
__device__ __forceinline__ void st4(double* p, const double* v, bool vec) {
  if (vec) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  } else {
    for (int e = 0; e < 4; ++e) p[e] = v[e];
  }
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ void st2(float* p, float a, float b, bool vec) {
  if (vec) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else p[0] = a, p[1] = b;
}
__device__ __forceinline__ void st2(double* p, double a, double b, bool vec) {
  if (vec) *reinterpret_cast<double2*>(p) = make_double2(a, b);
  else p[0] = a, p[1] = b;
}

// ---------------------------------------------------------------------------
// K1 residual_restrict (batch 1) and K8a residual_restrict_pair (batch 2).
// Replaces gerris_tpu/ops/pallas/rbgs.py:residual_restrict (core _rr_core)
// and residual_restrict_pair (_resid_restrict_kernel_pair).
// Bound: device-memory bytes (reads u and rhs, writes r0 + r0/4 + r0/16,
// per system: at 2048^2 float32 ~53 MB, ~16 us).
// Design: a block of 32 x 8 threads covers a wide tile of 32 x 128 cells,
// each thread a 4 x 4 patch of r0 (tiles of 8 or 16 rows on request, to
// time them).  The u tile, its ghost rows (sgn * u + off, or the
// neighbour tiles' rows) and its two halo columns sit in shared memory,
// loaded by 16-byte vectors (the columns one value a row); one barrier.
// A thread reads its patch's rows by 16-byte vectors and its left and
// right neighbours from the next lanes (shuffles) or the halo, reads rhs
// and writes r0 by 16-byte vectors, and pools its patch's 2 x 2 of r1
// and its one r2 in registers: no barrier and no shared buffer for the
// pools, and a warp's r1 pairs and r2 values land on contiguous
// addresses.  Every value is one expression in one order whatever the
// tile (gtt::residual_value, the neighbour sum up + down + left + right,
// mean4 rows first, K16's div * scale - sub one fused multiply-add), so
// r0, r1 and r2 do not depend on the tiling.
//
// K16 residual_restrict_div (DIV = true, batch 1).
// Replaces gerris_tpu/ops/pallas/rbgs.py:residual_restrict_div
// (_resid_restrict_div_kernel): the MAC projection's K4 + K1 in one
// launch on the fold route.
// Bound: device-memory bytes (reads u, ufx and ufy, writes r0 + r0/4 +
// r0/16; at 2048^2 f32 4.31 n^2 words, ~72 MB, ~22 us).
// Design: K1's tile; a thread forms its patch's rhs - sub from the four
// faces of each cell (gtt::divergence_sum, K4's face sum, times the scale
// minus sub in one fused multiply-add) in registers, so div never goes to
// device memory; the x faces are read by 16-byte vectors, the y faces
// (rows of n1 + 1, so unaligned) one by one, coalesced.
// ---------------------------------------------------------------------------
template <typename T, bool DIV>
__global__ void __launch_bounds__(256) residual_restrict_kernel(RRArgs<T> a) {
  __shared__ __align__(16) T su[RR_ROWS + 2][RR_LD];
  const RRSystem<T> s = blockIdx.z ? a.sys[1] : a.sys[0];
  const int n0 = a.n0, n1 = a.n1;
  const int nt = 32 * blockDim.y;
  const int rows = min(4 * (int)blockDim.y, n0), cols = min(RR_COLS, n1);
  const int i0 = blockIdx.y * rows, j0 = blockIdx.x * cols;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * 32 + tx;
  const bool vec = a.vec;
  // the tile's rows and its ghost or neighbour rows, 4 cells at a time
  const int q4 = cols / 4;
  for (int k = t; k < (rows + 2) * q4; k += nt) {
    const int li = k / q4, q = k - li * q4;
    const int gi = i0 + li - 1;
    const int mi = gi < 0 ? 0 : gi >= n0 ? n0 - 1 : gi;
    T v[4];
    ld4(s.u + (size_t)mi * n1 + j0 + 4 * q, v, vec);
    if (gi < 0) {
      for (int e = 0; e < 4; ++e) v[e] = a.sgn[0] * v[e] + s.off[0];
    } else if (gi >= n0) {
      for (int e = 0; e < 4; ++e) v[e] = a.sgn[1] * v[e] + s.off[1];
    }
    st4(&su[li][4 + 4 * q], v, true);
  }
  // the halo columns of the tile's rows (corner ghosts are never read)
  for (int k = t; k < 2 * rows; k += nt) {
    const int li = 1 + (k >> 1);
    const T* row = s.u + (size_t)(i0 + li - 1) * n1;
    if (!(k & 1)) {
      su[li][3] = j0 > 0 ? row[j0 - 1]
                  : a.per_y ? row[n1 - 1]
                            : a.sgn[2] * row[0] + s.off[2];
    } else {
      su[li][4 + cols] = j0 + cols < n1 ? row[j0 + cols]
                         : a.per_y ? row[0]
                                   : a.sgn[3] * row[n1 - 1] + s.off[3];
    }
  }
  __syncthreads();
  const T sub = s.sub ? *s.sub : T(0);
  // the thread's patch: rows lr..lr+3, columns lc..lc+3 of the tile.  Every
  // thread computes (the shuffles want the whole warp): a patch outside a
  // smaller level's tile reads shared memory inside the buffer and the
  // level's first rows in device memory, and only a patch inside the
  // level stores
  const int lr = 4 * ty, lc = 4 * tx;
  const bool live = lr < rows && lc < cols;
  const int gi0 = live ? i0 + lr : 0, gj0 = live ? j0 + lc : 0;
  T r0[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int li = lr + rr + 1;
    T up[4], c[4], dn[4], rhs[4];
    ld4(&su[li - 1][4 + lc], up, true);
    ld4(&su[li][4 + lc], c, true);
    ld4(&su[li + 1][4 + lc], dn, true);
    const T lf_lane = __shfl_up_sync(0xffffffffu, c[3], 1);
    const T rt_lane = __shfl_down_sync(0xffffffffu, c[0], 1);
    const T lf = tx == 0 ? su[li][3] : lf_lane;
    const T rt = lc + 4 == cols ? su[li][4 + cols] : rt_lane;
    const size_t g = (size_t)(gi0 + rr) * n1 + gj0;
    // rhs - sub; K16's rhs is the faces' divergence times the scale, and
    // div * scale - sub is one fused multiply-add, written out so that
    // nvcc's contraction (which stops at a basic block's edge) cannot
    // round some cells of a patch otherwise than others
    if (DIV) {
      T x0[4], x1[4];
      ld4(s.ufx + g, x0, vec);
      ld4(s.ufx + g + n1, x1, vec);
      const T* fy = s.ufy + (size_t)(gi0 + rr) * (n1 + 1) + gj0;
      for (int e = 0; e < 4; ++e)
        rhs[e] = fma_rn(gtt::divergence_sum(x0[e], x1[e], fy[e], fy[e + 1]),
                        s.div_scale, -sub);
    } else {
      ld4(s.rhs + g, rhs, vec);
      for (int e = 0; e < 4; ++e) rhs[e] = rhs[e] - sub;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const T l = cc > 0 ? c[cc - 1] : lf;
      const T r = cc < 3 ? c[cc + 1] : rt;
      const T nb = up[cc] + dn[cc] + l + r;
      r0[rr][cc] = gtt::residual_value(rhs[cc], nb, c[cc], a.h2, s.dia);
    }
    if (live) st4(s.r0 + (size_t)(gi0 + rr) * n1 + gj0, r0[rr], vec);
  }
  if (!live) return;
  // the patch's 2 x 2 of r1 and its r2, in registers
  T m[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      m[p][q] = mean4(r0[2 * p][2 * q], r0[2 * p][2 * q + 1],
                      r0[2 * p + 1][2 * q], r0[2 * p + 1][2 * q + 1]);
  const int h1 = n1 / 2;
  for (int p = 0; p < 2; ++p)
    st2(s.r1 + (size_t)(gi0 / 2 + p) * h1 + gj0 / 2, m[p][0], m[p][1], vec);
  s.r2[(size_t)(gi0 / 4) * (n1 / 4) + gj0 / 4] =
      mean4(m[0][0], m[0][1], m[1][0], m[1][1]);
}

// ---------------------------------------------------------------------------
// restrict_pyramid: `levels` successive 2x2 mean pools of an n0 x n1
// level (n0/2 x n1/2, ..., n0 >> levels x n1 >> levels; a square level
// or a box of several unit boxes, such as n x 2n), per system, in one
// launch; restrict2 is its one-level case.
// Replaces the cascades' in-VMEM restriction pyramid of
// gerris_tpu/ops/pallas/rbgs.py:cascade_prolong_relax and
// cascade_prolong_relax_pair (_cp_core's _row_pool + _lane_pool,
// rbgs.py:915-944 and 1310-1330), and the chains of one-level pools that
// K12's and the adaptive corrections' levels ran from the host.
// Bound: device-memory bytes (reads the top level once, writes each level
// once: 1/3 of the top's bytes more); at the cascades' 512^2 top that is
// ~1.4 MB, under 1 us at 3.35 TB/s, so one launch's latency bounds it and
// the design's point is to make it one launch instead of one per level.
// Design: one block per tile x tile tile of the top, the tile PY_TILE or
// the largest power of two below it that divides both sides (the whole
// top of a square level below PY_TILE), one thread per cell of the first
// level, which it forms
// from its four children in device memory; the block's later levels come
// from shared memory, each written once.  Levels coarser than one cell
// per tile are finished in the same launch by the last block to arrive
// (a device-wide arrival count per system and __threadfence), which
// reads the one-cell-per-tile level back from L2 and then resets the
// count to 0 for the next launch on the stream, so no memset launch is
// needed.  Every cell is independent of the tiling: the mean of its
// four children, rows first, 0.5 * (0.5 (a + c) + 0.5 (b + d)) (the plain
// version's order, ops/cuda/rbgs.py:pool_plain), so every level is bit
// for bit the chain of one-level pools; multiplying by 0.5 is exact, so
// FMA contraction changes no bit either.
// ---------------------------------------------------------------------------
constexpr int PY_TILE = 32;  // top cells per block side: 16 x 16 threads

// One system of a restrict_pyramid launch: the levels back to back in
// `out`, the finest first; `count` the blocks' arrivals (nullptr when no
// level is coarser than one cell per tile).
template <typename T>
struct PYSystem {
  const T* r;
  T* out;
  unsigned int* count;
};

template <typename T>
struct PYArgs {
  PYSystem<T> sys[MAX_BATCH];
  int n0, n1, levels, tile;
};

template <typename T>
__global__ void restrict_pyramid_kernel(PYArgs<T> a) {
  __shared__ T sl[PY_TILE / 2][PY_TILE / 2 + 1];
  __shared__ int last;
  const PYSystem<T> s = blockIdx.z ? a.sys[1] : a.sys[0];
  const int n1 = a.n1, half = a.tile / 2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // level 1: one cell per thread from its children in device memory
  int m0 = a.n0 / 2, m1 = n1 / 2, w = half, lv = 1;
  const int i = blockIdx.y * half + ty, j = blockIdx.x * half + tx;
  const T* p = s.r + (size_t)(2 * i) * n1 + 2 * j;
  T v = mean4(p[0], p[1], p[n1], p[n1 + 1]);
  T* out = s.out;
  out[(size_t)i * m1 + j] = v;
  // the block's coarser levels, from its own cells in shared memory
  while (lv < a.levels && w > 1) {
    if (ty < w && tx < w) sl[ty][tx] = v;
    __syncthreads();
    out += (size_t)m0 * m1;
    m0 /= 2;
    m1 /= 2;
    w /= 2;
    ++lv;
    if (ty < w && tx < w) {
      v = mean4(sl[2 * ty][2 * tx], sl[2 * ty][2 * tx + 1],
                sl[2 * ty + 1][2 * tx], sl[2 * ty + 1][2 * tx + 1]);
      out[(size_t)(blockIdx.y * w + ty) * m1 + blockIdx.x * w + tx] = v;
    }
    __syncthreads();
  }
  if (lv == a.levels) return;
  // levels coarser than one cell per tile: the last block to arrive
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0)
    last = atomicAdd(s.count, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int t = ty * half + tx, nt = half * half;
  while (lv < a.levels) {
    const T* f = out;
    const int mf = m1;
    out += (size_t)m0 * m1;
    m0 /= 2;
    m1 /= 2;
    ++lv;
    for (int k = t; k < m0 * m1; k += nt) {
      const int ci = k / m1, cj = k - ci * m1;
      const T* q = f + (size_t)(2 * ci) * mf + 2 * cj;
      // other blocks wrote the first of these levels: read it from L2
      out[k] = mean4(__ldcg(q), __ldcg(q + 1), __ldcg(q + mf),
                     __ldcg(q + mf + 1));
    }
    __threadfence();
    __syncthreads();
  }
  if (t == 0) *s.count = 0u;
}

// ---------------------------------------------------------------------------
// K3 prolong_relax (batch 1) and K8c prolong_relax_pair (batch 2).
// Replaces gerris_tpu/ops/pallas/rbgs.py:prolong_relax (core _pr_core) and
// prolong_relax_pair (_prolong_relax_kernel_pair).
// Bound: device-memory bytes for the fine levels (reads coarse/4 + rhs
// (+ u), writes du once for all sweeps); at the coarse levels that fit
// one block, launch latency and the block's serial sweeps.
// Design: one block per tile x tile output tile of one system, the tile
// chosen per level by the wrapper (the largest whose buffers fit shared
// memory and that still gives every SM a block).  The block's shared
// buffers hold the tile plus a halo of `halo` = 2*nsweeps cells and one
// outer frozen ring; the prolonged du and the rhs are placed there once,
// and every half-sweep updates the cells of one global colour (i+j)%2.
// The valid region shrinks by at most one cell per half-sweep, so after
// 2*nsweeps half-sweeps the tile is exact (the TPU kernel's own argument,
// rbgs.py:5-10).  The sweep engine, pr_relax, is shared by K3, K8c, the
// K3 launches of the cascades K2, K8b and K12, K17, K10 and K15 (its
// placement, coefficients and periodic rows are template parameters;
// K3's instance prolongs or starts from zero, with the constant
// coefficient and non-periodic rows):
// * colour-split storage: a buffer cell (li, lj) lies in the half of its
//   local parity (li + lj) & 1, at li * B/2 + lj / 2, so a half-sweep's
//   cells are one half, read and written at unit stride, and their four
//   neighbours the other half at unit stride: no lane idles on the other
//   colour, and no two lanes of a warp share a bank;
// * a shrinking update region: half-sweep s (1-based) updates only the
//   cells within 2*nsweeps - s (+1 for K17's ring) of the tile, the
//   cells that the tile's final values depend on; the others would be
//   overwritten by nothing that is read, so the result is that of
//   updating the whole buffer, bit for bit, at ~half the work at tile 64;
// * no ghost cells in the sweeps: a cell on a domain edge reads its
//   ghost as sgn * its own value (a whole-level block's periodic row or
//   column as the cell across the wrap, which is of the other colour), the
//   value that a ghost refreshed before the half-sweep held; only blocks
//   that touch a domain edge test for it, and a half-sweep costs one
//   barrier.
// A level that fits one block is run with tile = n and halo = 0: the
// buffer is the whole level plus its ghost ring; the pair then runs as
// two blocks.  src == nullptr starts from du = 0 (the coarsest level);
// u != nullptr adds u to the result.
// ---------------------------------------------------------------------------
// threads of a K3 block (K10's and K15's come from their wrapper's
// plan, ops/cuda/rbgs.py:_sweep_plan): 512 for the largest tiles, whose
// half-sweeps have ~1500-3500 cells (16 warps hide the shared-memory
// latency of a half-sweep better than 8: 0.119 against 0.146 ms for K3
// at 2048^2 on an H100), 256 for smaller tiles and whole levels, whose
// half-sweeps are short and whose barriers then cost more with more warps
constexpr int PR_THREADS = 512;
__host__ __forceinline__ int pr_threads(int tile, int halo) {
  return halo > 0 && tile >= 64 ? 512 : 256;
}

// The colour-split buffer of a side-B square: half (li + lj) & 1, row
// stride B / 2 (B is even), each half `hs` entries, padded so that hs % 32
// is 16: the two halves of a row's neighbouring cells then fall in other
// banks (the placement and the tile's writes read both)
__host__ __device__ __forceinline__ int pr_half(int B) {
  const int e = B * (B / 2);
  return e + ((48 - e % 32) % 32);
}

struct PRBuf {
  int B, H, hs;
  __device__ __forceinline__ int at(int li, int lj) const {
    return ((li + lj) & 1) * hs + li * H + (lj >> 1);
  }
};

// Products and sums that nvcc never contracts into an FMA: each rounded
// on its own, as PyTorch's separate elementwise kernels round them (K15's
// prolongation, so that it gives prolong_plain's bits)
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

// The shared buffers of an engine block, each 2 * hs entries (pr_half):
// du and rhs, then with CF_FACES each cell's low x face, its low y face
// and its denominator
template <Coef COEF>
__host__ __device__ __forceinline__ int pr_buffers() {
  return COEF == CF_FACES ? 5 : 2;
}

// The sweep engine: the placement and the sweeps of one block in its
// shared buffers from buf on (pr_buffers); ends with the block
// synchronised and du final on the tile and, with ring = 1, on the
// one-cell ring around it.
// PLACE: PL_PROLONG places the bilinear prolongation of s.src (rows
// first, homogeneous ghosts sgn * c or a wrap; zero when s.src is
// nullptr), PL_GIVEN places s.src itself.
// COEF: CF_CONST updates a cell to (nb - h2 rhs) * inv_denom; CF_FACES to
// (num - h2 rhs) / den, num = ax_lo up + ax_hi dn + ay_lo lf + ay_hi rt
// and den = ax_lo + ax_hi + ay_lo + ay_hi + dia h2 formed once at
// placement, a cell with den <= 1e-20 keeping its value.  A cell's high
// faces are its neighbours' low faces, in the other colour half at k + H
// (x) and k + q (y); on a periodic axis face n is face 0.  Keep the
// expressions of the sweeps and of K15's den as they are: nvcc contracts
// each into FMAs by its shape, and the two-phase step's results (whose
// VOF and curvature decisions amplify a rounding difference past
// chip_smoke's gate, PERF.md) are held bit for bit to this arithmetic.
// CF_FACES prolongs with every product and sum rounded on its own
// (mul_rn, add_rn), as the plain prolong_plain rounds them.
// PX: periodic rows (per_y, periodic columns, is a run-time flag).  A
// tiled block reads its halo (values, faces) across a periodic axis'
// wrap at placement; a whole-level block reads the cell across the wrap
// in the sweeps.
template <typename T, Place PLACE, Coef COEF, bool PX>
__device__ __forceinline__ void pr_relax(const PRArgs<T>& a,
                                         const PRSystem<T>& s,
                                         const PRFaces<T>& f,
                                         const PRBuf& L, T* buf, int ring) {
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int per_y = a.per_y;
  const T sx0 = a.sgn[0], sx1 = a.sgn[1], sy0 = a.sgn[2], sy1 = a.sgn[3];
  const int B = L.B, H = L.H, hs = L.hs;
  T* const rb = buf + 2 * hs;
  T* const axs = buf + 4 * hs;  // CF_FACES only, as the next two
  T* const ays = buf + 6 * hs;
  T* const dns = buf + 8 * hs;
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int t = threadIdx.x, nt = blockDim.x;
  const int tx = t & 31, ty = t >> 5, nty = nt >> 5;
  const int m0 = n0 / 2, m1 = n1 / 2;
  const T* src = s.src;
  // a tiled block reads periodic rows and columns across the wrap; a
  // whole-level block's wrap is read in the sweeps
  const bool wrap_x = PX && halo > 0;
  const bool wrap_y = per_y && halo > 0;

  // ---- place du (prolonged, zero or given) and rhs (and the faces)
  for (int li = ty; li < B; li += nty) {
    int gi = gi0 + li;
    if (wrap_x) gi = (gi % n0 + n0) % n0;
    const bool real_i = gi >= 0 && gi < n0;
    // the low x face of local row li: face n0 is face 0 when periodic
    int fi = gi0 + li;
    if (PX) fi = (fi % n0 + n0) % n0;
    for (int lj = tx; lj < B; lj += 32) {
      int gj = gj0 + lj;
      if (wrap_y) gj = (gj % n1 + n1) % n1;
      const bool real_j = gj >= 0 && gj < n1;
      const bool real = real_i && real_j;
      T du = T(0), r = T(0);
      if (real) {
        r = s.rhs[(size_t)gi * n1 + gj];
        if (PLACE == PL_GIVEN) {
          du = src[(size_t)gi * n1 + gj];
        } else if (src) {
          const int ci = gi >> 1, cj = gj >> 1;
          int cin = (gi & 1) ? ci + 1 : ci - 1;
          if (PX) cin = (cin + m0) % m0;
          // row step first, on coarse columns cj and its neighbour
          auto rowstep = [&](int cc) -> T {
            const T base = src[(size_t)ci * m1 + cc];
            T nb;
            if (PX)
              nb = src[(size_t)cin * m1 + cc];
            else if (gi == 0)
              nb = sx0 * base;
            else if (gi == n0 - 1)
              nb = sx1 * base;
            else
              nb = src[(size_t)cin * m1 + cc];
            if constexpr (COEF == CF_FACES)
              return add_rn(mul_rn(T(0.75), base), mul_rn(T(0.25), nb));
            return T(0.75) * base + T(0.25) * nb;
          };
          const T p = rowstep(cj);
          int cjn = (gj & 1) ? cj + 1 : cj - 1;
          T q;
          if (per_y)
            q = rowstep((cjn + m1) % m1);
          else if (gj == 0)
            q = sy0 * p;
          else if (gj == n1 - 1)
            q = sy1 * p;
          else
            q = rowstep(cjn);
          if constexpr (COEF == CF_FACES)
            du = add_rn(mul_rn(T(0.75), p), mul_rn(T(0.25), q));
          else
            du = T(0.75) * p + T(0.25) * q;
        }
      }
      const int k = L.at(li, lj);
      buf[k] = du;
      rb[k] = r;
      if (COEF == CF_FACES) {
        int fj = gj0 + lj;
        if (per_y) fj = (fj % n1 + n1) % n1;
        const T ax_lo =
            fi >= 0 && fi <= n0 && real_j ? f.ax[(size_t)fi * n1 + gj] : T(0);
        const T ay_lo = real_i && fj >= 0 && fj <= n1
                            ? f.ay[(size_t)gi * (n1 + 1) + fj]
                            : T(0);
        T den = T(0);
        if (real) {
          const int hi = PX && gi == n0 - 1 ? 0 : gi + 1;
          const int hj = per_y && gj == n1 - 1 ? 0 : gj + 1;
          const T ax_hi = f.ax[(size_t)hi * n1 + gj];
          const T ay_hi = f.ay[(size_t)gi * (n1 + 1) + hj];
          const T dh2 = (f.dia ? f.dia[(size_t)gi * n1 + gj] : f.dia_s) * a.h2;
          den = ax_lo + ax_hi + ay_lo + ay_hi + dh2;
        }
        axs[k] = ax_lo;
        ays[k] = ay_lo;
        dns[k] = den;
      }
    }
  }
  __syncthreads();

  // the domain's cells in the buffer, inside the frozen outer ring
  const int di0 = wrap_x ? 1 : max(1, -gi0);
  const int di1 = wrap_x ? B - 2 : min(B - 2, n0 - 1 - gi0);
  const int dj0 = wrap_y ? 1 : max(1, -gj0);
  const int dj1 = wrap_y ? B - 2 : min(B - 2, n1 - 1 - gj0);
  // the block holds a domain edge (or a whole level's periodic cells)
  const bool edge = (!wrap_x && (gi0 < 0 || gi0 + B > n0)) ||
                    (!wrap_y && (gj0 < 0 || gj0 + B > n1));
  const int par0 = (gi0 + gj0) & 1;
  const int S = 2 * a.nsweeps;
  for (int sw = 0; sw < S; ++sw) {
    // the tile grown by the half-sweeps still to come (+ the ring)
    const int grow = S - 1 - sw + ring;
    const int li0 = max(di0, halo + 1 - grow);
    const int li1 = min(di1, halo + tile + grow);
    const int lj0 = max(dj0, halo + 1 - grow);
    const int lj1 = min(dj1, halo + tile + grow);
    // the colour's local parity: red ((i+j) even) first
    const int pc = (sw & 1) ^ par0;
    T* const own = buf + pc * hs;
    const T* const nbr = buf + (pc ^ 1) * hs;
    const T* const own_rb = rb + pc * hs;
    // slots of the region: rows x cells of the colour per row (the
    // count differs by one between rows on a clipped odd width)
    const int hw = (lj1 - lj0 + 2) >> 1, nr = li1 - li0 + 1;
    if (hw > 0 && nr > 0) {
      int r = t / hw, c = t - r * hw;
      const int dr = nt / hw, dc = nt - dr * hw;
      while (r < nr) {
        const int li = li0 + r;
        const int q = (pc + li) & 1;  // the colour's column parity
        const int m = ((lj0 - q + 1) >> 1) + c;
        const int lj = 2 * m + q;
        if (lj <= lj1) {
          const int k = li * H + m;
          const T d0 = COEF == CF_FACES ? dns[pc * hs + k] : T(1);
          // a zero diagonal (CF_FACES): the cell keeps its value
          if (COEF == CF_CONST || d0 > T(1e-20)) {
            const T cv = own[k];
            T up = nbr[k - H], dn = nbr[k + H];
            T lf = nbr[k - 1 + q], rt = nbr[k + q];
            if (edge) {
              const int gi = gi0 + li, gj = gj0 + lj;
              if (!wrap_x) {
                if (PX) {  // a whole level: across the wrap
                  if (gi == 0) up = buf[L.at(li + n0 - 1, lj)];
                  if (gi == n0 - 1) dn = buf[L.at(li - n0 + 1, lj)];
                } else {
                  if (gi == 0) up = sx0 * cv;
                  if (gi == n0 - 1) dn = sx1 * cv;
                }
              }
              if (!wrap_y) {
                if (per_y) {  // a whole level: across the wrap
                  if (gj == 0) lf = buf[L.at(li, lj + n1 - 1)];
                  if (gj == n1 - 1) rt = buf[L.at(li, lj - n1 + 1)];
                } else {
                  if (gj == 0) lf = sy0 * cv;
                  if (gj == n1 - 1) rt = sy1 * cv;
                }
              }
            }
            T nw;
            if constexpr (COEF == CF_CONST) {
              const T nb = up + dn + lf + rt;
              nw = fma(-a.h2, own_rb[k], nb) * s.inv_denom;
              if (a.use_omega) nw = fma(a.omega, nw, a.one_m_omega * cv);
            } else {
              const int o = pc * hs + k, x = (pc ^ 1) * hs + k;
              const T num = axs[o] * up + axs[x + H] * dn + ays[o] * lf +
                            ays[x + q] * rt;
              nw = (num - a.h2 * own_rb[k]) / d0;
              if (a.use_omega) nw = a.one_m_omega * cv + a.omega * nw;
            }
            own[k] = nw;
          }
        }
        c += dc;
        r += dr;
        if (c >= hw) {
          c -= hw;
          ++r;
        }
      }
    }
    __syncthreads();
  }
}

// The block's tile of the engine's result (+ u) to device memory (of a
// whole level on a rectangle, the tile of its longer side: its cells)
template <typename T>
__device__ __forceinline__ void pr_write_tile(const PRArgs<T>& a,
                                              const PRSystem<T>& s,
                                              const PRBuf& L, const T* buf) {
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nty = blockDim.x >> 5;
  for (int li = halo + 1 + ty; li < halo + 1 + tile; li += nty) {
    const int gi = gi0 + li;
    if (gi >= n0) break;
    for (int lj = halo + 1 + tx; lj < halo + 1 + tile; lj += 32) {
      const int gj = gj0 + lj;
      if (gj >= n1) break;
      const size_t g = (size_t)gi * n1 + gj;
      const T v = buf[L.at(li, lj)];
      s.out[g] = s.u ? v + s.u[g] : v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(PR_THREADS)
    prolong_relax_kernel(PRArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const PRSystem<T> s = blockIdx.z ? a.sys[1] : a.sys[0];
  const int B = a.tile + 2 * a.halo + 2;
  const PRBuf L{B, B / 2, pr_half(B)};
  T* buf = reinterpret_cast<T*>(smem_raw);
  pr_relax<T, PL_PROLONG, CF_CONST, false>(a, s, PRFaces<T>{}, L, buf, 0);
  pr_write_tile(a, s, L, buf);
}

// ---------------------------------------------------------------------------
// K17 prolong_relax_correct (batch 1).
// Replaces gerris_tpu/ops/pallas/rbgs.py:prolong_relax_correct
// (_pr_correct_kernel), including the x face n0 that its wrapper appends:
// the fold route's K3 + K5 in one launch.  p' = u + du as K3 computes it
// (homogeneous ghosts in the sweeps), then the projection's correction by
// p' with the real pressure ghosts (sgn * mirror + off): uf' = uf - dt
// grad_f p', g = the mean of a cell's two face gradients, and with cells
// U' = U - dt gx, V' = V - dt gy.
// Bound: device-memory bytes (reads coarse/4, rhs, u, ufx, ufy [, U, V];
// writes p', ufx', ufy', gx, gy [, U', V']; at 2048^2 f32 9.25 n^2 words,
// ~155 MB, ~46 us, with the cells 13.25 n^2, ~222 MB, ~66 us).
// Design: K3's tile and sweep engine (pr_relax) with its update region
// one cell wider, so that du is exact on the one-cell ring around the
// tile that the tile's face gradients read (the TPU kernel widens its
// halo to 2*nsweeps + 1 for that ring, rbgs.py:702; here the ring lies
// inside K3's buffer, whose frozen outer ring is beyond the halo), then
// an epilogue.  The ring's domain ghosts are rebuilt from p' with the
// real BCs (a whole-level block's periodic columns wrap), and each thread
// finishes its tile cells from the buffer through gtt::correct_cell, K5's
// per-cell code: its low faces, the domain's last faces, g and the
// cells.  The faces and cells are read from device memory in the
// epilogue, not staged in shared memory.
// ---------------------------------------------------------------------------
// g: the real pressure BCs' ghosts
template <typename T>
__global__ void __launch_bounds__(PR_THREADS)
    prolong_relax_correct_kernel(PRArgs<T> a, gtt::Correction<T> o,
                                 gtt::Ghosts<T> g) {
  extern __shared__ unsigned char smem_raw[];
  const PRSystem<T>& s = a.sys[0];
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int B = tile + 2 * halo + 2;
  const PRBuf L{B, B / 2, pr_half(B)};
  T* buf = reinterpret_cast<T*>(smem_raw);
  pr_relax<T, PL_PROLONG, CF_CONST, false>(a, s, PRFaces<T>{}, L, buf, 1);
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nty = blockDim.x >> 5;
  // a tiled block holds periodic columns across the wrap
  const bool wrap_y = a.per_y && halo > 0;
  const int lo = halo, hi = halo + tile + 1;  // the tile and its ring

  // ---- p' = du + u where the ring lies in the domain
  for (int li = lo + ty; li <= hi; li += nty) {
    const int gi = gi0 + li;
    if (gi < 0 || gi >= n0) continue;
    for (int lj = lo + tx; lj <= hi; lj += 32) {
      int gj = gj0 + lj;
      if (wrap_y)
        gj = (gj + n1) % n1;
      else if (gj < 0 || gj >= n1)
        continue;
      buf[L.at(li, lj)] += s.u[(size_t)gi * n1 + gj];
    }
  }
  __syncthreads();
  // ---- the ring's domain ghosts from p' with the real BCs
  for (int li = lo + ty; li <= hi; li += nty) {
    const int gi = gi0 + li;
    const bool real_i = gi >= 0 && gi < n0;
    for (int lj = lo + tx; lj <= hi; lj += 32) {
      const int gj = gj0 + lj;
      const bool real_j = wrap_y || (gj >= 0 && gj < n1);
      const int k = L.at(li, lj);
      if (!real_i && real_j) {
        buf[k] = gi < 0 ? g.s[0] * buf[L.at(li + 1, lj)] + g.o[0]
                        : g.s[1] * buf[L.at(li - 1, lj)] + g.o[1];
      } else if (real_i && !real_j) {
        if (a.per_y)  // a whole-level block: wrap
          buf[k] = gj < 0 ? buf[L.at(li, lj + n1)] : buf[L.at(li, lj - n1)];
        else
          buf[k] = gj < 0 ? g.s[2] * buf[L.at(li, lj + 1)] + g.o[2]
                          : g.s[3] * buf[L.at(li, lj - 1)] + g.o[3];
      }
    }
  }
  __syncthreads();
  // ---- p' and the correction of the tile's cells
  for (int li = halo + 1 + ty; li < halo + 1 + tile; li += nty) {
    const int i = gi0 + li;
    for (int lj = halo + 1 + tx; lj < halo + 1 + tile; lj += 32) {
      const int j = gj0 + lj;
      const T pc = buf[L.at(li, lj)];
      s.out[(size_t)i * n1 + j] = pc;
      gtt::correct_cell(o, i, j, n0, n1, pc, buf[L.at(li - 1, lj)],
                        buf[L.at(li + 1, lj)], buf[L.at(li, lj - 1)],
                        buf[L.at(li, lj + 1)]);
    }
  }
}

// ---------------------------------------------------------------------------
// K11 residual.
// Replaces gerris_tpu/ops/pallas/rbgs.py:residual_pallas (_residual_kernel):
// r = rhs - (L - dia) u with static ghosts (sgn * mirror + off per side),
// periodic on either axis, on any n0 x n1 level (a box's rectangle).  The
// adaptive solve's one residual per cycle.
// Bound: device-memory bytes (reads u and rhs once, writes r once).
// Design: one thread per cell reading its four neighbours straight from
// device memory: a neighbour is the next thread's cell or the row above,
// so L1 and L2 serve all but one read of each u value, and no tile is
// staged.  The cell's value is K1's expression (gtt::residual_value), so
// K1 with sub = 0 gives this r0 bit for bit.
// ---------------------------------------------------------------------------
template <typename T>
struct ResArgs {
  const T* u;
  const T* rhs;
  T* r;
  T dia, h2;
  T sgn[4], off[4];
  int n0, n1, per_x, per_y;
};

template <typename T>
__global__ void residual_kernel(ResArgs<T> a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int n0 = a.n0, n1 = a.n1;
  if (i >= n0 || j >= n1) return;
  const T* u = a.u;
  const size_t k = (size_t)i * n1 + j;
  const T c = u[k];
  T up, dn, lf, rt;
  if (i > 0)
    up = u[k - n1];
  else if (a.per_x)
    up = u[(size_t)(n0 - 1) * n1 + j];
  else
    up = a.sgn[0] * c + a.off[0];
  if (i < n0 - 1)
    dn = u[k + n1];
  else if (a.per_x)
    dn = u[j];
  else
    dn = a.sgn[1] * c + a.off[1];
  if (j > 0)
    lf = u[k - 1];
  else if (a.per_y)
    lf = u[k + n1 - 1];
  else
    lf = a.sgn[2] * c + a.off[2];
  if (j < n1 - 1)
    rt = u[k + 1];
  else if (a.per_y)
    rt = u[k - (n1 - 1)];
  else
    rt = a.sgn[3] * c + a.off[3];
  const T nb = up + dn + lf + rt;
  a.r[k] = gtt::residual_value(a.rhs[k], nb, c, a.h2, a.dia);
}

// ---------------------------------------------------------------------------
// K10 rbgs_relax.
// Replaces gerris_tpu/ops/pallas/rbgs.py:rbgs_relax (_kernel): nsweeps
// red-black Gauss-Seidel sweeps (red = global (i+j) even first) from a given
// u on (L - dia) u = rhs, scalar dia, homogeneous ghosts, periodic rows
// and/or columns, omega.  The "relax" solver's sweeps and the upward
// levels of a correction with periodic rows.  A level may be a box's
// rectangle (n x 3n for the capillary wave's 1 x 3 box, either side the
// longer): tiles divide both sides, and a whole level is one block on the
// square buffer of its longer side (rounded up to even), its sweeps
// clipped to the domain, as K15's.
// Bound: device-memory bytes for a level of many tiles (reads u and rhs,
// writes the result once for all sweeps; at 2048^2 f32 ~50 MB, ~15 us);
// a level that fits one block is bound by its serial half-sweeps.
// Design: the sweep engine (pr_relax) with the given-u placement and the
// constant coefficient, K3's tile without the prolongation: colour-split
// bank-padded buffers of u and rhs, a shrinking update region, no ghost
// pass, one barrier per half-sweep, the tile and threads chosen per level
// by the wrapper (ops/cuda/rbgs.py:_sweep_plan).  On a periodic axis a
// tiled block reads its halo across the wrap (the TPU kernel's wrapped
// halo DMAs); a whole-level block reads the cell across it.  The
// wrapper splits the sweeps over consecutive launches when their halo
// outgrows shared memory; the sweeps of consecutive launches compose
// exactly, so the result is bit-identical for every tile and split.
// ---------------------------------------------------------------------------
template <typename T, bool PX>
__global__ void __launch_bounds__(PR_THREADS)
    rbgs_relax_kernel(PRArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const PRSystem<T>& s = a.sys[0];
  const int B = a.tile + 2 * a.halo + 2;
  const PRBuf L{B, B / 2, pr_half(B)};
  T* buf = reinterpret_cast<T*>(smem_raw);
  pr_relax<T, PL_GIVEN, CF_CONST, PX>(a, s, PRFaces<T>{}, L, buf, 0);
  pr_write_tile(a, s, L, buf);
}

// ---------------------------------------------------------------------------
// K15 rbgs_relax_alpha.
// Replaces gerris_tpu/ops/pallas/rbgs.py:rbgs_relax_alpha (_kernel_alpha),
// with the bilinear prolongation between its levels folded in: nsweeps
// red-black Gauss-Seidel sweeps (red = global (i+j) even first) on
// div(alpha grad u) - dia u = rhs, face coefficients ax ((n0+1) x n1) and
// ay (n0 x (n1+1)), a scalar or per-cell dia, homogeneous ghosts,
// periodic rows and/or columns, from a given u or from the prolongation
// of a coarse correction (zero without one), + u.  A cell's update is
// (ax_lo u_up + ax_hi u_dn + ay_lo u_lf + ay_hi u_rt - h2 rhs) / den with
// den = ax_lo + ax_hi + ay_lo + ay_hi + dia h2, summed in that order;
// a cell with den <= 1e-20 (a zero diagonal) keeps its value.  On a
// periodic axis face n is face 0.  Every level of the two-phase
// projections' and the variable-density diffusion's corrections: the
// coarsest from zero, every upward level from the coarser one's result,
// the finest + u (solvers/poisson.py:_correction_variable).  A level may
// be a rectangle (a box of several unit boxes, n x 2n): tiles divide
// both sides, and a whole level is one block on the square buffer of its
// longer side, its sweeps clipped to the domain.
// Bound: device-memory bytes for a level of many tiles (reads the coarse
// correction or u, rhs, ax, ay and the cell dia once, writes the result
// once for all sweeps; at 1024^2 f32 ~25 MB, ~7.5 us); a level that fits
// one block is bound by its serial half-sweeps.
// Design: the sweep engine (pr_relax) with the face coefficients: five
// colour-split bank-padded buffers (u, rhs, each cell's low x face, its
// low y face, den), den formed once at placement from the faces and dia;
// a cell's high faces are its neighbours' low faces in the other colour
// half.  The coefficients are static across the sweeps, so the update
// region shrinks by one cell a side per half-sweep as in K3, and a
// half-sweep costs one barrier.  The prolonged placement is K3's, with
// periodic rows.  The tile (64/32/16) and the threads (256/512) are
// chosen per level by the wrapper (_sweep_plan); at 64^2 and below a
// level is one whole-level block.  The sweeps are split over
// consecutive launches when their halo outgrows shared memory (the first
// places the prolongation, the last adds u): bit-identical for every
// tile and split.
// ---------------------------------------------------------------------------
template <typename T, Place PLACE, bool PX>
__global__ void __launch_bounds__(PR_THREADS)
    rbgs_relax_alpha_kernel(PRArgs<T> a, PRFaces<T> f) {
  extern __shared__ unsigned char smem_raw[];
  const PRSystem<T>& s = a.sys[0];
  const int B = a.tile + 2 * a.halo + 2;
  const PRBuf L{B, B / 2, pr_half(B)};
  T* buf = reinterpret_cast<T*>(smem_raw);
  pr_relax<T, PLACE, CF_FACES, PX>(a, s, f, L, buf, 0);
  pr_write_tile(a, s, L, buf);
}

// ---------------------------------------------------------------------------
// coarse_block: the coarse tail of a cascade in one launch, one block per
// system: K12 coarse_vcycle's block kernel, and the levels at and below
// 64^2 of K2 cascade_prolong_relax and of K8b cascade_prolong_relax_pair.
// Replaces gerris_tpu/ops/pallas/rbgs.py:coarse_vcycle (_cv_kernel, its
// smoother _cv_relax) at and below 64^2, and the sub-cascade that the
// cascade kernels run on r2 in VMEM (_cp_core's "coarse_vcycle on r2",
// rbgs.py:1325-1356).  For 1 or 2 systems of one size n <= 64, each with
// its own dia, given each level's rhs down to the coarsest (the
// cascades' and K12's restrict_pyramid makes them): du = 0 at the
// coarsest level and `coarsest` red-black sweeps there, then at each
// level up to n the bilinear prolongation of the coarser du and `nsweeps`
// sweeps, with omega, homogeneous ghosts sgn * mirror, periodic columns
// or not.
// Bound: latency, not bytes or operations.  A 64^2 tail reads ~21 KB of
// rhs and writes 16 KB (f32), but its ~100 half-sweeps (80 at 16^2 for the
// cascades' 40 coarsest sweeps, 10 at each of 32^2 and 64^2) run one
// after another, each a few shared-memory loads deep and ended by a
// barrier.
// Design: every level lives in shared memory, colour-split as the sweep
// engine's buffers (pr_half; no ghost ring: a cell on a domain edge reads
// sgn * its own value, or the cell across the periodic wrap), so a
// half-sweep's neighbours are read at unit stride with no bank conflict
// and every index comes from shifts and masks.  The threads that sweep
// follow the level: `warps16` warps at 16^2 and below (__syncwarp between
// half-sweeps for one warp), `warps32` at 32^2 (a named barrier), the
// whole block at 64^2; the others wait at the block barrier that ends the
// level.  A thread keeps its cells (at most 4 of a colour) in registers
// for the whole level, du and rhs, with their neighbours' indices and
// domain edges: a cell is updated by its thread alone, so a half-sweep
// is the neighbours' loads (unconditional, issued together), the
// arithmetic and one store a cell, then the barrier.  The whole block
// loads the rhs of every level in one round of loads, places each
// prolongation, and writes du.  A pair runs as two
// blocks, on two SMs.  The arithmetic is the sweep engine's, written out
// where nvcc would otherwise pick a contraction: the update fma(-h2, rhs,
// nb) * inv_denom with the neighbour sum ((up + dn) + lf) + rt, omega as
// fma(omega, new, (1 - omega) cv), and K3's prolongation, 0.75 c + 0.25
// nb per axis (rows first) with the 0.75 c product fused; so a cascade's
// tail is the K3 launches it replaces bit for bit.  inv_denom comes per
// level and system from the launcher: K3's 1 / (4 + dia h2), or with
// `fused` the one K12's earlier block kernel formed on the card, 1 /
// fma(dia, h2, 4), so that K12 keeps its bits.
// ---------------------------------------------------------------------------
constexpr int CB_TOP = 64;
constexpr int CB_LEVELS = 6;     // 64^2 .. 2^2
constexpr int CB_THREADS = 512;  // threads of a block
constexpr int CB_LOADS = 12;     // loads of rhs a thread has in flight

template <typename T>
struct CBSystem {
  const T* rhs[CB_LEVELS];  // finest first
  T* du;
  T inv_denom[CB_LEVELS];
};

template <typename T>
struct CBArgs {
  CBSystem<T> sys[MAX_BATCH];
  T h2[CB_LEVELS];
  int n, levels, nsweeps, coarsest, warps16, warps32;
  T omega, one_m_omega;
  int use_omega;
  T sgn[4];
  int per_y;
};

// A level in shared memory: s x s cells (s a power of two, at least 2),
// cell (i, j) in the half of its colour (i + j) & 1 at i * s/2 + j/2,
// each half hs entries (pr_half); the level's rhs, then its du
struct CBLevel {
  int s, lh, hs;  // side, log2(s / 2), half size
  __device__ __forceinline__ int at(int i, int j) const {
    return ((i + j) & 1) * hs + (i << lh) + (j >> 1);
  }
};

__device__ __forceinline__ CBLevel cb_level(int s) {
  return CBLevel{s, __ffs(s) - 2, pr_half(s)};
}

// the offset of level l (side n >> l) in shared memory: the levels above
// it, each its rhs and du in two halves
__host__ __device__ __forceinline__ int cb_offset(int n, int l) {
  int off = 0;
  for (int k = 0; k < l; ++k) off += 4 * pr_half(n >> k);
  return off;
}

// The barrier between the steps of a level's p threads: the warp's, a
// named barrier of p threads, or the block's
__device__ __forceinline__ void cb_sync(int p) {
  if (p == 32)
    __syncwarp();
  else if (p < (int)blockDim.x)
    asm volatile("bar.sync 1, %0;" ::"r"(p) : "memory");
  else
    __syncthreads();
}

// One half-sweep, colour C, of a thread's N cells k[u] of a level (see
// cb_sweeps): the neighbours, the other colour, from shared memory at
// the indices fixed for the level (a domain edge's read at the cell's
// own index and replaced by sgn * c after), the cell's du and rhs from
// registers; the new value back to both.
template <typename T, int N, int C>
__device__ __forceinline__ void cb_half(const CBArgs<T>& a, T* du, int hs,
                                        const int (&k)[N],
                                        const bool (&own)[N],
                                        const int (&ui)[N],
                                        const int (&di)[N],
                                        const int (&li)[N],
                                        const int (&ri)[N],
                                        const int (&edge)[N], T (&v)[N],
                                        const T (&r)[N], T h2, T inv) {
  const T* const nbr = du + (C ^ 1) * hs;
  T* const out = du + C * hs;
  T up[N], dn[N], lf[N], rt[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    up[u] = nbr[ui[u]];
    dn[u] = nbr[di[u]];
    lf[u] = nbr[li[u]];
    rt[u] = nbr[ri[u]];
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const T c = v[u];
    const T U = edge[u] & 1 ? mul_rn(a.sgn[0], c) : up[u];
    const T D = edge[u] & 2 ? mul_rn(a.sgn[1], c) : dn[u];
    const T Lf = edge[u] & 4 ? mul_rn(a.sgn[2], c) : lf[u];
    const T R = edge[u] & 8 ? mul_rn(a.sgn[3], c) : rt[u];
    T nw = fma(-h2, r[u], U + D + Lf + R) * inv;
    if (a.use_omega) nw = fma(a.omega, nw, a.one_m_omega * c);
    v[u] = nw;
    if (own[u]) out[k[u]] = nw;
  }
}

// The sweeps of level L by threads [0, p) (red, (i + j) even, first): a
// thread's cells are the colour-split indices k = t, t + p, ..., N of
// them in each colour (the level has at most N p cells of a colour; a
// thread left with none still meets the barriers).  A cell is updated by
// its thread alone, so the thread keeps its cells' du and rhs in
// registers and reads only their neighbours from shared memory, at
// indices fixed for the level.
template <typename T, int N>
__device__ __forceinline__ void cb_sweeps(const CBArgs<T>& a, T* du,
                                          const T* rhs, const CBLevel& L,
                                          int p, int half_sweeps, T h2,
                                          T inv) {
  const int s = L.s, H = s >> 1, cells = s * H, hs = L.hs;
  const bool per_y = a.per_y;
  int k[N], ui[N], di[N], li[2][N], ri[2][N], edge[2][N];
  bool own[N];
  T v[2][N], r[2][N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int kk = threadIdx.x + u * p;
    own[u] = kk < cells;
    k[u] = own[u] ? kk : 0;
    const int i = k[u] >> L.lh, m = k[u] & (H - 1);
    const bool top = i == 0, bottom = i == s - 1;
    ui[u] = top ? k[u] : k[u] - H;
    di[u] = bottom ? k[u] : k[u] + H;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = (c + i) & 1;  // the column parity: j = 2 m + q
      const bool left = q == 0 && m == 0, right = q == 1 && m == H - 1;
      li[c][u] = left ? (per_y ? k[u] + H - 1 : k[u]) : k[u] - 1 + q;
      ri[c][u] = right ? (per_y ? k[u] - H + 1 : k[u]) : k[u] + q;
      edge[c][u] = top | bottom << 1 | (left && !per_y) << 2 |
                   (right && !per_y) << 3;
      v[c][u] = du[c * hs + k[u]];
      r[c][u] = rhs[c * hs + k[u]];
    }
  }
  for (int sw = 0; sw < half_sweeps; sw += 2) {
    cb_half<T, N, 0>(a, du, hs, k, own, ui, di, li[0], ri[0], edge[0], v[0],
                     r[0], h2, inv);
    cb_sync(p);
    cb_half<T, N, 1>(a, du, hs, k, own, ui, di, li[1], ri[1], edge[1], v[1],
                     r[1], h2, inv);
    cb_sync(p);
  }
}

// Level F's du (side s) = the bilinear prolongation of level C's (side
// s / 2), as K3 places it: rows first, a domain edge's ghost sgn * c or
// the column across the periodic wrap; by the whole block, in F's
// colour-split order, every load unconditional (a domain edge's ghost
// replaced after)
template <typename T>
__device__ __forceinline__ void cb_prolong(const CBArgs<T>& a, const T* c,
                                           const CBLevel& C, T* f,
                                           const CBLevel& F) {
  const int p = blockDim.x;
  const int s = F.s, H = s >> 1, half = s * H, m1 = C.s;
  const bool per_y = a.per_y;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < 2 * half; idx += p) {
    const int h = idx >= half;
    const int kk = idx - h * half;
    const int gi = kk >> F.lh;
    const int gj = 2 * (kk & (H - 1)) + ((gi + h) & 1);
    const int ci = gi >> 1, cj = gj >> 1;
    const bool top = gi == 0, bottom = gi == s - 1;
    // the coarse row beside ci (ci itself at a domain edge, unused)
    const int cin = top || bottom ? ci : (gi & 1) ? ci + 1 : ci - 1;
    // the coarse column beside cj: across the wrap when periodic (cj
    // itself at a domain edge, unused)
    int cjn = (gj & 1) ? cj + 1 : cj - 1;
    const bool left = !per_y && gj == 0, right = !per_y && gj == s - 1;
    cjn = per_y ? (cjn + m1) & (m1 - 1) : left || right ? cj : cjn;
    const T b0 = c[C.at(ci, cj)], n0 = c[C.at(cin, cj)];
    const T b1 = c[C.at(ci, cjn)], n1 = c[C.at(cin, cjn)];
    // the row step on coarse columns cj and cjn
    const T nb0 = top ? mul_rn(a.sgn[0], b0)
                      : bottom ? mul_rn(a.sgn[1], b0) : n0;
    const T nb1 = top ? mul_rn(a.sgn[0], b1)
                      : bottom ? mul_rn(a.sgn[1], b1) : n1;
    const T pv = fma(T(0.75), b0, mul_rn(T(0.25), nb0));
    const T qr = fma(T(0.75), b1, mul_rn(T(0.25), nb1));
    const T qv = left ? mul_rn(a.sgn[2], pv)
                      : right ? mul_rn(a.sgn[3], pv) : qr;
    f[h * F.hs + kk] = fma(T(0.75), pv, mul_rn(T(0.25), qv));
  }
}

// arr[l] by static indices only (a run-time index into the kernel's
// parameters would copy them to local memory)
template <typename V, int M>
__device__ __forceinline__ V cb_pick(const V (&arr)[M], int l) {
  V x = arr[0];
#pragma unroll
  for (int k = 1; k < M; ++k)
    if (l == k) x = arr[k];
  return x;
}

template <typename T>
__global__ void __launch_bounds__(CB_THREADS)
    coarse_block_kernel(CBArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T h2s[CB_LEVELS], invs[CB_LEVELS];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const CBSystem<T> s = blockIdx.x ? a.sys[1] : a.sys[0];
  const int n = a.n, nl = a.levels, t = threadIdx.x;
  if (t < nl) {
    h2s[t] = cb_pick(a.h2, t);
    invs[t] = cb_pick(s.inv_denom, t);
  }
  // every level's rhs from device memory (levels 0 .. nl - 1 as one index
  // range), CB_LOADS loads a thread in flight; the coarsest du = 0
  int total = 0;
  for (int l = 0; l < nl; ++l) total += (n >> l) * (n >> l);
  for (int g0 = t; g0 < total; g0 += CB_LOADS * CB_THREADS) {
    T x[CB_LOADS];
    int at[CB_LOADS];
#pragma unroll
    for (int e = 0; e < CB_LOADS; ++e) {
      int g = g0 + e * CB_THREADS, l = 0;
      at[e] = -1;
      if (g < total) {
        while (g >= (n >> l) * (n >> l)) g -= (n >> l) * (n >> l), ++l;
        const CBLevel L = cb_level(n >> l);
        x[e] = cb_pick(s.rhs, l)[g];
        at[e] = cb_offset(n, l) + L.at(g >> (L.lh + 1), g & (L.s - 1));
      }
    }
#pragma unroll
    for (int e = 0; e < CB_LOADS; ++e)
      if (at[e] >= 0) sm[at[e]] = x[e];
  }
  {
    const CBLevel L = cb_level(n >> (nl - 1));
    T* const du = sm + cb_offset(n, nl - 1) + 2 * L.hs;
    for (int k = t; k < 2 * L.hs; k += CB_THREADS) du[k] = T(0);
  }
  __syncthreads();
  // coarsest first: its sweeps from du = 0, then prolong + sweeps
  for (int l = nl - 1; l >= 0; --l) {
    const int side = n >> l;
    const CBLevel L = cb_level(side);
    T* const rhs = sm + cb_offset(n, l);
    T* const du = rhs + 2 * L.hs;
    if (l < nl - 1) {
      const CBLevel C = cb_level(side >> 1);
      cb_prolong(a, sm + cb_offset(n, l + 1) + 2 * C.hs, C, du, L);
      __syncthreads();
    }
    const int p = side <= 16   ? 32 * a.warps16
                  : side == 32 ? 32 * a.warps32
                               : CB_THREADS;
    if (t < p) {
      const T h2 = h2s[l], inv = invs[l];
      const int half_sweeps = 2 * (l == nl - 1 ? a.coarsest : a.nsweeps);
      const int per = side * (side >> 1) / p;  // cells of a colour a thread
      if (per >= 4)
        cb_sweeps<T, 4>(a, du, rhs, L, p, half_sweeps, h2, inv);
      else if (per == 2)
        cb_sweeps<T, 2>(a, du, rhs, L, p, half_sweeps, h2, inv);
      else
        cb_sweeps<T, 1>(a, du, rhs, L, p, half_sweeps, h2, inv);
    }
    __syncthreads();
  }
  // the top level's du to device memory
  const CBLevel L = cb_level(n);
  const T* const du = sm + 2 * L.hs;
  for (int g = t; g < n * n; g += CB_THREADS)
    s.du[g] = du[L.at(g >> (L.lh + 1), g & (n - 1))];
}

bool batch_ok(int batch) { return batch >= 1 && batch <= MAX_BATCH; }

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// residual_restrict_kernel on square power-of-two levels of at least 16^2:
// a block per RR_ROWS x RR_COLS tile (the level's size where smaller)
template <typename T, bool DIV>
int launch_rr(const RRArgs<T>& a, int batch, int tile_rows, void* stream) {
  if (a.n0 < 16 || a.n1 < 16 || a.n0 & 3 || a.n1 & 3 ||
      (tile_rows != 8 && tile_rows != 16 && tile_rows != RR_ROWS))
    return (int)cudaErrorInvalidValue;
  const int rows = a.n0 < tile_rows ? a.n0 : tile_rows;
  const int cols = a.n1 < RR_COLS ? a.n1 : RR_COLS;
  if (a.n0 % rows || a.n1 % cols) return (int)cudaErrorInvalidValue;
  dim3 grid(a.n1 / cols, a.n0 / rows, batch);
  residual_restrict_kernel<T, DIV>
      <<<grid, dim3(32, tile_rows / 4), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_residual_restrict(int batch, const void* const* u,
                             const void* const* rhs, const void* const* sub,
                             const double* dia, const double* off, double h2,
                             int n0, int n1, const double* sgn, int per_y,
                             void* const* r0, void* const* r1,
                             void* const* r2, int tile_rows, void* stream) {
  if (!batch_ok(batch)) return (int)cudaErrorInvalidValue;
  RRArgs<T> a = {};
  for (int b = 0; b < batch; ++b) {
    RRSystem<T>& s = a.sys[b];
    s.u = (const T*)u[b];
    s.rhs = (const T*)rhs[b];
    s.sub = (const T*)sub[b];
    s.dia = T(dia[b]);
    for (int k = 0; k < 4; ++k) s.off[k] = T(off[4 * b + k]);
    s.r0 = (T*)r0[b];
    s.r1 = (T*)r1[b];
    s.r2 = (T*)r2[b];
  }
  a.h2 = T(h2);
  a.n0 = n0;
  a.n1 = n1;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_y = per_y;
  a.vec = 1;
  for (int b = 0; b < batch; ++b) {
    const RRSystem<T>& q = a.sys[b];
    a.vec = a.vec && aligned16(q.u) && aligned16(q.rhs) &&
            aligned16(q.r0) && aligned16(q.r1) && aligned16(q.r2);
  }
  return launch_rr<T, false>(a, batch, tile_rows, stream);
}

template <typename T>
int launch_residual_restrict_div(const void* const* ptr, double dia,
                                 const double* off, double h2,
                                 double div_scale, int n0, int n1,
                                 const double* sgn, int per_y,
                                 int tile_rows, void* stream) {
  RRArgs<T> a = {};
  RRSystem<T>& s = a.sys[0];
  s.u = (const T*)ptr[0];
  s.ufx = (const T*)ptr[1];
  s.ufy = (const T*)ptr[2];
  s.sub = (const T*)ptr[3];
  s.r0 = (T*)ptr[4];
  s.r1 = (T*)ptr[5];
  s.r2 = (T*)ptr[6];
  s.div_scale = T(div_scale);
  s.dia = T(dia);
  for (int k = 0; k < 4; ++k) s.off[k] = T(off[k]);
  a.h2 = T(h2);
  a.n0 = n0;
  a.n1 = n1;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_y = per_y;
  a.vec = aligned16(s.u) && aligned16(s.ufx) && aligned16(s.r0) &&
          aligned16(s.r1) && aligned16(s.r2);
  return launch_rr<T, true>(a, 1, tile_rows, stream);
}

// r: the top level per system; out: its levels back to back per system;
// count: one arrival count per system, 0 between launches (used only when
// a level is coarser than one cell per tile)
template <typename T>
int launch_restrict_pyramid(int batch, const void* const* r, int n0, int n1,
                            int levels, void* const* out,
                            unsigned int* count, void* stream) {
  if (!batch_ok(batch) || levels < 1 || levels > 30 ||
      n0 % (1 << levels) || n1 % (1 << levels) || n0 < 2 || n1 < 2)
    return (int)cudaErrorInvalidValue;
  PYArgs<T> a = {};
  for (int b = 0; b < batch; ++b) {
    a.sys[b].r = (const T*)r[b];
    a.sys[b].out = (T*)out[b];
    a.sys[b].count = count + b;
  }
  int tile = PY_TILE;
  while (n0 % tile || n1 % tile) tile /= 2;
  a.n0 = n0;
  a.n1 = n1;
  a.levels = levels;
  a.tile = tile;
  dim3 block(tile / 2, tile / 2);
  dim3 grid(n1 / tile, n0 / tile, batch);
  restrict_pyramid_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
PRArgs<T> prolong_args(int batch, const void* const* src,
                       const void* const* rhs, const void* const* u,
                       void* const* out, const double* dia, int n0, int n1,
                       int tile, int halo, int nsweeps, double h2,
                       double omega, const double* sgn, int per_y) {
  PRArgs<T> a = {};
  for (int b = 0; b < batch; ++b) {
    PRSystem<T>& s = a.sys[b];
    s.src = (const T*)src[b];
    s.rhs = (const T*)rhs[b];
    s.u = (const T*)u[b];
    s.out = (T*)out[b];
    s.inv_denom = T(1.0 / (4.0 + dia[b] * h2));
  }
  a.n0 = n0;
  a.n1 = n1;
  a.tile = tile;
  a.halo = halo;
  a.nsweeps = nsweeps;
  a.h2 = T(h2);
  a.omega = T(omega);
  a.one_m_omega = T(1.0 - omega);
  a.use_omega = omega != 1.0;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_y = per_y;
  return a;
}

// the dynamic shared memory of an engine block of COEF's buffers, each
// in two colour halves (pr_half)
template <typename T, Coef COEF>
size_t engine_smem(int tile, int halo) {
  return 2 * (size_t)pr_buffers<COEF>() * pr_half(tile + 2 * halo + 2) *
         sizeof(T);
}

template <typename T>
int launch_prolong_relax(int batch, const void* const* coarse,
                         const void* const* rhs, const void* const* u,
                         void* const* out, const double* dia, int n0, int n1,
                         int tile, int halo, int nsweeps, double h2,
                         double omega, const double* sgn, int per_y,
                         void* stream) {
  if (!batch_ok(batch)) return (int)cudaErrorInvalidValue;
  const PRArgs<T> a =
      prolong_args<T>(batch, coarse, rhs, u, out, dia, n0, n1, tile, halo,
                      nsweeps, h2, omega, sgn, per_y);
  static int smem_set[gtt::MAX_DEVICES];
  cudaError_t e = gtt::allow_smem((const void*)prolong_relax_kernel<T>,
                                  smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n1 / tile, n0 / tile, batch);
  prolong_relax_kernel<T>
      <<<grid, pr_threads(tile, halo), engine_smem<T, CF_CONST>(tile, halo),
         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptr: coarse, rhs, u, ufx, ufy, U, V (nullptr without cells), then the
// outputs p', ufx', ufy', gx, gy, U', V'
template <typename T>
int launch_prolong_relax_correct(const void* const* ptr, double dia, int n0,
                                 int n1, int tile, int halo, int nsweeps,
                                 double h2, double omega, double dt,
                                 double h, const double* sgn,
                                 const double* off, int per_y,
                                 void* stream) {
  void* const* out = (void* const*)(ptr + 7);
  const PRArgs<T> a = prolong_args<T>(1, ptr, ptr + 1, ptr + 2, out, &dia,
                                      n0, n1, tile, halo, nsweeps, h2,
                                      omega, sgn, per_y);
  const gtt::Correction<T> o{
      (const T*)ptr[3], (const T*)ptr[4], (const T*)ptr[5], (const T*)ptr[6],
      (T*)out[1],       (T*)out[2],       (T*)out[3],       (T*)out[4],
      (T*)out[5],       (T*)out[6],       T(dt),            T(h)};
  static int smem_set[gtt::MAX_DEVICES];
  cudaError_t e = gtt::allow_smem(
      (const void*)prolong_relax_correct_kernel<T>, smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n1 / tile, n0 / tile, 1);
  prolong_relax_correct_kernel<T>
      <<<grid, pr_threads(tile, halo), engine_smem<T, CF_CONST>(tile, halo),
         (cudaStream_t)stream>>>(
          a, o, gtt::make_ghosts<T>(sgn, off, per_y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_residual(const void* u, const void* rhs, void* r, int n0, int n1,
                    double dia, double h2, const double* sgn,
                    const double* off, int per_x, int per_y, void* stream) {
  ResArgs<T> a = {};
  a.u = (const T*)u;
  a.rhs = (const T*)rhs;
  a.r = (T*)r;
  a.dia = T(dia);
  a.h2 = T(h2);
  for (int k = 0; k < 4; ++k) {
    a.sgn[k] = T(sgn[k]);
    a.off[k] = T(off[k]);
  }
  a.n0 = n0;
  a.n1 = n1;
  a.per_x = per_x;
  a.per_y = per_y;
  dim3 block(32, 8);
  dim3 grid((n1 + 31) / 32, (n0 + 7) / 8);
  residual_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// launch one engine instance with its own once-per-device smem opt-in
template <typename Kernel, typename... Args>
int launch_engine(Kernel kernel, int* smem_set, dim3 grid, int threads,
                  size_t smem, void* stream, Args... args) {
  cudaError_t e = gtt::allow_smem((const void*)kernel, smem_set);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rbgs_relax(const void* u, const void* rhs, void* out, int n0,
                      int n1, int tile, int halo, int nsweeps, double dia,
                      double h2, double omega, const double* sgn, int per_x,
                      int per_y, int threads, void* stream) {
  const void* add = nullptr;
  const PRArgs<T> a =
      prolong_args<T>(1, &u, &rhs, &add, &out, &dia, n0, n1, tile, halo,
                      nsweeps, h2, omega, sgn, per_y);
  // a whole level on a rectangle is one block whose tile is its longer
  // side (even: a (1, 3) level takes tile 4), as K15's
  const dim3 grid((n1 + tile - 1) / tile, (n0 + tile - 1) / tile, 1);
  const size_t smem = engine_smem<T, CF_CONST>(tile, halo);
  static int set[2][gtt::MAX_DEVICES];
  if (per_x)
    return launch_engine(rbgs_relax_kernel<T, true>, set[1], grid, threads,
                         smem, stream, a);
  return launch_engine(rbgs_relax_kernel<T, false>, set[0], grid, threads,
                       smem, stream, a);
}

// ptr: src (the start u, or the coarse correction with prolong, NULL for
// zero), rhs, ax, ay, dia (NULL for the scalar), u (added; NULL for
// none), out
template <typename T>
int launch_rbgs_relax_alpha(const void* const* ptr, int prolong, int n0,
                            int n1, int tile, int halo, int nsweeps,
                            double dia, double h2, double omega,
                            const double* sgn, int per_x, int per_y,
                            int threads, void* stream) {
  const double zero = 0.0;  // den is formed from the faces
  const PRArgs<T> a =
      prolong_args<T>(1, ptr, ptr + 1, ptr + 5, (void* const*)(ptr + 6),
                      &zero, n0, n1, tile, halo, nsweeps, h2, omega, sgn,
                      per_y);
  const PRFaces<T> f{(const T*)ptr[2], (const T*)ptr[3], (const T*)ptr[4],
                     T(dia)};
  // a whole level on a rectangle is one block whose tile is its longer
  // side: the engine clips the sweeps to the domain and the write to
  // its cells
  const dim3 grid((n1 + tile - 1) / tile, (n0 + tile - 1) / tile, 1);
  const size_t smem = engine_smem<T, CF_FACES>(tile, halo);
  static int set[4][gtt::MAX_DEVICES];
  if (prolong) {
    if (per_x)
      return launch_engine(rbgs_relax_alpha_kernel<T, PL_PROLONG, true>,
                           set[3], grid, threads, smem, stream, a, f);
    return launch_engine(rbgs_relax_alpha_kernel<T, PL_PROLONG, false>,
                         set[2], grid, threads, smem, stream, a, f);
  }
  if (per_x)
    return launch_engine(rbgs_relax_alpha_kernel<T, PL_GIVEN, true>, set[1],
                         grid, threads, smem, stream, a, f);
  return launch_engine(rbgs_relax_alpha_kernel<T, PL_GIVEN, false>, set[0],
                       grid, threads, smem, stream, a, f);
}

// ptr: per system its levels' rhs (`levels` entries, finest first), then
// per system its du; dia per system.  warps16, warps32:
// the warps that sweep the levels of 16^2 and below and the 32^2 level
// (1 to 16, and 4 to 16: a thread holds at most 4 cells of a colour).
template <typename T>
int launch_coarse_block(int batch, const void* const* ptr, const double* dia,
                        int n, int levels, int nsweeps, int coarsest,
                        double h2, double omega, const double* sgn,
                        int per_y, int fused, int warps16, int warps32,
                        void* stream) {
  if (!batch_ok(batch) || n < 2 || n > CB_TOP || (n & (n - 1)) ||
      levels < 1 || levels > CB_LEVELS || (n >> (levels - 1)) < 2 ||
      warps16 < 1 || 32 * warps16 > CB_THREADS || warps32 < 4 ||
      32 * warps32 > CB_THREADS)
    return (int)cudaErrorInvalidValue;
  CBArgs<T> a = {};
  for (int b = 0; b < batch; ++b) {
    CBSystem<T>& s = a.sys[b];
    if (!ptr[batch * levels + b]) return (int)cudaErrorInvalidValue;
    for (int l = 0; l < levels; ++l) {
      if (!ptr[b * levels + l]) return (int)cudaErrorInvalidValue;
      s.rhs[l] = (const T*)ptr[b * levels + l];
      const double h2l = h2 * double(1 << (2 * l));
      s.inv_denom[l] = T(fused ? 1.0 / std::fma(dia[b], h2l, 4.0)
                               : 1.0 / (4.0 + dia[b] * h2l));
    }
    s.du = (T*)ptr[batch * levels + b];
  }
  for (int l = 0; l < levels; ++l) a.h2[l] = T(h2 * double(1 << (2 * l)));
  a.n = n;
  a.levels = levels;
  a.nsweeps = nsweeps;
  a.coarsest = coarsest;
  a.warps16 = warps16;
  a.warps32 = warps32;
  a.omega = T(omega);
  a.one_m_omega = T(1.0 - omega);
  a.use_omega = omega != 1.0;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_y = per_y;
  const size_t smem = (size_t)cb_offset(n, levels) * sizeof(T);
  static int smem_set[gtt::MAX_DEVICES];
  cudaError_t e =
      gtt::allow_smem((const void*)coarse_block_kernel<T>, smem_set);
  if (e != cudaSuccess) return (int)e;
  coarse_block_kernel<T>
      <<<batch, CB_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface.  For the batched kernels the device pointers of a
// launch are one host table of `batch` entries per argument, in the order
// listed (residual_restrict: u, rhs, sub, r0, r1, r2; restrict_pyramid: r,
// out, its levels back to back;
// prolong_relax: coarse, rhs, u, out), so that a launch builds one array;
// dia is a host array of `batch` entries, the ghost offsets of 4 * batch.
// coarse_block: each system's levels (finest first), then each system's
// du;
// residual and rbgs_relax take one system's pointers;
// rbgs_relax_alpha one table (src, rhs, ax, ay, dia, u, out: src the
// start u, or with prolong = 1 the coarse correction or NULL for zero;
// dia NULL for the scalar; u, added to the result, NULL for none);
// residual_restrict_div one table (u, ufx, ufy, sub, r0, r1, r2) and
// prolong_relax_correct one table (coarse, rhs, u, ufx, ufy, U, V, p',
// ufx', ufy', gx, gy, U', V'; the cells NULL without them).
#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_residual_restrict_##SUFFIX(                              \
      int batch, void* const* ptr, const double* dia, const double* off,      \
      double h2, int n0, int n1, const double* sgn, int per_y,                \
      int tile_rows, void* stream) {                                          \
    return launch_residual_restrict<T>(                                       \
        batch, ptr, ptr + batch, ptr + 2 * batch, dia, off, h2, n0, n1, sgn,  \
        per_y, ptr + 3 * batch, ptr + 4 * batch, ptr + 5 * batch, tile_rows,  \
        stream);                                                              \
  }                                                                           \
  extern "C" int gtt_restrict_pyramid_##SUFFIX(                              \
      int batch, void* const* ptr, int n0, int n1, int levels,                \
      unsigned int* count, void* stream) {                                    \
    return launch_restrict_pyramid<T>(batch, ptr, n0, n1, levels,             \
                                      ptr + batch, count, stream);            \
  }                                                                           \
  extern "C" int gtt_prolong_relax_##SUFFIX(                                  \
      int batch, void* const* ptr, const double* dia, int n0, int n1,         \
      int tile, int halo, int nsweeps, double h2, double omega,               \
      const double* sgn, int per_y, void* stream) {                           \
    return launch_prolong_relax<T>(batch, ptr, ptr + batch, ptr + 2 * batch,  \
                                   ptr + 3 * batch, dia, n0, n1, tile, halo,  \
                                   nsweeps, h2, omega, sgn, per_y, stream);   \
  }                                                                           \
  extern "C" int gtt_residual_##SUFFIX(                                       \
      const void* u, const void* rhs, void* r, int n0, int n1, double dia,    \
      double h2, const double* sgn, const double* off, int per_x, int per_y, \
      void* stream) {                                                         \
    return launch_residual<T>(u, rhs, r, n0, n1, dia, h2, sgn, off, per_x,   \
                              per_y, stream);                                 \
  }                                                                           \
  extern "C" int gtt_rbgs_relax_##SUFFIX(                                     \
      const void* u, const void* rhs, void* out, int n0, int n1, int tile,    \
      int halo, int nsweeps, double dia, double h2, double omega,             \
      const double* sgn, int per_x, int per_y, int threads, void* stream) {   \
    return launch_rbgs_relax<T>(u, rhs, out, n0, n1, tile, halo, nsweeps,     \
                                dia, h2, omega, sgn, per_x, per_y, threads,   \
                                stream);                                      \
  }                                                                           \
  extern "C" int gtt_residual_restrict_div_##SUFFIX(                          \
      void* const* ptr, double dia, const double* off, double h2,             \
      double div_scale, int n0, int n1, const double* sgn, int per_y,         \
      int tile_rows, void* stream) {                                          \
    return launch_residual_restrict_div<T>(ptr, dia, off, h2, div_scale, n0,  \
                                           n1, sgn, per_y, tile_rows,         \
                                           stream);                           \
  }                                                                           \
  extern "C" int gtt_prolong_relax_correct_##SUFFIX(                          \
      void* const* ptr, double dia, int n0, int n1, int tile, int halo,       \
      int nsweeps, double h2, double omega, double dt, double h,              \
      const double* sgn, const double* off, int per_y, void* stream) {        \
    return launch_prolong_relax_correct<T>(ptr, dia, n0, n1, tile, halo,      \
                                           nsweeps, h2, omega, dt, h, sgn,    \
                                           off, per_y, stream);               \
  }                                                                           \
  extern "C" int gtt_rbgs_relax_alpha_##SUFFIX(                               \
      void* const* ptr, int prolong, int n0, int n1, int tile, int halo,      \
      int nsweeps, double dia, double h2, double omega, const double* sgn,    \
      int per_x, int per_y, int threads, void* stream) {                      \
    return launch_rbgs_relax_alpha<T>(ptr, prolong, n0, n1, tile, halo,       \
                                      nsweeps, dia, h2, omega, sgn, per_x,    \
                                      per_y, threads, stream);                \
  }                                                                           \
  extern "C" int gtt_coarse_block_##SUFFIX(                                   \
      int batch, void* const* ptr, const double* dia, int n, int levels,      \
      int nsweeps, int coarsest, double h2, double omega, const double* sgn,  \
      int per_y, int fused, int warps16, int warps32, void* stream) {         \
    return launch_coarse_block<T>(batch, ptr, dia, n, levels, nsweeps,        \
                                  coarsest, h2, omega, sgn, per_y, fused,     \
                                  warps16, warps32, stream);                  \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
