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
//   restrict2          one 2x2 mean pool (the cascades' restriction);
//   prolong_relax      bilinear prolongation of a coarse correction (or
//                      du = 0) + nsweeps red-black Gauss-Seidel sweeps
//                      (+ u), in one launch;
//   residual           r = rhs - (L - dia) u, periodic on either axis;
//   rbgs_relax         nsweeps red-black sweeps from a given u, periodic
//                      on either axis, in one launch;
//   rbgs_relax_alpha   the same with face coefficients and a scalar or
//                      per-cell dia (div(alpha grad u) - dia u = rhs);
//   coarse_block       the whole cascade of a level of at most 64^2 in
//                      one block;
//   residual_restrict_div  residual_restrict with rhs = div(uf) / dt formed
//                      from the MAC faces in the kernel;
//   prolong_relax_correct  prolong_relax (+ u) with the projection's
//                      correction by the result as its epilogue;
//   and the cascades (ops/cuda/rbgs.py:cascade_prolong_relax and
//   coarse_vcycle) are host sequences of restrict2, prolong_relax and
//   coarse_block launches.
//
// The first three take a batch of 1 or 2 independent systems of one size:
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

#include "stencil.cuh"

namespace {

constexpr int MAX_BATCH = 2;
constexpr int RR_TILE = 16;  // residual_restrict output tile (4-aligned)
constexpr int PR_THREADS_X = 32;
constexpr int PR_THREADS_Y = 8;

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
};

// One system of a restrict2 launch.
template <typename T>
struct R2System {
  const T* r;
  T* out;
};

template <typename T>
struct R2Args {
  R2System<T> sys[MAX_BATCH];
  int n0, n1;
};

// One system of a prolong_relax launch.
template <typename T>
struct PRSystem {
  const T* coarse;  // nullptr: start from du = 0
  const T* rhs;
  const T* u;  // nullptr: return du, else u + du
  T* out;
  T inv_denom;  // 1 / (4 + dia h2)
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

// ---------------------------------------------------------------------------
// K1 residual_restrict (batch 1) and K8a residual_restrict_pair (batch 2).
// Replaces gerris_tpu/ops/pallas/rbgs.py:residual_restrict (core _rr_core)
// and residual_restrict_pair (_resid_restrict_kernel_pair).
// Bound: device-memory bytes (reads u and rhs, writes r0 + r0/4 + r0/16,
// per system).
// Design: one block per 16x16 output tile of one system; the u tile and its
// 1-cell halo (with the domain ghosts) sit in shared memory, so u is read
// ~1.27x instead of 5x; r0 stays in shared memory for the two pooling
// levels, so r1 and r2 never re-read r0 from device memory.
//
// K16 residual_restrict_div (DIV = true, batch 1).
// Replaces gerris_tpu/ops/pallas/rbgs.py:residual_restrict_div
// (_resid_restrict_div_kernel): the MAC projection's K4 + K1 in one
// launch on the fold route.
// Bound: device-memory bytes (reads u, ufx and ufy, writes r0 + r0/4 +
// r0/16; at 2048^2 f32 4.31 n^2 words, ~72 MB, ~22 us).
// Design: K1's tile; a thread forms its cell's rhs from the four faces
// (gtt::mac_divergence, K4's expression) in registers, so div never goes
// to device memory.  The faces of a tile are read once, coalesced along
// the rows.
// ---------------------------------------------------------------------------
template <typename T, bool DIV>
__global__ void residual_restrict_kernel(RRArgs<T> a) {
  __shared__ T su[RR_TILE + 2][RR_TILE + 2];
  __shared__ T sr[RR_TILE][RR_TILE];
  __shared__ T s1[RR_TILE / 2][RR_TILE / 2];
  const RRSystem<T> s = blockIdx.z ? a.sys[1] : a.sys[0];
  const int n0 = a.n0, n1 = a.n1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * RR_TILE, j0 = blockIdx.x * RR_TILE;
  const int nt = RR_TILE * RR_TILE;
  for (int k = ty * RR_TILE + tx; k < (RR_TILE + 2) * (RR_TILE + 2);
       k += nt) {
    const int li = k / (RR_TILE + 2), lj = k % (RR_TILE + 2);
    const int gi = i0 + li - 1, gj = j0 + lj - 1;
    const bool in_i = gi >= 0 && gi < n0, in_j = gj >= 0 && gj < n1;
    T v = T(0);
    if (in_i && in_j) {
      v = s.u[(size_t)gi * n1 + gj];
    } else if (in_j) {  // ghost row
      v = gi < 0 ? a.sgn[0] * s.u[gj] + s.off[0]
                 : a.sgn[1] * s.u[(size_t)(n0 - 1) * n1 + gj] + s.off[1];
    } else if (in_i) {  // ghost column
      if (a.per_y)
        v = s.u[(size_t)gi * n1 + (gj < 0 ? n1 - 1 : 0)];
      else
        v = gj < 0 ? a.sgn[2] * s.u[(size_t)gi * n1] + s.off[2]
                   : a.sgn[3] * s.u[(size_t)gi * n1 + n1 - 1] + s.off[3];
    }
    su[li][lj] = v;  // corner ghosts are never read
  }
  __syncthreads();
  const T sub = s.sub ? *s.sub : T(0);
  const int gi = i0 + ty, gj = j0 + tx;
  const T c = su[ty + 1][tx + 1];
  const T nb = su[ty][tx + 1] + su[ty + 2][tx + 1] + su[ty + 1][tx] +
               su[ty + 1][tx + 2];
  const T rhs = DIV ? gtt::mac_divergence(s.ufx, s.ufy, gi, gj, n1,
                                          s.div_scale)
                    : s.rhs[(size_t)gi * n1 + gj];
  const T r = gtt::residual_value(rhs - sub, nb, c, a.h2, s.dia);
  s.r0[(size_t)gi * n1 + gj] = r;
  sr[ty][tx] = r;
  __syncthreads();
  // 2x2 means: rows first, then columns (the plain version's order)
  if (ty < RR_TILE / 2 && tx < RR_TILE / 2) {
    const T p = T(0.5) * (sr[2 * ty][2 * tx] + sr[2 * ty + 1][2 * tx]);
    const T q =
        T(0.5) * (sr[2 * ty][2 * tx + 1] + sr[2 * ty + 1][2 * tx + 1]);
    const T m = T(0.5) * (p + q);
    s1[ty][tx] = m;
    s.r1[(size_t)(i0 / 2 + ty) * (n1 / 2) + j0 / 2 + tx] = m;
  }
  __syncthreads();
  if (ty < RR_TILE / 4 && tx < RR_TILE / 4) {
    const T p = T(0.5) * (s1[2 * ty][2 * tx] + s1[2 * ty + 1][2 * tx]);
    const T q =
        T(0.5) * (s1[2 * ty][2 * tx + 1] + s1[2 * ty + 1][2 * tx + 1]);
    s.r2[(size_t)(i0 / 4 + ty) * (n1 / 4) + j0 / 4 + tx] = T(0.5) * (p + q);
  }
}

// ---------------------------------------------------------------------------
// restrict2: one 2x2 mean pool, (n0, n1) -> (n0/2, n1/2), per system.
// Part of the port of gerris_tpu/ops/pallas/rbgs.py:cascade_prolong_relax
// and cascade_prolong_relax_pair (their in-VMEM restriction pyramid,
// _row_pool + _lane_pool).
// Bound: device-memory bytes; one thread per coarse cell reads its four
// children once.  The levels it serves are at most (n/4)^2, so the launch
// latency, not the bytes, dominates at the coarse end.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void restrict2_kernel(R2Args<T> a) {
  const R2System<T> s = blockIdx.z ? a.sys[1] : a.sys[0];
  const int n1 = a.n1, m1 = n1 / 2;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.n0 / 2 || j >= m1) return;
  const T* p = s.r + (size_t)(2 * i) * n1 + 2 * j;
  const T x = T(0.5) * (p[0] + p[n1]);
  const T y = T(0.5) * (p[1] + p[n1 + 1]);
  s.out[(size_t)i * m1 + j] = T(0.5) * (x + y);
}

// ---------------------------------------------------------------------------
// K3 prolong_relax (batch 1) and K8c prolong_relax_pair (batch 2).
// Replaces gerris_tpu/ops/pallas/rbgs.py:prolong_relax (core _pr_core) and
// prolong_relax_pair (_prolong_relax_kernel_pair).
// Bound: device-memory bytes for the fine levels (reads coarse/4 + rhs
// (+ u), writes du once for all sweeps); at the coarse levels that fit
// one block, launch latency and the block's serial sweeps.
// Design: one block per tile x tile output tile of one system.  The
// block's shared buffer holds the tile plus a halo of `halo` = 2*nsweeps
// cells and one outer frozen ring; the prolonged du and the rhs are placed
// there once, every half-sweep updates the cells of one global colour
// (i+j)%2 inside the buffer, and the valid region shrinks by at most one
// cell per half-sweep, so after 2*nsweeps half-sweeps the tile is exact
// (the TPU kernel's own argument, rbgs.py:5-10).  Domain-edge ghost cells
// that fall inside the buffer are recomputed (homogeneous: sgn * mirror)
// before every half-sweep.  A level that fits one block is run with
// tile = n and halo = 0: the buffer is the whole level plus its ghost
// ring (periodic columns are refreshed as ghosts there); the pair then
// runs as two blocks.
// coarse == nullptr starts from du = 0 (the coarsest level); u != nullptr
// adds u to the result.
// ---------------------------------------------------------------------------
// The prolongation and the sweeps of one block, in its shared buffers buf
// (du) and rb (rhs), each B x B with B = tile + 2 halo + 2; ends with the
// block synchronised and du final on the tile and on the halo's cells at
// most halo - 2 nsweeps + 1 from it.
template <typename T>
__device__ __forceinline__ void pr_relax(const PRArgs<T>& a,
                                         const PRSystem<T>& s, T* buf,
                                         T* rb) {
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int per_y = a.per_y;
  const T sx0 = a.sgn[0], sx1 = a.sgn[1], sy0 = a.sgn[2], sy1 = a.sgn[3];
  const int B = tile + 2 * halo + 2;
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m1 = n1 / 2;
  const T* coarse = s.coarse;
  // whole-level blocks refresh periodic wrap columns like ghosts
  const bool wrap_ghost = per_y && halo == 0;

  // ---- place du (prolonged or zero) and rhs
  for (int li = ty; li < B; li += PR_THREADS_Y) {
    const int gi = gi0 + li;
    const bool real_i = gi >= 0 && gi < n0;
    for (int lj = tx; lj < B; lj += PR_THREADS_X) {
      int gj = gj0 + lj;
      if (per_y && !wrap_ghost) gj = (gj % n1 + n1) % n1;
      const bool real = real_i && gj >= 0 && gj < n1;
      T du = T(0), r = T(0);
      if (real) {
        r = s.rhs[(size_t)gi * n1 + gj];
        if (coarse) {
          const int ci = gi >> 1, cj = gj >> 1;
          const int cin = (gi & 1) ? ci + 1 : ci - 1;
          // row step first, on coarse columns cj and its neighbour
          auto rowstep = [&](int cc) -> T {
            const T base = coarse[(size_t)ci * m1 + cc];
            T nb;
            if (gi == 0)
              nb = sx0 * base;
            else if (gi == n0 - 1)
              nb = sx1 * base;
            else
              nb = coarse[(size_t)cin * m1 + cc];
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
          du = T(0.75) * p + T(0.25) * q;
        }
      }
      buf[li * B + lj] = du;
      rb[li * B + lj] = r;
    }
  }
  __syncthreads();

  for (int sw = 0; sw < 2 * a.nsweeps; ++sw) {
    const int color = sw & 1;  // red ((i+j) even) first
    // ---- domain-edge ghosts from the current interior
    for (int li = ty; li < B; li += PR_THREADS_Y) {
      const int gi = gi0 + li;
      const bool real_i = gi >= 0 && gi < n0;
      const bool ghost_i = gi == -1 || gi == n0;
      for (int lj = tx; lj < B; lj += PR_THREADS_X) {
        const int gj = gj0 + lj;
        const bool real_j = per_y && !wrap_ghost ? true : gj >= 0 && gj < n1;
        const bool ghost_j = !real_j && (gj == -1 || gj == n1);
        if (ghost_i && real_j) {
          buf[li * B + lj] = gi < 0 ? sx0 * buf[(li + 1) * B + lj]
                                    : sx1 * buf[(li - 1) * B + lj];
        } else if (real_i && ghost_j) {
          if (wrap_ghost)
            buf[li * B + lj] = gj < 0 ? buf[li * B + lj + n1]
                                      : buf[li * B + lj - n1];
          else
            buf[li * B + lj] = gj < 0 ? sy0 * buf[li * B + lj + 1]
                                      : sy1 * buf[li * B + lj - 1];
        }
      }
    }
    __syncthreads();
    // ---- one colour; the frozen outer ring is never updated
    for (int li = ty + 1; li < B - 1; li += PR_THREADS_Y) {
      const int gi = gi0 + li;
      if (gi < 0 || gi >= n0) continue;
      for (int lj = tx + 1; lj < B - 1; lj += PR_THREADS_X) {
        const int gj = gj0 + lj;
        if (!per_y && (gj < 0 || gj >= n1)) continue;
        if (wrap_ghost && (gj < 0 || gj >= n1)) continue;
        if (((gi + gj) & 1) != color) continue;
        const int k = li * B + lj;
        const T c = buf[k];
        const T nb = buf[k - B] + buf[k + B] + buf[k - 1] + buf[k + 1];
        T nw = (nb - a.h2 * rb[k]) * s.inv_denom;
        if (a.use_omega) nw = a.one_m_omega * c + a.omega * nw;
        buf[k] = nw;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void prolong_relax_kernel(PRArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const PRSystem<T> s = blockIdx.z ? a.sys[1] : a.sys[0];
  const int n1 = a.n1, tile = a.tile, halo = a.halo;
  const int B = tile + 2 * halo + 2;
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* rb = buf + (size_t)B * B;
  pr_relax(a, s, buf, rb);
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // ---- the tile (+ u)
  for (int li = halo + 1 + ty; li < halo + 1 + tile; li += PR_THREADS_Y) {
    const int gi = gi0 + li;
    for (int lj = halo + 1 + tx; lj < halo + 1 + tile;
         lj += PR_THREADS_X) {
      const int gj = gj0 + lj;
      const size_t g = (size_t)gi * n1 + gj;
      const T v = buf[li * B + lj];
      s.out[g] = s.u ? v + s.u[g] : v;
    }
  }
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
// Design: K3's tile and sweeps (pr_relax), then an epilogue.  The face
// gradients of the tile's cells read p' on a one-cell ring around the
// tile.  The TPU kernel widens its halo to 2*nsweeps + 1 for that ring
// (rbgs.py:702), since its window's edge rows are rewritten as ghosts at
// every half-sweep; K3's buffer keeps a frozen ring beyond its halo of
// 2*nsweeps, the cells next to which go wrong one per half-sweep, so
// after 2*nsweeps half-sweeps du is exact on the tile's ring already, at
// K3's buffer size.  The ring's domain ghosts are then rebuilt from p'
// with the real BCs (a whole-level block's periodic columns wrap), and
// each thread finishes its tile cells from the buffer through
// gtt::correct_cell, K5's per-cell code: its low faces, the domain's last
// faces, g and the cells.  The faces and cells are read from device
// memory in the epilogue, not staged in shared memory.
// ---------------------------------------------------------------------------
// g: the real pressure BCs' ghosts
template <typename T>
__global__ void prolong_relax_correct_kernel(PRArgs<T> a,
                                             gtt::Correction<T> o,
                                             gtt::Ghosts<T> g) {
  extern __shared__ unsigned char smem_raw[];
  const PRSystem<T>& s = a.sys[0];
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int B = tile + 2 * halo + 2;
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* rb = buf + (size_t)B * B;
  pr_relax(a, s, buf, rb);
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // a tiled block holds periodic columns across the wrap
  const bool wrap_y = a.per_y && halo > 0;
  const int lo = halo, hi = halo + tile + 1;  // the tile and its ring

  // ---- p' = du + u where the ring lies in the domain
  for (int li = lo + ty; li <= hi; li += PR_THREADS_Y) {
    const int gi = gi0 + li;
    if (gi < 0 || gi >= n0) continue;
    for (int lj = lo + tx; lj <= hi; lj += PR_THREADS_X) {
      int gj = gj0 + lj;
      if (wrap_y)
        gj = (gj + n1) % n1;
      else if (gj < 0 || gj >= n1)
        continue;
      buf[li * B + lj] += s.u[(size_t)gi * n1 + gj];
    }
  }
  __syncthreads();
  // ---- the ring's domain ghosts from p' with the real BCs
  for (int li = lo + ty; li <= hi; li += PR_THREADS_Y) {
    const int gi = gi0 + li;
    const bool real_i = gi >= 0 && gi < n0;
    for (int lj = lo + tx; lj <= hi; lj += PR_THREADS_X) {
      const int gj = gj0 + lj;
      const bool real_j = wrap_y || (gj >= 0 && gj < n1);
      const int k = li * B + lj;
      if (!real_i && real_j) {
        buf[k] = gi < 0 ? g.s[0] * buf[k + B] + g.o[0]
                        : g.s[1] * buf[k - B] + g.o[1];
      } else if (real_i && !real_j) {
        if (a.per_y)  // a whole-level block: wrap
          buf[k] = gj < 0 ? buf[k + n1] : buf[k - n1];
        else
          buf[k] = gj < 0 ? g.s[2] * buf[k + 1] + g.o[2]
                          : g.s[3] * buf[k - 1] + g.o[3];
      }
    }
  }
  __syncthreads();
  // ---- p' and the correction of the tile's cells
  for (int li = halo + 1 + ty; li < halo + 1 + tile; li += PR_THREADS_Y) {
    const int i = gi0 + li;
    for (int lj = halo + 1 + tx; lj < halo + 1 + tile;
         lj += PR_THREADS_X) {
      const int j = gj0 + lj;
      const int k = li * B + lj;
      const T pc = buf[k];
      s.out[(size_t)i * n1 + j] = pc;
      gtt::correct_cell(o, i, j, n0, n1, pc, buf[k - B], buf[k + B],
                        buf[k - 1], buf[k + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K11 residual.
// Replaces gerris_tpu/ops/pallas/rbgs.py:residual_pallas (_residual_kernel):
// r = rhs - (L - dia) u with static ghosts (sgn * mirror + off per side),
// periodic on either axis.  The adaptive solve's one residual per cycle.
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
// and/or columns.  The "relax" solver's sweeps and the upward levels of a
// correction with periodic rows.
// Bound: device-memory bytes for a level of many tiles (reads u and rhs,
// writes the result once for all sweeps); a level that fits one block is
// bound by its serial half-sweeps.
// Design: K3's tile without its prolongation.  One block per tile x tile
// output tile; the shared buffer holds the tile, a halo of 2*nsweeps cells
// and a frozen outer ring, and the rhs beside it.  On a periodic axis the
// halo is read across the wrap (the TPU kernel's wrapped halo DMAs); on a
// non-periodic one, the domain-edge ghosts inside the buffer are
// recomputed (sgn * mirror) before every half-sweep.  The valid region
// shrinks by at most one cell per half-sweep, so the tile is exact after
// 2*nsweeps of them, for any tile size.  A level that fits one block runs
// with tile = n and halo = 0, its periodic wrap refreshed like a ghost
// ring.  The global colour of a wrapped cell is that of its unwrapped
// position: the levels are even.
// ---------------------------------------------------------------------------
template <typename T>
struct RXArgs {
  const T* u;
  const T* rhs;
  T* out;
  int n0, n1, tile, halo, nsweeps;
  T h2, inv_denom, omega, one_m_omega;
  int use_omega;
  T sgn[4];
  int per_x, per_y;
};

template <typename T>
__global__ void rbgs_relax_kernel(RXArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int B = tile + 2 * halo + 2;
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* rb = buf + (size_t)B * B;
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // a tiled block reads its halo across a periodic axis' wrap; a
  // whole-level block (halo 0) refreshes the wrap like a ghost ring
  const bool wrap_x = a.per_x && halo > 0, wrap_y = a.per_y && halo > 0;
  const T sx0 = a.sgn[0], sx1 = a.sgn[1], sy0 = a.sgn[2], sy1 = a.sgn[3];

  // ---- place u and rhs
  for (int li = ty; li < B; li += PR_THREADS_Y) {
    int gi = gi0 + li;
    if (wrap_x) gi = (gi % n0 + n0) % n0;
    const bool real_i = gi >= 0 && gi < n0;
    for (int lj = tx; lj < B; lj += PR_THREADS_X) {
      int gj = gj0 + lj;
      if (wrap_y) gj = (gj % n1 + n1) % n1;
      const bool real = real_i && gj >= 0 && gj < n1;
      const size_t g = (size_t)gi * n1 + gj;
      buf[li * B + lj] = real ? a.u[g] : T(0);
      rb[li * B + lj] = real ? a.rhs[g] : T(0);
    }
  }
  __syncthreads();

  for (int sw = 0; sw < 2 * a.nsweeps; ++sw) {
    const int color = sw & 1;  // red ((i+j) even) first
    // ---- ghosts from the current interior: domain edges, and the wrap of
    // a whole-level block
    for (int li = ty; li < B; li += PR_THREADS_Y) {
      const int gi = gi0 + li;
      const bool real_i = wrap_x || (gi >= 0 && gi < n0);
      const bool ghost_i = !real_i && (gi == -1 || gi == n0);
      for (int lj = tx; lj < B; lj += PR_THREADS_X) {
        const int gj = gj0 + lj;
        const bool real_j = wrap_y || (gj >= 0 && gj < n1);
        const bool ghost_j = !real_j && (gj == -1 || gj == n1);
        const int k = li * B + lj;
        if (ghost_i && real_j) {
          if (a.per_x)
            buf[k] = gi < 0 ? buf[k + n0 * B] : buf[k - n0 * B];
          else
            buf[k] = gi < 0 ? sx0 * buf[k + B] : sx1 * buf[k - B];
        } else if (real_i && ghost_j) {
          if (a.per_y)
            buf[k] = gj < 0 ? buf[k + n1] : buf[k - n1];
          else
            buf[k] = gj < 0 ? sy0 * buf[k + 1] : sy1 * buf[k - 1];
        }
      }
    }
    __syncthreads();
    // ---- one colour; the frozen outer ring is never updated
    for (int li = ty + 1; li < B - 1; li += PR_THREADS_Y) {
      const int gi = gi0 + li;
      if (!wrap_x && (gi < 0 || gi >= n0)) continue;
      for (int lj = tx + 1; lj < B - 1; lj += PR_THREADS_X) {
        const int gj = gj0 + lj;
        if (!wrap_y && (gj < 0 || gj >= n1)) continue;
        if (((gi + gj) & 1) != color) continue;
        const int k = li * B + lj;
        const T c = buf[k];
        const T nb = buf[k - B] + buf[k + B] + buf[k - 1] + buf[k + 1];
        T nw = (nb - a.h2 * rb[k]) * a.inv_denom;
        if (a.use_omega) nw = a.one_m_omega * c + a.omega * nw;
        buf[k] = nw;
      }
    }
    __syncthreads();
  }

  // ---- the tile
  for (int li = halo + 1 + ty; li < halo + 1 + tile; li += PR_THREADS_Y) {
    const int gi = gi0 + li;
    for (int lj = halo + 1 + tx; lj < halo + 1 + tile;
         lj += PR_THREADS_X) {
      a.out[(size_t)gi * n1 + gj0 + lj] = buf[li * B + lj];
    }
  }
}

// ---------------------------------------------------------------------------
// K15 rbgs_relax_alpha.
// Replaces gerris_tpu/ops/pallas/rbgs.py:rbgs_relax_alpha (_kernel_alpha):
// nsweeps red-black Gauss-Seidel sweeps (red = global (i+j) even first)
// from a given u on div(alpha grad u) - dia u = rhs, face coefficients ax
// ((n0+1) x n1) and ay (n0 x (n1+1)), a scalar or per-cell dia,
// homogeneous ghosts, periodic rows and/or columns.  A cell's update is
// (ax_lo u_up + ax_hi u_dn + ay_lo u_lf + ay_hi u_rt - h2 rhs) / den with
// den = ax_lo + ax_hi + ay_lo + ay_hi + dia h2, summed in that order;
// a cell with den <= 1e-20 (a zero diagonal) keeps its value.  On a
// periodic axis face n is face 0.  Every level of the two-phase
// projections' and the variable-density diffusion's corrections.
// Bound: device-memory bytes for a level of many tiles (reads u, rhs,
// ax, ay and the cell dia once, writes the result once for all sweeps);
// a level that fits one block is bound by its serial half-sweeps.
// Design: K10's tile.  One block per tile x tile output tile; shared
// buffers of B x B (B = tile + 2 halo + 2, the halo 2 nsweeps, then a
// frozen outer ring) hold u, rhs, each local cell's low x face (row li
// holds face gi0 + li, so a cell reads rows li and li + 1), its low y
// face (column lj likewise), and den, formed once per launch from the
// faces and dia.  The coefficients are static across the sweeps, so the
// valid region shrinks by at most one cell per half-sweep exactly as in
// K10, and the tile is exact after 2 nsweeps of them for any tile size.
// On a periodic axis the halo and the face windows are read across the
// wrap; a level that fits one block runs with tile = n and halo = 0, its
// periodic wrap refreshed like a ghost ring.
// ---------------------------------------------------------------------------
template <typename T>
struct RAArgs {
  const T* u;
  const T* rhs;
  const T* ax;
  const T* ay;
  const T* dia_cell;  // nullptr: the scalar dia
  T* out;
  int n0, n1, tile, halo, nsweeps;
  T dia, h2, omega, one_m_omega;
  int use_omega;
  T sgn[4];
  int per_x, per_y;
};

template <typename T>
__global__ void rbgs_relax_alpha_kernel(RAArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int n0 = a.n0, n1 = a.n1, tile = a.tile, halo = a.halo;
  const int B = tile + 2 * halo + 2;
  const size_t BB = (size_t)B * B;
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* rb = buf + BB;
  T* axs = rb + BB;
  T* ays = axs + BB;
  T* den = ays + BB;
  const int gi0 = blockIdx.y * tile - halo - 1;
  const int gj0 = blockIdx.x * tile - halo - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool wrap_x = a.per_x && halo > 0, wrap_y = a.per_y && halo > 0;
  const T sx0 = a.sgn[0], sx1 = a.sgn[1], sy0 = a.sgn[2], sy1 = a.sgn[3];

  // ---- place u, rhs, the faces and the cell dia (in den for now)
  for (int li = ty; li < B; li += PR_THREADS_Y) {
    int gi = gi0 + li;
    if (wrap_x) gi = (gi % n0 + n0) % n0;
    const bool real_i = gi >= 0 && gi < n0;
    // the low x face of local row li: face n0 is face 0 when periodic
    int fi = gi0 + li;
    if (a.per_x) fi = (fi % n0 + n0) % n0;
    const bool face_i = fi >= 0 && fi <= n0;
    for (int lj = tx; lj < B; lj += PR_THREADS_X) {
      int gj = gj0 + lj;
      if (wrap_y) gj = (gj % n1 + n1) % n1;
      const bool real_j = gj >= 0 && gj < n1;
      int fj = gj0 + lj;
      if (a.per_y) fj = (fj % n1 + n1) % n1;
      const bool face_j = fj >= 0 && fj <= n1;
      const size_t g = (size_t)gi * n1 + gj;
      const int k = li * B + lj;
      buf[k] = real_i && real_j ? a.u[g] : T(0);
      rb[k] = real_i && real_j ? a.rhs[g] : T(0);
      axs[k] = face_i && real_j ? a.ax[(size_t)fi * n1 + gj] : T(0);
      ays[k] = real_i && face_j ? a.ay[(size_t)gi * (n1 + 1) + fj] : T(0);
      den[k] = a.dia_cell == nullptr ? a.dia
               : (real_i && real_j ? a.dia_cell[g] : T(0));
    }
  }
  __syncthreads();
  // ---- den = ax_lo + ax_hi + ay_lo + ay_hi + dia h2 of the cells a
  // sweep may update (each thread rewrites only its own entries)
  for (int li = ty + 1; li < B - 1; li += PR_THREADS_Y) {
    for (int lj = tx + 1; lj < B - 1; lj += PR_THREADS_X) {
      const int k = li * B + lj;
      const T dh2 = den[k] * a.h2;
      den[k] = axs[k] + axs[k + B] + ays[k] + ays[k + 1] + dh2;
    }
  }
  __syncthreads();

  for (int sw = 0; sw < 2 * a.nsweeps; ++sw) {
    const int color = sw & 1;  // red ((i+j) even) first
    // ---- ghosts from the current interior: domain edges, and the wrap of
    // a whole-level block
    for (int li = ty; li < B; li += PR_THREADS_Y) {
      const int gi = gi0 + li;
      const bool real_i = wrap_x || (gi >= 0 && gi < n0);
      const bool ghost_i = !real_i && (gi == -1 || gi == n0);
      for (int lj = tx; lj < B; lj += PR_THREADS_X) {
        const int gj = gj0 + lj;
        const bool real_j = wrap_y || (gj >= 0 && gj < n1);
        const bool ghost_j = !real_j && (gj == -1 || gj == n1);
        const int k = li * B + lj;
        if (ghost_i && real_j) {
          if (a.per_x)
            buf[k] = gi < 0 ? buf[k + n0 * B] : buf[k - n0 * B];
          else
            buf[k] = gi < 0 ? sx0 * buf[k + B] : sx1 * buf[k - B];
        } else if (real_i && ghost_j) {
          if (a.per_y)
            buf[k] = gj < 0 ? buf[k + n1] : buf[k - n1];
          else
            buf[k] = gj < 0 ? sy0 * buf[k + 1] : sy1 * buf[k - 1];
        }
      }
    }
    __syncthreads();
    // ---- one colour; the frozen outer ring is never updated
    for (int li = ty + 1; li < B - 1; li += PR_THREADS_Y) {
      const int gi = gi0 + li;
      if (!wrap_x && (gi < 0 || gi >= n0)) continue;
      for (int lj = tx + 1; lj < B - 1; lj += PR_THREADS_X) {
        const int gj = gj0 + lj;
        if (!wrap_y && (gj < 0 || gj >= n1)) continue;
        if (((gi + gj) & 1) != color) continue;
        const int k = li * B + lj;
        const T d0 = den[k];
        if (!(d0 > T(1e-20))) continue;  // a zero diagonal: untouched
        const T c = buf[k];
        const T num = axs[k] * buf[k - B] + axs[k + B] * buf[k + B] +
                      ays[k] * buf[k - 1] + ays[k + 1] * buf[k + 1];
        T nw = (num - a.h2 * rb[k]) / d0;
        if (a.use_omega) nw = a.one_m_omega * c + a.omega * nw;
        buf[k] = nw;
      }
    }
    __syncthreads();
  }

  // ---- the tile
  for (int li = halo + 1 + ty; li < halo + 1 + tile; li += PR_THREADS_Y) {
    const int gi = gi0 + li;
    for (int lj = halo + 1 + tx; lj < halo + 1 + tile;
         lj += PR_THREADS_X) {
      a.out[(size_t)gi * n1 + gj0 + lj] = buf[li * B + lj];
    }
  }
}

// ---------------------------------------------------------------------------
// K12 coarse_vcycle, its block kernel.
// Replaces gerris_tpu/ops/pallas/rbgs.py:coarse_vcycle (_cv_kernel, its
// smoother _cv_relax) together with the restrict2 and K3 launches of the
// levels above 64^2 (ops/cuda/rbgs.py:coarse_vcycle): du for the whole
// sub-hierarchy at and below r's level, homogeneous ghosts, non-periodic
// rows, periodic columns or not, omega 1.
// Bound: barriers and launches, not bytes: at the 64^2 top it reads r
// (16 KB in f32) and writes du once, and its work is ~2 * coarsest +
// 4 * nsweeps half-sweeps of at most 2048 cells each, serial in between.
// Design: the TPU kernel holds a 512^2 cascade in one launch; a 512^2
// level does not fit one block's shared memory, so on the card one block
// of 1024 threads holds the cascade from a top of at most 64^2 down to
// min_n^2 and back: the residual pyramid (r at the top, restricted in
// shared memory) and du in two ping-pong buffers (level l from the top in
// buffer l % 2), ~41 KB in f32 and ~82 KB in f64.  A cell's neighbours
// are read through index tests instead of a ghost ring, so a half-sweep
// costs one barrier.  The coarsest level starts from du = 0 with
// `coarsest` sweeps; every level above it is a bilinear prolongation
// (K3's arithmetic) and `nsweeps` sweeps.
// ---------------------------------------------------------------------------
constexpr int CB_TOP = 64;
constexpr int CB_THREADS = 1024;
constexpr int CB_LEVELS = 7;  // 64^2 .. 1^2

template <typename T>
struct CBArgs {
  const T* r;
  T* du;
  int n, min_n, nsweeps, coarsest;
  double dia, h2;  // h2 at r's level
  T sgn[4];
  int per_y;
};

template <typename T>
__device__ void cb_restrict(const T* f, T* c, int s) {
  const int n1 = 2 * s;
  for (int k = threadIdx.x; k < s * s; k += CB_THREADS) {
    const int i = k / s, j = k - i * s;
    const T* p = f + (size_t)(2 * i) * n1 + 2 * j;
    const T x = T(0.5) * (p[0] + p[n1]);
    const T y = T(0.5) * (p[1] + p[n1 + 1]);
    c[k] = T(0.5) * (x + y);
  }
  __syncthreads();
}

// nsweeps red-black sweeps of the s x s level d on rhs, one barrier per
// half-sweep
template <typename T>
__device__ void cb_sweeps(T* d, const T* rhs, int s, int nsweeps,
                          const CBArgs<T>& a) {
  const double h2d = a.h2 * double(a.n / s) * double(a.n / s);
  const T h2 = T(h2d);
  const T inv_denom = T(1.0 / (4.0 + a.dia * h2d));
  const int half = s / 2;  // cells of one colour per row
  const int cells = s * half;
  for (int sw = 0; sw < 2 * nsweeps; ++sw) {
    const int color = sw & 1;  // red ((i+j) even) first
    for (int k = threadIdx.x; k < cells; k += CB_THREADS) {
      const int i = k / half;
      const int j = 2 * (k - i * half) + ((i + color) & 1);
      const int q = i * s + j;
      const T c = d[q];
      const T up = i > 0 ? d[q - s] : a.sgn[0] * c;
      const T dn = i < s - 1 ? d[q + s] : a.sgn[1] * c;
      T lf, rt;
      if (a.per_y) {
        lf = d[j > 0 ? q - 1 : q + s - 1];
        rt = d[j < s - 1 ? q + 1 : q - (s - 1)];
      } else {
        lf = j > 0 ? d[q - 1] : a.sgn[2] * c;
        rt = j < s - 1 ? d[q + 1] : a.sgn[3] * c;
      }
      d[q] = (up + dn + lf + rt - h2 * rhs[q]) * inv_denom;
    }
    __syncthreads();
  }
}

// bilinear prolongation of the (s/2)^2 level c into the s^2 level f (rows
// first, homogeneous ghosts; K3's arithmetic)
template <typename T>
__device__ void cb_prolong(const T* c, T* f, int s, const CBArgs<T>& a) {
  const int m1 = s / 2;
  for (int k = threadIdx.x; k < s * s; k += CB_THREADS) {
    const int gi = k / s, gj = k - gi * s;
    const int ci = gi >> 1, cj = gj >> 1;
    const int cin = (gi & 1) ? ci + 1 : ci - 1;
    auto rowstep = [&](int cc) -> T {
      const T base = c[ci * m1 + cc];
      T nb;
      if (gi == 0)
        nb = a.sgn[0] * base;
      else if (gi == s - 1)
        nb = a.sgn[1] * base;
      else
        nb = c[cin * m1 + cc];
      return T(0.75) * base + T(0.25) * nb;
    };
    const T p = rowstep(cj);
    const int cjn = (gj & 1) ? cj + 1 : cj - 1;
    T q;
    if (a.per_y)
      q = rowstep((cjn + m1) % m1);
    else if (gj == 0)
      q = a.sgn[2] * p;
    else if (gj == s - 1)
      q = a.sgn[3] * p;
    else
      q = rowstep(cjn);
    f[k] = T(0.75) * p + T(0.25) * q;
  }
  __syncthreads();
}

template <typename T>
__global__ void coarse_block_kernel(CBArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n;
  // the residual pyramid n^2 .. min_n^2, then the two du buffers
  T* rs[CB_LEVELS];
  int sizes[CB_LEVELS];
  int nl = 0;
  T* p = sm;
  for (int s = n; s >= a.min_n; s >>= 1, ++nl) {
    rs[nl] = p;
    sizes[nl] = s;
    p += s * s;
  }
  T* dbuf[2] = {p, p + n * n};
  for (int k = threadIdx.x; k < n * n; k += CB_THREADS) rs[0][k] = a.r[k];
  __syncthreads();
  for (int l = 1; l < nl; ++l) cb_restrict(rs[l - 1], rs[l], sizes[l]);
  // the coarsest level from du = 0
  T* d = dbuf[(nl - 1) & 1];
  const int sc = sizes[nl - 1];
  for (int k = threadIdx.x; k < sc * sc; k += CB_THREADS) d[k] = T(0);
  __syncthreads();
  cb_sweeps(d, rs[nl - 1], sc, a.coarsest, a);
  for (int l = nl - 2; l >= 0; --l) {
    T* f = dbuf[l & 1];
    cb_prolong(d, f, sizes[l], a);
    cb_sweeps(f, rs[l], sizes[l], a.nsweeps, a);
    d = f;
  }
  for (int k = threadIdx.x; k < n * n; k += CB_THREADS) a.du[k] = d[k];
}

bool batch_ok(int batch) { return batch >= 1 && batch <= MAX_BATCH; }

template <typename T>
int launch_residual_restrict(int batch, const void* const* u,
                             const void* const* rhs, const void* const* sub,
                             const double* dia, const double* off, double h2,
                             int n0, int n1, const double* sgn, int per_y,
                             void* const* r0, void* const* r1,
                             void* const* r2, void* stream) {
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
  dim3 block(RR_TILE, RR_TILE);
  dim3 grid(n1 / RR_TILE, n0 / RR_TILE, batch);
  residual_restrict_kernel<T, false>
      <<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_residual_restrict_div(const void* const* ptr, double dia,
                                 const double* off, double h2,
                                 double div_scale, int n0, int n1,
                                 const double* sgn, int per_y,
                                 void* stream) {
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
  dim3 block(RR_TILE, RR_TILE);
  dim3 grid(n1 / RR_TILE, n0 / RR_TILE, 1);
  residual_restrict_kernel<T, true>
      <<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_restrict2(int batch, const void* const* r, int n0, int n1,
                     void* const* out, void* stream) {
  if (!batch_ok(batch)) return (int)cudaErrorInvalidValue;
  R2Args<T> a = {};
  for (int b = 0; b < batch; ++b) {
    a.sys[b].r = (const T*)r[b];
    a.sys[b].out = (T*)out[b];
  }
  a.n0 = n0;
  a.n1 = n1;
  dim3 block(32, 8);
  dim3 grid((n1 / 2 + 31) / 32, (n0 / 2 + 7) / 8, batch);
  restrict2_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
PRArgs<T> prolong_args(int batch, const void* const* coarse,
                       const void* const* rhs, const void* const* u,
                       void* const* out, const double* dia, int n0, int n1,
                       int tile, int halo, int nsweeps, double h2,
                       double omega, const double* sgn, int per_y) {
  PRArgs<T> a = {};
  for (int b = 0; b < batch; ++b) {
    PRSystem<T>& s = a.sys[b];
    s.coarse = (const T*)coarse[b];
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
  const int B = tile + 2 * halo + 2;
  const size_t smem = 2 * (size_t)B * B * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      prolong_relax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(PR_THREADS_X, PR_THREADS_Y);
  dim3 grid(n1 / tile, n0 / tile, batch);
  prolong_relax_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(a);
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
  const int B = tile + 2 * halo + 2;
  const size_t smem = 2 * (size_t)B * B * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      prolong_relax_correct_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(PR_THREADS_X, PR_THREADS_Y);
  dim3 grid(n1 / tile, n0 / tile, 1);
  prolong_relax_correct_kernel<T>
      <<<grid, block, smem, (cudaStream_t)stream>>>(
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

template <typename T>
int launch_rbgs_relax(const void* u, const void* rhs, void* out, int n0,
                      int n1, int tile, int halo, int nsweeps, double dia,
                      double h2, double omega, const double* sgn, int per_x,
                      int per_y, void* stream) {
  RXArgs<T> a = {};
  a.u = (const T*)u;
  a.rhs = (const T*)rhs;
  a.out = (T*)out;
  a.n0 = n0;
  a.n1 = n1;
  a.tile = tile;
  a.halo = halo;
  a.nsweeps = nsweeps;
  a.h2 = T(h2);
  a.inv_denom = T(1.0 / (4.0 + dia * h2));
  a.omega = T(omega);
  a.one_m_omega = T(1.0 - omega);
  a.use_omega = omega != 1.0;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_x = per_x;
  a.per_y = per_y;
  const int B = tile + 2 * halo + 2;
  const size_t smem = 2 * (size_t)B * B * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      rbgs_relax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(PR_THREADS_X, PR_THREADS_Y);
  dim3 grid(n1 / tile, n0 / tile);
  rbgs_relax_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptr: u, rhs, ax, ay, dia (nullptr for the scalar), out
template <typename T>
int launch_rbgs_relax_alpha(const void* const* ptr, int n0, int n1,
                            int tile, int halo, int nsweeps, double dia,
                            double h2, double omega, const double* sgn,
                            int per_x, int per_y, void* stream) {
  RAArgs<T> a = {};
  a.u = (const T*)ptr[0];
  a.rhs = (const T*)ptr[1];
  a.ax = (const T*)ptr[2];
  a.ay = (const T*)ptr[3];
  a.dia_cell = (const T*)ptr[4];
  a.out = (T*)ptr[5];
  a.n0 = n0;
  a.n1 = n1;
  a.tile = tile;
  a.halo = halo;
  a.nsweeps = nsweeps;
  a.dia = T(dia);
  a.h2 = T(h2);
  a.omega = T(omega);
  a.one_m_omega = T(1.0 - omega);
  a.use_omega = omega != 1.0;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_x = per_x;
  a.per_y = per_y;
  const int B = tile + 2 * halo + 2;
  const size_t smem = 5 * (size_t)B * B * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      rbgs_relax_alpha_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(PR_THREADS_X, PR_THREADS_Y);
  dim3 grid(n1 / tile, n0 / tile);
  rbgs_relax_alpha_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_coarse_block(const void* r, void* du, int n, int min_n,
                        int nsweeps, int coarsest, double dia, double h2,
                        const double* sgn, int per_y, void* stream) {
  if (n > CB_TOP || min_n < 2 || min_n > n) return (int)cudaErrorInvalidValue;
  CBArgs<T> a = {};
  a.r = (const T*)r;
  a.du = (T*)du;
  a.n = n;
  a.min_n = min_n;
  a.nsweeps = nsweeps;
  a.coarsest = coarsest;
  a.dia = dia;
  a.h2 = h2;
  for (int k = 0; k < 4; ++k) a.sgn[k] = T(sgn[k]);
  a.per_y = per_y;
  size_t cells = 0;
  for (int s = n; s >= min_n; s >>= 1) cells += (size_t)s * s;
  cells += (size_t)n * n + (size_t)(n / 2) * (n / 2);
  const size_t smem = cells * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      coarse_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  coarse_block_kernel<T><<<1, CB_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface.  For the batched kernels the device pointers of a
// launch are one host table of `batch` entries per argument, in the order
// listed (residual_restrict: u, rhs, sub, r0, r1, r2; restrict2: r, out;
// prolong_relax: coarse, rhs, u, out), so that a launch builds one array;
// dia is a host array of `batch` entries, the ghost offsets of 4 * batch.
// residual, rbgs_relax and coarse_block take one system's pointers;
// rbgs_relax_alpha one table (u, rhs, ax, ay, dia, out; dia NULL for the
// scalar);
// residual_restrict_div one table (u, ufx, ufy, sub, r0, r1, r2) and
// prolong_relax_correct one table (coarse, rhs, u, ufx, ufy, U, V, p',
// ufx', ufy', gx, gy, U', V'; the cells NULL without them).
#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_residual_restrict_##SUFFIX(                              \
      int batch, void* const* ptr, const double* dia, const double* off,      \
      double h2, int n0, int n1, const double* sgn, int per_y,                \
      void* stream) {                                                         \
    return launch_residual_restrict<T>(                                       \
        batch, ptr, ptr + batch, ptr + 2 * batch, dia, off, h2, n0, n1, sgn,  \
        per_y, ptr + 3 * batch, ptr + 4 * batch, ptr + 5 * batch, stream);    \
  }                                                                           \
  extern "C" int gtt_restrict2_##SUFFIX(int batch, void* const* ptr, int n0,  \
                                        int n1, void* stream) {               \
    return launch_restrict2<T>(batch, ptr, n0, n1, ptr + batch, stream);     \
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
      const double* sgn, int per_x, int per_y, void* stream) {                \
    return launch_rbgs_relax<T>(u, rhs, out, n0, n1, tile, halo, nsweeps,     \
                                dia, h2, omega, sgn, per_x, per_y, stream);   \
  }                                                                           \
  extern "C" int gtt_residual_restrict_div_##SUFFIX(                          \
      void* const* ptr, double dia, const double* off, double h2,             \
      double div_scale, int n0, int n1, const double* sgn, int per_y,         \
      void* stream) {                                                         \
    return launch_residual_restrict_div<T>(ptr, dia, off, h2, div_scale, n0,  \
                                           n1, sgn, per_y, stream);           \
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
      void* const* ptr, int n0, int n1, int tile, int halo, int nsweeps,      \
      double dia, double h2, double omega, const double* sgn, int per_x,      \
      int per_y, void* stream) {                                              \
    return launch_rbgs_relax_alpha<T>(ptr, n0, n1, tile, halo, nsweeps, dia,  \
                                      h2, omega, sgn, per_x, per_y, stream);  \
  }                                                                           \
  extern "C" int gtt_coarse_block_##SUFFIX(                                   \
      const void* r, void* du, int n, int min_n, int nsweeps, int coarsest,   \
      double dia, double h2, const double* sgn, int per_y, void* stream) {    \
    return launch_coarse_block<T>(r, du, n, min_n, nsweeps, coarsest, dia,    \
                                  h2, sgn, per_y, stream);                    \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
