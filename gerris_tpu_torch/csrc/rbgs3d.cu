// K13 rbgs_relax_3d for Hopper (sm_90a): the 3D multigrid smoother of
// gerris_tpu_torch/solvers/poisson.py:relax (every upward level of a 3D
// correction).
//
// Replaces gerris_tpu/ops/pallas/rbgs3d.py:rbgs_relax_3d (_kernel3d):
// nsweeps red-black Gauss-Seidel sweeps (red = global (i+j+k) even, red
// half first) from a given u on (L7 - dia) u = rhs, with L7 the 7-point
// Laplacian, a scalar dia and homogeneous ghosts ghost = sgn * u per side,
// sides ordered (x lo, x hi, y lo, y hi, z lo, z hi), -1 Dirichlet and +1
// Neumann.  A cell's update is
//   new = (xm + xp + ym + yp + zm + zp - h2 * rhs) * inv_denom,
//   inv_denom = 1 / (6 + dia h2) (computed on the host, in double),
// then (1 - omega) * u + omega * new when omega != 1: the TPU kernel's
// multiply by the reciprocal, not the jnp route's division.
//
// Layout: a contiguous (n0, n1, n2) row-major field, axis 2 contiguous,
// any shape.  The TPU kernel's strips, their 2*nsweeps halo, the 128-lane
// padding of n2 and its plane limits were VMEM/DMA constraints, not
// semantics, and are not copied.
//
// Bound: device-memory bytes.  A sweep does ~10 flops per cell and no
// tensor-core work; the least a call must move is u and rhs in and u out
// once.
// Design: one launch per half-sweep, one thread per cell of the colour,
// neighbours read straight from device memory (L1/L2 serve the reuse),
// updated in place: a half-sweep reads only the other colour (and each
// thread its own cell) and writes only its own colour, so the launch has
// no race and needs no barrier.  The first launch also copies the other
// colour from u to the output (a thread per cell), so u is left as it was
// and no separate copy runs: 2 * nsweeps launches per call, each moving
// u, rhs and the colour's half of the output.  A tile with a 2*nsweeps
// halo (K3/K10's design) would cost 27x the cell work at 4 sweeps on an
// 8^3 tile; a plane-marching shared-memory design is later work.
//
// The launches go on the caller's stream, allocate nothing, and the call
// returns the first CUDA error (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int HS_THREADS_X = 32;
constexpr int HS_THREADS_Y = 8;

template <typename T>
struct HalfSweepArgs {
  const T* src;  // the values read: u in the first launch, else dst
  T* dst;
  const T* rhs;
  T h2, inv_denom, w_old, w_new;  // w_old = 1 - omega, w_new = omega
  T sgn[6];
  int n0, n1, n2;
  int colour;    // 0: the red half ((i+j+k) even), 1: the black half
  int copy;      // 1: a thread per cell, the other colour copied src -> dst
  int over;      // omega != 1
};

// One half-sweep.  Threads: x along axis 2 (every cell with `copy`, else
// every second cell, k = 2x + parity), y along axis 1, blockIdx.z along
// axis 0.
template <typename T>
__global__ void rbgs3d_half_sweep_kernel(HalfSweepArgs<T> a) {
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n1) return;
  // the colour's cells of row (i, j) have k % 2 == parity
  const int parity = (i + j + a.colour) & 1;
  const int k = a.copy ? x : 2 * x + parity;
  if (k >= a.n2) return;
  const size_t n2 = (size_t)a.n2;
  const size_t plane = (size_t)a.n1 * n2;
  const size_t c = ((size_t)i * a.n1 + j) * n2 + k;
  const T* u = a.src;
  const T uc = u[c];
  if ((k & 1) != parity) {  // only in a copying launch
    a.dst[c] = uc;
    return;
  }
  const T xm = i > 0 ? u[c - plane] : a.sgn[0] * uc;
  const T xp = i < a.n0 - 1 ? u[c + plane] : a.sgn[1] * uc;
  const T ym = j > 0 ? u[c - n2] : a.sgn[2] * uc;
  const T yp = j < a.n1 - 1 ? u[c + n2] : a.sgn[3] * uc;
  const T zm = k > 0 ? u[c - 1] : a.sgn[4] * uc;
  const T zp = k < a.n2 - 1 ? u[c + 1] : a.sgn[5] * uc;
  const T nb = xm + xp + ym + yp + zm + zp;
  T v = (nb - a.h2 * a.rhs[c]) * a.inv_denom;
  if (a.over) v = a.w_old * uc + a.w_new * v;
  a.dst[c] = v;
}

template <typename T>
int launch_rbgs_relax_3d(const void* u, const void* rhs, void* out, int n0,
                         int n1, int n2, int nsweeps, double h2,
                         double inv_denom, double omega, const double* sgn,
                         void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || n0 > 65535 || nsweeps < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nsweeps == 0)
    return (int)cudaMemcpyAsync(out, u, (size_t)n0 * n1 * n2 * sizeof(T),
                                cudaMemcpyDeviceToDevice, s);
  HalfSweepArgs<T> a = {};
  a.dst = (T*)out;
  a.rhs = (const T*)rhs;
  a.h2 = T(h2);
  a.inv_denom = T(inv_denom);
  a.w_old = T(1.0 - omega);
  a.w_new = T(omega);
  for (int q = 0; q < 6; ++q) a.sgn[q] = T(sgn[q]);
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.over = omega != 1.0;
  const dim3 block(HS_THREADS_X, HS_THREADS_Y);
  for (int h = 0; h < 2 * nsweeps; ++h) {
    a.colour = h & 1;
    a.copy = h == 0;
    a.src = h == 0 ? (const T*)u : (const T*)out;
    const int nx = a.copy ? n2 : (n2 + 1) / 2;
    const dim3 grid((nx + HS_THREADS_X - 1) / HS_THREADS_X,
                    (n1 + HS_THREADS_Y - 1) / HS_THREADS_Y, n0);
    rbgs3d_half_sweep_kernel<T><<<grid, block, 0, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// The C interface (loaded with ctypes by gerris_tpu_torch/ops/cuda/rbgs3d.py):
// u, rhs and out are device pointers to contiguous (n0, n1, n2) fields of
// the suffix's type (out distinct from u); sgn is a host array of 6 ghost
// signs.  2 * nsweeps half-sweep launches (a copy when nsweeps == 0).
#define GTT_EXPORT(SUFFIX, T)                                                 \
  extern "C" int gtt_rbgs_relax_3d_##SUFFIX(                                  \
      const void* u, const void* rhs, void* out, int n0, int n1, int n2,     \
      int nsweeps, double h2, double inv_denom, double omega,                 \
      const double* sgn, void* stream) {                                      \
    return launch_rbgs_relax_3d<T>(u, rhs, out, n0, n1, n2, nsweeps, h2,     \
                                   inv_denom, omega, sgn, stream);            \
  }

GTT_EXPORT(f32, float)
GTT_EXPORT(f64, double)
