"""Derived variables, wavelets and droplets (gerris_tpu_torch/ops/derived.py,
spectral/wavelets.py, physics/droplets.py) against the JAX package on the
CPU in float64, and the gates of tests/test_derived.py on the port.

The vorticity, the velocity norms, the Laplacian and the stream function
(walls and periodic), the Haar transforms and their error fields within
1e-12 of max; the droplet labels on a field with periodic wraps, their
statistics, the conversion to particles and back and the removal, against
the JAX package's, with the volume kept; the stamp of a small droplet,
whose volume the JAX package's rescale loses to its clamp (ROADMAP Queue
3) and the port keeps."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops import derived as jder  # noqa: E402
from gerris_tpu.physics import droplets as jdrop  # noqa: E402
from gerris_tpu.solvers.poisson import MultilevelParams as JMP  # noqa: E402
from gerris_tpu.spectral import wavelets as jwav  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.ops import derived  # noqa: E402
from gerris_tpu_torch.physics import droplets  # noqa: E402
from gerris_tpu_torch.physics import particles as tp  # noqa: E402
from gerris_tpu_torch.solvers.poisson import MultilevelParams  # noqa: E402
from gerris_tpu_torch.spectral import wavelets  # noqa: E402

CPU = torch.device("cpu")


def close(a, b, rtol=1e-12):
    a = np.asarray(a, dtype=np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
    assert err <= rtol, err


def bcs(kind):
    if kind == "periodic":
        return [jbc.periodic_bc(2)] * 2, \
            [tbc.FieldBC.uniform(tbc.Periodic(), 2)] * 2
    return [jbc.velocity_bc(c, 2) for c in range(2)], \
        [tbc.velocity_bc(c, 2) for c in range(2)]


@pytest.mark.parametrize("kind", ["walls", "periodic"])
def test_derived_fields_match_jax(kind):
    """The vorticity (2D and 3D), |u|, |u|^2, the Laplacian and the stream
    function of a seeded velocity; the stream function's solve on both
    sides with a dense coarsest level of 8^2."""
    rng = np.random.default_rng(0)
    U = [rng.standard_normal((32, 32)) for _ in range(2)]
    jb, tb = bcs(kind)
    jU, tU = [jnp.asarray(u) for u in U], [torch.as_tensor(u) for u in U]
    jg, tg = JGrid(5), Grid(5)
    close(jder.vorticity(jU, jg, jb), derived.vorticity(tU, tg, tb))
    close(jder.velocity_norm(jU), derived.velocity_norm(tU))
    close(jder.velocity2(jU), derived.velocity2(tU))
    close(jder.laplacian_of(jU[0], jg, jb[0]),
          derived.laplacian_of(tU[0], tg, tb[0]))
    U3 = [rng.standard_normal((8, 8, 8)) for _ in range(3)]
    jb3 = [jbc.velocity_bc(c, 3) for c in range(3)]
    tb3 = [tbc.velocity_bc(c, 3) for c in range(3)]
    for a, b in zip(jder.vorticity([jnp.asarray(u) for u in U3],
                                   JGrid(3, dim=3), jb3),
                    derived.vorticity([torch.as_tensor(u) for u in U3],
                                      Grid(3, dim=3), tb3)):
        close(a, b)
    # the stream function: the JAX function fixes its params, so its
    # solve is run here as it runs it, with the CPU's dense cap
    from gerris_tpu.solvers import poisson as jpoisson
    w = jder.vorticity(jU, jg, jb)
    if kind == "periodic":
        w = w - jnp.mean(w)
        jfbc = jbc.periodic_bc(2)
    else:
        jfbc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    kw = dict(tolerance=1e-8, nitermax=60, dense_coarse_max=64)
    jpsi, _ = jpoisson.solve(jnp.zeros(jg.shape), w, jg, jfbc, JMP(**kw))
    tpsi = derived.stream_function(tU, tg, tb,
                                   params=MultilevelParams(**kw))
    close(jpsi, tpsi, 1e-11)


def test_vorticity_and_stream_function():
    """tests/test_derived.py's gate on the port: psi recovered from u =
    (-dpsi/dy, dpsi/dx) up to the discretization."""
    grid = Grid(6)
    per = [tbc.FieldBC.uniform(tbc.Periodic(), 2)] * 2
    x, y = (torch.as_tensor(c) for c in grid.centers)
    s = 2 * math.pi
    psi_exact = torch.sin(s * x) * torch.sin(s * y) / s
    U = [-torch.sin(s * x) * torch.cos(s * y),
         torch.cos(s * x) * torch.sin(s * y)]
    w = derived.vorticity(U, grid, per)
    we = -2 * s * torch.sin(s * x) * torch.sin(s * y)
    assert float((w - we).abs().max()) < 0.1
    psi = derived.stream_function(U, grid, per, params=MultilevelParams(
        tolerance=1e-8, nitermax=60, dense_coarse_max=1024))
    d = psi - psi_exact
    assert float((d - d.mean()).abs().max()) < 2e-3
    assert float(derived.velocity_norm(U).max()) <= 1.0 + 1e-12


def test_wavelets_match_jax():
    f = np.random.default_rng(1).standard_normal((64, 32))
    ja, jd = jwav.haar2d(jnp.asarray(f), 3)
    ta, td = wavelets.haar2d(torch.as_tensor(f), 3)
    close(ja, ta)
    for jt, tt in zip(jd, td):
        for a, b in zip(jt, tt):
            close(a, b)
    close(jwav.ihaar2d(ja, jd), wavelets.ihaar2d(ta, td))
    close(jwav.wavelet_energy(jnp.asarray(f), 3),
          wavelets.wavelet_energy(torch.as_tensor(f), 3))
    close(jwav.degrade(jnp.asarray(f), 2),
          wavelets.degrade(torch.as_tensor(f), 2))
    close(jwav.wavelet_error(jnp.asarray(f), 2),
          wavelets.wavelet_error(torch.as_tensor(f), 2))


def test_haar_roundtrip_and_energy():
    """tests/test_derived.py's gate on the port: the inverse, Parseval, and
    the degraded error of a smooth field growing with the levels."""
    f = torch.randn((64, 64), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    a, det = wavelets.haar2d(f, 3)
    assert float((wavelets.ihaar2d(a, det) - f).abs().max()) < 1e-12
    e = float((a * a).sum()) + sum(float((d * d).sum())
                                   for trio in det for d in trio)
    assert abs(e - float((f * f).sum())) < 1e-8
    smooth = torch.sin(2 * math.pi * torch.as_tensor(Grid(6).centers[0]))
    e1 = float(wavelets.wavelet_error(smooth, 1).max())
    e2 = float(wavelets.wavelet_error(smooth, 2).max())
    assert e1 < e2 < 0.25


def drops_field():
    """A 32^2 fraction: a large body, small discs, a disc cut by the
    periodic x and y edges, and a two-cell droplet."""
    x, y = (np.asarray(c) for c in Grid(5).centers)
    f = np.zeros((32, 32))
    f[(x + 0.1) ** 2 + (y + 0.1) ** 2 < 0.09] = 1.0
    f[(np.abs(x) > 0.45) & (np.abs(y) > 0.45)] = 0.7
    f[5:7, 27] = 0.4
    f[26, 26] = 0.9
    f[20:23, 2:4] = 0.6
    return f


def test_tag_droplets_matches_jax():
    """The labels and counts, with and without the periodic merges: the
    corner droplet is one across both wraps."""
    f = drops_field()
    for periodic in ((False, False), (True, False), (True, True)):
        jl, jn = jdrop.tag_droplets(f, periodic=periodic)
        tl, tn = droplets.tag_droplets(torch.as_tensor(f), periodic=periodic)
        assert jn == tn and np.array_equal(jl, tl)
    assert droplets.tag_droplets(f, periodic=(True, True))[1] == \
        droplets.tag_droplets(f)[1] - 3


def test_droplet_conversions_match_jax():
    """The statistics, the droplets below 5 cells as particles (the
    largest kept), the removal and the stamp of a particle back, against
    the JAX package; the volume kept by the conversion to particles and
    by every stamp back (the two-cell droplet's disc holds no cell
    vertex: the JAX package's stamp of it is empty, ROADMAP Queue 3)."""
    f = drops_field()
    rng = np.random.default_rng(2)
    U = [rng.standard_normal((32, 32)) for _ in range(2)]
    jg, tg = JGrid(5), Grid(5)
    tf = torch.as_tensor(f)
    lab, n = droplets.tag_droplets(tf)
    jst = jdrop.droplet_stats(f, lab, n, jg, U)
    tst = droplets.droplet_stats(tf, lab, n, tg,
                                 [torch.as_tensor(u) for u in U])
    assert np.array_equal(jst[0], tst[0])
    for a, b in zip(jst[1:], tst[1:]):
        close(a, b)
    jf, jparts = jdrop.droplets_to_particles(f, U, jg, 5, rho_p=2.0)
    tf2, tparts = droplets.droplets_to_particles(
        tf, [torch.as_tensor(u) for u in U], tg, 5, rho_p=2.0)
    close(jf, tf2, 0.0)
    assert len(jparts) == tparts["vol"].shape[0] > 0
    for k in ("pos", "vel", "vol", "mass"):
        close(np.stack([np.asarray(p[k]) for p in jparts]), tparts[k])
    close(jdrop.remove_droplets(f, jg, 5),
          droplets.remove_droplets(tf, tg, 5), 0.0)
    vol = float(tf.sum()) * tg.cell_volume
    assert abs(float(tf2.sum()) * tg.cell_volume
               + float(tparts["vol"].sum()) - vol) < 1e-14
    back, jback = tf2, jnp.asarray(np.asarray(tf2))
    lost = 0.0
    for k in range(tparts["vol"].shape[0]):
        pos, v = tparts["pos"][k], tparts["vol"][k]
        jnew = jdrop.particle_to_droplet(jback, np.asarray(pos), float(v), jg)
        jadded = float(jnp.sum(jnew - jback)) * jg.cell_volume
        before = float(back.sum()) * tg.cell_volume
        new = droplets.particle_to_droplet(back, pos, v, tg)
        added = float(new.sum()) * tg.cell_volume - before
        assert abs(added - float(v)) < 1e-12 * vol
        if abs(jadded - float(v)) < 1e-12 * vol:
            # where gerris_tpu keeps the volume the stamps are the same
            close(jnew - jback, new - back)
        else:
            lost += float(v) - jadded
        back, jback = new, jnew
    # the two-cell droplet's disc holds no cell vertex: gerris_tpu stamps
    # nothing for it (ROADMAP Queue 3)
    assert lost > 0.0
    assert abs(float(back.sum()) * tg.cell_volume - vol) < 1e-12 * vol
    fed = tp.feed_particles(tp.make_particles(8, 2, device=CPU),
                            tparts["pos"], vel=tparts["vel"],
                            vol=tparts["vol"], mass=tparts["mass"])
    assert int(fed["alive"].sum()) == tparts["vol"].shape[0]


@pytest.mark.parametrize("radius,lo,hi", [(1.0, 0.14, 0.16),
                                          (1.5, 0.06, 0.07),
                                          (2.0, 0.05, 0.055),
                                          (3.0, 0.025, 0.03)])
def test_particle_to_droplet_keeps_the_volume(radius, lo, hi):
    """A particle of a disc's volume (radius in cells) stamped into an
    empty 32^2 fraction: the JAX package rescales every cell of its stamp
    by vol / (the stamp's volume), pushing the full cells above 1, and its
    clamp drops the excess (15%, 6.7%, 5.2% and 2.8% of the volume at
    these radii for this centre); the
    port's stamp holds the volume exactly, within [0, 1]."""
    grid = Grid(5)
    vol = math.pi * (radius * grid.h) ** 2
    pos = np.array([0.013, -0.021])
    f = torch.zeros(grid.shape, dtype=torch.float64)
    got = droplets.particle_to_droplet(f, pos, vol, grid)
    assert abs(float(got.sum()) * grid.cell_volume - vol) < 1e-14
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    ref = jdrop.particle_to_droplet(jnp.zeros((32, 32)), pos, vol, JGrid(5))
    loss = 1.0 - float(jnp.sum(ref)) * grid.cell_volume / vol
    assert lo < loss < hi
