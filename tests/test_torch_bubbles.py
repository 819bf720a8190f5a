"""Bubbles (gerris_tpu_torch/physics/bubbles.py) against the JAX package on
the CPU in float64, and the bubble gates of tests/test_particles.py on
the port.

The gas pressure and the radius right-hand side of each model, the
interaction system's accelerations, the RK4 integrations (alone and
coupled, a dead bubble among them), the bubble state, one bubble step
(with and without interactions) and the void fraction's rate, within
1e-12 of max; then the Minnaert period and the in-phase pair's frequency
shift on the port."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import bubbles as jb  # noqa: E402
from gerris_tpu.physics import particles as jp  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import bubbles as tb  # noqa: E402
from gerris_tpu_torch.physics import particles as tp  # noqa: E402

CPU = torch.device("cpu")
MODELS = ("rp", "keller_miksis", "const")


def close(a, b, rtol=1e-12):
    a = np.asarray(a, dtype=np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
    assert err <= rtol, err


def radii(n=24, seed=0, clamped=True):
    """Seeded radii around R0 (with ``clamped`` the first below the clamp
    1e-3 R0), wall speeds, p0 and the liquid pressure; J (jnp) and T
    (torch) of each."""
    rng = np.random.default_rng(seed)
    R0 = rng.uniform(0.008, 0.012, n)
    R = R0 * rng.uniform(0.9, 1.1, n)
    if clamped:
        R[0] = 1e-4 * R0[0]
    Rd = rng.uniform(-0.5, 0.5, n)
    p0 = rng.uniform(0.8, 1.2, n)
    pl = rng.uniform(0.9, 1.1, n)
    vals = (R, Rd, p0, R0, pl)
    return [jnp.asarray(v) for v in vals], [torch.as_tensor(v)
                                            for v in vals]


def cfg_pair(**kw):
    return jb.BubbleConfig(**kw), tb.BubbleConfig(**kw)


def test_gas_pressure_matches_jax():
    (R, _, p0, R0, _), (tR, _, tp0, tR0, _) = radii()
    close(jb.gas_pressure(p0, R0, R, 1.4), tb.gas_pressure(tp0, tR0, tR, 1.4))


@pytest.mark.parametrize("model", MODELS)
def test_radius_rhs_matches_jax(model):
    """Each model's d(Rdot)/dt with tension and viscosity on."""
    J, T = radii()
    jc, tc = cfg_pair(model=model, sigma=0.01, visc=1e-3, cl=50.0)
    close(jb.radius_rhs(*J, 1.3, jc), tb.radius_rhs(*T, 1.3, tc))


def cloud(n=8, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.3, 0.3, (n, 2))
    alive = np.ones(n, bool)
    alive[3] = False
    return pos, alive


def test_coupled_radius_rhs_matches_jax():
    """The interaction system's accelerations: a cloud of 8, one dead,
    two of them closer than the sum of their radii (the floor)."""
    J, T = radii(8)
    pos, alive = cloud()
    pos[5] = pos[6] + 0.005
    jc, tc = cfg_pair(sigma=0.01, visc=1e-3)
    close(jb.coupled_radius_rhs(*J, 1.0, jnp.asarray(pos),
                                jnp.asarray(alive), jc),
          tb.coupled_radius_rhs(*T, 1.0, torch.as_tensor(pos),
                                torch.as_tensor(alive), tc))


@pytest.mark.parametrize("coupled", [False, True])
def test_integrate_radius_matches_jax(coupled):
    """RK4 over one flow step in 16 substeps (R, Rdot), alone and with the
    interactions (a cloud of 8, one dead)."""
    J, T = radii(8, clamped=False)
    pos, alive = cloud()
    jc, tc = cfg_pair(sigma=0.01, visc=1e-3, interactions=coupled)
    if coupled:
        jr = jb.integrate_radius_coupled(*J, 1.0, jnp.asarray(pos),
                                         jnp.asarray(alive), 1e-3, jc)
        tr = tb.integrate_radius_coupled(*T, 1.0, torch.as_tensor(pos),
                                         torch.as_tensor(alive), 1e-3, tc)
    else:
        jr = jb.integrate_radius(*J, 1.0, 1e-3, jc)
        tr = tb.integrate_radius(*T, 1.0, 1e-3, tc)
    for a, b in zip(jr, tr):
        close(a, b)


def bubble_states(n=12, cap=16):
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.4, 0.4, (n, 2))
    vel = 0.1 * rng.standard_normal((n, 2))
    R = rng.uniform(0.009, 0.011, n)
    p0 = rng.uniform(0.9, 1.1, n)
    J = jb.make_bubbles(cap, 2, pos, vel=vel, R=R, p0=p0)
    T = tb.make_bubbles(cap, 2, pos, vel=vel, R=R, p0=p0, device=CPU)
    return J, T


def test_make_bubbles_matches_jax():
    J, T = bubble_states()
    assert set(J) == set(T) and T["alive"].dtype == torch.bool
    for k in J:
        close(np.asarray(J[k], dtype=float), T[k].double(), 0.0)


@pytest.mark.parametrize("interactions", [False, True])
def test_step_bubbles_matches_jax(interactions):
    """One bubble step at 32^2 with walls: the pressure at each bubble,
    the radii, the translation (drag, lift, added mass, buoyancy under
    gravity), the force; then the void fraction's rate (Gaussian)."""
    rng = np.random.default_rng(3)
    jg, tg = JGrid(5), Grid(5)
    U = [rng.standard_normal(tg.shape) for _ in range(2)]
    P = 1.0 + 0.1 * rng.standard_normal(tg.shape)
    J, T = bubble_states()
    kw = dict(capacity=16, gravity=(0.0, -1.0), rkernel=1.5 * tg.h)
    jpc, tpc = jp.ParticleConfig(**kw), tp.ParticleConfig(**kw)
    jc, tc = cfg_pair(interactions=interactions, substeps=8)
    jub = [jbc.velocity_bc(c, 2) for c in range(2)]
    tub = [tbc.velocity_bc(c, 2) for c in range(2)]
    jn, jt = jb.step_bubbles(J, [jnp.asarray(u) for u in U],
                             [jnp.asarray(u) for u in U], jnp.asarray(P),
                             jg, jub, jbc.default_scalar_bc(2), jpc, jc,
                             1e-2, 1.0, 1e-3)
    tn, tt, _ = tb.step_bubbles(T, [torch.as_tensor(u) for u in U],
                                [torch.as_tensor(u) for u in U],
                                torch.as_tensor(P), tg, tub,
                                tbc.default_scalar_bc(2), tpc, tc, 1e-2,
                                1.0, 1e-3)
    assert set(jn) == set(tn)
    for k in jn:
        close(np.asarray(jn[k], dtype=float), tn[k].double())
    close(jt, tt)
    close(jb.void_fraction_dt(jn, J, jg, jpc, 1e-3),
          tb.void_fraction_dt(tn, T, tg, tpc, 1e-3))


# -- the gates of tests/test_particles.py on the port ------------------------

def test_bubble_minnaert_frequency():
    """A small radial perturbation oscillates at the Minnaert frequency
    omega^2 = 3 gamma p0 / (rho R0^2) (linearized Rayleigh-Plesset)."""
    cfg = tb.BubbleConfig(model="rp", gamma=1.4, substeps=64)
    R0, p0 = 0.01, 1.0
    R = torch.tensor([R0 * 1.001], dtype=torch.float64)
    Rd = torch.zeros(1, dtype=torch.float64)
    one = torch.ones(1, dtype=torch.float64)
    period = 2 * math.pi / math.sqrt(3 * 1.4 * p0 / (R0 * R0))
    dt = period / 64
    rs = []
    for _ in range(130):
        R, Rd = tb.integrate_radius(R, Rd, p0 * one, R0 * one,
                                    p0 * one, 1.0, dt, cfg)
        rs.append(float(R[0]))
    s = np.array(rs) - R0
    crossings = np.where(np.diff(np.sign(s)) != 0)[0]
    assert len(crossings) >= 3
    measured = 2 * dt * np.mean(np.diff(crossings))
    assert abs(measured - period) / period < 0.05


def test_bubble_interactions_frequency_shift():
    """Two bubbles oscillating in phase have the lower frequency omega0 /
    sqrt(1 + R0/d) (GfsBubbleInteractions, bubbles.c:815-1130): the
    test's pair and its lone bubble as one system of three, the lone one
    1e6 away, 4 RK4 substeps a step where the test takes 8 (the same
    frequencies to 1e-10; chip_smoke.pair_frequencies, which the card
    runs too)."""
    w1, w2, (omega0, expected) = chip_smoke.pair_frequencies(
        CPU, substeps=chip_smoke.PAIR_SUBSTEPS)
    assert abs(w1 - omega0) / omega0 < 0.05
    assert abs(w2 - expected) / expected < 0.05
    assert w2 < 0.95 * w1
