"""The port's 2D PLIC line geometry (gerris_tpu_torch physics/vof.py:
line_area_positive and line_alpha_positive) against exact rationals
where one component of the normal is small, and against ``gerris_tpu``
where both are not.

The port computes the area in the piecewise form on ordered components
lo <= hi: a^2 / (2 lo hi) up to lo, (a - lo/2) / hi up to hi, 1 - (1 -
a)^2 / (2 lo hi) above.  The reference's closed form (gerris_tpu
vof.py:41-53) divides a difference of squares by 2 lo hi and loses ~eps
/ lo there: 3.9e-2 of area at lo = 1e-6 in float32.  The port's alpha
is the reference's closed form, which measures no loss (its area given
back within a few float32 ulps).  Tolerances: the exact area within 2e-7
in float32 (a few ulps) and 4e-16 in float64; the JAX package within
1e-12 of max in float64 where min(m1, m2) >= 0.02."""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.physics import vof as jvof  # noqa: E402

from gerris_tpu_torch.physics import vof as tvof  # noqa: E402

SMALL = (1e-3, 1e-4, 1e-5, 1e-6)
TOL = {torch.float32: 2e-7, torch.float64: 4e-16}


def _exact_area(m1, m2, a):
    """The fraction of the unit square below m1 x + m2 y = a, exactly, for
    the float inputs as given (their sum need not be 1)."""
    m1, m2, a = Fraction(float(m1)), Fraction(float(m2)), Fraction(float(a))
    a = min(max(a, Fraction(0)), Fraction(1))
    if m1 == 0 or m2 == 0:
        return float(min(max(a / (m1 + m2), Fraction(0)), Fraction(1)))

    def sq(x):
        return max(x, Fraction(0)) ** 2

    v = (a * a - sq(a - m1) - sq(a - m2) + sq(a - m1 - m2)) / (2 * m1 * m2)
    return float(min(max(v, Fraction(0)), Fraction(1)))


def _alphas(m1):
    """Alpha over [0, 1], densely in the triangles at both ends."""
    return np.concatenate([np.linspace(0.0, 1.0, 401),
                           np.linspace(0.0, 3 * m1, 60),
                           1.0 - np.linspace(0.0, 3 * m1, 60)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m1", SMALL)
def test_line_area_small_component_exact(m1, dtype):
    """The area within a few ulps of the exact one for m1 from 1e-3 down
    to 1e-6 (m2 = 1 - m1, either order), alpha over [0, 1]."""
    a = torch.from_numpy(_alphas(m1)).to(dtype)
    lo = torch.full_like(a, m1)
    hi = 1.0 - lo
    for p, q in ((lo, hi), (hi, lo)):
        got = tvof.line_area_positive(p, q, a)
        want = np.array([_exact_area(x, y, z) for x, y, z in
                         zip(p.tolist(), q.tolist(), a.tolist())])
        assert float(np.max(np.abs(got.double().numpy() - want))) <= \
            TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_line_alpha_small_component_exact(dtype):
    """The inverse gives back its fraction: the exact area of the alpha
    that line_alpha_positive returns within a few ulps of c, for m1 from
    1e-3 down to 1e-6 and c over [0, 1] (both ends densely)."""
    c = torch.from_numpy(np.concatenate([
        np.linspace(0.0, 1.0, 201), np.linspace(0.0, 1e-3, 40),
        1.0 - np.linspace(0.0, 1e-3, 40)])).to(dtype)
    for m1 in SMALL:
        lo = torch.full_like(c, m1)
        hi = 1.0 - lo
        a = tvof.line_alpha_positive(lo, hi, c)
        back = np.array([_exact_area(x, y, z) for x, y, z in
                         zip(lo.tolist(), hi.tolist(), a.tolist())])
        assert float(np.max(np.abs(back - c.double().numpy()))) <= \
            TOL[dtype] * 2


def test_line_geometry_matches_jax_where_components_are_not_small():
    """min(m1, m2) >= 0.02 in float64: the area, the alpha and the
    rectangle fractions within 1e-12 of max of the JAX package's."""
    rng = np.random.default_rng(3)
    m1 = rng.uniform(0.02, 0.98, 4000)
    m2 = 1.0 - m1
    a = rng.uniform(-0.1, 1.1, 4000)
    c = rng.uniform(-0.1, 1.1, 4000)
    t = [torch.from_numpy(x) for x in (m1, m2, a, c)]
    for ref, got in (
            (jvof.line_area_positive(m1, m2, a),
             tvof.line_area_positive(t[0], t[1], t[2])),
            (jvof.line_alpha_positive(m1, m2, c),
             tvof.line_alpha_positive(t[0], t[1], t[3]))):
        ref = np.asarray(ref)
        assert np.max(np.abs(ref - got.numpy())) <= 1e-12 * np.max(
            np.abs(ref))


def test_reference_closed_form_loses_digits():
    """The reference's closed form in float32, pinned: at m1 = 1e-5 its
    area is off the exact one by more than 1e-3 somewhere on alpha in
    [0, 1], at m1 = 1e-6 by more than 1e-2; the port's stays within
    2e-7 on the same inputs."""
    for m1, worse in ((1e-5, 1e-3), (1e-6, 1e-2)):
        a = _alphas(m1).astype(np.float32)
        lo = np.full_like(a, np.float32(m1))
        hi = np.float32(1.0) - lo
        want = np.array([_exact_area(x, y, z) for x, y, z in zip(lo, hi, a)])
        ref = np.asarray(jvof.line_area_positive(lo, hi, a), np.float64)
        assert np.max(np.abs(ref - want)) > worse
        got = tvof.line_area_positive(*(torch.from_numpy(x)
                                        for x in (lo, hi, a)))
        assert np.max(np.abs(got.double().numpy() - want)) <= 2e-7


def test_rectangle_fraction_takes_the_piecewise_area():
    """rectangle_fraction of the whole cell is line_area_positive, and its
    halves sum to it, with a small component in float32."""
    rng = np.random.default_rng(4)
    m1 = torch.from_numpy(rng.uniform(1e-6, 1e-4, 300)).float()
    m2 = 1.0 - m1
    a = torch.from_numpy(rng.uniform(0.0, 1.0, 300)).float()
    zero, half, one = (torch.full_like(a, v) for v in (0.0, 0.5, 1.0))
    whole = tvof.line_area_positive(m1, m2, a)
    again = tvof.rectangle_fraction(m1, m2, a, zero, one, zero, one)
    left = tvof.rectangle_fraction(m1, m2, a, zero, half, zero, one)
    right = tvof.rectangle_fraction(m1, m2, a, half, one, zero, one)
    assert float(torch.max(torch.abs(again - whole))) <= 2e-7
    assert float(torch.max(torch.abs(0.5 * (left + right) - whole))) <= 1e-6
