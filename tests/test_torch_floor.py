"""chip_smoke.py's float32 floor bound (check_floor): the plain float32
run's distance from the plain float64 run, bounded per route and field,
on the CPU.  The numbers of the first card run of the 3D droplet with
the reference's closed-form plane volume (U, V, W 1.23 / 1.26 / 1.26, T
1.5e-4, P 6.0e-3 after 2 steps), which no gate caught then, fail it;
those after the piecewise volume (2.1e-3 / 2.5e-3 / 2.1e-3, 1.5e-6,
7.6e-6) pass.  check_against_plain applies it: a route run on the CPU
at a small level fails once its bound is below its floor."""
import math

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

CLOSED_FORM = dict(U=1.23, V=1.26, W=1.26, T=1.5e-4, P=6.0e-3)
PIECEWISE = dict(U=2.1e-3, V=2.5e-3, W=2.1e-3, T=1.5e-6, P=7.6e-6)


def test_every_route_has_finite_bounds():
    """Every route's bounds cover U, V and P, and T on every route that
    carries a VOF tracer (all but the single-phase ones: the cylinder's,
    the moving solids', the rigid body's and the metrics'), each finite
    and positive."""
    for name, bounds in chip_smoke.FLOOR_BOUNDS.items():
        want = set("UVP") | (set() if name in chip_smoke.SINGLE_PHASE_ROUTES
                             else {"T"})
        assert want <= set(bounds), name
        assert all(math.isfinite(v) and v > 0 for v in bounds.values()), name


def test_floor_bound_fails_the_closed_form_droplet():
    with pytest.raises(AssertionError, match="droplet3d U"):
        chip_smoke.check_floor("droplet3d", CLOSED_FORM)
    chip_smoke.check_floor("droplet3d", PIECEWISE)
    for k in CLOSED_FORM:
        with pytest.raises(AssertionError):
            chip_smoke.check_floor("droplet3d", {**PIECEWISE,
                                                 k: CLOSED_FORM[k]})


def test_check_against_plain_applies_the_floor_bound(monkeypatch):
    """The capillary wave at level 3 on the CPU (its 'kernels' the plain
    versions there): within its bounds it passes; with U's bound below
    its measured floor check_against_plain raises."""
    dev = torch.device("cpu")

    def make(dtype):
        return chip_smoke.capwave_sim(dev, 3, dtype)

    early = make(torch.float32).run(max_steps=2).state
    runs = chip_smoke.check_against_plain("capwave", make, 2, early, 1e-9)
    floor = chip_smoke.rel_err(runs["plain32"]["U"].double(),
                               runs["plain64"]["U"])
    assert 0.0 < floor <= chip_smoke.FLOOR_BOUNDS["capwave"]["U"]
    monkeypatch.setitem(chip_smoke.FLOOR_BOUNDS, "capwave",
                        {**chip_smoke.FLOOR_BOUNDS["capwave"],
                         "U": floor / 2})
    with pytest.raises(AssertionError, match="capwave U"):
        chip_smoke.check_against_plain("capwave", make, 2, early, 1e-9)
