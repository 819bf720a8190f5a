"""The port's .gfs reader (gerris_tpu_torch/utils/gfs_config.py) against
the JAX package's reader on every .gfs text of the JAX tests that reach
the reader: the tokens, the translated expressions and every ParsedSim
field.  A closure is held to the JAX closure's values at the same points
within 1e-14, on numpy arrays and on float64 torch tensors (and the
expressions on Python floats to math's).  Parsing through the JAX reader
runs no step.  Also the reader gates of tests/test_gfs_config.py on the
port, and the reader's faults that the port repairs."""
import dataclasses
import math
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.utils import gfs_config as J  # noqa: E402

from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import vof  # noqa: E402
from gerris_tpu_torch.utils import gfs_config as G  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import test_gfs_modules as jmod  # noqa: E402
import test_misc2 as jmisc  # noqa: E402
import test_roundtrip as jrt  # noqa: E402

LES = """
1 0 GfsSimulation GfsBox GfsGEdge {{}} {{
    Refine {level}
    VariableTurbulentViscosity NUT 0.17 {extra}
    SourceViscosity (0.001 + NUT)
    Init {{}} {{
        U = sin(2.*M_PI*y)
        V = sin(2.*M_PI*x)
    }}
    Time {{ iend = 2 }}
}}
GfsBox {{}}
"""

# the texts of tests/test_outputs2.py, test_spurious.py, test_boxgraph.py,
# test_balance.py and test_gfs_config.py (written there inside the tests)
OUTPUTS2 = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 0 }
  VariableTracer T
  Init {} { T = cos(2.*M_PI*y) }
  OutputCorrelation { istep = 1 } corr.dat { v = T } { s = cos(2.*M_PI*y) }
  OutputSquares { istep = 1 } sq-%ld.oogl { v = T min = -1 max = 1 }
  OutputLocation { istep = 1 } loc.dat 0.25 0.25
}
GfsBox {}
"""
SPURIOUS = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { end = 0 }
  Refine 6
  VariableTracerVOFHeight T
  VariableCurvature K T Kmax
  SourceTension T 1 K
  InitFraction T (0.0625 - x*x - y*y)
}
GfsBox {}
"""
BOXGRAPH = """
3 3 GfsSimulation GfsBox GfsGEdge {} {
  Refine 3
  Time { iend = 0 }
}
GfsBox {}
GfsBox {}
GfsBox {}
1 2 right top
2 3 right
3 3 top
"""
BALANCE = """
1 0 GfsSimulation GfsBox GfsGEdge {} {
  Refine 4
  Time { iend = 1 }
  EventBalance { istep = 10 } 1.2
}
GfsBox {}
"""
BUILD3D = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 2 dtmax = 0.02 }
  Refine 4
  VariableTracer T
  Init {} {
    U = 0.25
    T = exp(-50.*(x*x + y*y + z*z))
  }
}
GfsBox { front = Boundary { BcDirichlet T 0 } }
"""
GLOBAL = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { end = 1 }
  Refine 4
  Global {
      #define A0 0.5
      #define SQ(a) ((a)*(a))
      double channel (double x) {
          double y1 = 0.2/4.;
          double y2 = 1e-6/4.;
          return x <= -0.25 ? y1 : x < 0.25 ?
              y2 + 0.5*(y1 - y2)*(1. + cos (2.*M_PI*(x + 0.25))) : y2;
      }
      static double B = A0*2.;
  }
  Init {} { U = A0*channel(x) + SQ(y) + B }
}
GfsBox {}
"""
STRICT_BAD = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { end = 1 }
  FrobnicateQuux { istep = 1 } 3.0
}
GfsBox {}
"""
# the texts the port's build and run tests use (tests/test_torch_gfs_*)
LID = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 5 dtmax = DTMAX }
  Refine LEVEL
  SourceViscosity 1e-3
  OutputScalarNorm { istep = 1 } stdout { v = U }
}
GfsBox { top = Boundary { BcDirichlet U 1 } }
"""
VOF = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 3 }
  Refine 5
  VariableTracerVOFHeight T
  VariableCurvature K T Kmax
  SourceTension T 0.01 K
  PhysicalParams { alpha = 1./(T*1. + (1. - T)*0.1) }
  SourceViscosity 1e-2
  InitFraction T (difference(ellipse(0,0,0.2,0.15), ellipse(0.3,0.3,0.05,0.05)))
  OutputScalarSum { istep = 1 } stdout { v = T }
}
GfsBox { left = Boundary { BcAngle T 60 } }
"""
ADVECTION = """1 0 GfsAdvection GfsBox GfsGEdge {} {
  Time { end = 0.5 }
  Refine 5
  VariableTracerVOF T
  VariableTracer C { gradient = gfs_center_minmod_gradient }
  InitFraction T (0.0225 - (x - 0.1)*(x - 0.1) - y*y)
  Init {} { C = exp(-100.*(x*x + y*y)) }
  VariableStreamFunction { step = 0.25 } Psi (t < 0.25 ? 1. : -1.)*sin(M_PI*(x + 0.5))*sin(M_PI*(y + 0.5))/M_PI
}
GfsBox {}
"""
POISSON = """1 0 GfsPoisson GfsBox GfsGEdge {} {
  Time { iend = 1 }
  Refine LEVEL
  ApproxProjectionParams { tolerance = 1e-30 nitermin = 10 nitermax = 10 }
  Init {} {
    Div = { int k = 3, l = 3; return -M_PI*M_PI*(k*k + l*l)*sin (M_PI*k*x)*sin (M_PI*l*y); }
  }
}
GfsBox {}
"""
AMR = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 2 }
  Refine 5
  VariableTracerVOF T
  InitFraction T (0.04 - x*x - y*y)
  SourceViscosity 1e-2
  Init {} { U = 0.1 }
  AdaptFunction { istep = 1 } { cmax = 0.5 maxlevel = 5 minlevel = 4 } (T > 0 && T < 1 ? 1 : fabs(Vorticity)*dL)
  OutputScalarNorm { istep = 1 } stdout { v = T }
}
GfsBox {}
1 1 right
"""
EXPRESSIONS = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 0 }
  Refine 4
  VariableTracer A
  Init {} {
    U = (x > 0 && y < 0.1) || !(x*y > 0.01) ? MIN(x, 0.2) : MAX(y, -0.1)
    V = atan2(y, x + 1.) + pow(fabs(x), 1.5) + CLAMP(y, -0.2, 0.2)
    A = !(x > 0.) ? floor(4.*x) + ceil(3.*y) : sqrt(x*x + y*y)*tanh(x)
    P = dx(x*x) + dy(3.*y) + cosh(x) - sinh(y) + exp(-x*x) + log(2. + y)
  }
  Solid (union(ellipse(-0.2,0,0.1,0.1), cube(0.2,0.1,0.,0.2)))
  SurfaceBc U Dirichlet (0.5*ay)
  Source A sin(t)*x
}
GfsBox { left = Boundary { BcDirichlet V (t < 1. ? t : 1.) BcNeumann A 0.5 } }
"""
TEXTS = {
    "particulate": jmod.PARTICULATE_GFS % "parts.txt",
    "fft": jmod.FFT_GFS % ("espec.txt", "uspec.txt"),
    "roundtrip": jrt.SRC.replace("IEND", "3").replace("DUMP", "end.gfs"),
    "outputs2": OUTPUTS2,
    "les": LES.format(level=5, extra=""),
    "les_sigma": LES.format(level=5, extra="sigma"),
    "misc2_cli": jmisc.GFS_MINI,
    "spurious": SPURIOUS,
    "boxgraph": BOXGRAPH,
    "balance": BALANCE,
    "build3d": BUILD3D,
    "global": GLOBAL,
    "strict_bad": STRICT_BAD,
    "lid": LID.replace("LEVEL", "5").replace("DTMAX", "0.02"),
    "vof": VOF,
    "advection": ADVECTION,
    "poisson": POISSON.replace("LEVEL", "6"),
    "amr": AMR,
    "expressions": EXPRESSIONS,
}

# the JAX closures evaluate without builtins: import what jnp imports
# lazily by calling each function once here
for _f in J._FUNS.values():
    if callable(_f):
        try:
            _f(*([0.5] * _f.__code__.co_argcount)) \
                if hasattr(_f, "__code__") else _f(0.5)
        except TypeError:
            _f(0.5, 0.5)
J.jnp.where(True, 1.0, 0.0)
J._mesh_gradient(J.jnp.ones((3, 3)), J.jnp.ones((3, 3)), 0)

RNG = np.random.default_rng(7)
PX = RNG.uniform(-0.5, 0.5, (6, 5))
PY = RNG.uniform(-0.5, 0.5, (6, 5))
PZ = RNG.uniform(-0.5, 0.5, (6, 5))


def _free_names(fn):
    src = getattr(fn, "source", "")
    return set(J.re.findall(r"\b([A-Za-z_]\w*)\b", src)) - set(J._FUNS) \
        - {"x", "y", "z", "t", "where", "return", "dx", "dy", "dz"}


def _agree(a, b, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b.cpu().numpy() if isinstance(b, torch.Tensor) else b,
                   dtype=np.float64)
    a, b = np.broadcast_arrays(a, b)
    ok = np.isclose(a, b, rtol=1e-14, atol=1e-14) | (np.isnan(a)
                                                     & np.isnan(b))
    assert ok.all(), (what, np.abs(a - b).max())


def _same_callable(fj, fp, what):
    """A JAX closure and the port's at the same points: numpy arrays,
    float64 tensors, and for a translated expression Python floats."""
    extra = {v: PX * 0.5 + 0.2 for v in _free_names(fj)}
    if "dL" in extra:
        extra["dL"] = 0.01
    ref = np.asarray(fj(PX, PY, PZ, 0.3, **extra))
    _agree(ref, fp(PX, PY, PZ, 0.3, **extra), what + " (numpy)")
    tx = [torch.as_tensor(a) for a in (PX, PY, PZ)]
    tex = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in extra.items()}
    _agree(ref, fp(*tx, 0.3, **tex), what + " (torch)")
    if hasattr(fp, "source") and "dx" not in fp.source \
            and "dy" not in fp.source:
        sx = {k: float(np.ravel(v)[3]) if isinstance(v, np.ndarray) else v
              for k, v in extra.items()}
        got = fp(float(PX.flat[3]), float(PY.flat[3]), float(PZ.flat[3]),
                 0.3, **sx)
        _agree(ref.flat[3] if ref.ndim else ref, got, what + " (math)")


def _same(a, b, what):
    if callable(a) and not isinstance(a, type):
        assert callable(b), what
        _same_callable(a, b, what)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (what, a, b)
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (what, a, b)
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{k}]")
    else:
        assert a == b, (what, a, b)


def _parse_both(text, **kw):
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        return J.parse_gfs(text, **kw), G.parse_gfs(text, **kw)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_tokens_and_parsed_fields_match_the_jax_reader(name):
    text = TEXTS[name]
    assert G.tokenize(text) == J.tokenize(text)
    if name == "strict_bad":
        for mod in (J, G):
            with pytest.raises(ValueError, match="FrobnicateQuux"):
                mod.parse_gfs(text, {}, strict=True)
    pj, pt = _parse_both(text)
    assert [f.name for f in dataclasses.fields(pj)] == \
        [f.name for f in dataclasses.fields(pt)]
    for f in dataclasses.fields(pj):
        _same(getattr(pj, f.name), getattr(pt, f.name), f.name)


EXPRS = [
    "(y - 0.01*cos (2.*M_PI*x))",
    "{ int k = 3, l = 3; return -M_PI*M_PI*(k*k + l*l)*sin (M_PI*k*x)"
    "*sin (M_PI*l*y); }",
    "({ double r2 = x*x + y*y; x += 0.1; return r2 < 0.04 ? 1. : 0.; })",
    "x > 0 ? (y > 0 ? 1 : 2) : 3",
    "(x > 0.1 && y < 0.2) || !(x < -0.3)",
    "!(x > 0) ? exp(x) : -exp(-x)",
    "fabs(t - 0.5) < 0.2 ? MIN(x, y) : MAX(x, t)",
    "atan2(y, 0.5) + pow(2., x) + CLAMP(x, -0.1, 0.1) + floor(3.*y)",
]


@pytest.mark.parametrize("k", range(len(EXPRS)))
def test_translate_expr_matches_the_jax_closures(k):
    fj = J.translate_expr(EXPRS[k])
    fp = G.translate_expr(EXPRS[k])
    assert fp.source == fj.source
    _same_callable(fj, fp, EXPRS[k])
    _agree(fj.np(PX, PY, PZ, 0.3), fp.np(PX, PY, PZ, 0.3), "np")


def test_where_branches_take_the_field_dtype_and_device():
    """Python-scalar branches of a ternary take the coordinates' dtype
    (float32 stays float32, not torch's default), and a closure on
    tensors makes no tensor from host data."""
    fn = G.translate_expr("x > 0 ? 1. : 0.")
    for dt in (torch.float32, torch.float64):
        x = torch.linspace(-1, 1, 9, dtype=dt)
        out = fn(x, x)
        assert out.dtype == dt and out.device == x.device
    assert fn(0.5, 0.0) == 1.0 and fn(-0.5, 0.0) == 0.0
    g = G.translate_expr("!(x > 0)")
    assert g(0.5, 0.0) is False and g(-0.5, 0.0) is True


def test_not_is_c_logical_not_on_python_floats():
    """The reference's '!' becomes '~', which complements a Python bool
    into -2 (true): on a scalar, J's !(x > 0) is wrong.  The port's
    _not is C's logical not on bools, numbers and tensors."""
    fj = J.translate_expr("!(x > 0) ? 1. : 2.")
    fp = G.translate_expr("!(x > 0) ? 1. : 2.")
    assert fp(0.5, 0.0) == 2.0
    assert float(fj(np.float64(0.5), 0.0)) == 2.0    # numpy scalars agree
    assert fp(torch.tensor(0.5), 0.0).item() == 2.0


# --- the gates of tests/test_gfs_config.py on the port -------------------

def test_expression_translation():
    fn = G.translate_expr("(y - 0.01*cos (2.*M_PI*x))")
    assert abs(float(fn(0.0, 0.01)) - 0.0) < 1e-12
    fn2 = G.translate_expr(
        "{ int k = 3, l = 3; return -M_PI*M_PI*(k*k + l*l)*sin (M_PI*k*x)"
        "*sin (M_PI*l*y); }")
    assert abs(float(fn2(0.5 / 3, 0.5 / 3)) - (-math.pi ** 2 * 18)) < 1e-9


def test_translate_dx_dy():
    fn = G.translate_expr("dx(x*x) + dy(3.*y)")
    grid = Grid(level=5, dim=2)
    for x, y in (np.broadcast_arrays(*grid.centers),
                 [torch.as_tensor(c) for c in
                  np.broadcast_arrays(*grid.centers)]):
        out = fn(x, y)
        err = np.abs(np.asarray(out) - (2 * np.asarray(x) + 3.0))
        assert float(err[1:-1, 1:-1].max()) < 1e-10


def test_gfs_global_block():
    sim = G.parse_gfs(GLOBAL, {}, strict=True)
    fn = sim.inits["U"]
    x = np.array([0.0, -0.3, 0.3])
    y = np.array([1.0, 2.0, 0.0])
    y1, y2 = 0.2 / 4.0, 1e-6 / 4.0
    ch = np.array([y2 + 0.5 * (y1 - y2) * (1 + np.cos(2 * np.pi * 0.25)),
                   y1, y2])
    want = 0.5 * ch + y ** 2 + 1.0
    assert np.allclose(fn.np(x, y), want)
    assert np.allclose(fn(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                       want)


def test_strict_mode_raises_on_unknown_directive():
    with pytest.raises(ValueError, match="FrobnicateQuux"):
        G.parse_gfs(STRICT_BAD, {}, strict=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim = G.parse_gfs(STRICT_BAD, {})
    assert sim.unknown_directives == ["FrobnicateQuux"]
    assert any("FrobnicateQuux" in str(x.message) for x in w)


# --- the CSG convention (tests/test_misc2.py::test_csg_shapes) -----------

def test_csg_namespace_matches_the_jax_function():
    """The port's shapes and combinators give the JAX reader's values
    (gfs_config.py:460-489, the convention of fcaf463: positive outside
    a shape, fluid where the expression is positive)."""
    nj, npt = J._csg_namespace(), G._csg_namespace()
    assert set(nj) == set(npt)
    shapes = {"ellipse": (0.1, -0.05, 0.2, 0.3),
              "sphere": (0.1, -0.05, 0.02, 0.25),
              "cube": (0.05, 0.1, 0.0, 0.4)}
    for k, args in shapes.items():
        _same_callable(nj[k](*args), npt[k](*args), k)
    for comb in ("union", "intersection", "difference"):
        a = (nj["ellipse"](0, 0, 0.3, 0.2), npt["ellipse"](0, 0, 0.3, 0.2))
        b = (nj["sphere"](0.1, 0, 0, 0.15), npt["sphere"](0.1, 0, 0, 0.15))
        _same_callable(nj[comb](a[0], b[0]), npt[comb](a[1], b[1]), comb)


def test_csg_shapes():
    """tests/test_misc2.py::test_csg_shapes asserts the convention that
    fcaf463 replaced (the shape's inside as the fluid) and fails on the
    JAX package; in the reference's convention the fluid of
    difference(ellipse(0.3), ellipse(0.15)) is everything but the
    annulus, and of a union everything but the two discs."""
    grid = Grid(level=6, dim=2)
    phi = G._maybe_shape(
        "(difference(ellipse(0,0,0.3,0.3), ellipse(0,0,0.15,0.15)))", {})
    assert phi is not None
    f = vof.fraction_from_levelset(grid, phi, device="cpu")
    solid = float(torch.sum(1.0 - f)) * grid.h ** 2
    exact = math.pi * (0.3 ** 2 - 0.15 ** 2)
    assert abs(solid - exact) / exact < 0.01, solid
    phi_u = G._maybe_shape("(union(ellipse(-0.2,0,0.1,0.1), "
                           "ellipse(0.2,0,0.1,0.1)))", {})
    fu = vof.fraction_from_levelset(grid, phi_u, device="cpu")
    assert abs(float(torch.sum(1.0 - fu)) * grid.h ** 2
               - 2 * math.pi * 0.1 ** 2) < 0.002
    # and the JAX package's _maybe_shape gives the same fractions
    fj = np.asarray(vof.fraction_from_levelset(
        grid, lambda x, y: torch.as_tensor(np.array(J._maybe_shape(
            "(difference(ellipse(0,0,0.3,0.3), ellipse(0,0,0.15,0.15)))",
            {})(x.numpy(), y.numpy()))), device="cpu"))
    assert np.array_equal(fj, f.numpy())


def test_a_closure_is_the_first_torch_comparison_of_a_process():
    """torch's C code imports on a tensor's first comparison with a float,
    through the builtins of the frame that compares: a closure evaluated
    as a process's first such comparison must run (the tests before it
    in one process would otherwise hide the fault)."""
    import subprocess
    code = ("import torch\n"
            "from gerris_tpu_torch.utils import gfs_config as G\n"
            "f = G.translate_expr('x <= -0.25 ? 1. : 2.', {})\n"
            "x = torch.tensor([-0.5, 0.0], dtype=torch.float64)\n"
            "print(f(x, x).tolist())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[1.0, 2.0]"
