"""Reader for a subset of the reference's .gfs simulation-file language
(port of gerris_tpu/utils/gfs_config.py).

The reference compiles each GfsFunction's C text with gcc and dlopens it
(src/utils.c:359-719, build_function_gcc :658); here an expression is
translated to Python and evaluated as a closure whose functions dispatch
on their arguments: torch tensors stay on their device and dtype, numpy
arrays take numpy, Python floats ``math`` (SURVEY.md section 7, stage 9).
A closure never makes a tensor from host data, so a card tensor meets no
CPU tensor inside it; the reads at build time (the refine probe, the
constant folds) are host reads of host values.

Supported subset: the header ``NB NE GfsSimulation|GfsPoisson|
GfsAdvection GfsBox GfsGEdge {}``, Time / Refine / PhysicalParams /
ProjectionParams / ApproxProjectionParams / SourceDiffusion /
SourceViscosity / VariableTracer[VOF[Height]] / VariableCurvature /
SourceTension[CSS] / InitFraction / Init / EventStop / Solid /
AdvectionParams / the Output* and Adapt* events / the fork's particle,
bubble and spectra classes / GfsBox boundaries (BcDirichlet, BcNeumann,
BcAngle) and box-graph edges.  ``build_simulation`` builds the port's
Simulation, AMRSimulation (Refine expressions, Adapt*),
PoissonSimulation or AdvectionSimulation on ``device`` (the CUDA card
by default) in ``dtype``.  Unknown directives raise (strict) or warn;
the directives of classes the port does not run yet are parsed, and
their builders raise NotImplementedError naming the ROADMAP slice.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def tokenize(text: str):
    # strip comments
    text = re.sub(r"#.*", "", text)
    # keep braces and parens as structure
    tokens = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch in "{}":
            tokens.append(ch)
            i += 1
            continue
        if ch == "(":
            # capture a balanced parenthesized expression as one token;
            # when an operator follows the close — e.g. the shear.gfs
            # stream function (t < 2.5 ? 1. : -1.)*sin(...)/M_PI — keep
            # consuming (word mode) so the whole product stays one token
            depth = 0
            j = i
            while j < n:
                c = text[j]
                if c == "(":
                    depth += 1
                elif c == ")":
                    depth -= 1
                    if depth == 0 and (j + 1 >= n or text[j + 1].isspace()
                                       or text[j + 1] in "{}"):
                        j += 1
                        break
                elif depth == 0 and (c.isspace() or c in "{}"):
                    break
                j += 1
            tokens.append(text[i:j])
            i = j
            continue
        j = i
        depth = 0
        while j < n:
            c = text[j]
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            elif depth == 0 and (c.isspace() or c in "{}"):
                break
            j += 1
        tokens.append(text[i:j])
        i = j
    return tokens


def _read_block(tokens, i):
    """Return (contents tokens, next index) for a '{ ... }' block at i."""
    assert tokens[i] == "{", tokens[max(0, i - 3):i + 3]
    depth = 0
    out = []
    while i < len(tokens):
        if tokens[i] == "{":
            depth += 1
            if depth > 1:
                out.append(tokens[i])
        elif tokens[i] == "}":
            depth -= 1
            if depth == 0:
                return out, i + 1
            out.append(tokens[i])
        else:
            out.append(tokens[i])
        i += 1
    raise ValueError("unbalanced block")


def _kv_block(tokens):
    """Parse 'a = 1 b = x c = { ... }' token lists into a dict of strings."""
    out = {}
    i = 0
    while i < len(tokens):
        if i + 1 < len(tokens) and tokens[i + 1] == "=":
            key = tokens[i]
            j = i + 2
            if j < len(tokens) and tokens[j] == "{":
                blk, j = _read_block(tokens, j)
                out[key] = "{ " + " ".join(blk) + " }"
            else:
                # value may span until the next 'key =' pair
                val = []
                while j < len(tokens) and not (j + 1 < len(tokens)
                                               and tokens[j + 1] == "="):
                    val.append(tokens[j])
                    j += 1
                    if len(val) == 1 and not _continues(tokens, j):
                        break
                out[key] = " ".join(val)
            i = j
        else:
            i += 1
    return out


def _continues(tokens, j):
    return j < len(tokens) and tokens[j] not in "{}" and \
        not (j + 1 < len(tokens) and tokens[j + 1] == "=")


# ---------------------------------------------------------------------------
# expression translation (GfsFunction -> closure)
# ---------------------------------------------------------------------------

def _unary(tfn, nfn, mfn):
    def f(v):
        if isinstance(v, torch.Tensor):
            return tfn(v)
        if isinstance(v, np.ndarray):
            return nfn(v)
        return mfn(v)
    return f


def _binary(tfn, nfn, mfn):
    """A two-argument function: torch where either argument is a tensor
    (a scalar partner filled to the tensor's shape on its device, a fill
    and no host copy), numpy where either is an array, else ``math``."""
    def f(a, b):
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if ta or tb:
            if not ta:
                a = torch.full_like(b, a)
            if not tb:
                b = torch.full_like(a, b)
            return tfn(a, b)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return nfn(a, b)
        return mfn(a, b)
    return f


def _clamp(v, lo, hi):
    if isinstance(v, torch.Tensor):
        return torch.clamp(v, lo, hi)
    if isinstance(v, np.ndarray):
        return np.clip(v, lo, hi)
    return min(max(v, lo), hi)


def _not(v):
    """C's ``!``: logical not of a bool or of a number (v == 0)."""
    if isinstance(v, torch.Tensor):
        return torch.logical_not(v)
    if isinstance(v, np.ndarray):
        return np.logical_not(v)
    return not v


# the builtins an expression is evaluated with: none but __import__, which
# torch's C code calls on a tensor's first comparison with a float and
# looks up in the builtins of the frame that calls it
_BUILTINS = {"__import__": __import__}

_FUNS = {
    "sin": _unary(torch.sin, np.sin, math.sin),
    "cos": _unary(torch.cos, np.cos, math.cos),
    "tan": _unary(torch.tan, np.tan, math.tan),
    "exp": _unary(torch.exp, np.exp, math.exp),
    "log": _unary(torch.log, np.log, math.log),
    "sqrt": _unary(torch.sqrt, np.sqrt, math.sqrt),
    "fabs": _unary(torch.abs, np.abs, abs),
    "abs": _unary(torch.abs, np.abs, abs),
    "atan2": _binary(torch.atan2, np.arctan2, math.atan2),
    "atan": _unary(torch.atan, np.arctan, math.atan),
    "asin": _unary(torch.asin, np.arcsin, math.asin),
    "acos": _unary(torch.acos, np.arccos, math.acos),
    "floor": _unary(torch.floor, np.floor, lambda v: float(math.floor(v))),
    "ceil": _unary(torch.ceil, np.ceil, lambda v: float(math.ceil(v))),
    "pow": _binary(torch.pow, np.power, math.pow),
    "tanh": _unary(torch.tanh, np.tanh, math.tanh),
    "cosh": _unary(torch.cosh, np.cosh, math.cosh),
    "sinh": _unary(torch.sinh, np.sinh, math.sinh),
    "MIN": _binary(torch.minimum, np.minimum, min),
    "MAX": _binary(torch.maximum, np.maximum, max),
    "CLAMP": _clamp,
    "M_PI": math.pi,
}
_MINIMUM = _FUNS["MIN"]
_MAXIMUM = _FUNS["MAX"]


def _where(cond, a, b, like=None):
    """C's ternary on a condition: a bool tensor (Python-scalar branches
    take the dtype and device of ``like``, the expression's coordinate
    tensor), a numpy array, or a Python bool."""
    if isinstance(cond, torch.Tensor):
        for v in (a, b):
            if isinstance(v, torch.Tensor):
                like = v
                break
        dt = like.dtype if isinstance(like, torch.Tensor) \
            and like.is_floating_point() else torch.float64
        if not isinstance(a, torch.Tensor):
            a = torch.full_like(cond, a, dtype=dt)
        if not isinstance(b, torch.Tensor):
            b = torch.full_like(cond, b, dtype=dt)
        return torch.where(cond, a, b)
    if isinstance(cond, np.ndarray):
        return np.where(cond, a, b)
    return a if cond else b


def _split_top(src: str, seps) -> list:
    """Split at top-level (outside parens) occurrences of any multi-char
    separator in ``seps``; returns the operand list (len 1 if none)."""
    parts = []
    depth = 0
    last = 0
    i = 0
    while i < len(src):
        ch = src[i]
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif depth == 0:
            for s in seps:
                if src.startswith(s, i):
                    parts.append(src[last:i])
                    last = i + len(s)
                    i += len(s) - 1
                    break
        i += 1
    parts.append(src[last:])
    return parts


def _c_to_py(src: str) -> str:
    """Recursive C-expression -> Python transform: ternaries become
    where(,,), '&&'/'||' become parenthesized '&'/'|', '!' becomes
    _not(operand) (the reference's '~' would complement a Python bool),
    applied inside every paren group (function args included)."""
    src = src.strip()
    # ternary: lowest precedence, right-associative
    depth = 0
    for i, ch in enumerate(src):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "?" and depth == 0:
            d2 = nest = 0
            for j in range(i + 1, len(src)):
                c2 = src[j]
                if c2 in "([":
                    d2 += 1
                elif c2 in ")]":
                    d2 -= 1
                elif c2 == "?" and d2 == 0:
                    nest += 1
                elif c2 == ":" and d2 == 0:
                    if nest == 0:
                        return (f"where({_c_to_py(src[:i])}, "
                                f"{_c_to_py(src[i + 1:j])}, "
                                f"{_c_to_py(src[j + 1:])})")
                    nest -= 1
            break
    for seps, op in ((("||",), "|"), (("&&",), "&")):
        parts = _split_top(src, seps)
        if len(parts) > 1:
            return f" {op} ".join(f"({_c_to_py(p)})" for p in parts)
    # descend into paren groups (incl. function-call argument lists)
    out = []
    i = 0
    while i < len(src):
        ch = src[i]
        if ch == "(":
            depth = 0
            for j in range(i, len(src)):
                if src[j] == "(":
                    depth += 1
                elif src[j] == ")":
                    depth -= 1
                    if depth == 0:
                        break
            inner = src[i + 1:j]
            args = _split_top(inner, (",",))
            out.append("(" + ", ".join(_c_to_py(a) for a in args) + ")")
            i = j + 1
        elif ch == "!" and i + 1 < len(src) and src[i + 1] != "=":
            # C's unary not binds to the next operand: a paren group, or
            # a name or number with its call's arguments
            j = i + 1
            while j < len(src) and src[j].isspace():
                j += 1
            m = re.match(r"[\w.]*\s*", src[j:])
            k = j + m.end()
            if k < len(src) and src[k] == "(" and (m.group().strip() or
                                                    k == j):
                depth = 0
                for k in range(k, len(src)):
                    if src[k] == "(":
                        depth += 1
                    elif src[k] == ")":
                        depth -= 1
                        if depth == 0:
                            break
                k += 1
            else:
                k = j + len(m.group().rstrip())
            out.append(f"_not({_c_to_py(src[j:k])})")
            i = k
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _mesh_gradient(a, coord, axis):
    """Central-difference d(a)/d(coord) along ``axis``, edge one-sided;
    returns 0 for scalars (reference: the dx()/dy() helpers of the
    GfsFunction header, src/utils.c function.h).  Torch tensors (roll and
    an index on their device) or numpy arrays."""
    nd = np.ndim(a) if not isinstance(a, torch.Tensor) else a.dim()
    cd = np.ndim(coord) if not isinstance(coord, torch.Tensor) \
        else coord.dim()
    if nd == 0 or cd == 0 or a.shape[axis] < 2:
        return a * 0.0 if nd else 0.0
    idx0 = [0] * cd
    idx1 = list(idx0)
    idx1[axis] = 1
    h = coord[tuple(idx1)] - coord[tuple(idx0)]
    n = a.shape[axis]
    if isinstance(a, torch.Tensor):
        fwd = torch.roll(a, -1, axis)
        bwd = torch.roll(a, 1, axis)
        sh = [1] * nd
        sh[axis] = n
        i = torch.arange(n, device=a.device).reshape(sh)
        where = torch.where
    else:
        fwd = np.roll(a, -1, axis)
        bwd = np.roll(a, 1, axis)
        i = np.arange(n).reshape([n if k == axis else 1 for k in range(nd)])
        where = np.where
    g = (fwd - bwd) / (2.0 * h)
    g = where(i == 0, (fwd - a) / h, g)
    return where(i == n - 1, (a - bwd) / h, g)


def translate_expr(expr: str, defines: dict = None, variables=()):
    """C expression -> python callable(x, y[, z], t=0, **variables).

    Handles the reference's simple function bodies; '{ ... return e; }'
    blocks with plain int/double declarations are reduced to 'e' with the
    declared constants substituted (the runtime-gcc analogue,
    src/utils.c:658-719).  C ternaries become where(); ``variables``
    names extra cell-field keyword arguments (the reference's variable
    accessors injected into compiled functions, src/utils.c function.h)."""
    src = expr.strip()
    m = re.match(r"^\(\s*(\{.*\})\s*\)$", src, re.DOTALL)
    if m:   # parenthesized C block: InitFraction T ({ ...; return e; })
        src = m.group(1)
    consts = {}
    symbolic = []              # ordered (name, expr) for x/y-dependent decls
    if src.startswith("{"):
        body = src.strip("{}")
        # pull out simple declarations: int k = 3, l = 3;  double a = ...;
        # non-constant declarations (double r2 = x*x + y*y;) are kept as
        # ordered textual substitutions — the C sequential-decl semantics
        def _split_decls(text):
            # split on top-level commas only (atan2(y, x) stays whole)
            out, depth, cur = [], 0, []
            for ch in text:
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                if ch == "," and depth == 0:
                    out.append("".join(cur))
                    cur = []
                else:
                    cur.append(ch)
            out.append("".join(cur))
            return out

        for m in re.finditer(r"\b(?:int|double|float)\s+([^;]+);", body):
            for piece in _split_decls(m.group(1)):
                if "=" in piece:
                    k, v = piece.split("=", 1)
                    k, v = k.strip(), v.strip()
                    try:
                        consts[k] = float(eval(v, {}, {}))
                    except Exception:
                        for pk, pv in reversed(symbolic):
                            v = re.sub(rf"\b{re.escape(pk)}\b",
                                       f"({pv})", v)
                        # earlier numeric consts must be substituted NOW:
                        # the final consts pass runs on src before the
                        # symbolic pass re-introduces their names
                        for pk, pv in consts.items():
                            v = re.sub(rf"\b{re.escape(pk)}\b",
                                       repr(pv), v)
                        symbolic.append((k, v))
        stmts = [s.strip() for s in body.split(";")]
        ret = [s for s in stmts if s.startswith("return")]
        shifts = [s for s in stmts
                  if re.match(r"[xyz]\s*[+\-]=", s)]
        if not ret:
            raise ValueError(f"unsupported C block (no return): {expr}")
        src = ret[0][len("return"):].strip()
        # apply coordinate shifts like 'x += 0.5;'
        for sh in shifts:
            var, op, val = re.match(r"([xyz])\s*([+\-])=\s*(.*)", sh).groups()
            repl = f"({var} {op} ({val}))"
            src = re.sub(rf"\b{var}\b", repl, src)
    if src.startswith("(") and src.endswith(")"):
        pass
    if defines:
        for k in sorted(defines, key=len, reverse=True):
            src = re.sub(rf"\b{re.escape(k)}\b", f"({defines[k]})", src)
    for k, v in consts.items():
        src = re.sub(rf"\b{re.escape(k)}\b", repr(v), src)
    for k, v in reversed(symbolic):
        src = re.sub(rf"\b{re.escape(k)}\b", f"({v})", src)
    py = _c_to_py(src)
    code = compile(py, "<gfs expression>", "eval")

    def fn(x, y, z=0.0, t=0.0, **vars):
        ns = dict(_FUNS)
        like = next((c for c in (x, y, z) if isinstance(c, torch.Tensor)),
                    None)
        ns.update({"x": x, "y": y, "z": z, "t": t, "_not": _not,
                   "where": lambda c, a, b: _where(c, a, b, like)})
        # the reference's derivative helpers dx()/dy()/dz() (function.h
        # injected into compiled GfsFunctions, src/utils.c): central
        # differences of an already-evaluated grid expression, with the
        # spacing taken from the coordinate mesh itself
        ns["dx"] = lambda a: _mesh_gradient(a, x, 0)
        ns["dy"] = lambda a: _mesh_gradient(a, y, 1)
        ns["dz"] = lambda a: _mesh_gradient(a, z, 2)
        ns.update(vars)
        return eval(code, {"__builtins__": _BUILTINS}, ns)

    def fn_np(x, y, z=0.0, t=0.0, **vars):
        """float64 numpy evaluation (exact constants, host-side)."""
        ns = {"sin": np.sin, "cos": np.cos, "tan": np.tan, "exp": np.exp,
              "log": np.log, "sqrt": np.sqrt, "fabs": np.abs,
              "abs": np.abs, "atan2": np.arctan2, "atan": np.arctan,
              "asin": np.arcsin, "acos": np.arccos, "floor": np.floor,
              "ceil": np.ceil, "pow": np.power, "tanh": np.tanh,
              "cosh": np.cosh, "sinh": np.sinh, "MIN": np.minimum,
              "MAX": np.maximum, "CLAMP": lambda v, lo, hi: np.clip(v, lo, hi),
              "M_PI": math.pi, "where": np.where, "_not": np.logical_not,
              "x": x, "y": y, "z": z, "t": t}
        ns.update(vars)
        return eval(code, {"__builtins__": _BUILTINS}, ns)

    fn.source = src
    fn.np = fn_np
    fn.variables = tuple(variables)
    return fn


# ---------------------------------------------------------------------------
# simulation assembly
# ---------------------------------------------------------------------------

@dataclass
class ParsedSim:
    sim_class: str = "GfsSimulation"
    level: int = 4
    refine_expr: Optional[object] = None               # spatial Refine fn
    time: dict = field(default_factory=dict)
    nu: float = 0.0
    nu_expr: Optional[object] = None     # SourceViscosity GfsFunction
    refine_surface: int = 0              # RefineSurface N (init fractions)
    curvature_vars: list = field(default_factory=list)  # (K, tracer, Kmax)
    turbulent_viscosity: list = field(default_factory=list)  # (name, Cs, model)
    source: Optional[str] = None          # original .gfs text (round-trip)
    source_defines: dict = field(default_factory=dict)
    checkpoint: Optional[str] = None      # InitCheckpoint sidecar path
    tension_css: list = field(default_factory=list)     # (tracer, sigma)
    solver_backend: Optional[str] = None  # GModule hypre/lis/agmg -> mgcg
    pipes: list = field(default_factory=list)  # SourcePipe/Culvert entries
    coriolis: Optional[tuple] = None     # SourceCoriolis (f, drag)
    tension: list = field(default_factory=list)       # (tracer, sigma)
    vof_tracers: list = field(default_factory=list)   # names
    tracers: list = field(default_factory=list)
    filtered: dict = field(default_factory=dict)       # name -> (parent, n)
    init_fractions: dict = field(default_factory=dict)  # tracer -> phi fn
    inits: dict = field(default_factory=dict)          # var -> fn
    raw_inits: dict = field(default_factory=dict)      # var -> C expr text
    solids: list = field(default_factory=list)         # phi fns (fluid>0)
    alpha_expr: Optional[str] = None
    projection: dict = field(default_factory=dict)
    approx_projection: dict = field(default_factory=dict)
    adapts: list = field(default_factory=list)         # (sched, params, expr)
    events: list = field(default_factory=list)         # (name, params, extra)
    boundaries: dict = field(default_factory=dict)     # side -> {var: (kind, fn)}
    periodic: set = field(default_factory=set)         # axes
    electro: Optional[dict] = None                     # GfsElectroHydro block
    source_electric: bool = False
    conductivity: Optional[tuple] = None               # (var, expr, potential)
    n_boxes: int = 1
    unknown_directives: list = field(default_factory=list)
    box_stack: tuple = (1, 1)
    box_edges: list = field(default_factory=list)  # (b1, b2, d, rotate)
    errors: list = field(default_factory=list)         # build diagnostics
    # the fork's module classes (modules/particulatecommon.c,
    # modules/bubbles.c, modules/fft.c, modules/turbulence.c)
    particle_lists: list = field(default_factory=list)
    source_particulate: Optional[dict] = None          # two-way coupling
    init_spectra: Optional[dict] = None                # GfsInitSpectra
    sources: dict = field(default_factory=dict)        # var -> rhs fn (GfsSource)
    stream_function: Optional[tuple] = None            # (name, fn, sched)
    surface_bcs: dict = field(default_factory=dict)    # var -> (kind, fn)
    metric_spec: Optional[tuple] = None                # (kind, kv)
    physical: dict = field(default_factory=dict)       # PhysicalParams kv
    tide_reference: Optional[str] = None  # GModule tide { reference = }
    refine_solid: Optional[int] = None                 # RefineSolid level
    tracer_gradients: dict = field(default_factory=dict)  # name -> limiter
    advection_params: dict = field(default_factory=dict)  # AdvectionParams kv
    beta: float = 1.0        # diffusion implicitness (NSConfig default)
    solids_raw: list = field(default_factory=list)     # unnegated Solid fns
    variables: list = field(default_factory=list)      # plain Variable names
    box_shift: tuple = (0.0, 0.0, 0.0)  # GfsGEdge { x = ... } global shift


_SHAPES = {
    # spatial.h's CSG shape macros in the reference's sign convention,
    # positive outside the shape (src/spatial.h ellipse:40-44,
    # sphere:46-49); tests/test_misc2.py::test_csg_shapes asserts the
    # opposite, which gerris_tpu's fcaf463 replaced
    "ellipse": lambda xc, yc, a, b: (
        lambda x, y, z=0.0, t=0.0: ((x - xc) / a) ** 2
        + ((y - yc) / b) ** 2 - 1.0),
    "sphere": lambda xc, yc, zc, r: (
        lambda x, y, z=0.0, t=0.0: (x - xc) ** 2 + (y - yc) ** 2
        + (z - zc) ** 2 - r * r),
}


def _csg_namespace():
    """Shape constructors + CSG combinators over level-set callables, in
    the reference's sign convention (positive outside; InitFraction and
    Solid both fill/keep fluid where the expression is POSITIVE).

    Reference: src/spatial.h — shapes ellipse:40, sphere:46, cube:51 and
    the CSG macros intersection=MAX / union=MIN / difference(a,b)=
    MAX(a,-b) (:27-29)."""

    def _lift(v):
        return v if callable(v) else (lambda x, y, z=0.0, t=0.0: v)

    ns = dict(_SHAPES)
    ns["cube"] = lambda xc, yc, zc, h: (
        lambda x, y, z=0.0, t=0.0: _MAXIMUM(
            _MAXIMUM((x - xc) ** 2 - (h / 2) ** 2,
                     (y - yc) ** 2 - (h / 2) ** 2),
            (z - zc) ** 2 - (h / 2) ** 2 if zc is not None else -math.inf))
    ns["union"] = lambda a, b: (
        lambda x, y, z=0.0, t=0.0, a=_lift(a), b=_lift(b):
        _MINIMUM(a(x, y, z, t), b(x, y, z, t)))
    ns["intersection"] = lambda a, b: (
        lambda x, y, z=0.0, t=0.0, a=_lift(a), b=_lift(b):
        _MAXIMUM(a(x, y, z, t), b(x, y, z, t)))
    ns["difference"] = lambda a, b: (
        lambda x, y, z=0.0, t=0.0, a=_lift(a), b=_lift(b):
        _MAXIMUM(a(x, y, z, t), -b(x, y, z, t)))
    return ns


def _maybe_shape(expr, defines):
    """CSG shape expressions -> level-set callables, e.g.
    ``(difference(ellipse(0,0,.25,.25), ellipse(0,0,.1,.1)))``."""
    s = expr.strip()
    if s.startswith("(") and s.endswith(")"):
        s = s[1:-1].strip()
    # unary minus flips which side is solid (test/wannier: the outer
    # cylinder `Solid (- ellipse (...))` bounds the fluid from outside)
    neg = False
    while s.startswith("-"):
        neg = not neg
        s = s[1:].lstrip()
    if not re.match(r"^(ellipse|sphere|cube|union|intersection|difference)"
                    r"\s*\(", s):
        return None
    # textual Define substitution (values are expression strings, and
    # may reference other defines — iterate to a fixpoint)
    for _ in range(8):
        s2 = s
        for k in sorted(defines or {}, key=len, reverse=True):
            s2 = re.sub(rf"\b{re.escape(k)}\b", f"({defines[k]})", s2)
        if s2 == s:
            break
        s = s2
    try:
        val = eval(_c_to_py(s), {"__builtins__": _BUILTINS},
                   dict(_FUNS, _not=_not, **_csg_namespace()))
    except Exception:
        return None
    if not callable(val):
        return None
    if neg:
        inner = val
        return lambda x, y, z=0.0, t=0.0: -inner(x, y, z, t)
    return val


def _expand_func_macros(text: str, macros: dict) -> str:
    """Expand function-like Define macros (balanced-paren argument
    parsing; fixpoint over nested uses) — the m4 pipeline analogue
    (reference: src/gerris.c:245-259)."""
    for _ in range(12):
        changed = False
        for name, (params, body) in macros.items():
            pat = re.compile(rf"\b{re.escape(name)}\s*\(")
            m = pat.search(text)
            while m:
                depth = 0
                j = m.end() - 1
                while j < len(text):
                    if text[j] == "(":
                        depth += 1
                    elif text[j] == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    j += 1
                args = _split_top(text[m.end():j], (",",))
                rep = body
                for p, a in zip(params, args):
                    rep = re.sub(rf"\b{re.escape(p)}\b", f"({a.strip()})",
                                 rep)
                text = text[:m.start()] + "(" + rep + ")" + text[j + 1:]
                changed = True
                m = pat.search(text)
        if not changed:
            return text
    return text


def _reduce_c_body(body: str) -> str:
    """Reduce a simple C function body (sequential declarations + one
    return) to a single C expression by textual back-substitution —
    the same sequential-decl semantics translate_expr applies to
    GfsFunction blocks."""
    decls = []
    ret = None
    for s in (p.strip() for p in body.split(";")):
        if s.startswith("return"):
            ret = s[len("return"):].strip()
            break
        m = re.match(r"(?:static\s+)?(?:const\s+)?(?:double|float|int)\s+(.+)",
                     s, re.DOTALL)
        if m:
            for piece in _split_top(m.group(1), (",",)):
                if "=" in piece:
                    k, v = piece.split("=", 1)
                    decls.append((k.strip(), v.strip()))
    if ret is None:
        raise ValueError(f"unsupported Global function body (no return): "
                         f"{body[:120]!r}")
    for k, v in reversed(decls):
        ret = re.sub(rf"\b{re.escape(k)}\b", f"({v})", ret)
    return f"({ret})"


def _parse_global_body(body: str, defines: dict, func_macros: dict):
    """Digest one GfsGlobal C block (reference: src/utils.c:382-398 —
    the block is prepended to every compiled GfsFunction).  Supported:
    #define constants and function-like macros, global const
    declarations, and single-return function definitions — all become
    textual substitutions visible to every GfsFunction, exactly the
    visibility the reference's C compilation gives them."""
    for m in re.finditer(r"#\s*define\s+(\w+)(\([^)]*\))?[ \t]+(.+)", body):
        name, params, val = m.groups()
        if params:
            func_macros[name] = (
                [p.strip() for p in params.strip("()").split(",")],
                val.strip())
        else:
            defines[name] = val.strip()
    body = re.sub(r"#\s*define.*", "", body)
    # function definitions: [static] double f(double x, ...) { ... }
    fpat = re.compile(
        r"(?:static\s+)?(?:double|float|int)\s+(\w+)\s*\(([^)]*)\)\s*\{")
    spans = []
    pos = 0
    while True:
        m = fpat.search(body, pos)
        if m is None:
            break
        depth = 0
        k = m.end() - 1
        for k in range(m.end() - 1, len(body)):
            if body[k] == "{":
                depth += 1
            elif body[k] == "}":
                depth -= 1
                if depth == 0:
                    break
        params = [p.split()[-1].lstrip("*")
                  for p in m.group(2).split(",") if p.strip()]
        func_macros[m.group(1)] = (
            params, _reduce_c_body(body[m.end():k]))
        spans.append((m.start(), k + 1))
        pos = k + 1
    for s, e in reversed(spans):
        body = body[:s] + body[e:]
    # remaining global declarations: [static] double a = <expr>;
    for m in re.finditer(
            r"(?:static\s+)?(?:const\s+)?(?:double|float|int)\s+"
            r"(\w+)\s*=\s*([^;]+);", body):
        v = m.group(2).strip()
        defines[m.group(1)] = v if _isnum(v) else f"({v})"


def _extract_globals(text: str, defines: dict, func_macros: dict) -> str:
    """Pull every ``[Gfs]Global { ... }`` block out of the raw text (before
    tokenization — the contents are C, not .gfs directives)."""
    pat = re.compile(r"(?:^|\s)(?:Gfs)?Global\s*\{")
    while True:
        m = pat.search(text)
        if m is None:
            return text
        start = text.index("{", m.start())
        depth = 0
        k = start
        for k in range(start, len(text)):
            if text[k] == "{":
                depth += 1
            elif text[k] == "}":
                depth -= 1
                if depth == 0:
                    break
        _parse_global_body(text[start + 1:k], defines, func_macros)
        text = text[:m.start()] + text[k + 1:]


def parse_gfs(text: str, defines: dict = None,
              strict: bool = False) -> ParsedSim:
    """Parse a .gfs file subset into a ParsedSim description.

    ``strict``: unknown directives raise instead of warning (the
    verbatim test suites run strict so silently-ignored physics cannot
    pass a gate)."""
    text0 = text
    defines0 = dict(defines or {})
    defines = dict(defines or {})
    func_macros = {}
    # Define macros (the reference pipes through m4, src/gerris.c:245-259)
    for m in re.finditer(r"^\s*Define\s+(\w+)(\([^)]*\))?\s+(.*)$",
                         text, re.MULTILINE):
        name, params, body = m.groups()
        if params:
            func_macros[name] = (
                [p.strip() for p in params.strip("()").split(",")],
                body.strip())
        else:
            defines[name] = body.strip()
    text = re.sub(r"^\s*Define.*$", "", text, flags=re.MULTILINE)
    # GModule lines load compiled plugins in the reference (src/gerris.c);
    # here every module is built in.  The external-solver modules select
    # the AMG-class backend (modules/hypre.c replacing poisson_solve).
    mods = set(re.findall(r"^\s*GModule\s+(\w+)\s*$", text, re.MULTILINE))
    solver_backend = "mgcg" if mods & {"hypre", "lis", "agmg"} else None
    text = re.sub(r"^\s*GModule\s+\w+\s*$", "", text, flags=re.MULTILINE)
    # GModule tide { reference = Y/m/d-H:M:S-UTC } (gfs_module_read,
    # modules/tide.c:368-396): calendar origin of simulation t=0
    tide_reference = None
    mt = re.search(r"^\s*GModule\s+tide\s*\{([^}]*)\}", text, re.MULTILINE)
    if mt:
        mref = re.search(r"reference\s*=\s*(\S+)", mt.group(1))
        if mref:
            tide_reference = mref.group(1)
        text = text[:mt.start()] + text[mt.end():]
    # GfsGlobal C blocks feed the GfsFunction namespace (src/utils.c:382)
    text = _extract_globals(text, defines, func_macros)
    # -DNAME=VALUE textual substitution
    for k, v in defines.items():
        if re.match(r"^\w+$", str(k)):
            text = re.sub(rf"\b{re.escape(k)}\b", str(v), text)
    if func_macros:
        text = _expand_func_macros(text, func_macros)
    toks = tokenize(text)
    sim = ParsedSim()
    sim.source = text0
    sim.source_defines = defines0
    sim.solver_backend = solver_backend
    sim.tide_reference = tide_reference

    # header: NB NE Class GfsBox GfsGEdge {}
    i = 0
    sim.n_boxes = int(toks[i]); i += 1
    n_edges = int(toks[i]); i += 1
    sim.sim_class = toks[i]; i += 1
    assert toks[i] == "GfsBox"; i += 1
    assert toks[i] == "GfsGEdge"; i += 1
    gblk, i = _read_block(toks, i)   # GfsGEdge params: global box shift
    gkv = _kv_block(gblk)
    sim.box_shift = (float(gkv.get("x", 0.0)), float(gkv.get("y", 0.0)),
                     float(gkv.get("z", 0.0)))
    body, i = _read_block(toks, i)

    _parse_sim_body(sim, body, defines, strict=strict)

    # GfsElectroHydro carries a second read block with the electric
    # parameters (modules/electrohydro.c:93-210 gfs_electro_hydro_read):
    # { perm = <expr> charge = <expr|var> ElectricProjectionParams {...} }
    if sim.sim_class.startswith("GfsElectroHydro") and i < len(toks) \
            and toks[i] == "{":
        eblk, i = _read_block(toks, i)
        ekv, eproj = {}, {}
        j = 0
        while j < len(eblk):
            if eblk[j] == "ElectricProjectionParams" and j + 1 < len(eblk) \
                    and eblk[j + 1] == "{":
                blk2, j = _read_block(eblk, j + 1)
                eproj = _kv_block(blk2)
            elif j + 2 < len(eblk) and eblk[j + 1] == "=":
                ekv[eblk[j]] = eblk[j + 2]
                j += 3
            else:
                j += 1
        sim.electro = {"perm": ekv.get("perm", "1."),
                       "charge": ekv.get("charge"),
                       "projection": eproj}

    # boxes and edges
    boxes = 0
    while i < len(toks):
        if toks[i] == "GfsBox":
            i += 1
            if i < len(toks) and toks[i] == "{":
                blk, i = _read_block(toks, i)
                _parse_box(sim, blk, defines)
            boxes += 1
        elif re.match(r"^\d+$", toks[i]) and i + 2 < len(toks):
            b1, b2, d = int(toks[i]), int(toks[i + 1]), toks[i + 2]
            i += 3
            rotate = None
            if i < len(toks) and toks[i] in ("right", "left",
                                             "top", "bottom"):
                # GfsGEdge rotation: b1's side d joins b2's side rotate
                # (gfs_gedge_link_boxes, src/boundary.c:1718-1724)
                rotate = toks[i]
                i += 1
            sim.box_edges.append((b1, b2, d, rotate))
            if b1 == b2:
                sim.periodic.add({"right": 0, "left": 0,
                                  "top": 1, "bottom": 1}[d])
            elif rotate is None:
                # linear stacks: count connections per axis
                ax = {"right": 0, "left": 0, "top": 1, "bottom": 1}[d]
                s = list(sim.box_stack)
                s[ax] += 1
                sim.box_stack = tuple(s)
        else:
            i += 1
    return sim


def _parse_sim_body(sim: ParsedSim, toks, defines, strict: bool = False):
    i = 0
    n = len(toks)
    while i < n:
        t = toks[i]
        if t == "Time":
            blk, i = _read_block(toks, i + 1)
            sim.time = {k: float(v) for k, v in _kv_block(blk).items()}
        elif t == "Refine":
            i += 1
            expr = toks[i]; i += 1
            try:
                sim.level = int(eval(expr, {"__builtins__": _BUILTINS},
                                     dict(_FUNS, **{k: _num(v) for k, v in
                                                    defines.items()
                                                    if _isnum(v)})))
            except Exception:
                # spatially-varying refinement (e.g. capwave.gfs:65):
                # keep the expression; the builder makes a static
                # composite mesh (GfsRefine, src/refine.c:115)
                m = re.findall(r"\d+", expr)
                sim.level = max(int(x) for x in m) if m else sim.level
                sim.refine_expr = translate_expr(expr, defines)
        elif t == "RefineSurface":
            # RefineSurface LEVEL|{return N;} SURFACE-EXPR: high-res
            # initial fractions near the surface (src/refine.c); dense
            # arrays supersample InitFraction globally instead
            i += 1
            if toks[i] == "{":
                blk, i = _read_block(toks, i)
                nums = [int(float(re.sub(r"[^0-9.]", "", x)))
                        for x in blk if re.search(r"\d", x)]
                lvl = nums[0] if nums else sim.level
            else:
                lvl = int(float(toks[i]))
                i += 1
            if i < n and not _is_directive(toks[i]) and toks[i] not in "{}":
                i += 1          # the surface expression token
            sim.refine_surface = max(sim.refine_surface, lvl)
        elif t in ("ProjectionParams", "ApproxProjectionParams"):
            blk, i = _read_block(toks, i + 1)
            d = {k: float(v) for k, v in _kv_block(blk).items()}
            if t == "ProjectionParams":
                sim.projection = d
            else:
                sim.approx_projection = d
        elif t == "PhysicalParams":
            blk, i = _read_block(toks, i + 1)
            kv = _kv_block(blk)
            sim.alpha_expr = kv.get("alpha")
            sim.physical = kv                 # L / g for GfsRiver etc.
        elif t == "AdvectionParams":
            blk, i = _read_block(toks, i + 1)
            sim.advection_params.update(_kv_block(blk))
        elif t in ("SourceDiffusion", "SourceViscosity"):
            if toks[i + 1] == "{":
                _, i = _read_block(toks, i + 1)
                i -= 1
            if t == "SourceViscosity" or _isnum(toks[i + 1]) \
                    or "/" in toks[i + 1]:
                # GfsSourceViscosity reads just the viscosity
                # (src/source.c gfs_source_viscosity_read): a constant
                # expression (possibly using math functions, e.g.
                # sqrt(0.8/LAPLACE) in test/spurious) stays a float;
                # anything referencing cell fields becomes a
                # field-dependent GfsFunction (MU(T1) in
                # test/capwave/air-water)
                fn = translate_expr(toks[i + 1], defines)
                free = set(re.findall(r"\b([A-Za-z_]\w*)\b", fn.source))
                free -= set(_FUNS) | {"where", "return"}
                if free:
                    sim.nu_expr = fn
                else:
                    sim.nu = float(fn.np(0.0, 0.0))
                i += 2
            else:
                var = toks[i + 1]
                sim.nu = float(eval(toks[i + 2], {"__builtins__": _BUILTINS},
                                    {}))
                i += 3
            if i < n and toks[i] == "{":
                # trailing parameter block: { beta = 1 } — diffusion
                # implicitness (gfs_diffusion_params_read, src/source.c;
                # beta=0.5 Crank-Nicholson, 1 backward Euler)
                blk, i = _read_block(toks, i)
                kv = _kv_block(blk)
                if "beta" in kv:
                    sim.beta = float(kv["beta"])
        elif t in ("VariableTracerVOF", "VariableTracerVOFHeight"):
            sim.vof_tracers.append(toks[i + 1])
            i += 2
        elif t == "VariableTracer":
            tname = toks[i + 1]
            sim.tracers.append(tname)
            i += 2
            if i < n and toks[i] == "{":
                # advection-parameter block: { gradient = ... cfl = ... }
                # (gfs_advection_params_read, src/advection.c)
                blk, i = _read_block(toks, i)
                kv = _kv_block(blk)
                gmap = {"gfs_center_gradient": "centered",
                        "gfs_center_van_leer_gradient": "van_leer",
                        "gfs_center_minmod_gradient": "minmod",
                        "gfs_center_sweby_gradient": "minmod"}
                if "gradient" in kv:
                    sim.tracer_gradients[tname] = \
                        gmap.get(kv["gradient"], "van_leer")
        elif t == "VariableFiltered":
            # VariableFiltered T1 T 1 (src/variable.c GfsVariableFiltered)
            sim.filtered[toks[i + 1]] = (toks[i + 2], int(toks[i + 3]))
            i += 4
        elif t == "VariableCurvature":
            # VariableCurvature K T [Kmax]: the curvature itself is
            # evaluated by the tension source; the names are recorded so
            # outputs/adapt criteria can read K (and the f(1-f)-diffused
            # maximum-curvature variable Kmax, src/tension.c:427-482)
            kname, tracer = toks[i + 1], toks[i + 2]
            i += 3
            kmax = None
            if i < n and toks[i] not in "{}" \
                    and _is_directive(toks[i]) \
                    and not re.match(
                        r"^(Gfs)?(Output|Source|Variable|Init|Adapt|"
                        r"Event|Refine|Time|Physical|Projection|Approx|"
                        r"Advection|Solid|Surface|Metric|Global|Define|"
                        r"GModule|Particle|Force)", toks[i]):
                kmax = toks[i]
                i += 1
            sim.curvature_vars.append((kname, tracer, kmax))
        elif t == "VariablePosition":
            # Position is an output-only helper
            i += 4
        elif t == "InitCheckpoint":
            # our re-parseable .gfs dump format: the original config
            # text plus this directive pointing at the sidecar state
            # arrays (the reference dumps per-cell data inside the
            # GfsBox block instead, src/output.c:1354-1564)
            sim.checkpoint = toks[i + 1]
            i += 2
        elif t == "VariableTurbulentViscosity":
            # VariableTurbulentViscosity NUT CS [smagorinsky|sigma]
            # (modules/turbulence.c:934-1131; the C reader takes Cs
            # only — model_type 1 = Smagorinsky — the optional model
            # token here exposes the compiled-in sigma variant too)
            vname = toks[i + 1]
            cs = float(toks[i + 2])
            i += 3
            model = "smagorinsky"
            if i < n and toks[i] in ("smagorinsky", "sigma"):
                model = toks[i]
                i += 1
            sim.turbulent_viscosity.append((vname, cs, model))
        elif t == "SourceTension":
            tracer = toks[i + 1]
            sigma = float(eval(toks[i + 2], {"__builtins__": _BUILTINS}, {}))
            sim.tension.append((tracer, sigma))
            i += 4 if i + 3 < n and toks[i + 3] not in "{}" and \
                not _is_directive(toks[i + 3]) else 3
        elif t in ("SourceCoriolis", "GfsSourceCoriolis"):
            # SourceCoriolis F [DRAG] (gfs_source_coriolis_read,
            # src/source.c:1798-1870; f may be an expression — constant
            # subset here, matching RiverConfig.coriolis)
            vals = []
            j = i + 1
            while j < n and len(vals) < 2 and toks[j] not in "{}" \
                    and not _is_directive(toks[j]):
                try:
                    vals.append(float(eval(toks[j],
                                           {"__builtins__": _BUILTINS}, {})))
                except Exception:
                    vals.append(0.0)
                j += 1
            i = j
            sim.coriolis = (vals[0] if vals else 0.0,
                            vals[1] if len(vals) > 1 else 0.0)
        elif t in ("SourcePipe", "SourceCulvert", "GfsSourcePipe",
                   "GfsSourceCulvert"):
            # (x1,y1) (x2,y2) DIAMETER [{ type/entrance/B/n/ke }]
            # (source_pipe_read src/river.c:1754 +
            # gfs_source_culvert_read modules/culvert.c:117)
            def _vec(tok):
                return tuple(float(v) for v in
                             re.findall(r"[-+0-9.eE]+", tok)[:2])
            p1 = _vec(toks[i + 1])
            p2 = _vec(toks[i + 2])
            diam = float(toks[i + 3])
            i += 4
            kv = {}
            if i < n and toks[i] == "{":
                blk, i = _read_block(toks, i)
                kv = _kv_block(blk)
            sim.pipes.append((t.replace("Gfs", ""), p1, p2, diam, kv))
        elif t in ("SourceTensionCSS", "GfsSourceTensionCSS"):
            # CSS variant (gfs_source_tension_css_read,
            # src/tension.c:181-196): no curvature variable argument
            tracer = toks[i + 1]
            sigma = float(eval(toks[i + 2], {"__builtins__": _BUILTINS}, {}))
            sim.tension_css.append((tracer, sigma))
            i += 3
        elif t == "InitFraction":
            j = i + 1
            sched = {}
            if toks[j] == "{":        # optional schedule block
                sblk, j = _read_block(toks, j)
                sched = _kv_block(sblk)
            tracer = toks[j]
            expr = toks[j + 1]
            if expr == "{":
                blk, j2 = _read_block(toks, j + 1)
                expr = "{" + " ".join(blk) + "}"
                i = j2
            else:
                i = j + 2
            shape = _maybe_shape(expr, defines)
            fn = shape or translate_expr(expr, defines)
            if sched:
                # re-initialisation event (InitFraction { start = end }
                # Tref ... — the reference's error-reference trick); the
                # runner applies it when the schedule fires
                sim.events.append(("InitFraction", sched, (tracer, fn)))
            else:
                sim.init_fractions[tracer] = fn
        elif t == "Variable":
            # plain (non-advected) cell variable (src/variable.c
            # GfsVariable); materialised as a zero field at init
            sim.variables.append(toks[i + 1])
            i += 2
        elif t == "Solid":
            expr = toks[i + 1]
            i += 2
            if expr.endswith(".gts"):
                # triangulated GTS surface input (src/surface.h:43-108;
                # e.g. Solid hexagon.gts { scale = ... })
                kv = {}
                if i < n and toks[i] == "{":
                    blk, i = _read_block(toks, i)
                    kv = _kv_block(blk)
                from ..physics import gts as gtsm
                fn = gtsm.surface_phi(
                    expr, dim=2,
                    scale=float(kv.get("scale", 1.0)),
                    translate=(float(kv.get("tx", 0.0)),
                               float(kv.get("ty", 0.0)),
                               float(kv.get("tz", 0.0))),
                    flip=bool(int(float(kv.get("flip", 0)))))
                # GTS surface_phi is positive INSIDE the surface; the
                # fluid is outside the solid body
                fn = (lambda x, y, z=0.0, t=0.0, f=fn: -f(x, y, z, t))
            else:
                shape = _maybe_shape(expr, defines)
                fn = shape or translate_expr(expr, defines)
            # reference semantics: the FLUID is where the Solid
            # expression is POSITIVE (gfs_solid_read + spatial.h sign
            # convention; e.g. Solid (ellipse(...)) keeps the fluid
            # outside the disk, Solid (- ellipse(...)) inside —
            # test/wannier uses both)
            sim.solids.append(fn)
            sim.solids_raw.append(fn)
        elif t == "Init":
            _, i2 = _read_block(toks, i + 1)      # schedule block
            blk, i = _read_block(toks, i2)
            kv = _kv_block(blk)
            for var, expr in kv.items():
                # inline references to variables initialised earlier in the
                # block (Init { U0 = ...  U = U0 } — reynolds/skew.gfs);
                # the reference evaluates sequentially against live cell
                # variables (src/init.c gfs_init_read)
                for prev, prev_expr in sim.raw_inits.items():
                    expr = re.sub(rf"\b{re.escape(prev)}\b",
                                  f"({prev_expr})", expr)
                sim.raw_inits[var] = expr
                sim.inits[var] = translate_expr(expr, defines)
        elif t == "SourceElectric":
            # Maxwell-stress momentum source (modules/electrohydro.c:612)
            sim.source_electric = True
            i += 1
        elif t == "SourceDiffusionExplicit":
            # SourceDiffusionExplicit Rhoe <sigma expr> [Phi]: explicit
            # conduction d var/dt = div(sigma grad Phi)
            # (modules/electrohydro.c ohmic charge transport)
            var = toks[i + 1]
            expr = toks[i + 2]
            j = i + 3
            pot = None
            # the optional potential argument is a variable name (Phi),
            # which the directive-regex would otherwise swallow
            if j < n and toks[j] not in "{}" and \
                    (toks[j] == "Phi" or not _is_directive(toks[j])):
                pot = toks[j]
                j += 1
            sim.conductivity = (var, expr, pot)
            i = j
        elif t == "Source":
            # GfsSource [{sched}] VAR <expr> (src/source.c gfs_source_read):
            # constant/expression rhs added to the variable's equation.
            j = i + 1
            if toks[j] == "{":
                _, j = _read_block(toks, j)   # schedule (unused: static)
            var = toks[j]; j += 1
            expr = toks[j]
            if expr == "{":
                blk, j = _read_block(toks, j)
                expr = "{" + " ".join(blk) + "}"
            else:
                j += 1
            sim.sources[var] = translate_expr(expr, defines)
            i = j
        elif t == "VariableStreamFunction":
            # VariableStreamFunction [{sched}] Psi <expr> (src/variable.c):
            # prescribes a discretely divergence-free velocity from the
            # stream function sampled at cell corners.
            j = i + 1
            sched = {}
            if toks[j] == "{":
                blk, j = _read_block(toks, j)
                sched = _kv_block(blk)
            name = toks[j]; j += 1
            expr = toks[j]
            if expr == "{":
                blk, j = _read_block(toks, j)
                expr = "{" + " ".join(blk) + "}"
            else:
                j += 1
            sim.stream_function = (name, translate_expr(expr, defines),
                                   sched)
            i = j
        elif t == "SurfaceBc":
            # SurfaceBc VAR Dirichlet|Neumann <expr> (src/boundary.c
            # surface_bc_read): BC on the embedded solid surface.
            var = toks[i + 1]
            kind = toks[i + 2].lower()
            j = i + 3
            expr = toks[j]
            if expr == "{":
                blk, j = _read_block(toks, j)
                expr = "{" + " ".join(blk) + "}"
            else:
                j += 1
            # ax/ay/az (solid-surface area centroid, simulation.c:919-921):
            # our DirichletSurface evaluates value callables AT the
            # surface projection point already, so they alias x/y/z here
            expr = re.sub(r"\ba([xyz])\b", r"\1", expr)
            sim.surface_bcs[var] = (kind, translate_expr(expr, defines))
            i = j
        elif t in ("MetricStretch", "MetricLonLat", "MetricCubed"):
            # Metric* [{sched}] [name] { params } (src/metric.c)
            j = i + 1
            kv = {}
            while j < n:
                if toks[j] == "{":
                    blk, j = _read_block(toks, j)
                    kv = _kv_block(blk) or kv
                elif not _is_directive(toks[j]) and toks[j] != "}":
                    j += 1            # optional metric name token
                else:
                    break
            sim.metric_spec = (t, kv)
            i = j
        elif t == "RefineSolid":
            sim.refine_solid = int(toks[i + 1])
            i += 2
        elif t == "EventStop":
            blk, i = _read_block(toks, i + 1)
            sched = _kv_block(blk)
            var = toks[i]; tol = float(toks[i + 1])
            i += 2
            # optional diff variable name (gfs_event_stop_read): an
            # ALL-CAPS identifier like DU is a variable, not a
            # CamelCase directive
            diff = None
            if i < n and toks[i] not in "{}" \
                    and (not _is_directive(toks[i])
                         or re.match(r"^[A-Z][A-Z0-9]*$", toks[i])):
                diff = toks[i]
                i += 1
            sim.events.append(("EventStop", sched, (var, tol, diff)))
        elif t in ("GfsParticleList", "ParticleList"):
            # the fork's Lagrangian container (gfs_particle_list_read,
            # modules/particulatecommon.c:1022-1093 over GfsEventList
            # src/event.c gfs_event_list_read):
            # GfsParticleList [*NAME] [{sched}] [DefaultClass]
            #   { particles } { forces } [idlast]
            j = i + 1
            name = None
            if j < n and toks[j].startswith("*"):
                name = toks[j][1:]
                j += 1
            sched = {}
            default_cls = None
            if j < n and toks[j] == "{":
                blk, j2 = _read_block(toks, j)
                if "=" in blk:       # schedule, not the particle list
                    sched = _kv_block(blk)
                    j = j2
            if j < n and toks[j] not in "{}" and _is_directive(toks[j]):
                default_cls = toks[j]
                j += 1
            particles = []
            if j < n and toks[j] == "{":
                blk, j = _read_block(toks, j)
                particles = _parse_particle_entries(blk, default_cls)
            forces = []
            if j < n and toks[j] == "{":
                blk, j = _read_block(toks, j)
                forces = _parse_force_entries(blk)
            idlast = None
            if j < n and _isnum(toks[j]):
                idlast = int(float(toks[j]))
                j += 1
            sim.particle_lists.append(dict(
                name=name, sched=sched, particles=particles,
                forces=forces, idlast=idlast))
            i = j
        elif t in ("GfsSourceParticulate", "SourceParticulate"):
            # two-way momentum coupling (source_particulate_read,
            # modules/particulatecommon.c:2230): NAME { rkernel = r }
            j = i + 1
            pname = toks[j]
            j += 1
            kv = {}
            if j < n and toks[j] == "{":
                blk, j = _read_block(toks, j)
                kv = _kv_block(blk)
            sim.source_particulate = dict(
                plist=pname, rkernel=float(kv.get("rkernel", 0.0)))
            i = j
        elif t in ("GfsInitSpectra", "InitSpectra"):
            # solenoidal velocity init from a model spectrum
            # (gfs_init_spectra_read, modules/turbulence.c:279-346):
            # [{sched}] { x0.. L E } { alpha epsilon c1 c2 c3 .. }
            # [level] U V [W]
            j = i + 1
            blks = []
            while j < n and toks[j] == "{":
                blk, j = _read_block(toks, j)
                blks.append(_kv_block(blk))
            sched = {}
            if blks and not any(k in blks[0] for k in ("x0", "L", "E")):
                sched = blks.pop(0)
            level = None
            if j < n and _isnum(toks[j]):
                level = int(float(toks[j]))
                j += 1
            vars_ = []
            while j < n and toks[j] not in "{}" \
                    and not _is_directive(toks[j]) \
                    and re.match(r"^\w+$", toks[j]):
                vars_.append(toks[j])
                j += 1
            sim.init_spectra = dict(
                sched=sched, pos=blks[0] if blks else {},
                params=blks[1] if len(blks) > 1 else {}, level=level,
                vars=vars_)
            i = j
        elif t in ("GfsOutputParticleList", "OutputParticleList"):
            # gfs_output_particle_list_read (particulatecommon.c:2660):
            # [{sched}] FILE PLISTNAME
            j = i + 1
            sched = {}
            if j < n and toks[j] == "{":
                blk, j = _read_block(toks, j)
                sched = _kv_block(blk)
            fileish = toks[j]
            pname = toks[j + 1]
            i = j + 2
            sim.events.append(("OutputParticleList", sched,
                               ([fileish, pname], [])))
        elif t in ("GfsOutputSpectra", "GfsOutputEnergySpectra",
                   "GfsOutputSpectraInterface"):
            # modules/fft.c output classes keep their Gfs prefix in the
            # registry; route to the generic Output collector under the
            # stripped name
            toks[i] = t[3:]
            continue
        elif t.startswith("Output") or t in ("EventScript", "GModule",
                                             "AdaptFunction", "AdaptError",
                                             "AdaptGradient",
                                             "AdaptVorticity",
                                             "AdaptThickness",
                                             "AdaptStreamlineCurvature",
                                             "EventBalance"):
            # schedule block, then positional args / extra blocks
            j = i + 1
            sched = {}
            if j < n and toks[j] == "{":
                blk, j = _read_block(toks, j)
                sched = _kv_block(blk)
            args = []
            blocks = []
            while j < n and not _is_directive(toks[j]) and toks[j] != "}":
                if toks[j] == "{":
                    blk, j = _read_block(toks, j)
                    blocks.append(_kv_block(blk))
                else:
                    args.append(toks[j])
                    j += 1
            sim.events.append((t, sched, (args, blocks)))
            i = j
        elif _is_directive(t):
            # unknown directive: consume its argument shape (optional
            # {} blocks + positional args) so parsing stays aligned,
            # then raise (strict) or warn — never silently skip physics
            j = i + 1
            while j < n and toks[j] != "}" and not _is_directive(toks[j]):
                if toks[j] == "{":
                    _, j = _read_block(toks, j)
                else:
                    j += 1
            msg = f"unsupported .gfs directive {t!r}"
            if strict:
                raise ValueError(msg)
            import warnings
            warnings.warn(msg + " — skipped", RuntimeWarning, stacklevel=2)
            sim.unknown_directives.append(t)
            i = j
        else:
            i += 1


def _parse_particle_entries(blk, default_cls):
    """Particle entries of a GfsParticleList block: each is
    [Class] [{sched}] id x y z [mass volume vx vy vz [fx fy fz]]
    [velR p0 (GfsBubble)] (gfs_particle_read src/particle.c:46,
    gfs_particulate_read modules/particulatecommon.c:844,
    gfs_bubble_read modules/bubbles.c:277)."""
    out = []
    j = 0
    n = len(blk)
    while j < n:
        cls = default_cls or "GfsParticulate"
        if _is_directive(blk[j]):
            cls = blk[j]
            j += 1
        if j < n and blk[j] == "{":
            _, j = _read_block(blk, j)          # per-particle schedule
        nums = []
        while j < n and _isnum(blk[j]):
            nums.append(float(blk[j]))
            j += 1
        if not nums:
            j += 1
            continue
        e = dict(cls=cls, id=int(nums[0]), pos=nums[1:4])
        rest = nums[4:]
        if len(rest) >= 5:
            e["mass"], e["volume"] = rest[0], rest[1]
            e["vel"] = rest[2:5]
            rest = rest[5:]
        if len(rest) >= 3:
            e["force"] = rest[:3]
            rest = rest[3:]
        if cls.endswith("Bubble") and len(rest) >= 2:
            e["velR"], e["p0"] = rest[0], rest[1]
        out.append(e)
    return out


def _parse_force_entries(blk):
    """Force-object entries: ClassName [coefficient-expr | {block}]
    (gfs_particle_force_read + force-coeff optional GfsFunction,
    modules/particulatecommon.c:684,519-680)."""
    out = []
    j = 0
    while j < len(blk):
        t = blk[j]
        if _is_directive(t):
            j += 1
            expr = None
            if j < len(blk) and blk[j] == "{":
                b2, j = _read_block(blk, j)
                expr = " ".join(b2)
            elif j < len(blk) and blk[j] not in "{}" \
                    and not _is_directive(blk[j]):
                expr = blk[j]
                j += 1
            out.append((t, expr))
        else:
            j += 1
    return out


def _is_directive(tok):
    return bool(re.match(r"^(Gfs)?[A-Z][A-Za-z]+$", tok)) and not _isnum(tok)


def _isnum(v):
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _num(v):
    return float(v)


def _parse_box(sim: ParsedSim, toks, defines):
    i = 0
    while i < len(toks):
        if toks[i] in ("left", "right", "top", "bottom",
                       "back", "front") and \
                i + 2 < len(toks) and toks[i + 1] == "=":
            side = toks[i]
            assert toks[i + 2] == "Boundary"
            i += 3
            if i < len(toks) and toks[i] == "{":
                blk, i = _read_block(toks, i)
                j = 0
                bcs_here = {}
                while j < len(blk):
                    if blk[j] in ("BcDirichlet", "BcNeumann", "BcAngle"):
                        kind = blk[j]
                        var = blk[j + 1]
                        expr = blk[j + 2]
                        fn = translate_expr(expr, defines) if not _isnum(expr) \
                            else float(expr)
                        bcs_here[var] = ({"BcDirichlet": "dirichlet",
                                          "BcNeumann": "neumann",
                                          "BcAngle": "angle"}[kind], fn)
                        j += 3
                    elif blk[j] == "BcTide":
                        # BcTide V H P { a0 g0 a1 g1 ... } — embedded
                        # N x 14 (amplitude, phase) samples along the
                        # boundary (bc_tide_read, modules/tide.c:78-198;
                        # without a block the FES2004 atlas is required)
                        var, hvar, pvar = blk[j + 1], blk[j + 2], blk[j + 3]
                        j += 4
                        nums = ()
                        if j < len(blk) and blk[j] == "{":
                            sub, j = _read_block(blk, j)
                            nums = tuple(float(x) for x in sub)
                        bcs_here[var] = ("tide", (hvar, pvar, nums))
                    else:
                        j += 1
                sim.boundaries[side] = bcs_here
        else:
            i += 1


# ---------------------------------------------------------------------------
# build the port's simulation from the parsed description
# ---------------------------------------------------------------------------

_GRADIENTS = {"gfs_center_gradient": "centered",
              "gfs_center_van_leer_gradient": "van_leer",
              "gfs_center_minmod_gradient": "minmod",
              "gfs_center_sweby_gradient": "minmod"}


def solver_params(d: dict, dim: int, solver_backend=None):
    """A ProjectionParams-style block -> the schedule the port runs: the
    JAX reader's MultilevelParams (gerris_tpu gfs_config.py:1597-1613,
    its defaults and the block's tolerance, nitermax, nitermin, erelax,
    nrelax, and GModule hypre/lis/agmg's "mgcg") with the TPU's floors of
    utils/convert.params_from_jax (convert.py:78-120), so the card, the
    CPU and the JAX package on the TPU run the same sweeps."""
    import dataclasses
    import types
    from ..solvers import poisson
    from .convert import TPU_NRELAX, params_from_jax
    kw = {"tolerance": float(d["tolerance"])} if "tolerance" in d else {}
    for k in ("nitermax", "nitermin", "erelax", "nrelax"):
        if k in d:
            kw[k] = int(d[k])
    if solver_backend:
        kw["solver"] = solver_backend
    p = poisson.MultilevelParams(**kw)
    return params_from_jax(types.SimpleNamespace(
        **dataclasses.asdict(p), tpu_nrelax=TPU_NRELAX), dim)


def _bc_value(fn, dim: int):
    """A BC value: a constant, or a translated expression called as the
    port's BCs call a value, f(x, y[, z], t): the expression takes t as a
    keyword (gerris_tpu's closure takes the positional t as z in 2D, so
    its time-dependent .gfs BCs see t = 0)."""
    if not callable(fn):
        return fn
    if dim == 2:
        return lambda x, y, t=0.0, f=fn: f(x, y, t=t)
    return lambda x, y, z, t=0.0, f=fn: f(x, y, z, t=t)


def build_simulation(sim: ParsedSim, dim: int = 2, device=None,
                     dtype=torch.float64):
    """The simulation a parsed .gfs describes (the class registry
    dispatch, src/init.c:121-314): the port's Simulation,
    AMRSimulation, PoissonSimulation or AdvectionSimulation on ``device``
    (the CUDA card by default; "cpu" for the plain versions) in
    ``dtype``.  The configuration is the one utils/convert's
    config_from_jax gives for the JAX reader's build of the same text."""
    from ..core.device import default_device
    from ..core.grid import Grid
    from ..core import bc as bcs
    from ..models import ns
    from ..models.simulation import Simulation, Time
    from ..events.events import EventStop
    from ..physics import vof as vofm

    device = default_device(device)
    if sim.sim_class == "GfsPoisson":
        return _build_poisson(sim, device, dtype)
    if sim.sim_class in ("GfsRiver", "GfsOcean"):
        raise NotImplementedError(
            f"{sim.sim_class} waits for the port's models/river.py and "
            "ocean.py (ROADMAP Queue 1, slice 8)")
    if sim.sim_class == "GfsSkewSymmetric" or \
            sim.sim_class.startswith("GfsElectroHydro"):
        raise NotImplementedError(
            f"{sim.sim_class} waits for the port's models/skew.py and "
            "electro.py (ROADMAP Queue 1, slice 8)")
    if sim.pipes:
        raise NotImplementedError("SourcePipe / SourceCulvert wait for the "
                                  "port's physics/culvert.py (slice 8)")

    def mk_grid(level):
        # PhysicalParams { L = ... }: the box edge in physical units
        # (gfs_physical_params_read, src/simulation.c)
        L = float(sim.physical.get("L", 1.0))
        if dim == 3:
            # gerris3D on the same file (src/ftt.h FTT_DIMENSION)
            assert sim.box_stack == (1, 1), \
                "3D multi-box layouts not supported"
            return Grid(level=level, dim=3, size=L, origin=(-L / 2,) * 3)
        sx, sy = sim.box_shift[0] * L, sim.box_shift[1] * L
        if sim.box_stack != (1, 1):
            return Grid(level=level, dim=dim, size=L, extents=sim.box_stack,
                        origin=(-L / 2 + sx, -L / 2 * sim.box_stack[1] + sy))
        return Grid(level=level, dim=dim, size=L,
                    origin=(-L / 2 + sx, -L / 2 + sy))

    if sim.refine_expr is not None:
        # the true depth: a level-l cell refines while refine(centre) > l
        # (GfsRefine, src/refine.c), probed on the host's cell centres
        rf = sim.refine_expr
        lmax = 2
        for l in range(2, sim.level + 2):
            if bool(np.any(np.asarray(rf(*mk_grid(l).centers)) > l)):
                lmax = l + 1
            else:
                break
        sim.level = lmax
    grid = mk_grid(sim.level)

    def side_bc(var, default):
        sides = []
        names = (("left", "right"), ("bottom", "top"), ("back", "front"))
        for ax in range(dim):
            pair = []
            for sd in range(2):
                if ax in sim.periodic:
                    pair.append(bcs.Periodic())
                    continue
                b = sim.boundaries.get(names[ax][sd], {}).get(var)
                if b is None:
                    pair.append(default(ax, sd))
                elif b[0] == "tide":
                    raise NotImplementedError(
                        "BcTide waits for the port's physics/tide.py "
                        "(ROADMAP Queue 1, slice 8)")
                elif b[0] == "dirichlet":
                    pair.append(bcs.Dirichlet(_bc_value(b[1], dim)))
                elif b[0] == "angle":
                    # GfsBcAngle: a VOF fraction's contact angle in degrees
                    # (src/boundary.c:412-457)
                    pair.append(bcs.Contact(_bc_value(b[1], dim)))
                else:
                    pair.append(bcs.Neumann(_bc_value(b[1], dim)))
            sides.append(tuple(pair))
        return bcs.FieldBC(tuple(sides))

    def tracer_bc(t):
        """A Boundary block's BcDirichlet T applies to the tracer
        (src/boundary.c gfs_boundary_read); else the mirror default."""
        if any(t in d for d in sim.boundaries.values()):
            return side_bc(t, lambda ax, sd: bcs.Neumann())
        return bcs.default_scalar_bc(dim)

    if sim.sim_class == "GfsAdvection":
        return _build_advection(sim, grid, tracer_bc, device, dtype)

    density = None
    if sim.alpha_expr:
        # PhysicalParams { alpha = <expr of one tracer> } (src/poisson.c:
        # 868): the affine VAR/RHO pattern is rho(T) = 1 / alpha with
        # rho1 = rho(T = 1), rho2 = rho(T = 0)
        fn = translate_expr(sim.alpha_expr)
        names_in = set(re.findall(r"\b([A-Za-z_]\w*)\b", fn.source))
        names_in -= set(_FUNS) | {"x", "y", "z", "t", "where", "return"}
        if len(names_in) == 1:
            var = names_in.pop()
            parent, npass = sim.filtered.get(var, (var, 0))
            a0 = float(fn.np(0.0, 0.0, **{var: 0.0}))
            a1 = float(fn.np(0.0, 0.0, **{var: 1.0}))
            density = (parent, 1.0 / a1, 1.0 / a0, npass)
        elif names_in:
            sim.errors.append(
                f"PhysicalParams alpha not reducible: {sim.alpha_expr}")

    solid_phi = None
    if sim.solids:
        fns = tuple(sim.solids)
        if len(fns) == 1:
            solid_phi = fns[0]
        else:
            def solid_phi(x, y, z=0.0, t=0.0, fns=fns):
                out = fns[0](x, y, z, t)
                for f in fns[1:]:
                    out = _MINIMUM(out, f(x, y, z, t))
                return out

    # GfsSource: the velocity components' -> body_force, a tracer's -> its
    # source (src/source.c gfs_source_read)
    vnames = ns.velocity_names(dim)
    body_force = None
    if any(v in sim.sources for v in vnames):
        body_force = tuple(sim.sources.get(v) for v in vnames)

    from ..solvers import advection as advm
    adv_kw = {}
    if "cfl" in sim.advection_params:
        adv_kw["cfl"] = float(sim.advection_params["cfl"])
    if "gradient" in sim.advection_params:
        adv_kw["gradient"] = _GRADIENTS.get(sim.advection_params["gradient"],
                                            "van_leer")
    if sim.advection_params.get("scheme") == "none":
        adv_kw["scheme"] = "none"
    advection = advm.AdvectionParams(**adv_kw)
    moving_order = int(float(sim.advection_params.get("moving_order", 1)))

    metric = None
    if sim.metric_spec is not None:
        from ..core import metric as metm
        kind, kv = sim.metric_spec
        if kind == "MetricStretch":
            metric = metm.MetricStretch(sx=float(kv.get("sx", 1.0)),
                                        sy=float(kv.get("sy", 1.0)))
        elif kind == "MetricLonLat":
            metric = metm.MetricLonLat()
        elif kind == "MetricCubed":
            metric = metm.MetricCubed()

    # SourceViscosity with a GfsFunction: its free field names become
    # nu_var_fields, VariableFiltered names as (name, parent, npass)
    nu_var = None
    nu_var_fields = ()
    if sim.nu_expr is not None:
        nu_var = sim.nu_expr
        names_in = set(re.findall(r"\b([A-Za-z_]\w*)\b",
                                  sim.nu_expr.source))
        names_in -= set(_FUNS) | {"x", "y", "z", "t", "where", "return"}
        nu_var_fields = tuple(
            (v, *sim.filtered[v]) if v in sim.filtered else (v, None, 0)
            for v in sorted(names_in))

    def mk_params(d):
        return solver_params(d, dim, sim.solver_backend)

    cfg = ns.NSConfig(
        grid=grid,
        u_bcs=tuple(
            side_bc(v, lambda ax, sd, c=c: bcs.Dirichlet(0.0) if ax == c
                    else bcs.Neumann())
            for c, v in enumerate(vnames)),
        nu=float(sim.nu),
        nu_var=nu_var,
        nu_var_fields=nu_var_fields,
        vof_tracers=tuple((t, tracer_bc(t)) for t in sim.vof_tracers),
        tension=tuple(sim.tension),
        tension_css=tuple(sim.tension_css),
        # (name, BC, diffusivity 0[, source]): gerris_tpu's reader puts a
        # tracer's Source in the diffusivity's slot (gfs_config.py:1715)
        tracers=tuple((t, tracer_bc(t), 0.0) + (
            (_bc_value(sim.sources[t], dim),) if t in sim.sources else ())
            for t in sim.tracers),
        projection=mk_params(sim.projection),
        approx_projection=mk_params(sim.approx_projection),
        diffusion_params=_diffusion_default(dim),
        p_bc=side_bc("P", lambda ax, sd: bcs.Neumann()),
        density=density,
        solid_phi=solid_phi,
        advection=advection,
        moving_order=moving_order,
        beta=sim.beta,
        body_force=body_force,
        metric=metric,
        surface_u=_surface_u_from_bcs(sim) if sim.surface_bcs else None,
        particle_coupling=bool(sim.source_particulate
                               and sim.particle_lists),
    )
    particle_systems = _particle_systems(sim, grid, device, dtype)
    time = Time(t=sim.time.get("t", 0.0), end=sim.time.get("end", math.inf),
                iend=int(sim.time.get("iend", 2 ** 31)),
                dtmax=sim.time.get("dtmax", math.inf))
    events, adapt_spec = _events(sim, cfg, EventStop)

    def init_fields(target_grid):
        fields = {}
        for var, fn in sim.inits.items():
            fields[var] = lambda *c, f=fn: f(*c)
        for tracer, phi in sim.init_fractions.items():
            fields[tracer] = vofm.fraction_from_levelset(
                target_grid, phi,
                refine=max(0, min(sim.refine_surface - target_grid.level,
                                  5)), device=device, dtype=dtype)
        return fields

    if sim.turbulent_viscosity:
        from ..events.variables import VariableTurbulentViscosity
        for vname, cs, model in sim.turbulent_viscosity:
            events.append(VariableTurbulentViscosity(vname, cs, model))

    if adapt_spec is not None and adapt_spec.cmax == 0.0 \
            and adapt_spec.minlevel == adapt_spec.maxlevel == sim.level:
        # cmax = 0 with min == max == the Refine level pins every cell at
        # the level the domain has: the uniform engine, the same physics
        # (gfs_config.py:1977-1986)
        adapt_spec = None
    if adapt_spec is not None or sim.refine_expr is not None:
        from ..models import amr_ns
        from ..solvers.composite import CompositeGrid
        import dataclasses as _dc

        if sim.particle_lists:
            # the JAX reader builds the particles and drops them here
            # (gfs_config.py:1988-2005): the composite step has no
            # particle phase (ROADMAP Queue 3)
            raise NotImplementedError(
                "particles on an adaptive mesh: the composite step has "
                "no particle phase")
        if adapt_spec is not None:
            s = amr_ns.AMRSimulation(cfg, adapt=adapt_spec, time=time,
                                     events=events, device=device,
                                     dtype=dtype)
        else:
            base = _dc.replace(grid, level=max(2, sim.level - 4))
            rf = sim.refine_expr
            mesh = CompositeGrid.from_refine_fn(
                base, sim.level, lambda x, y, l: rf(x, y) > l)
            s = amr_ns.AMRSimulation(cfg, mesh=mesh, time=time,
                                     events=events, device=device,
                                     dtype=dtype)
    else:
        s = Simulation(cfg, time=time, events=events, device=device,
                       dtype=dtype, particle_systems=particle_systems)
    s.errors = sim.errors
    s.curvature_vars = {k: (tr, km) for k, tr, km in sim.curvature_vars}
    s.gfs_source = (sim.source, sim.source_defines)
    s.init(**init_fields(grid))
    if sim.init_spectra is not None:
        _apply_init_spectra(s, sim.init_spectra)
    if sim.checkpoint:
        from ..events.outputs import load_checkpoint
        load_checkpoint(sim.checkpoint, s)
    return s


def _diffusion_default(dim: int):
    """The diffusion's schedule: the reference's default (diffusion_params
    None) with the TPU's floors (convert.params_from_jax(None))."""
    from .convert import params_from_jax
    return params_from_jax(None, dim)


def _schedule_kw(sched: dict) -> dict:
    kw = {}
    if "istep" in sched:
        kw["istep"] = int(float(sched["istep"]))
    if "step" in sched:
        kw["step"] = float(sched["step"])
    if "start" in sched:
        kw["start"] = "end" if sched["start"] == "end" \
            else float(sched["start"])
    return kw


def _solution_text(sblk: dict, sim: ParsedSim) -> str:
    sol = sblk.get("s")
    for prev, prev_expr in sim.raw_inits.items():
        sol = re.sub(rf"\b{re.escape(prev)}\b", f"({prev_expr})", sol)
    return sol


def _events(sim: ParsedSim, cfg, EventStop):
    """The parsed events -> the port's event objects and the adaptation
    spec (gfs_config.py:1793-1952).  A directive whose build fails is
    recorded in ``sim.errors`` and warned about, not swallowed."""
    from ..events import outputs as out
    from ..parallel.balance import EventBalance
    events = []
    adapt_spec = None
    for name, sched, extra in sim.events:
        if name == "EventStop":
            var, tol, diff = (extra if len(extra) == 3
                              else (extra[0], extra[1], None))
            # a time-interval schedule clamps dt through next_time
            # (gfs_event_next; test/wannier paces its timestep so)
            kw = _schedule_kw(sched)
            if "step" in kw:
                kw["istep"] = None
            elif "istep" not in kw:
                kw["istep"] = 1
            events.append(EventStop(var, tol, diff_name=diff, **kw))
            continue
        if extra is None:
            continue
        args, blocks = extra
        kw = _schedule_kw(sched)
        fileish = args[0] if args and not args[0].startswith("{") else None
        if name == "EventBalance":
            # GfsEventBalance istep max (src/balance.c:262-297): one device
            events.append(EventBalance(
                max_ratio=float(args[0]) if args else 1.1,
                istep=int(float(sched.get("istep", 1)))))
            continue
        try:
            if name == "OutputTime":
                events.append(out.OutputTime(file=fileish, **kw))
            elif name == "OutputTiming":
                # the step's timers (src/output.c:772-830), which the
                # JAX reader leaves out
                events.append(out.OutputTiming(file=fileish, **kw))
            elif name == "OutputScalarNorm" and blocks:
                v = blocks[0].get("v")
                if v and re.match(r"^\w+$", v):
                    events.append(out.OutputScalarNorm(v, file=fileish,
                                                       **kw))
            elif name == "OutputScalarSum" and blocks:
                v = blocks[0].get("v")
                if v:
                    vv = v if re.match(r"^\w+$", v) else \
                        _scalar_expr_value(v, sim)
                    events.append(out.OutputScalarSum(vv, file=fileish,
                                                      **kw))
            elif name in ("OutputErrorNorm", "OutputCorrelation") \
                    and len(blocks) >= 2:
                # the file may itself be a { shell pipe } block
                # (src/output.c:70-130): find v and s by content
                vblk = next((b for b in blocks
                             if "v" in b and "s" not in b), {})
                sblk = next((b for b in blocks if "s" in b), {})
                v = vblk.get("v")
                if v and sblk.get("s"):
                    fn = translate_expr(_solution_text(sblk, sim), None)
                    unb = bool(int(float(sblk.get("unbiased", "0"))))
                    if name == "OutputErrorNorm":
                        events.append(out.OutputErrorNorm(
                            v, fn, unbiased=unb,
                            relative=bool(int(float(
                                sblk.get("relative", "0")))),
                            file=fileish, **kw))
                    else:
                        events.append(out.OutputCorrelation(
                            v, fn, unbiased=unb, file=fileish, **kw))
            elif name == "OutputSolidForce" and fileish:
                events.append(out.OutputSolidForce(file=fileish, **kw))
            elif name == "OutputInterface" and fileish:
                tr = sim.vof_tracers[0] if sim.vof_tracers else "T"
                events.append(out.OutputInterface(tr, file=fileish, **kw))
            elif name == "OutputSimulation" and fileish:
                # the name as given: a .gfs name writes the re-parseable
                # text dump (gerris_tpu gfs_config.py:1872-1875 appends
                # .npz, so its .gfs dumps never reach that branch)
                events.append(out.OutputSimulation(fileish, **kw))
            elif name == "OutputPPM" and blocks:
                v = blocks[0].get("v")
                if v and fileish and re.match(r"^\w+$", v):
                    events.append(out.OutputPPM(v, fileish, **kw))
            elif name == "OutputSquares" and blocks and fileish:
                v = blocks[0].get("v")
                if v and re.match(r"^\w+$", v):
                    vmin = blocks[0].get("min")
                    vmax = blocks[0].get("max")
                    events.append(out.OutputSquares(
                        v, fileish,
                        vmin=None if vmin is None else float(vmin),
                        vmax=None if vmax is None else float(vmax), **kw))
            elif name == "OutputLocation" and fileish and len(args) >= 3:
                # OutputLocation file x y [z] (src/output.c:1714): every
                # primary variable, as the reference's line
                pt = [float(a) for a in args[1:]]
                dim = cfg.grid.dim
                from ..models.ns import velocity_names
                vs = list(velocity_names(dim)) + ["P"] \
                    + list(sim.tracers) + list(sim.vof_tracers)
                events.append(out.OutputLocation(
                    vs, [pt[:dim]], file=fileish, **kw))
            elif name == "OutputParticleList" and len(args) >= 2:
                events.append(out.OutputParticleList(
                    args[1], file=args[0], **kw))
            elif name in ("OutputSpectra", "OutputSpectraInterface") \
                    and len(args) >= 2:
                events.append(out.OutputSpectra(args[1], file=fileish,
                                                **kw))
            elif name == "OutputEnergySpectra":
                events.append(out.OutputEnergySpectra(file=fileish, **kw))
            elif name == "AdaptFunction" and blocks and args:
                adapt_spec = _make_adapt_spec(sched, blocks[0], args[0],
                                              sim)
            elif name == "AdaptError" and blocks and args:
                adapt_spec = _make_adapt_error_spec(sched, blocks[0],
                                                    args[0], sim)
            elif name in ("AdaptGradient", "AdaptVorticity") and blocks:
                adapt_spec = _make_adapt_gradient_spec(
                    sched, blocks[0], args[0] if args else "U",
                    name == "AdaptVorticity", sim)
            elif name in ("AdaptThickness",
                          "AdaptStreamlineCurvature") and blocks:
                adapt_spec = _make_adapt_misc_spec(
                    sched, blocks[0], args[0] if args else None,
                    "Thickness" if name == "AdaptThickness"
                    else "StreamlineCurvature", sim)
            # EventScript and GModule are skipped (shell execution and
            # module loading)
        except Exception as exc:
            sim.errors.append(f"{name}: {exc!r}")
    if sim.errors:
        import warnings
        for e in sim.errors:
            warnings.warn(f"gfs_config: {e}")
    return events, adapt_spec


def _particle_systems(sim: ParsedSim, grid, device, dtype) -> list:
    """GfsParticleList entries -> ParticleSystem runtimes
    (modules/particulatecommon.c's class registry :27-49, the forces
    :255-680, GfsBubble modules/bubbles.c)."""
    from ..physics import particles as parts
    from ..physics import bubbles as bub
    from ..models.particle_system import ParticleSystem

    fmap = {"ForceDrag": "drag", "ForceLift": "lift", "ForceBuoy": "buoy",
            "ForceAddedMass": "added_mass", "ForceInertial": "inertial"}
    out = []
    for k, pl in enumerate(sim.particle_lists):
        entries = pl["particles"]
        dimp = grid.dim
        cap = max(16, 2 * len(entries))
        pos = [list(e.get("pos", [0] * 3))[:dimp] for e in entries]
        vel = [list(e.get("vel", [0] * 3))[:dimp] for e in entries]
        forces = []
        cd = None
        for f, expr in pl["forces"]:
            key = fmap.get(f[3:] if f.startswith("Gfs") else f)
            if key:
                forces.append(key)
                if key == "drag" and expr is not None and _isnum(expr):
                    cd = float(expr)
        pcfg = parts.ParticleConfig(
            capacity=cap, forces=tuple(forces), cd=cd,
            two_way=bool(sim.source_particulate),
            rkernel=(sim.source_particulate or {}).get("rkernel", 0.0))
        if any(e["cls"].endswith("Bubble") for e in entries):
            R = [(3.0 * e.get("volume", 1e-6) / (4 * math.pi)) ** (1. / 3.)
                 for e in entries]
            state = bub.make_bubbles(
                cap, dimp, pos=pos, vel=vel, R=R,
                p0=[e.get("p0", 1.0) for e in entries], device=device,
                dtype=dtype)
            bcfg = bub.BubbleConfig()
        else:
            state = parts.make_particles(
                cap, dimp, pos=pos or None, vel=vel or None,
                vol=[e.get("volume", 1e-6) for e in entries] or None,
                mass=[e.get("mass", 1e-6) for e in entries] or None,
                device=device, dtype=dtype)
            bcfg = None
        out.append(ParticleSystem(pcfg, state, bubble_cfg=bcfg,
                                  name=pl["name"] or f"plist{k}"))
    return out


def _build_advection(sim: ParsedSim, grid, tracer_bc, device, dtype):
    """GfsAdvection (src/simulation.c:2061 advection_run): the tracers
    advected by a prescribed velocity, from VariableStreamFunction psi at
    the cell corners (divergence-free by construction,
    GfsVariableStreamFunction src/variable.c) or from Init U and V
    evaluated at the face centres (test/rotate)."""
    from ..core.grid import Grid
    from ..models.classes import AdvectionSimulation
    from ..models.simulation import Time
    from ..physics import vof as vofm

    def axis(a, faces):
        c = grid.axis_faces(a) if faces else grid.axis_centers(a)
        return torch.as_tensor(c, dtype=dtype, device=device)

    xf, yf = axis(0, True), axis(1, True)
    if sim.stream_function is not None:
        _, psi_fn, psched = sim.stream_function

        def u_face(t, fn=psi_fn):
            Psi = fn(xf[:, None], yf[None, :], t=t) \
                + torch.zeros((xf.numel(), yf.numel()), dtype=dtype,
                              device=device)
            return [(Psi[:, 1:] - Psi[:, :-1]) / grid.h,
                    -(Psi[1:, :] - Psi[:-1, :]) / grid.h]
    elif "U" in sim.inits or "V" in sim.inits:
        # the cell velocities' expressions evaluated at the face centres:
        # exact for the linear fields these cases use (the reference
        # face-interpolates the cell init)
        psched = {}
        xc, yc = axis(0, False), axis(1, False)

        def _ev(fn, X, Y, t):
            z = torch.zeros((X.numel(), Y.numel()), dtype=dtype,
                            device=device)
            if not callable(fn):
                return z + float(fn)
            return fn(X[:, None], Y[None, :], t=t) + z

        def u_face(t, uf_=sim.inits.get("U", 0.0),
                   vf_=sim.inits.get("V", 0.0)):
            return [_ev(uf_, xf, yc, t), _ev(vf_, xc, yf, t)]
    else:
        raise ValueError("GfsAdvection needs VariableStreamFunction or "
                         "Init U/V velocities")
    tracers = ([(nm, tracer_bc(nm), True) for nm in sim.vof_tracers]
               + [(nm, tracer_bc(nm), False) for nm in sim.tracers])
    tkw = sim.time or {}
    tend = float(tkw.get("end", 0.0))
    breaks = []
    if psched.get("step"):
        # the stream function is re-evaluated on this schedule and may
        # jump there (shear.gfs flips its sign at t = 2.5)
        st = float(psched["step"])
        breaks = [k * st for k in range(1, int(tend / st) + 1)
                  if k * st < tend]
    s = AdvectionSimulation(
        grid, u_face, tracers,
        cfl=float(sim.advection_params.get("cfl", 0.8)),
        gradients=sim.tracer_gradients, breaks=breaks,
        time=Time(**{k: (int(v) if k in ("i", "iend") else float(v))
                     for k, v in tkw.items()}), device=device, dtype=dtype)
    s.errors = sim.errors
    fields = {var: (lambda *c, f=fn: f(*c)) for var, fn in sim.inits.items()}
    for tracer, phi in sim.init_fractions.items():
        fields[tracer] = vofm.fraction_from_levelset(
            grid, phi, refine=max(0, min(sim.refine_surface - grid.level, 5)),
            device=device, dtype=dtype)
    return s.init(**fields)


def _apply_init_spectra(s, spec):
    """GfsInitSpectra (modules/turbulence.c:279, :626-900): a solenoidal
    velocity from a model spectrum E(k) ~ (k/k0)^alpha exp(-alpha/2
    (k/k0)^2), k0 from kmax, scaled so that the kinetic energy is E.  The
    noise is torch's normal draws from a generator seeded with the
    block's seed (the JAX package draws jax.random's)."""
    from ..spectral import fft as sfft
    from ..models.ns import velocity_names

    grid = s.cfg.grid
    pos = spec.get("pos", {})
    par = spec.get("params", {})
    E_tot = float(pos.get("E", 1.0))
    alpha = float(par.get("alpha", 4.0))
    kmax = par.get("kmax")
    k0 = float(kmax) if kmax not in (None, "") else 4.0 * 2 * math.pi
    seed = int(float(par.get("seed", 0.0)))

    def model(k):
        kk = torch.clamp(k, min=1e-12) / k0
        return kk ** alpha * torch.exp(-0.5 * alpha * kk ** 2)

    gen = torch.Generator(device=s.device).manual_seed(seed)
    U = sfft.init_solenoidal(grid, model, generator=gen, device=s.device,
                             dtype=s.dtype)
    ke = float(sum(torch.sum(u ** 2) for u in U)) * grid.cell_volume / 2.0
    scale = math.sqrt(E_tot / max(ke, 1e-300))
    names = spec.get("vars") or list(velocity_names(grid.dim))
    for n, u in zip(names, U):
        s.state[n] = (u * scale).contiguous()


def _field_values(names_in, s, sim: ParsedSim):
    """The fields an expression names, at the finest resolution:
    Velocity2, the VariableFiltered names, or sim_field's (Vorticity
    among them)."""
    from ..events.outputs import sim_field
    vals = {}
    for v in names_in:
        if v == "Velocity2":
            vals[v] = sum(sim_field(s, c) ** 2
                          for c in ("U", "V", "W")[:s.cfg.grid.dim])
        elif v in sim.filtered:
            from ..models.ns import filtered as filt
            parent, npass = sim.filtered[v]
            fbc = dict(s.cfg.vof_tracers).get(parent)
            vals[v] = filt(sim_field(s, parent), s.cfg.grid, fbc, npass,
                           s.time.t)
        else:
            vals[v] = sim_field(s, v)
    return vals


def _scalar_expr_value(expr: str, sim: ParsedSim):
    """An OutputScalarSum expression such as 'RHO(T1)*Velocity2' ->
    callable(sim) on the finest grid, on the fields' device
    (src/output.c's scalar functions)."""
    fn = translate_expr(expr)
    names_in = set(re.findall(r"\b([A-Za-z_]\w*)\b", fn.source))
    names_in -= set(_FUNS) | {"x", "y", "z", "t", "where"}

    def value(s):
        from ..events.outputs import _coords
        vals = _field_values(names_in, s, sim)
        like = s.fine("U") if hasattr(s, "topo") else s.state["U"]
        return fn(*_coords(s, like), t=s.time.t, **vals)

    return value


def _adapt_spec(sched, params, sim: ParsedSim, criterion,
                cmax=1e-2, cfactor=4.0, pin_minlevel=False):
    from ..models import amr_ns
    maxlevel = int(float(params.get("maxlevel", sim.level)))
    minlevel = int(float(params.get("minlevel", max(2, maxlevel - 4))))
    if pin_minlevel and float(params.get("cmax", cmax)) == 0.0 \
            and maxlevel >= sim.level:
        # cmax = 0 pins the flagged cells at maxlevel (test/sessile):
        # coarsening the rest only saves cells in the tree code
        minlevel = int(float(params.get("minlevel", maxlevel)))
    maxcells = params.get("maxcells")
    return amr_ns.AdaptSpec(
        criterion=criterion, cmax=float(params.get("cmax", cmax)),
        cfactor=float(params.get("cfactor", cfactor)),
        minlevel=minlevel, maxlevel=maxlevel,
        istep=int(float(sched.get("istep", 1))),
        maxcells=None if maxcells is None else int(float(maxcells)))


def _make_adapt_spec(sched, params, expr, sim: ParsedSim):
    """AdaptFunction { istep } { cmax maxlevel [minlevel] } (expr) -> the
    AMR driver's AdaptSpec (src/adaptive.c GfsAdaptFunction): the
    expression at the finest level with dL the candidate cell's size, an
    affine cost in dL split into (c0, c1)."""
    fn = translate_expr(expr)
    names_in = set(re.findall(r"\b([A-Za-z_]\w*)\b", fn.source))
    names_in -= set(_FUNS) | {"x", "y", "z", "t", "where", "dL"}

    def criterion(s):
        from ..events.outputs import _coords
        vals = _field_values(names_in, s, sim)
        like = s.fine("U")
        c = _coords(s, like)

        def c_at(dl):
            # a boolean criterion ((T > 0 && T < 1), sessile.gfs) becomes
            # a float before the difference in dL
            v = fn(*c, t=s.time.t, dL=dl, **vals)
            if not isinstance(v, torch.Tensor):
                return torch.full_like(like, float(v))
            return torch.broadcast_to(v.to(like.dtype), like.shape)
        c0 = c_at(0.0)
        return c0, c_at(1.0) - c0

    return _adapt_spec(sched, params, sim, criterion, pin_minlevel=True)


def _surface_u_from_bcs(sim: ParsedSim):
    """SurfaceBc U/V/W Dirichlet expressions -> NSConfig.surface_u per
    component (src/boundary.c surface BCs; test/couette)."""
    out = []
    for v in ("U", "V", "W"):
        e = sim.surface_bcs.get(v)
        if e is not None and e[0] == "dirichlet":
            out.append(lambda x, y, t=0.0, f=e[1]: f(x, y, t=t))
        else:
            out.append(None)
    return tuple(out) if any(o is not None for o in out) else None


def _make_adapt_gradient_spec(sched, params, var, use_vorticity,
                              sim: ParsedSim):
    """GfsAdaptGradient v: refine where |grad v| times the cell length
    exceeds cmax (src/adaptive.c gradient_cost); GfsAdaptVorticity: the
    cost |w| h / max|U| (src/adaptive.c:350 cost_vorticity)."""
    def criterion(s):
        from ..events.outputs import sim_field
        from ..core import bc as _b
        from ..ops import stencils as st
        from ..ops.derived import vorticity
        from ..models.ns import velocity_names

        g = s.topo.grid(s.topo.lmax)
        if use_vorticity:
            U = [sim_field(s, nm) for nm in velocity_names(s.topo.dim)]
            w = vorticity(U, g, list(s.cfg.u_bcs), t=s.time.t)
            maxa = torch.clamp(torch.sqrt(torch.max(sum(u * u for u in U))),
                               min=1e-30)
            return None, torch.abs(w) / maxa
        v = sim_field(s, var)
        fbc = dict(s.cfg.vof_tracers).get(var) \
            or _b.default_scalar_bc(s.topo.dim)
        vp = _b.apply_bc(v, g, fbc, t=s.time.t)
        return None, torch.sqrt(sum(st.center_gradient(vp, g, a) ** 2
                                    for a in range(s.topo.dim)))

    return _adapt_spec(sched, params, sim, criterion)


def _make_adapt_misc_spec(sched, params, var, kind, sim: ParsedSim):
    """GfsAdaptThickness v: refine sheets thinner than 1/cmax cells
    (src/adaptive.c:665-790, cmax 1/3); GfsAdaptStreamlineCurvature: the
    streamline curvature times the cell size over cmax
    (src/adaptive.c:390-412)."""
    from ..models import amr_ns
    if kind == "Thickness":
        return _adapt_spec(
            sched, params, sim,
            lambda s: (amr_ns.thickness_cost(s, vof_name=var or "T"), None),
            cmax=1.0 / 3.0, cfactor=1.1)
    return _adapt_spec(
        sched, params, sim,
        lambda s: (amr_ns.streamline_curvature_cost(s), None))


def _make_adapt_error_spec(sched, params, var, sim: ParsedSim):
    """GfsAdaptError { istep } { cmax maxlevel [maxcells] } v: refine where
    the truncation-error estimate h^2 |D^2 v| exceeds cmax
    (src/adaptive.c:594 cost_error)."""
    def criterion(s):
        from ..events.outputs import sim_field
        from ..models import amr_ns
        from ..core import bc as _b
        g = s.topo.grid(s.topo.lmax)
        fbc = s.field_bc(var) if hasattr(s, "field_bc") else None
        fbc = fbc or _b.default_scalar_bc(s.topo.dim)
        return None, None, amr_ns.hessian_cost(sim_field(s, var), g, fbc,
                                               t=s.time.t)

    return _adapt_spec(sched, params, sim, criterion)


def _build_poisson(sim: ParsedSim, device, dtype):
    """GfsPoisson: P's BCs from the boxes (Neumann 0 by default), the
    (Approx)ProjectionParams schedule with the TPU's floors
    (solver_params), an optional solid and SurfaceBc P."""
    from ..core.grid import Grid
    from ..core import bc as bcs
    from ..models.classes import PoissonSimulation

    grid = Grid(level=sim.level, dim=2)
    names = (("left", "right"), ("bottom", "top"))
    sides = []
    for ax in range(2):
        pair = []
        for sd in range(2):
            b = sim.boundaries.get(names[ax][sd], {}).get("P")
            if b is None:
                pair.append(bcs.Neumann())
            elif b[0] == "dirichlet":
                pair.append(bcs.Dirichlet(_bc_value(b[1], 2)))
            else:
                pair.append(bcs.Neumann(_bc_value(b[1], 2)))
        sides.append(tuple(pair))
    d = sim.approx_projection or sim.projection
    d = {k: v for k, v in d.items() if k != "nrelax"}
    params = solver_params(d, 2)
    solid = sim.solids[0] if sim.solids else None
    sbc = sim.surface_bcs.get("P")
    if solid is not None and sbc is not None and sbc[0] == "dirichlet":
        # SurfaceBc P Dirichlet closes the domain: test/poisson/dirichlet
        # solves inside the boundary curve, the Solid's positive side
        solid = sim.solids_raw[0]
    ps = PoissonSimulation(grid, p_bc=bcs.FieldBC(tuple(sides)),
                           params=params, solid_phi=solid, surface_bc=sbc,
                           device=device, dtype=dtype)
    ps.errors = sim.errors
    return ps.init(Div=sim.inits["Div"])
