"""The .gts reader and level sets (gerris_tpu_torch/physics/gts.py)
against the JAX package's gerris_tpu/physics/gts.py on the CPU in
float64, on a closed octahedron that each test writes to its tmp_path
(the reference's test/hexagon/hexagon.gts is not in the repository, and
tests/test_gts.py skips without it).  Its four equator vertices lie on
the z = 0 plane, the case the section's vertex handling and duplicate
filter are for.  Values to 1e-12; the fractions of the section's
polygon (the fluid outside it) against the polygon's area."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import gts as jgts  # noqa: E402
from gerris_tpu.physics import solid as jsolid  # noqa: E402

from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import gts, solid  # noqa: E402

VERTS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], float)
FACES = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                  [1, 2, 5], [3, 1, 5], [0, 3, 5]])
SCALE = 0.3


def write_octahedron(path):
    """The octahedron as a GTS file: vertices, edges (1-based vertex
    pairs) and faces (1-based edge triples e1 e2 e3 with e1 = (a, b), e2
    = (b, c), e3 = (c, a))."""
    edges, faces = [], []
    for tri in FACES:
        ids = []
        for k in range(3):
            e = (int(tri[k]), int(tri[(k + 1) % 3]))
            key = tuple(sorted(e))
            if key not in [tuple(sorted(x)) for x in edges]:
                edges.append(e)
            ids.append([tuple(sorted(x)) for x in edges].index(key) + 1)
        faces.append(ids)
    lines = [f"{len(VERTS)} {len(edges)} {len(faces)}"]
    lines += [" ".join(f"{c:g}" for c in v) for v in VERTS]
    lines += [f"{a + 1} {b + 1}" for a, b in edges]
    lines += [" ".join(map(str, f)) for f in faces]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def octa(tmp_path):
    return write_octahedron(tmp_path / "octahedron.gts")


def test_read_and_section_match_jax(octa):
    """The vertices, the faces' vertex triples and the z = 0 section (the
    scaled square of 4 segments, each once) as the JAX package reads
    them."""
    v, f = gts.read_gts(octa)
    jv, jf = jgts.read_gts(octa)
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    assert v.shape == (6, 3) and f.shape == (8, 3)
    segs = gts.section_z0(gts.transform(v, scale=SCALE), f)
    jsegs = jgts.section_z0(jgts.transform(jv, scale=SCALE), jf)
    assert np.array_equal(segs, jsegs) and segs.shape == (4, 2, 2)


def _grid_points(n, lo=-0.5, hi=0.5, dim=2):
    c = (np.arange(n) + 0.5) / n * (hi - lo) + lo
    return np.meshgrid(*([c] * dim), indexing="ij")


def test_polygon_phi_matches_jax(octa):
    """The section's level set (positive inside the square, the distance
    to its nearest edge) at 40^2 points and at the centre, to 1e-12."""
    v, f = gts.read_gts(octa)
    segs = gts.section_z0(gts.transform(v, scale=SCALE), f)
    phi, jphi = gts.polygon_phi(segs), jgts.polygon_phi(segs)
    X, Y = _grid_points(40)
    ref = np.asarray(jphi(jnp.asarray(X), jnp.asarray(Y)))
    got = phi(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
    assert np.max(np.abs(ref - got)) <= 1e-12
    assert float(phi(0.0, 0.0)) == pytest.approx(SCALE / math.sqrt(2.0),
                                                 rel=1e-12)
    assert float(phi(0.45, 0.45)) < 0.0
    f32 = phi(torch.from_numpy(X).float(), torch.from_numpy(Y).float())
    assert f32.dtype == torch.float32 and bool(torch.isfinite(f32).all())


def test_polyhedron_phi_matches_jax(octa):
    """The 3D level set of the scaled octahedron at 16^3 points and at
    points on and off its axes (the jittered ray parity keeps the centre,
    whose +z ray meets the apex, inside), to 1e-12."""
    v, f = gts.read_gts(octa)
    vs = gts.transform(v, scale=SCALE)
    phi, jphi = gts.polyhedron_phi(vs, f), jgts.polyhedron_phi(vs, f)
    X, Y, Z = _grid_points(16, dim=3)
    ref = np.asarray(jphi(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z)))
    got = phi(*(torch.from_numpy(a) for a in (X, Y, Z))).numpy()
    assert np.max(np.abs(ref - got)) <= 1e-12
    assert float(phi(0.0, 0.0, 0.0)) == pytest.approx(SCALE / math.sqrt(3.0),
                                                      rel=1e-12)
    assert float(phi(0.45, 0.0, 0.0)) == pytest.approx(-0.15, rel=1e-12)
    vol = (got > 0).mean()
    assert vol == pytest.approx(4.0 / 3.0 * SCALE ** 3, rel=0.1)


def test_surface_phi_fractions_match_jax(octa):
    """surface_phi in 2D as a solid (the fluid outside the section:
    flip), its fractions at level 6 against the JAX package's to 1e-12 and
    the fluid area against 1 minus the square's 2 (0.3)^2; in 3D the
    level set as read, scaled and translated."""
    phi = gts.surface_phi(octa, dim=2, scale=SCALE, flip=True)
    jphi = jgts.surface_phi(octa, dim=2, scale=SCALE, flip=True)
    a, s = solid.solid_fractions(Grid(6), phi, device="cpu")
    ja, js = jsolid.solid_fractions(JGrid(6), jphi)
    assert np.max(np.abs(np.asarray(ja) - a.numpy())) <= 1e-12
    for jf, tf in zip(js, s):
        assert np.max(np.abs(np.asarray(jf) - tf.numpy())) <= 1e-12
    area = float(a.sum()) / 64 ** 2
    assert area == pytest.approx(1.0 - 2.0 * SCALE ** 2, rel=1e-3)
    p3 = gts.surface_phi(octa, dim=3, scale=SCALE, translate=(0.1, 0, 0))
    assert float(p3(0.1, 0.0, 0.0)) == pytest.approx(SCALE / math.sqrt(3.0),
                                                     rel=1e-12)
