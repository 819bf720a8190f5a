"""The Morton block tables (gerris_tpu_torch/core/blocks.py) against the
JAX package's (gerris_tpu/core/blocks.py): keys, grading, marks and
neighbours equal bit for bit, the native library and the numpy versions
alike, the library built into build/gerris_tpu_torch/, never under
native/, and the layouts refused without it."""
import os

import numpy as np
import pytest

from gerris_tpu.core import blocks as JB

from gerris_tpu_torch.core import blocks as B

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_native_library_builds_into_the_build_tree():
    """g++ builds native/block_table.cpp into build/gerris_tpu_torch/ and
    the library loads; nothing of the port's lands under native/."""
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    assert B.native_loaded()
    so = B.library_path()
    assert so.exists()
    assert so.parent == __import__("pathlib").Path(ROOT) / "build" \
        / "gerris_tpu_torch"
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before


def test_layouts_raise_without_the_native_library(monkeypatch):
    """Without the library the grading, the marks and the neighbour
    lookup raise: the numpy versions are the tests' oracle, never a
    silent runtime fallback."""
    lay = B.BlockLayout.uniform(1, (1, 1))
    monkeypatch.setattr(B, "_lib", lambda: None)
    for call in (lay.grade, lay.neighbors,
                 lambda: lay.apply_marks(np.zeros(len(lay), np.int8))):
        with pytest.raises(RuntimeError, match="block-table library"):
            call()


@pytest.mark.parametrize("native", [True, False])
def test_morton_keys_equal_the_reference(native):
    rng = np.random.default_rng(0)
    ix = rng.integers(0, 1 << 20, 1000)
    iy = rng.integers(0, 1 << 20, 1000)
    m = B.morton_encode_2d(ix, iy, native=native)
    assert np.array_equal(m, JB.morton_encode_2d(ix, iy, native=native))
    dx, dy = B.morton_decode_2d(m, native=native)
    assert np.array_equal(dx, ix) and np.array_equal(dy, iy)
    keys = B.make_key(rng.integers(0, 12, 1000), m)
    assert np.array_equal(keys, JB.make_key(JB.key_level(keys),
                                            JB.key_morton(keys)))
    assert np.array_equal(B.key_level(keys), JB.key_level(keys))
    assert np.array_equal(B.key_morton(keys), JB.key_morton(keys))


def _refined(mod, root, seed):
    """A layout refined twice at random blocks (grading between)."""
    rng = np.random.default_rng(seed)
    lay = mod.BlockLayout.uniform(2, root=root)
    for _ in range(2):
        marks = (rng.random(len(lay)) < 0.2).astype(np.int8)
        lay = lay.apply_marks(marks).grade()
    return lay


@pytest.mark.parametrize("root,seed", [((1, 1), 0), ((1, 3), 1),
                                       ((2, 1), 2)])
def test_marks_grading_and_neighbours_equal_the_reference(root, seed):
    """Refine / coarsen marks, the 2:1 grading fixpoint (with corners) and
    the neighbour tables on boxes of 1 x 1, 1 x 3 and 2 x 1 roots, bit for
    bit: the native library against the reference's, and the numpy
    versions against the reference's numpy versions.  The reference's own
    two gradings disagree on these layouts (its numpy fixpoint refines
    more; ROADMAP Queue 3), and the port keeps both as they are."""
    lay, jlay = _refined(B, root, seed), _refined(JB, root, seed)
    assert np.array_equal(lay.keys, jlay.keys)
    idx, delta = lay.neighbors()
    jidx, jdelta = jlay.neighbors()
    assert np.array_equal(idx, jidx) and np.array_equal(delta, jdelta)
    pidx, pdelta = lay._neighbors_py()
    assert np.array_equal(idx, pidx) and np.array_equal(delta, pdelta)
    assert np.array_equal(lay.grade().keys, jlay.grade().keys)
    assert np.array_equal(lay._grade_py(), jlay._grade_py())
    rng = np.random.default_rng(seed + 10)
    marks = rng.integers(-1, 2, len(lay)).astype(np.int8)
    got = lay.apply_marks(marks)
    assert np.array_equal(got.keys, jlay.apply_marks(marks).keys)
    assert np.array_equal(got.keys, np.sort(lay._apply_marks_py(marks)))
    assert np.array_equal(lay._apply_marks_py(marks),
                          jlay._apply_marks_py(marks))
