"""Checkpoints and the .gfs round trip on the port (gerris_tpu_torch/
events/outputs.py, utils/gfs_config.py), on the CPU in float64.

* tests/test_roundtrip.py's two cases on the port: parse -> run -> the
  end.gfs dump -> parse -> resume.  Both fail on the JAX package: its
  reader appends .npz to every OutputSimulation name
  (gfs_config.py:1872-1875), so a .gfs dump never reaches
  save_checkpoint's text branch; the port passes the name through.
* Checkpoints cross between the packages bit for bit, both ways: a
  uniform simulation, and a composite AMR one on a mesh whose leaves
  the JAX package already grades."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from gerris_tpu.events import outputs as jout  # noqa: E402
from gerris_tpu.utils import gfs_config as J  # noqa: E402

from gerris_tpu_torch.events import outputs as out  # noqa: E402
from gerris_tpu_torch.utils import gfs_config as G  # noqa: E402

SRC = """
1 0 GfsSimulation GfsBox GfsGEdge {} {
    Refine 5
    SourceViscosity 1e-2
    Init {} {
        U = 0.1*sin(2.*M_PI*x)*cos(2.*M_PI*y)
        V = -0.1*cos(2.*M_PI*x)*sin(2.*M_PI*y)
    }
    Time { iend = IEND }
    OutputSimulation { start = end } DUMP
}
GfsBox {}
"""


def _build(text, defines=None):
    return G.build_simulation(G.parse_gfs(text, defines or {}, strict=True),
                              device="cpu")


def test_gfs_text_roundtrip(tmp_path):
    dump = str(tmp_path / "end.gfs")
    sim = _build(SRC, {"IEND": "3", "DUMP": dump})
    sim.run()
    assert sim.time.i == 3
    text = open(dump).read()
    assert "InitCheckpoint" in text
    assert "SourceViscosity 1e-2" in text
    sim2 = _build(text)
    assert sim2.errors == []
    assert sim2.time.i == 3
    for k in ("U", "V", "P"):
        assert torch.equal(sim.state[k], sim2.state[k]), k
    simc = _build(SRC, {"IEND": "5", "DUMP": str(tmp_path / "e2.gfs")})
    simc.run()
    sim2.time.iend = 5
    sim2.run()
    for k in ("U", "V"):
        assert float((simc.state[k] - sim2.state[k]).abs().max()) < 1e-12, k


def test_roundtrip_twice_idempotent(tmp_path):
    d1 = str(tmp_path / "d1.gfs")
    sim = _build(SRC, {"IEND": "1", "DUMP": d1})
    sim.run()
    sim2 = _build(open(d1).read())
    d2 = str(tmp_path / "d2.gfs")
    out.save_checkpoint(d2, sim2)
    text2 = open(d2).read()
    assert text2.count("InitCheckpoint") == 1
    sim3 = _build(text2)
    assert torch.equal(sim2.state["U"], sim3.state["U"])


def test_output_simulation_name_passes_through():
    """The reference's reader makes OutputSimulation { } end.gfs write
    end.gfs.npz, an array file (gfs_config.py:1872-1875); the port's
    keeps end.gfs, the re-parseable text dump."""
    text = SRC.replace("IEND", "1").replace("DUMP", "end.gfs")
    js = J.build_simulation(J.parse_gfs(text))
    ts = _build(text)
    jev = [e for e in js.events if type(e).__name__ == "OutputSimulation"]
    tev = [e for e in ts.events if type(e).__name__ == "OutputSimulation"]
    assert jev[0].file == "end.gfs.npz" and tev[0].file == "end.gfs"


def test_uniform_checkpoints_cross_both_ways(tmp_path):
    text = SRC.replace("IEND", "2").replace("DUMP", "x.npz")
    rng = np.random.default_rng(11)
    js = J.build_simulation(J.parse_gfs(text))
    ts = _build(text)
    for k in ("U", "V", "P"):
        js.state[k] = jnp.asarray(rng.standard_normal((32, 32)))
    js.time.t, js.time.i = 0.375, 7
    jout.save_checkpoint(str(tmp_path / "j.npz"), js)
    out.load_checkpoint(str(tmp_path / "j.npz"), ts)
    assert (ts.time.t, ts.time.i) == (0.375, 7)
    for k in js.state:
        assert np.array_equal(ts.state[k].numpy(), np.asarray(js.state[k])), k
    for k in ("U", "V", "P"):
        ts.state[k] = torch.as_tensor(rng.standard_normal((32, 32)))
    ts.time.t, ts.time.i = 0.5, 9
    out.save_checkpoint(str(tmp_path / "t.npz"), ts)
    js2 = J.build_simulation(J.parse_gfs(text))
    jout.load_checkpoint(str(tmp_path / "t.npz"), js2)
    assert (js2.time.t, js2.time.i) == (0.5, 9)
    for k in ts.state:
        assert np.array_equal(np.asarray(js2.state[k]), ts.state[k].numpy()), k


def _amr_pair():
    """A JAX and a port AMRSimulation on the same static mesh, levels 3-5,
    graded by construction (level 5 for x < -1/4, 4 for x < 0, 3 else)."""
    import dataclasses
    from gerris_tpu.core import bc as jbc
    from gerris_tpu.core.grid import Grid as JGrid
    from gerris_tpu.models import amr_ns as jamr
    from gerris_tpu.models import ns as jns
    from gerris_tpu.solvers.composite import CompositeGrid as JCG
    from gerris_tpu_torch.core import bc as tbc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import amr_ns
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.composite import CompositeGrid

    def want(x, y, l):
        return x < (0.0 if l == 3 else -0.25)
    jcfg = jns.NSConfig(grid=JGrid(level=5), u_bcs=(jbc.velocity_bc(0, 2),
                                                    jbc.velocity_bc(1, 2)))
    tcfg = ns.NSConfig(grid=Grid(level=5), u_bcs=(tbc.velocity_bc(0, 2),
                                                  tbc.velocity_bc(1, 2)))
    js = jamr.AMRSimulation(jcfg, mesh=JCG.from_refine_fn(
        JGrid(level=3), 5, want))
    ts = amr_ns.AMRSimulation(tcfg, mesh=CompositeGrid.from_refine_fn(
        Grid(level=3), 5, want), device="cpu")
    del dataclasses
    return js, ts


def test_amr_checkpoints_cross_both_ways(tmp_path):
    js, ts = _amr_pair()
    assert np.array_equal(js.depth, ts.depth)
    rng = np.random.default_rng(12)
    fields = {n: rng.standard_normal((32, 32)) for n in ("U", "V", "P")}
    js.init(**fields)
    js.time.t, js.time.i = 0.25, 4
    jout.save_checkpoint(str(tmp_path / "j.npz"), js)
    out.load_checkpoint(str(tmp_path / "j.npz"), ts)
    assert np.array_equal(ts.depth, np.asarray(js.depth))
    assert ts.n_leaves() == int(sum(np.asarray(m).sum()
                                    for m in js.leaf.values()))
    for k, stack in js.state.items():
        assert sorted(stack) == sorted(ts.state[k]), k
        for l in stack:
            assert np.array_equal(ts.state[k][l].numpy(),
                                  np.asarray(stack[l])), (k, l)
    for k in ("U", "V", "P"):
        for l in ts.state[k]:
            ts.state[k][l] = torch.as_tensor(
                rng.standard_normal(tuple(ts.state[k][l].shape)))
    out.save_checkpoint(str(tmp_path / "t.npz"), ts)
    js2, _ = _amr_pair()
    jout.load_checkpoint(str(tmp_path / "t.npz"), js2)
    assert np.array_equal(np.asarray(js2.depth), ts.depth)
    for k, stack in ts.state.items():
        for l in stack:
            assert np.array_equal(np.asarray(js2.state[k][l]),
                                  stack[l].numpy()), (k, l)


def test_single_device_rank_files_load_in_both_packages(tmp_path):
    """parallel/checkpoint's rank files: the port writes {prefix}-0.npz in
    the JAX layout, which the JAX package reloads, and the port reloads
    the JAX package's."""
    from gerris_tpu.parallel import checkpoint as jck
    from gerris_tpu_torch.parallel import checkpoint as tck
    rng = np.random.default_rng(13)
    state = {"U": rng.standard_normal((16, 16)),
             "T": rng.standard_normal((16, 16)).astype(np.float32)}
    files = tck.save_sharded(str(tmp_path / "p"), {
        k: torch.as_tensor(v) for k, v in state.items()}, meta={"t": 1.5})
    assert [os.path.basename(f) for f in files] == ["p-0.npz"]
    back = jck.load_sharded(str(tmp_path / "p"))
    for k, v in state.items():
        assert np.array_equal(np.asarray(back[k]), v), k
    jck.save_sharded(str(tmp_path / "q"), {k: jnp.asarray(v)
                                           for k, v in state.items()})
    got = tck.load_sharded(str(tmp_path / "q"), device="cpu")
    for k, v in state.items():
        assert got[k].dtype == torch.as_tensor(v).dtype
        assert np.array_equal(got[k].numpy(), v), k
    with pytest.raises(NotImplementedError, match="slice 9"):
        tck.load_sharded(str(tmp_path / "q"), mesh=object(), device="cpu")
