"""The port's command line (gerris_tpu_torch/cli.py, python -m
gerris_tpu_torch) end to end on the CPU in float64: tests/test_misc2.py's
test_cli_run, -D, -e, --dry-run, -V, the default device, a subprocess
run of the lid's text, and the run through the CLI bit-identical to a
Simulation built by hand from the configuration the text states (the
card's gfs phase in chip_smoke.py does the same at 2048^2)."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gerris_tpu_torch import cli  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = ["--device", "cpu", "--dtype", "float64"]

GFS_MINI = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Refine 4
  Time { iend = 2 dtmax = 1e-2 }
  Init {} { U = (-y) V = (x) }
}
GfsBox {}
"""


def test_cli_run(tmp_path, capsys):
    f = tmp_path / "mini.gfs"
    f.write_text(GFS_MINI)
    assert cli.main([str(f), "--dry-run"] + CPU) == 0
    assert "GfsSimulation: level 4" in capsys.readouterr().err
    assert cli.main([str(f), "-e", "OutputScalarNorm U"] + CPU) == 0
    row = capsys.readouterr().out.split()
    assert row[0] == "OutputScalarNorm" and float(row[1]) == 0.02
    assert cli.main(["-V"]) == 0
    assert "torch" in capsys.readouterr().out


def test_defines_and_one_shot_events(tmp_path, capsys):
    f = tmp_path / "lid.gfs"
    f.write_text(chip_smoke.GFS_LID)
    assert cli.main([str(f), "-D", "LEVEL=4", "-D", "DTMAX=0.05", "-D",
                     "IEND=2", "-D", f"DUMP={tmp_path / 'end.gfs'}",
                     "-e", "OutputScalarSum U", "-e",
                     "OutputTime", "-e", "OutputFoo"] + CPU) == 0
    cap = capsys.readouterr()
    lines = [ln for ln in cap.out.splitlines() if ln.startswith("Output")]
    assert len([ln for ln in lines if "OutputScalarNorm" in ln]) == 3
    assert lines[-1].split()[0] == "OutputScalarSum"
    assert "step: 2" in cap.err and "OutputFoo" in cap.err


def test_the_card_is_the_default(tmp_path, monkeypatch):
    """Without a card the CLI raises unless --device cpu is given, as
    core/device.default_device does: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "mini.gfs"
    f.write_text(GFS_MINI)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(f)])


def test_cli_run_is_the_hand_built_simulation(tmp_path):
    """The lid's text through cli.main ends in the state of a Simulation
    built by hand from chip_smoke.gfs_lid_cfg with the same Time, bit for
    bit (the CPU analogue of chip_smoke's gfs phase)."""
    f = tmp_path / "lid.gfs"
    f.write_text(chip_smoke.GFS_LID)
    dump = tmp_path / "end.gfs"
    runs = chip_smoke.gfs_lid_runs(str(f), 5, 0.02, 4, str(dump),
                                   torch.device("cpu"), torch.float64)
    for n in ("U", "V", "P"):
        assert torch.equal(runs["cli"][n], runs["hand"][n]), n
    assert runs["rows_cli"] == runs["rows_hand"]
    assert os.path.exists(dump)


def test_python_m_runs_and_dumps_a_resumable_end(tmp_path):
    """python -m gerris_tpu_torch on the CPU: exit 0, its OutputScalarNorm
    lines those of the in-process run, and its end.gfs dump resumes
    through the reader to the final state."""
    f = tmp_path / "lid.gfs"
    f.write_text(chip_smoke.GFS_LID)
    dump = tmp_path / "end.gfs"
    args = ["-D", "LEVEL=4", "-D", "DTMAX=0.05", "-D", "IEND=3", "-D",
            f"DUMP={dump}"]
    # the child's torch on this process's thread count: the CPU's parallel
    # reductions round by their split
    env = dict(os.environ, PYTHONPATH=ROOT,
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    p = subprocess.run([sys.executable, "-m", "gerris_tpu_torch", str(f)]
                       + args + CPU, capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=300)
    assert p.returncode == 0, p.stderr
    sub = [ln for ln in p.stdout.splitlines()
           if ln.startswith("OutputScalarNorm")]
    sim = chip_smoke.gfs_build(chip_smoke.GFS_LID, torch.device("cpu"),
                               torch.float64, LEVEL=4, DTMAX=0.05, IEND=3,
                               DUMP=str(tmp_path / "x.gfs"))
    rows = []
    sim.events[0].sink = lambda s, row: rows.append(row)
    sim.events[0].file = None
    sim.run()
    assert len(sub) == len(rows) == 4
    for ln, row in zip(sub, rows):
        assert ln == "OutputScalarNorm(U) time: %g first: %g second: %g " \
            "infty: %g" % row
    back = chip_smoke.gfs_resume(str(dump), torch.device("cpu"),
                                 torch.float64)
    for n in ("U", "V", "P"):
        assert torch.equal(back.state[n], sim.state[n]), n
    assert back.time.i == 3
