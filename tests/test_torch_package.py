"""The port stands alone: monorfs_tpu_torch/ and chip_smoke.py import
neither jax nor monorfs_tpu, nor PIL, which the GPU machine lacks (AST scan,
imports inside functions included), and chip_smoke.py fails with no
result without a GPU or without the rest of the repository. The kernel
build reports only its own logs."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "monorfs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "monorfs_tpu", "PIL")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _smoke(cwd):
    # hide every GPU, so the test means the same on a host that has one
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_chip_smoke_fails_without_gpu():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_build_log_reads_only_the_current_build(tmp_path, monkeypatch):
    """_build.build_log gives the ptxas logs of the current sources' tag,
    not those of an older build left in the same directory."""
    from monorfs_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    (tmp_path / f"beam_scan_{_build._tag()}.log").write_text("current")
    (tmp_path / "beam_scan_0123456789abcdef.log").write_text("stale")
    assert _build.build_log() == "current"


ENTRY_POINTS = {
    "cli": "from monorfs_tpu_torch.cli import main; "
           "main(['-f', 'assets/linear1d.world', '-c', 'assets/mov1d.in', '--frames', '1'])",
    "simulation": "from monorfs_tpu_torch.sim import Simulation; "
                  "from monorfs_tpu_torch.config import Config; from monorfs_tpu_torch.io import World; "
                  "Simulation(Config(), World.from_file('assets/sim3d.world'), [])",
    "postanalysis": "import sys; from monorfs_tpu_torch.postanalysis import main; main(['-f', sys.argv[1]])",
    "bench_flagship": "from monorfs_tpu_torch.bench_flagship import main; main(['--particles', '8'])",
    "comm_volume": "from monorfs_tpu_torch.tools.comm_volume import main; main(['--ranks', '1'])",
    "viewer": "import sys; from monorfs_tpu_torch.viewer import main; main(['-f', sys.argv[1]])",
    "manipulator": "from monorfs_tpu_torch.manipulator import main; "
                   "main(['-f', 'assets/sim3d.world', '-c', 'assets/mov3d.in'])",
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_gpu(entry, tmp_path):
    """cli.main, Simulation, postanalysis, bench_flagship, comm_volume,
    viewer.main and manipulator.main default to the card: with no GPU visible and no device given they raise,
    and run nothing on the CPU."""
    record = tmp_path / "rec.zip"
    if entry in ("postanalysis", "viewer"):
        from monorfs_tpu_torch.cli import main

        main(["-f", "assets/linear1d.world", "-c", "assets/mov1d.in", "-y", "--frames", "2",
              "--device", "cpu", "-r", str(record)])
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-c", ENTRY_POINTS[entry], str(record)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert "CUDA device requested" in r.stderr
    assert "finished running" not in r.stdout and "ATE" not in r.stdout
