"""The harness end to end on the CPU at a tiny size: the window, the
traced slice, the check and the line; and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from rfsbench import harness

from . import small


@pytest.mark.parametrize("name,trace", [("chap3-p2000", 0), ("chap3-p800", 1), ("chap3-p2000", 1),
                                        ("chap3-p800", 0)])
def test_a_small_run_is_correct_and_names_no_device_metric(name, trace):
    rc, line, err = small.run(name, seconds=3, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert line["metrics"] == {}  # nothing under a device metric's name from a CPU run
    assert line["device"]["platform"] == "cpu"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"meas", "pose", "weight", "map"}
    assert err.strip().splitlines()[-1].startswith("check map ")


def test_the_same_seed_gives_the_same_inputs():
    b, c, config, traffic = small.cell("chap3-p800")
    a = harness.Inputs(config, traffic, 2**31 + 17, small.cpu())
    z = harness.Inputs(config, traffic, 2**31 + 17, small.cpu())
    for k, v in a.draws(1).items():
        assert v.equal(z.draws(1)[k])
    other = harness.Inputs(config, traffic, 2**31 + 18, small.cpu())
    assert not a.draws(0)["motion_normals"].equal(other.draws(0)["motion_normals"])


def _run_script(cwd, env):
    return subprocess.run([sys.executable, "rfsbench/run.py", "--workload", "chap3-p800", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_script(harness.ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "rfsbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run_script(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_file_keeps_to_its_limits():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = {c["name"] for c in bench["workloads"]}
    for m in bench["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= names
    for c in bench["workloads"]:
        assert (harness.BENCH / "workloads" / f"{c['traffic']}.json").exists()
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()
