"""What the harness and the reference load: no module whose top-level name
is jax, jaxlib, flax or monorfs_tpu (compared whole: monorfs_tpu_torch is
the port, not the JAX package), and the reference nothing of the port."""

import json
import subprocess
import sys

import pytest

from rfsbench import bench, harness

LIST = "import json, sys; {imports}; print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))"


def _top_levels(imports):
    out = subprocess.run([sys.executable, "-c", LIST.format(imports=imports)], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = _top_levels("import rfsbench.reference.frame, rfsbench.reference.world, rfsbench.work.frame")
    assert not mods & set(bench.FORBIDDEN)
    assert "monorfs_tpu_torch" not in mods


@pytest.mark.parametrize("imports", [
    "import rfsbench.bench, rfsbench.harness, rfsbench.check, rfsbench.trace, rfsbench.readings, "
    "rfsbench.faults",
    "import rfsbench.bench as b, rfsbench.harness as h; [b.read_metric(h.BENCH, m, b.Run()) for m in "
    "[x['name'] for x in json.load(open('BENCHMARK.json'))['per_layer'] + json.load(open('BENCHMARK.json'))"
    "['end_to_end']]]; import monorfs_tpu_torch.sim.simulation",
])
def test_the_harness_and_the_port_load_no_jax(imports):
    mods = _top_levels(imports)
    assert not mods & set(bench.FORBIDDEN), mods & set(bench.FORBIDDEN)


def test_the_check_compares_whole_top_level_names():
    assert bench.forbidden_modules(["monorfs_tpu_torch.sim.simulation", "numpy", "jax_like"]) == []
    assert bench.forbidden_modules(["monorfs_tpu.slam.phd", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "monorfs_tpu"]
