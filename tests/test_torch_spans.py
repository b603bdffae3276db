"""The port's profiler spans and the frame's host reads.

A few frames of a small chap3-shaped Simulation (the PRM3D world of the
benchmark's cells, 4 particles) run on the CPU under torch.profiler: the
weight inputs open their three nested ranges once a frame, which together
hold all of `phd.weight_inputs`; the history opens `record.read` once a
frame, which holds every read of `record`; every range a frame opens is
named in spans.SPANS; Simulation.reads counts each device-to-host read of
the frame path. Then the port's sources: every range they open is named in
spans.SPANS."""

import collections
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monorfs_tpu_torch import spans
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import World, parse_commands
from monorfs_tpu_torch.sim import Simulation
from monorfs_tpu_torch.slam import phd

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHD = phd.PHDConfig(num_particles=4, max_components=64, max_measurements=48, gate_top=8, estimate_cap=16,
                    beam_width=16, beam_candidates=4)
WARM, FRAMES = 2, 3
WEIGHT_PARTS = ("phd.weight_inputs.map_estimate", "phd.weight_inputs.mixture_ll", "phd.weight_inputs.assoc")
# reads a frame: pose, odometry, mask, z, labels, landmarks, visible, detected;
# with phd the best slot, the best map, every pose and the ancestors, with
# odometry the dead-reckoned pose
READS = {"phd": 12, "odometry": 9}


def _sim(algorithm="phd", collect_history=True):
    commands = parse_commands((ROOT / "assets" / "mov3d.in").read_text())[: WARM + FRAMES]
    return Simulation(Config(), World.from_file(ROOT / "assets" / "sim3d.world"), commands,
                      algorithm=algorithm, particles=4, dtype=np.float32, phd_config=PHD,
                      collect_history=collect_history, device="cpu"), commands


def _ranges(prof):
    """The profiler ranges the frames opened: events that are no operator
    and lie inside none."""
    out = []
    for e in prof.events():
        parent, inside_op = e.cpu_parent, False
        while parent is not None:
            inside_op = inside_op or "::" in parent.name
            parent = parent.cpu_parent
        if "::" not in e.name and not inside_op:
            out.append(e)
    return out


@pytest.mark.parametrize("algorithm,collect_history", [("phd", True), ("phd", False), ("odometry", True)])
def test_a_frame_opens_its_spans_and_counts_its_reads(algorithm, collect_history):
    sim, commands = _sim(algorithm, collect_history)
    for cmd in commands[:WARM]:
        sim.step(cmd)
    reads0 = sim.reads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for cmd in commands[WARM:]:
            sim.step(cmd)
    assert sim.reads - reads0 == (READS[algorithm] if collect_history else 0) * FRAMES

    ranges = _ranges(prof)
    assert {e.name for e in ranges} <= set(spans.SPANS)
    count = collections.Counter(e.name for e in ranges)
    nested = WEIGHT_PARTS if algorithm == "phd" else ()
    nested += ("record.read",) if collect_history else ()
    for name in nested:
        assert count[name] == FRAMES, name
    if algorithm == "phd":
        for e in (e for e in ranges if e.name == "phd.weight_inputs"):
            assert [c.name for c in e.cpu_children] == list(WEIGHT_PARTS)  # nothing between them
    for e in (e for e in ranges if e.name == "record"):
        assert [c.name for c in e.cpu_children] == ["record.read"]  # every read of the history inside it


def test_the_sources_open_only_named_spans():
    """Every range the port's sources open is in spans.SPANS: a literal
    name, or a stage of the smoother's gradient ascent with its `.fan` and
    `.grad` ranges."""
    text = "\n".join(p.read_text() for p in sorted((ROOT / "monorfs_tpu_torch").rglob("*.py")))
    opened = set(re.findall(r'(?:record_function|nested)\("([^"{}]+)"\)', text))
    stages = set(re.findall(r'_ascend\([^()]*"([a-z_.]+)"\)', text))
    assert 'record_function(f"{stage}.fan")' in text and 'record_function(f"{stage}.grad")' in text
    opened |= {f"{s}.{part}" for s in stages for part in ("fan", "grad")}
    assert {"phd.weight_inputs", "record.read", "loopy.sweep.map.fan", "loopy.refit.grad"} <= opened
    assert opened == set(spans.SPANS)
    assert len(spans.SPANS) == len(set(spans.SPANS))


def test_a_nested_range_has_no_device_annotation():
    """A nested range is recorded at operator scope: the profiler gives it
    no user annotation, so a CUDA trace gives it no device-side event."""
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("phd.weight_inputs"):
            with spans.nested("phd.weight_inputs.assoc"):
                (x + 1).sum()
    by = {e.name: e for e in prof.events()}
    assert by["phd.weight_inputs.assoc"].cpu_parent.name == "phd.weight_inputs"
    assert by["phd.weight_inputs"].is_user_annotation
    assert not by["phd.weight_inputs.assoc"].is_user_annotation
