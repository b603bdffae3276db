"""The benchmark's cells cut to a size the CPU tests can hold: the same
configuration files and traffic, 4 particles and 2 sampled frames besides
the first (or a sequence cut to its first commands), run through bench.main
on the CPU (its rehearsal: no look for a card, no device metric)."""

import contextlib
import io
import json

import torch

from rfsbench import bench, harness


def cell(name, particles=4, frames=2, length=None, tmp=None):
    """The cell's files with `particles` and `frames` sampled; with `length`
    its sequence is the command file's first `length` commands, written
    under the directory `tmp`."""
    b, c, config, traffic = harness.load_cell(name)
    traffic = dict(traffic, particles=particles, check=dict(traffic["check"], frames=frames))
    if length:
        lines = (harness.BENCH / config["commands"]).read_text().splitlines()[:length]
        path = tmp / f"{name}-{length}.in"
        path.write_text("\n".join(lines) + "\n")
        config = dict(config, commands=str(path))
    return b, c, config, traffic


def run(name, seconds=4, trace=0, seed=2147483999, hook=None, particles=4, **kw):
    """(exit code, the last stdout line as a dict or None, stderr); kw go
    to cell()."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", str(trace)], device_name="cpu", window_hook=hook,
                        cell=cell(name, particles, **kw))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def cpu():
    return torch.device("cpu")
