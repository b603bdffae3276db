"""The cell's inputs and the port's path, driven frame by frame.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
file, configs/<config>.json, and its traffic mix is workloads/<cell>.json.
The configuration names a world file and a command file, which the
simulated vehicle runs, and holds every setting as it is run. The traffic says how many particles, which frames the correctness
sample and the traced slice take, and the limits of `correct`.

Every input is made here from the run's seed, never by the port: the
commands, the draws of each sequence (vehicle noise, detections, clutter,
motion noise, the resampling uniform) on the device from a torch.Generator
seeded per sequence. The same inputs go to the
reference (reference/frame.py). The port is driven as its command line
drives it: a `Simulation` with its per-frame history, stepped one frame at a
time; a new sequence starts when one ends."""

import json
import pathlib

import numpy as np
import torch

from .reference import frame as ref
from .reference.world import World as RefWorld
from .reference.world import parse_commands

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_cell(name, root=ROOT):
    """(cell entry of BENCHMARK.json, configuration, traffic)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((BENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def seq_seed(seed, seq, *salt):
    """A 63-bit seed for sequence `seq` of a run seeded `seed` (any whole
    number) and an optional salt."""
    words = [int(seed) % 2**64, int(seq)] + [int(s) for s in salt]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def dtype_of(config):
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


class Inputs:
    """The inputs of one configuration: world, commands, draws; all from
    files under the benchmark and the run's seed."""

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.particles = traffic["particles"]
        self.dtype = dtype_of(config)
        self.model = ref.pose_model(config)
        self.world = RefWorld.from_file(BENCH / config["world"])
        self.commands = parse_commands((BENCH / config["commands"]).read_text())
        self.frames = len(self.commands)
        self.landmarks = max(len(self.world.landmarks), 1)
        vp = ref.vehicle_params(config, self.model, torch.float64, "cpu")
        self.clutter_count = float(vp.clutter_count)

    def draws(self, seq, frames=None):
        """Every draw of a sequence, made on the device in one go, each
        tensor with a leading frame axis."""
        n = frames or self.frames
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seq_seed(self.seed, seq, 0))
        kw = dict(generator=gen, dtype=self.dtype, device=self.device)
        odo, d = self.model.pose.odo_dim, self.model.meas_dim
        p = self.particles
        lm, mc = self.landmarks, self.config["max_clutter"]
        rate = torch.full((n,), self.clutter_count, dtype=self.dtype, device=self.device)
        return dict(
            odo_normals=torch.randn((n, odo), **kw),
            detect_u=torch.rand((n, lm), **kw),
            meas_normals=torch.randn((n, lm, d), **kw),
            clutter_draw=torch.poisson(rate, generator=gen),
            clutter_u=torch.rand((n, mc, d), **kw),
            motion_normals=torch.randn((n, p, odo), **kw),
            resample_u=torch.rand((n,), **kw),
        )


class SequenceDraws:
    """The `draws` a Simulation takes: frame(i) -> that frame's tensors."""

    def __init__(self, tensors):
        self.tensors = tensors

    def frame(self, i):
        return {name: t[i] for name, t in self.tensors.items()}


def descriptor_lines(descriptor):
    """The configuration's settings in the `Name: value` cfg format."""
    out = []
    for name, v in descriptor.items():
        if isinstance(v, bool):
            out.append(f"{name}: {v}")
        elif isinstance(v, list):
            rows = v if v and isinstance(v[0], list) else [v]
            out.append(f"{name}: [" + "; ".join(" ".join(repr(float(x)) for x in r) for r in rows) + "]")
        else:
            out.append(f"{name}: {v}")
    return out


class Program:
    """The port, built for a configuration: a new Simulation per sequence,
    as its command line builds one."""

    def __init__(self, inputs, device):
        from monorfs_tpu_torch.config import Config
        from monorfs_tpu_torch.io import World

        self.inputs, self.device = inputs, device
        config = inputs.config
        self.cfg = Config()
        self.cfg.apply_descriptor(descriptor_lines(config["descriptor"]))
        w = inputs.world
        self.world = World(pose=np.asarray(w.pose), landmarks=np.asarray(w.landmarks),
                           measurer_params=np.asarray(w.measurer_params))

    def simulation(self, draws, frames=None):
        from monorfs_tpu_torch.sim.simulation import Simulation

        inp, config = self.inputs, self.inputs.config
        commands = inp.commands[: frames or inp.frames]
        sim = Simulation(self.cfg, self.world, commands, algorithm=config["algorithm"],
                         particles=inp.particles, dtype=np.dtype(config["dtype"]),
                         collect_history=True, device=self.device, draws=SequenceDraws(draws))
        got = {f: getattr(sim.phd_cfg, f) for f in config["phd"]}
        if got != config["phd"]:
            raise RuntimeError(f"the port built {got}, the configuration states {config['phd']}")
        return sim, commands


class Capture:
    """What the reference needs of a captured frame: the state the step
    started from and the one it handed on, the true pose before and after,
    the odometry and measurement set the step received (read by wrapping
    the Simulation's own vehicle frame); no copy is made."""

    def __init__(self):
        self.frames = {}
        self._current = None

    def attach(self, sim):
        inner = sim._vehicle_frame

        def vehicle_frame(draws):
            out = inner(draws)
            if self._current is not None:
                self._current["vehicle"] = out[:3]
            return out

        sim._vehicle_frame = vehicle_frame

    def before(self, keys, sim):
        self._current = dict(pre=sim.nstate, true_pre=sim.vstate.pose)
        for key in keys:
            self.frames[key] = self._current

    def after(self, sim):
        if self._current is not None:
            self._current.update(post=sim.nstate, true_post=sim.vstate.pose)
            self._current = None
