"""The port's nested ranges leave the trace's readings as they were.

The port opens ranges inside its spans (`phd.weight_inputs.*`,
`record.read`) at operator scope, so a CUDA trace holds their host events
and no device-side annotation event for them. On a synthetic trace, every
per-layer reader of BENCHMARK.json and the breakdown read the same with and
without those host events. On a CPU frame of a cell's program, every user
range the frame opens is one that trace.SPANS names (its device-side
annotation is dropped from the device events), and every other range is a
nested one of the port's list: a user range added later and missing from
trace.SPANS would be counted as device launches and busy time."""

import json
import types

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from monorfs_tpu_torch import spans
from rfsbench import bench, harness, trace

from . import small

NESTED = ("phd.weight_inputs.map_estimate", "phd.weight_inputs.mixture_ll", "phd.weight_inputs.assoc",
          "record.read")


class Event:
    def __init__(self, name, device_type, start, end, host_us=0.0, device_us=0.0):
        self.name, self.device_type = name, device_type
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.cpu_time_total, self.device_time_total = host_us, device_us


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _frame(o, with_nested):
    """One frame's events from microsecond `o`: the spans on the host, the
    kernels and copies on the device with the spans' annotations around
    them, and the nested ranges on the host if asked."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    host = [("vehicle", 0, 120, 0), ("phd.predict", 120, 170, 6), ("phd.fused_stage", 170, 200, 9),
            ("phd.weight_inputs", 200, 420, 260), ("phd.beam_scan", 420, 430, 0),
            ("phd.normalise_resample", 430, 460, 5), ("record", 460, 900, 3)]
    out = [Event(n, cpu, o + a, o + b, b - a, d) for n, a, b, d in host]
    kernels = [("vectorized_elementwise_kernel<Mul>", 130, 136), ("fused_stage_kernel", 180, 189),
               ("vectorized_elementwise_kernel<Add>", 210, 300), ("radixSortKVInPlace", 305, 330),
               ("elementwise_kernel<Where>", 335, 480), ("beam_scan_block_kernel", 482, 520),
               ("reduce_kernel<Sum>", 522, 527), ("Memcpy DtoH (Device -> Pinned)", 880, 883)]
    out += [Event(n, cuda, o + a, o + b) for n, a, b in kernels]
    annotations = [("phd.predict", 130, 136), ("phd.weight_inputs", 210, 480), ("phd.beam_scan", 482, 520),
                   ("phd.normalise_resample", 522, 527), ("record", 880, 883)]
    out += [Event(n, cuda, o + a, o + b) for n, a, b in annotations]
    if with_nested:
        nested = [("phd.weight_inputs.map_estimate", 200, 240, 25), ("phd.weight_inputs.mixture_ll", 240, 330, 90),
                  ("phd.weight_inputs.assoc", 330, 420, 145), ("record.read", 460, 890, 3)]
        out += [Event(n, cpu, o + a, o + b, b - a, d) for n, a, b, d in nested]
    return out


def _readings(with_nested):
    frames = 3
    events = [ev for f in range(frames) for ev in _frame(1000 * f, with_nested)]
    run = bench.Run()
    run.trace = trace.Trace(Prof(events), frames, 3000e-6)
    run.frames, run.window_s, run.traced = frames, 3000e-6, True
    run.shapes = dict(P=800, K0=500, M=48, B=200, C=8, n_words=4)
    run.peaks = json.loads((harness.BENCH / "peaks.json").read_text())
    run.work = [{"index": 0, "ops": {"weight": 1e9, "beam": 2e8}, "fused_ms": 0.004}]
    per_layer = json.loads((harness.ROOT / "BENCHMARK.json").read_text())["per_layer"]
    got = {m["name"]: bench.read_metric(harness.BENCH, m["name"], run) for m in per_layer}
    t = run.trace
    got.update(busy_s=t.busy_s(), device_ops=t.device_ops(), idle_gaps=t.idle_gaps(), device=t.device,
               spans=t.spans, host=dict(t.span_host_us), dev=dict(t.span_device_us))
    return got


def test_the_nested_ranges_leave_every_reading_as_it_was():
    before, after = _readings(False), _readings(True)
    assert after == before
    assert before["launches_per_frame"] == 7 and before["weight_inputs_ms"] == 0.26
    assert before["idle_gaps"][0][0] == "record"  # the wait for the frame, named as before


def test_a_frame_opens_user_ranges_the_trace_knows_and_nested_ranges_the_port_lists():
    b, c, config, traffic = small.cell("chap3-p800")
    inputs = harness.Inputs(config, traffic, 2**31 + 77, small.cpu())
    program = harness.Program(inputs, small.cpu())
    sim, commands = program.simulation(inputs.draws(0, 3), frames=3)
    sim.step(commands[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for cmd in commands[1:]:
            sim.step(cmd)
    ranges = [e for e in prof.events() if "::" not in e.name and
              (e.cpu_parent is None or "::" not in e.cpu_parent.name)]
    user = {e.name for e in ranges if e.is_user_annotation}
    other = {e.name for e in ranges if not e.is_user_annotation}
    assert user <= set(trace.SPANS), user - set(trace.SPANS)
    assert other == set(NESTED) and other <= set(spans.SPANS)
    assert {"phd.weight_inputs", "record", "vehicle"} <= user
