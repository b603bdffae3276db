"""The traced slice: torch.profiler's events of a steady run of frames,
reduced to what the per-layer readers read.

Device events are the kernels, copies and fills on the card. A span is a
`record_function` range of the port (vehicle, record, phd.predict,
phd.fused_stage, phd.weight_inputs, phd.beam_scan, phd.normalise_resample)
with its host time and the device time of the PyTorch work launched inside
it; the port's hand-written kernels, launched through ctypes, carry no
parent operation, so their events are found by name."""

import collections
from typing import NamedTuple

from torch.autograd import DeviceType

SPANS = ("vehicle", "record", "kinect.frontend", "phd.predict", "phd.fused_stage", "phd.weight_inputs",
         "phd.beam_scan", "phd.normalise_resample")
KERNELS = {"beam": "beam_scan", "fused": "fused_stage_kernel"}  # name: substring of the kernel


class Event(NamedTuple):
    name: str
    start: float  # microseconds on the profiler's clock
    end: float


class Trace:
    """One traced slice of `frames` frames that took `window_s` seconds."""

    def __init__(self, prof, frames, window_s):
        self.frames, self.window_s = frames, window_s
        self.device = []
        self.span_host_us = collections.Counter()
        self.span_device_us = collections.Counter()
        self.spans = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if e.name not in SPANS:
                    self.device.append(Event(e.name, e.time_range.start, e.time_range.end))
            elif e.name in SPANS:
                self.span_host_us[e.name] += e.cpu_time_total
                self.span_device_us[e.name] += e.device_time_total
                self.spans.append(Event(e.name, e.time_range.start, e.time_range.end))
        self.device.sort(key=lambda ev: ev.start)
        self.spans.sort(key=lambda ev: ev.start)

    def kernels(self, which):
        """The device events of a hand-written kernel, in launch order."""
        part = KERNELS[which]
        return [ev for ev in self.device if part in ev.name]

    def busy(self):
        """Merged busy intervals of the device."""
        out = []
        for ev in self.device:
            if out and ev.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ev.end)
            else:
                out.append([ev.start, ev.end])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_ops(self, n=10):
        """[[name, seconds], ...] of the device operations that took most time."""
        by = collections.Counter()
        for ev in self.device:
            by[ev.name[:120]] += (ev.end - ev.start) / 1e6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n=10):
        """[[what the host was doing, seconds], ...]: the device's idle time
        between its busy intervals, summed by the innermost span the host was
        in at the gap's middle ("host" outside every span), largest first."""
        busy = self.busy()
        by = collections.Counter()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a + b)
            inner = [s for s in self.spans if s.start <= mid <= s.end]
            name = min(inner, key=lambda s: s.end - s.start).name if inner else "host"
            by[name] += (b - a) / 1e6
        return [[k, v] for k, v in by.most_common(n)]
