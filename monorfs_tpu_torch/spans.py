"""The port's profiler spans, named in one place.

Every range the port opens for torch.profiler is named in SPANS, with what
reads it. A reader of a CUDA trace finds a `record_function` range twice: as
a host event with the host time and the device time of the work launched
under it, and as a device-side annotation event of the same name that spans
that work. A reader that counts device events (profile_step.summarise,
rfsbench/trace.py) must drop the annotations by name, so a range it does not
know would be counted as device work. profile_step reads this tuple;
rfsbench/trace.py keeps its own list of the user ranges of a PHD frame.

The ranges nested inside one of them (`nested`) are recorded at operator
scope, as PyTorch's own operators are: the profiler keeps their host events,
with host time and the device time under them, and gives them no device-side
annotation, so the device events of a trace are the same with or without
them. With no profiler on, such a range costs under a microsecond; a
`record_function` range some 15 microseconds."""

import torch

SPANS = (
    "vehicle",  # vehicle_ms (rfsbench); profile_step's stages
    "record",  # profile_step --cli; the benchmark's idle gaps
    "record.read",  # nested: the frame's device-to-host reads (Simulation.reads), the host's wait for the frame
    "phd.predict",  # profile_step; the benchmark's idle gaps
    "phd.fused_stage",  # correct_ms (rfsbench); profile_step
    "phd.weight_inputs",  # weight_inputs_ms (rfsbench); profile_step
    "phd.weight_inputs.map_estimate",  # nested: profile_step (the MAP estimate's sort and gather)
    "phd.weight_inputs.mixture_ll",  # nested: profile_step (both maps' likelihoods at the MAP means)
    "phd.weight_inputs.assoc",  # nested: profile_step (the gated association likelihood, the beam's options)
    "phd.beam_scan",  # profile_step; the benchmark's idle gaps
    "phd.normalise_resample",  # profile_step; the benchmark's idle gaps
    "kinect.frontend",  # profile_step --kinect
    "graph.assoc",  # profile_step --graph
    "graph.hungarian",  # profile_step --graph
    "graph.auction",  # profile_step --graph scan-da
    "graph.solve",  # profile_step --graph
    "graph.marginals",  # profile_step --graph
    "loopy.refit.seeds",  # profile_step --loopy, as every loopy.* range
    "loopy.refit.grad",
    "loopy.refit.fan",
    "loopy.refit.map",
    "loopy.objective.cavity",
    "loopy.objective.ll",
    "loopy.final_map",
    "loopy.sweep.forward",
    "loopy.sweep.backward",
    "loopy.sweep.map",
    "loopy.sweep.map.grad",
    "loopy.sweep.map.fan",
    "loopy.sweep.fuse",
)


def nested(name):
    """A range inside one of the port's `record_function` ranges, recorded
    at operator scope (module docstring)."""
    return torch._C._profiler._RecordFunctionFast(name)
