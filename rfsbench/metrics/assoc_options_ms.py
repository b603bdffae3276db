"""Device milliseconds a frame of the weight stage's association options
where the port runs them as one hand-written kernel (`assoc_options_kernel`,
launched through ctypes, so found by name in the device events). None where
no such kernel ran: a port that builds the options with PyTorch operations
under `phd.weight_inputs`, which `weight_inputs_ms` then holds."""

KERNEL = "assoc_options_kernel"


def read(run):
    if run.trace is None:
        return None
    us = sum(ev.end - ev.start for ev in run.trace.device if KERNEL in ev.name)
    return us / 1e3 / run.trace.frames if us else None
