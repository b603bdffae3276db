"""Device milliseconds a frame of the weight stage's two mixture likelihoods
where the port runs them as one hand-written kernel (`mixture_ll_kernel`,
launched through ctypes with no PyTorch parent, so found by name in the
device events, outside `weight_inputs_ms`). None where no such kernel ran:
a port that computes the likelihoods with PyTorch operations under
`phd.weight_inputs`, which `weight_inputs_ms` then holds."""

KERNEL = "mixture_ll_kernel"


def read(run):
    if run.trace is None:
        return None
    us = sum(ev.end - ev.start for ev in run.trace.device if KERNEL in ev.name)
    return us / 1e3 / run.trace.frames if us else None
