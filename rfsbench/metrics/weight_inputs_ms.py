"""Device milliseconds a frame of the work launched under the port's
`phd.weight_inputs` span (the MAP estimate, both mixtures' likelihoods, the
gated association likelihood and the beam's option tensors)."""


def read(run):
    if run.trace is None or not run.trace.span_device_us.get("phd.weight_inputs"):
        return None
    return run.trace.span_device_us["phd.weight_inputs"] / 1e3 / run.trace.frames
