"""Host wall milliseconds a frame inside the port's `vehicle` span: the
simulated vehicle, or the RGB-D frontend (subsampling, upload, FAST, LATCH,
RANSAC, the host read and the measurement loop)."""


def read(run):
    if run.trace is None or "vehicle" not in run.trace.span_host_us:
        return None
    return run.trace.span_host_us["vehicle"] / 1e3 / run.trace.frames
