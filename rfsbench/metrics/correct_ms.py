"""Device milliseconds a frame of the correct stage: the work launched under
the port's `phd.fused_stage` span plus the hand-written fused kernel's
events (launched through ctypes, so found by name)."""


def read(run):
    if run.trace is None:
        return None
    us = run.trace.span_device_us.get("phd.fused_stage", 0.0)
    us += sum(ev.end - ev.start for ev in run.trace.kernels("fused"))
    return us / 1e3 / run.trace.frames if us else None
