"""The share of the traced slice's wall time in which the device ran
nothing, in %."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
