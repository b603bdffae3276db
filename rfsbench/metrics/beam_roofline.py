"""The beam kernel's share of its roofline: the least time of its launches
(work/kernels.beam_work at the cell's shapes, at the published peaks) over
their device time, in %."""

from ..work.kernels import beam_work, least_ms


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels("beam")
    if not launches:
        return None
    s = run.shapes
    ms, _ = least_ms(*beam_work(s["P"], s["M"], s["C"], s["B"], s["n_words"]), run.peaks)
    spent = sum(ev.end - ev.start for ev in launches) / 1e3
    return 100.0 * ms * len(launches) / spent
