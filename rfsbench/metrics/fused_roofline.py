"""The fused kernel's share of its roofline over the traced frames whose
work was counted (work/kernels.fused_work on that frame's data, at the
published peaks): their least time over their launches' device time, in %.
The i-th fused launch of the slice is the slice's i-th frame."""


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels("fused")
    rows = [w for w in run.work if w.get("fused_ms") is not None and w["index"] < len(launches)]
    if not launches or not rows:
        return None
    spent = sum((launches[w["index"]].end - launches[w["index"]].start) / 1e3 for w in rows)
    return 100.0 * sum(w["fused_ms"] for w in rows) / spent
