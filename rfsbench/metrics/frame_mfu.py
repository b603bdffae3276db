"""The whole frame's share of the card's fp32 peak: the frame's fp32
operations (work/frame.stage_ops, averaged over the traced frames whose work
was counted) times the slice's frames, over the slice's seconds, over the
published fp32 rate, in %."""


def read(run):
    if run.trace is None or not run.work:
        return None
    ops = sum(sum(w["ops"].values()) for w in run.work) / len(run.work)
    return 100.0 * ops * run.trace.frames / run.trace.window_s / run.peaks["fp32_ops_s"]
