"""Frames completed in the window over the window's seconds (host clock;
every frame ends with the history's read of the device, so a completed
frame is done on the device too)."""


def read(run):
    return run.frames / run.window_s if run.window_s and not run.traced else None
