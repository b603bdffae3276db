"""Seconds from the process's start to the first timed frame: imports, CUDA
start, the kernel library's load (its build in a fresh checkout), the
inputs, and the warm-up sequence (host clock)."""


def read(run):
    return None if run.traced else run.setup_s
