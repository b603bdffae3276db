"""One reader per metric, found by the metric's name in BENCHMARK.json:
metrics/<name>.py defines read(run) -> a number, or None where the run has
nothing to read (the harness then leaves the metric out of the line).

`run` (run.Run) holds the window's frames and seconds, the set-up seconds,
and in a traced run `trace` (trace.Trace), the cell's shapes and the work
counts of the frames the trace sampled (`work`)."""
