"""One reader per metric, `metrics/<name>.py`, found by the name
BENCHMARK.json gives: `read(run)` takes the run's record
(`semibench.window.Run`) and returns the number, or None where the run
holds nothing to read (the metric is then left out of the line)."""
