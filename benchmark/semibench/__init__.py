"""The harness of the port's benchmark: one cell, run once
(`benchmark/run.py`). Everything that belongs to one configuration, one
cell or one metric is a file of its own under `benchmark/`, found by name:
`configs/<config>.json`, `workloads/<cell>.json`, `metrics/<metric>.py`,
`work/<config>.py`, and the plain reference under `reference/`."""
