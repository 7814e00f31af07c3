"""The port's own tracing record of a run's traced repetition, which is
the run's only `torch.profiler` session: `semiclassical_tpu_torch.
profiling.records()`. None where the run holds no trace, where the port
did not run (the control in its place keeps no time loop, and its
counters are empty), or where the port keeps no such record."""


def of(run):
    """The newest record of the port's tracing, or None."""
    if run.trace is None or "captures" not in run.counters:
        return None
    from semiclassical_tpu_torch import profiling

    records = getattr(profiling, "records", None)
    return None if records is None else records()


def section_ms_per_step(run, section):
    """The device ms a step of the batch of the time loop's `section` in
    the traced repetition (`profiling.section` marks, timed by the stamp
    kernel in each block's twin graph), or None."""
    record = of(run)
    if not record or not record.get("steps"):
        return None
    seconds = record.get("sections", {}).get(section)
    return None if seconds is None else 1e3 * seconds / record["steps"]
