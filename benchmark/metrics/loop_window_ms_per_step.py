"""The time loop's `window` section: the taylor window's expansion: the sGDML Hessian and `_window_mono_map`. Its device ms a step of the
batch in the traced repetition, from the port's section clock
(`semibench.port_record`)."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "window")
