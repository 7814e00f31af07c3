"""The time loop's `observables` section: the observables of a step, their batch sums and second moments. Its device ms a step of the
batch in the traced repetition, from the port's section clock
(`semibench.port_record`)."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "observables")
