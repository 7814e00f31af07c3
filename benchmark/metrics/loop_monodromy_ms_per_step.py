"""The time loop's `monodromy` section: the monodromy update (the Z step of `rk4_step`). Its device ms a step of the
batch in the traced repetition, from the port's section clock
(`semibench.port_record`)."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "monodromy")
