"""The time loop's `integrator` section: the RK4 stages and the q, p, S update (or an exact map). Its device ms a step of the
batch in the traced repetition, from the port's section clock
(`semibench.port_record`)."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "integrator")
