"""The time loop's `prefactor` section: the HK prefactor's determinant and its sign tracker (`hk_prefactor_det`, K4 or K1). Its device ms a step of the
batch in the traced repetition, from the port's section clock
(`semibench.port_record`)."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "prefactor")
