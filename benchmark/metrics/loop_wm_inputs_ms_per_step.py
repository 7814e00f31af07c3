"""The time loop's `wm_inputs` section, on WM's separable path: the
assembly of K5's ten (n, d) input planes (`wm.wm_diag_inputs`: the
displacements, the NAC vectors, the casts and copies). Its device ms a
step of the batch in the traced repetition, from the port's section clock
(`semibench.port_record`); nothing where the port has no such section."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "wm_inputs")
