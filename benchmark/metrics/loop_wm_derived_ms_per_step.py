"""The time loop's `wm_derived` section: WM's scalar forms and the detA / detM trackers (`wm_scan_derived`, K2 x3 or K5). Its device ms a step of the
batch in the traced repetition, from the port's section clock
(`semibench.port_record`)."""

from semibench import port_record


def read(run):
    return port_record.section_ms_per_step(run, "wm_derived")
