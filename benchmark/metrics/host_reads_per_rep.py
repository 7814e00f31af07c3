"""Blocking device-to-host reads of the traced repetition: the port's
`host_reads` counter (`profiling.to_host`), each of which drains the
card's queue. Nothing where the port keeps no such record."""

from semibench import port_record


def read(run):
    record = port_record.of(run)
    if record is None:
        return None
    return record.get("counters", {}).get("host_reads", 0)
