"""`torch.cuda.max_memory_allocated` over set-up and window, in GB
(1e9 bytes), read when the window has closed, before the check runs."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
