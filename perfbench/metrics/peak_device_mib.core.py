"""peak_device_mib.core: torch.cuda.max_memory_allocated() over the window
(reset at its start), in MiB.  Traced run; None on the CPU."""


def read(run):
    if run.traffic["entry"] != "arrays" or run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2**20
