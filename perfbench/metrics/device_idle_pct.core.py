"""device_idle_pct.core: 1 - (the union of the device's kernel, copy and
set intervals) / (the traced window's wall time), from torch.profiler, in
percent.  None where the trace holds no device event (a CPU run)."""


def read(run):
    t = run.trace
    if run.traffic["entry"] != "arrays" or t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
