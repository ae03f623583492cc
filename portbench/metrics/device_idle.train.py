"""device_idle.train (%): the share of the traced train steps' host seconds
in which no kernel or copy ran on the card (torch.profiler)."""


def read(f):
    if f.kind != "train" or f.trace is None or f.trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - f.trace.busy_s / f.trace.window_s)
