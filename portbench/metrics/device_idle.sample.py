"""device_idle.sample (%): the share of the traced stretch of sampling (DDPM:
a run of steps inside a call; DDIM: a whole request, from the call to its
images on the host) in which no kernel or copy ran on the card
(torch.profiler)."""


def read(f):
    if f.kind != "sample" or f.trace is None or f.trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - f.trace.busy_s / f.trace.window_s)
