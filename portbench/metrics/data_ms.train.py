"""data_ms.train (ms): the mean host milliseconds of one batch's gather by
the program's ``data.Dataloader`` in the window, timed around each
``next()`` by the harness's loader (it runs on ``PrefetchLoader``'s
thread, beside the device's step)."""


def read(f):
    if f.kind != "train" or not f.data_ms:
        return None
    return sum(f.data_ms) / len(f.data_ms)
