"""train_mfu (%): model FLOPs trained in the window (forward and backward of
every image, counted over the reference model: ``portbench/lib/cost.py``)
over the window's host seconds, as a share of the card's dense bf16 peak
(989 TFLOP/s on an H100). The whole step's share: it bounds what any one
kernel's speed-up can give the train cells."""


def read(f):
    if f.kind != "train" or not f.peak_flops or f.window_s <= 0:
        return None
    return 100.0 * f.flops_train * f.images / f.window_s / f.peak_flops
