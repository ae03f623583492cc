"""sample_mfu (%): model FLOPs of every forward the window's returned images
took (the forward of one image, counted over the reference model, times the
sampler's steps, times the images) over the window's host seconds, as a share
of the card's dense bf16 peak."""


def read(f):
    if f.kind != "sample" or not f.peak_flops or f.window_s <= 0:
        return None
    return 100.0 * f.flops_fwd * f.forwards_per_image * f.images / f.window_s / f.peak_flops
