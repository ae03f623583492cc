"""The plain reference: the UNet, the noise schedule and samplers, the loss,
AdamW and the EMA in plain PyTorch (float32, TF32 off), and the data order.

It imports nothing of the port, nor JAX. It is a frozen copy of the port's
plain versions (``models/unet.py``, ``models/blocks.py``, ``ops/filters.py``,
the conv form of ``ops/resample.py``, ``diffusion.py``, ``data.py``'s
splitmix64 order), written as functions of a parameter dict named as the
port's ``state_dict`` is, so that the same seeded weights go to both sides.
"""
