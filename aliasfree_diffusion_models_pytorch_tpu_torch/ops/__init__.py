"""Signal-processing ops: filter design, alias-free resampling, attention, rotation."""
