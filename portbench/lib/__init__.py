"""The harness's shared parts: finding a cell's files by name, seeds, the
seeded weights, the bound arithmetic and FLOP count, the profiler window,
and the result line."""
