"""The benchmark of the PyTorch/CUDA port (``aliasfree_diffusion_models_pytorch_tpu_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``portbench/run.py``).
"""
