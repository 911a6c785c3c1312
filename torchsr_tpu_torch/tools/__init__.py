"""Benchmark tools of the port, each runnable as ``python -m
torchsr_tpu_torch.tools.<name>``."""
