"""The benchmark of the PyTorch/CUDA port `yalm_tpu_torch` on NVIDIA H100s:
`h100bench/run.py` is the command; README.md says how it is laid out and
how a later change adds a cell, a configuration, a mix or a metric."""
