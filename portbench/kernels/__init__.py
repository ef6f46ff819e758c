"""Kernel families of the port, one file each, found by name by `run.py`.

A family file holds `KERNELS`, a regular expression that matches the base
name (without namespace, template arguments or parameters) of every CUDA
kernel of the family in `stemgnn_tpu_torch/csrc/`, and, where the family
has a roofline metric, `bound_s(cfg, batches, training, peak)`: the least
seconds the family's work takes over units of the given batch sizes (train
steps, or forecast batches) at `peak` FLOP/s. Every kernel no family names
is library work.
"""
