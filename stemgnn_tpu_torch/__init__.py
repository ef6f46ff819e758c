"""stemgnn_tpu_torch: the PyTorch + CUDA port of stemgnn_tpu for one NVIDIA H100.

The JAX package `stemgnn_tpu` is the reference and this package never
imports it. Parameters, layouts and console output follow it; the hot ops
are hand-written CUDA kernels (`stemgnn_tpu_torch/csrc`) whose plain
PyTorch twins run on CPU tensors. Ported so far: the serving path and the
training path of the dense single-device model,
`python -m stemgnn_tpu_torch --dataset ECG_data --epoch 1`.
"""

from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig  # noqa: F401
