"""Hot-path ops: plain PyTorch twins + hand-written CUDA kernels.

Dispatch follows the tensor's device: each kernel wrapper runs its plain
version (the `torch_impl` twin) on a CPU tensor and launches its CUDA
kernel on a CUDA tensor, or raises. There is no size threshold and no
fallback from a kernel to its plain version. Where a gradient is needed a
forward wrapper goes through its `torch.autograd.Function`, whose backward
calls the backward wrapper (graph conv: plain PyTorch, as in the JAX package).

Each wrapper counts its launches in `<wrapper>.launches`; `KERNELS` maps a
kernel's name to its wrapper so a run can reset and read the counts.
"""

from __future__ import annotations

from stemgnn_tpu_torch.ops.cuda_attention import attention_kq, attention_kq_bwd
from stemgnn_tpu_torch.ops.cuda_graph import cheb_graph_conv
from stemgnn_tpu_torch.ops.cuda_gru import gru_over_nodes, gru_scan_bwd
from stemgnn_tpu_torch.ops.cuda_spectral import spe_seq_cell, spe_seq_cell_bwd
from stemgnn_tpu_torch.ops.torch_impl import (  # noqa: F401
    dense,
    laplacian_from_attention,
    order_contract,
)

KERNELS = {
    "gru_fwd": gru_over_nodes,
    "attention_kq_fwd": attention_kq,
    "cheb_graph_conv_fwd": cheb_graph_conv,
    "spectral_fwd": spe_seq_cell,
    "gru_bwd": gru_scan_bwd,
    "attention_kq_bwd": attention_kq_bwd,
    "spectral_bwd": spe_seq_cell_bwd,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
