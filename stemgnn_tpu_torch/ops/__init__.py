"""Hot-path ops: plain PyTorch twins + hand-written CUDA kernels.

Dispatch follows the tensor's device: each kernel wrapper runs its plain
version (the `torch_impl` twin) on a CPU tensor and launches its CUDA
kernel on a CUDA tensor, or raises. There is no size threshold and no
fallback from a kernel to its plain version. Where a gradient is needed a
forward wrapper goes through its `torch.autograd.Function`, whose backward
calls the backward wrapper (graph conv: plain PyTorch, as in the JAX package).

Each wrapper counts its launches in `<wrapper>.launches`; `KERNELS` maps a
kernel's name to its wrapper so a run can reset and read the counts. The bf16
arms of the graph conv and the spectral kernels (compute_dtype "bfloat16")
count on functions of their own, under names ending in `_bf16`, and the
bf16-storage arm of the spectral saving pair under names ending in
`_bf16acts`. Launches
made by replaying a captured CUDA graph are counted apart (`replayed`).
"""

from __future__ import annotations

import contextlib

from stemgnn_tpu_torch.ops.cuda_attention import attention_kq, attention_kq_bwd
from stemgnn_tpu_torch.ops.cuda_graph import cheb_graph_conv, cheb_graph_conv_bf16
from stemgnn_tpu_torch.ops.cuda_gru import (
    gru_bwd_grid,
    gru_fwd_grid,
    gru_over_nodes,
    gru_scan_bwd,
)
from stemgnn_tpu_torch.ops.cuda_spectral import (
    spe_seq_cell,
    spe_seq_cell_bf16,
    spe_seq_cell_bwd,
    spe_seq_cell_bwd_bf16,
    spe_seq_cell_bwd_reread,
    spe_seq_cell_bwd_reread_bf16,
    spe_seq_cell_bwd_reread_bf16acts,
    spe_seq_cell_save,
    spe_seq_cell_save_bf16,
    spe_seq_cell_save_bf16acts,
)
from stemgnn_tpu_torch.ops.torch_impl import (  # noqa: F401
    dense,
    laplacian_from_attention,
    order_contract,
)

KERNELS = {
    "gru_fwd": gru_over_nodes,  # the cluster kernel
    "gru_fwd_grid": gru_fwd_grid,  # the grid kernel: an H no cluster holds
    "attention_kq_fwd": attention_kq,
    "cheb_graph_conv_fwd": cheb_graph_conv,
    "spectral_fwd": spe_seq_cell,
    "gru_bwd": gru_scan_bwd,  # the cluster kernel
    "gru_bwd_grid": gru_bwd_grid,  # the grid kernel
    "attention_kq_bwd": attention_kq_bwd,
    "spectral_bwd": spe_seq_cell_bwd,
    "spectral_fwd_save": spe_seq_cell_save,
    "spectral_bwd_reread": spe_seq_cell_bwd_reread,
    # the bf16-storage arm of the saving pair (compute_dtype "bfloat16" with
    # cuda_spectral.SAVE_ACTS_F32 off)
    "spectral_fwd_save_bf16acts": spe_seq_cell_save_bf16acts,
    "spectral_bwd_reread_bf16acts": spe_seq_cell_bwd_reread_bf16acts,
    # the bf16 arms (compute_dtype "bfloat16")
    "cheb_graph_conv_fwd_bf16": cheb_graph_conv_bf16,
    "spectral_fwd_bf16": spe_seq_cell_bf16,
    "spectral_fwd_save_bf16": spe_seq_cell_save_bf16,
    "spectral_bwd_bf16": spe_seq_cell_bwd_bf16,
    "spectral_bwd_reread_bf16": spe_seq_cell_bwd_reread_bf16,
}

# launches made by replays of captured CUDA graphs: a replay runs the kernels
# a capture recorded without calling their wrappers, so whoever replays a
# graph adds here what its capture counted (`add_replayed`)
_replayed = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name, fn in KERNELS.items():
        fn.launches = 0
        _replayed[name] = 0


def launches() -> dict:
    """Calls of each wrapper that launched (or recorded into a capture) its
    kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


@contextlib.contextmanager
def counting_capture():
    """Around the capture of a CUDA graph. A capture records launches and makes
    none, so what the wrappers counted inside is taken off their counts again
    and left in the dict this yields: the launches one replay will make."""
    before = launches()
    recorded = {}
    try:
        yield recorded
    finally:
        for name, fn in KERNELS.items():
            recorded[name] = fn.launches - before[name]
            fn.launches = before[name]


def add_replayed(per_replay: dict) -> None:
    """Count one replay of a graph whose capture counted `per_replay` launches."""
    for name, n in per_replay.items():
        _replayed[name] += n


def replayed() -> dict:
    """Kernel launches made by graph replays since the last reset."""
    return dict(_replayed)
