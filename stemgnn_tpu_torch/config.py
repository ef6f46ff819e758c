"""Configuration dataclasses for stemgnn_tpu_torch.

The flag surface mirrors the reference CLI (main.py:9-30): the 21 reference
flags keep their names and defaults, and booleans parse properly (the
reference's `type=bool` flags treat the string "False" as truthy). The
port adds `seed`, `init_stream`, `dropout_seed`, `shuffle_seed`, `param_dtype`,
`compute_dtype`, `resume`, `ckpt_every`, `ckpt_async`, `log_jsonl`, `profile`,
`debug_nans`, `data_dir`, `output_dir`, `data_axis`, `graph_axis`,
`force_sparse_shard` and `use_ring`, with the JAX package's names and
defaults; `device` defaults to "cuda".

`sparse_k`, `gru_hidden` and `gru_segment` select the large-N stretch path
(stemgnn_tpu/config.py, PARITY.md deviation 6): a top-k sparse latent graph
with feature-space Chebyshev terms (`ops/sparse.py`) in place of the dense
[N, N] attention and Laplacian, and a GRU whose hidden size is decoupled
from N and whose node sequence runs as independent segments. On the
TrainConfig 0 means unset, as on the JAX package's.

`data_axis`, `graph_axis` and `force_sparse_shard` (the JAX package's names
and defaults) lay the run out on a ('data', 'graph') mesh of processes
(`parallel/mesh.py`, launched by torchrun): the batch sharded over 'data', the
nodes over 'graph' (the stretch path's sparse graph, or the dense path's
attention and Chebyshev rows). `use_ring` is the JAX package's ring
attention over 'graph', whose rows the port's partition already gives
(`parallel/ring.py`); it takes effect only where graph_axis > 1
(stemgnn_tpu/train/engine.py:476), where it refuses an N that 'graph' does
not divide.

`compute_dtype` is the JAX package's precision policy: "bfloat16" gives the
graph conv's and the spectral cell's kernels bf16 operands with f32 sums,
rounded where the JAX package's kernels round them; the GRU, the attention,
the Laplacian and every product outside those kernels stay f32 (with TF32
off on the card), which is what the JAX package computes on the CPU.

`param_dtype` is the JAX package's parameter storage: "bfloat16" casts the
parameters after init (to nearest, ties to even) and keeps them so; every
product where one meets an f32 activation promotes it to f32 exactly, as JAX
promotes bf16 x f32. The gradients and the optimizer's moments then follow
the JAX package's Pallas path leaf by leaf (train/optim.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StemGNNConfig:
    """Model hyperparameters (reference Model.__init__, base_model.py:79-104)."""

    units: int  # node count N; the reference hard-codes GRU hidden == N
    window_size: int = 12  # W, FFT/sequence length (main.py:13)
    horizon: int = 3  # forecast steps (main.py:14)
    multi_layer: int = 5  # channel multiplier m (main.py:20)
    stack_cnt: int = 2  # two residual stacks (handler.py:105)
    dropout_rate: float = 0.5  # on attention rows (base_model.py:103,161)
    leaky_rate: float = 0.2  # attention LeakyReLU slope (base_model.py:102)
    # stretch path: the top-k sparse latent graph (ops/sparse.py); None = the
    # dense reference semantics
    sparse_k: Optional[int] = None
    # stretch GRU (needs sparse_k): hidden size H in place of N, the node
    # sequence in independent segments of gru_segment nodes (0 = one segment)
    gru_hidden: Optional[int] = None
    gru_segment: int = 0
    # on a mesh, run the stretch path node-sharded (parallel/sparse_shard.py)
    # also where the 'graph' axis is 1: its collectives then sum over one rank
    force_sparse_shard: bool = False

    def __post_init__(self):
        if self.gru_hidden is not None and self.sparse_k is None:
            raise ValueError(
                "gru_hidden (the decoupled stretch GRU) requires sparse_k: "
                "the dense attention path depends on the reference's "
                "hidden==N shape pun (base_model.py:152)"
            )
        if self.gru_segment and self.gru_hidden is None:
            raise ValueError("gru_segment requires gru_hidden")

    @property
    def wm(self) -> int:
        """Expanded spectral width W*m (base_model.py:24-25)."""
        return self.window_size * self.multi_layer

    @property
    def glu_in(self) -> int:
        """GLU stack input width 4*W (base_model.py:37)."""
        return 4 * self.window_size

    @property
    def glu_out(self) -> int:
        """GLU stack hidden width 4*W*m (base_model.py:34,37)."""
        return 4 * self.window_size * self.multi_layer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training/eval configuration (reference main.py flags + port additions)."""

    # --- reference flags, same names/defaults (main.py:9-30) ---
    train: bool = True
    evaluate: bool = True
    dataset: str = "ECG_data"
    window_size: int = 12
    horizon: int = 3
    train_length: float = 7.0
    valid_length: float = 2.0
    test_length: float = 1.0
    epoch: int = 50
    lr: float = 1e-4
    multi_layer: int = 5
    device: str = "cuda"  # reference default 'cpu'; the port runs on the card
    validate_freq: int = 1
    batch_size: int = 32
    norm_method: str = "z_score"  # 'z_score' | 'min_max' | ''
    optimizer: str = "RMSProp"  # 'RMSProp' | anything-else => Adam (handler.py:126-129)
    early_stop: bool = False
    early_stop_step: int = 5  # referenced but undeclared in the reference (handler.py:189)
    exponential_decay_step: int = 5
    decay_rate: float = 0.5
    dropout_rate: float = 0.5
    leakyrelu_rate: float = 0.2
    # --- port additions (no reference counterpart) ---
    seed: int = 0  # torch.manual_seed(0) at main.py:52
    # the stream that draws the parameters: "torch" (the reference's torch
    # draw, models/initializers.py init_params) or "threefry" (the JAX
    # package's jax.random draw, init_params_threefry); the JAX package's
    # default and values (stemgnn_tpu/config.py init_stream)
    init_stream: str = "torch"
    # -1 = the dropout stream derives from `seed`; >= 0 decouples the
    # per-epoch dropout root from init and shuffle
    dropout_seed: int = -1
    # -1 = the per-epoch batch shuffle derives from `seed`; >= 0 decouples it
    shuffle_seed: int = -1
    # "float32" | "bfloat16": parameter storage (cast after init)
    param_dtype: str = "float32"
    # "float32" | "bfloat16": the graph conv's and spectral kernels' operands
    compute_dtype: str = "float32"
    resume: bool = False  # restore params + optimizer state + epoch from the last checkpoint
    ckpt_every: int = 1  # per-epoch checkpoint cadence (reference: every epoch)
    ckpt_async: bool = True  # copy and write checkpoints on a worker thread
    log_jsonl: bool = True  # structured per-epoch metrics JSONL
    profile: bool = False  # write a torch.profiler trace of one epoch
    # sanitizer mode: autograd anomaly detection, one eager step per batch,
    # raise on a non-finite loss or gradient
    debug_nans: bool = False
    data_dir: str = "dataset"
    output_dir: str = "output"
    sparse_k: int = 0  # >0: top-k sparse latent graph (large-N stretch path)
    gru_hidden: int = 0  # >0: decoupled GRU hidden size (stretch; needs sparse_k)
    gru_segment: int = 0  # >0: segmented node recurrence (stretch; needs gru_hidden)
    data_axis: int = 1  # mesh size along 'data' (DP)
    graph_axis: int = 1  # mesh size along 'graph' (node-block partition)
    # the stretch path node-sharded on a mesh whose 'graph' axis is 1
    force_sparse_shard: bool = False
    use_ring: bool = False  # the dense attention on the ring over 'graph' (graph_axis > 1)

    def __post_init__(self):
        for name in ("param_dtype", "compute_dtype"):
            if getattr(self, name) not in ("float32", "bfloat16"):
                raise ValueError(f"{name} {getattr(self, name)!r}: 'float32' or 'bfloat16'")
        if self.data_axis < 1 or self.graph_axis < 1:
            raise ValueError(f"mesh {self.data_axis}x{self.graph_axis}: each axis >= 1")

    def model_config(self, node_cnt: int) -> StemGNNConfig:
        return StemGNNConfig(
            units=node_cnt,
            window_size=self.window_size,
            horizon=self.horizon,
            multi_layer=self.multi_layer,
            stack_cnt=2,
            dropout_rate=self.dropout_rate,
            leaky_rate=self.leakyrelu_rate,
            sparse_k=self.sparse_k if self.sparse_k > 0 else None,
            gru_hidden=self.gru_hidden if self.gru_hidden > 0 else None,
            gru_segment=self.gru_segment,
            force_sparse_shard=self.force_sparse_shard,
        )


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


def add_cli_args(parser) -> None:
    """Register the reference's 21 flags (fixed bool parsing) + port flags."""
    defaults = TrainConfig()
    for field in dataclasses.fields(TrainConfig):
        name = f"--{field.name}"
        default = getattr(defaults, field.name)
        if field.type in ("bool", bool):
            parser.add_argument(name, type=_str2bool, default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)


def config_from_args(args) -> TrainConfig:
    kwargs = {f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**kwargs)
