"""Configuration dataclasses for stemgnn_tpu_torch.

The flag surface mirrors the reference CLI (main.py:9-30): the 21 reference
flags keep their names and defaults, and booleans parse properly (the
reference's `type=bool` flags treat the string "False" as truthy). The
port adds `seed`, `dropout_seed`, `shuffle_seed`, `param_dtype`,
`compute_dtype`, `resume`, `ckpt_every`, `ckpt_async`, `log_jsonl`, `profile`,
`debug_nans`, `data_dir` and `output_dir`, with the JAX package's names and
defaults; `device` defaults to "cuda".

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

    def __post_init__(self):
        for name in ("param_dtype", "compute_dtype"):
            if getattr(self, name) not in ("float32", "bfloat16"):
                raise ValueError(f"{name} {getattr(self, name)!r}: 'float32' or 'bfloat16'")

    def model_config(self, node_cnt: int) -> StemGNNConfig:
        return StemGNNConfig(
            units=node_cnt,
            window_size=self.window_size,
            horizon=self.horizon,
            multi_layer=self.multi_layer,
            stack_cnt=2,
            dropout_rate=self.dropout_rate,
            leaky_rate=self.leakyrelu_rate,
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
