from stemgnn_tpu_torch.data.pipeline import (  # noqa: F401
    WindowDataset,
    compute_norm_stats,
    de_normalized,
    ffill_bfill,
    load_csv,
    normalized,
    split_by_ratio,
    window_end_indices,
)
from stemgnn_tpu_torch.data.synthetic import ensure_dataset, synthesize  # noqa: F401
