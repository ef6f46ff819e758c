"""The benchmark of `stemgnn_tpu_torch` on one NVIDIA H100 (`run.py`)."""
