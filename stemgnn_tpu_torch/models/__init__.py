from stemgnn_tpu_torch.models.convert import (  # noqa: F401
    param_count,
    params_from_jax,
    params_to_jax,
)
from stemgnn_tpu_torch.models.initializers import init_params  # noqa: F401
from stemgnn_tpu_torch.models.stemgnn import StemGNN, forward  # noqa: F401
