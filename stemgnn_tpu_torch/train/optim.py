"""Optimizers with the reference's torch semantics.

- RMSProp (handler.py:127): torch.optim.RMSprop(lr, eps=1e-8) with torch's
  defaults alpha=0.99, no momentum, not centered:
      nu <- alpha*nu + (1-alpha)*g^2 ;  p <- p - lr * g / (sqrt(nu) + eps)
- Adam (handler.py:129): torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8).
- LR schedule (handler.py:130,170-171): ExponentialLR(gamma=decay_rate)
  stepped once every `exponential_decay_step` epochs, as `decayed_lr`, which
  the engine writes into the param groups each epoch.

The JAX package writes both updates out for optax
(stemgnn_tpu/train/optim.py); here they are torch's own.

Over parameters on a card the optimizer is built `capturable`, with its step
counts and its learning rate as tensors on the card, so that a train step can
be captured in a CUDA graph and a replay sees the learning rate `set_lr` wrote.
torch's capturable RMSprop forms p += g / ((sqrt(nu) + eps) / -lr) where the
other path forms p += -lr * g / (sqrt(nu) + eps): the same update rounded at
other places, so a run on the card and a run on the CPU agree to rounding and
not bit for bit (they never did: the kernels sum in another order).
"""

from __future__ import annotations

import torch


def make_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    """RMSProp if name == 'RMSProp' else Adam (handler.py:126-129), over
    `params`, an iterable of leaf tensors."""
    params = list(params)
    kwargs = {}
    if params and params[0].device.type == "cuda":
        kwargs["capturable"] = True
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    if name == "RMSProp":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, **kwargs)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, **kwargs)


def decayed_lr(base_lr: float, epoch: int, decay_step: int, decay_rate: float) -> float:
    """LR in effect during `epoch` (0-based).

    The reference steps ExponentialLR after epochs where (epoch+1) %
    decay_step == 0 (handler.py:170-171), so epoch e trains with
    gamma^floor(e / decay_step).
    """
    return base_lr * (decay_rate ** (epoch // decay_step))


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Write `lr` into every param group: in place where the group keeps its
    learning rate as a tensor (which a captured graph reads at each replay)."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
