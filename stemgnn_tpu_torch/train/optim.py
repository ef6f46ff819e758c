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

Over bf16 parameters (`param_dtype` "bfloat16") the optimizer follows the
JAX package's optax arithmetic leaf by leaf (`LeafwiseRMSprop`,
`LeafwiseAdam`): each leaf's gradient comes in its own dtype (f32 where a
kernel's backward returns it, bf16 elsewhere: train/engine.py), each moment
takes its gradient's dtype (optax's state follows what it is fed), the
hyperparameters are rounded to bf16 as optax's `inject_hyperparams` converts
them to the dtype of the first gradient leaf (a bf16 one), every op runs in
the gradient's dtype, rounded after each op as XLA rounds bf16 arithmetic on
the CPU (torch's bf16 ops round alike), and the parameter is rounded back to
bf16, as `optax.apply_updates` casts it. So a bf16 leaf takes the JAX
package's bits; an f32 leaf's moments can differ by an f32 ulp, where XLA on
the CPU contracts a * b + c into one fused multiply-add. torch's stock
optimizers keep every moment in its parameter's dtype, so these are written
out here; f32 parameters keep torch's own optimizers and their bits.
"""

from __future__ import annotations

import functools
import itertools

import torch


@functools.lru_cache(maxsize=64)
def _rounded(v: float, dtype) -> float:
    """The number v rounded to `dtype` (to nearest, ties to even): a
    hyperparameter optax holds in that dtype, or a Python number meeting an
    array of it in JAX (a weak type)."""
    return torch.tensor(v, dtype=dtype).item()


def _bf16(v):
    """A hyperparameter rounded to bf16: an f32 tensor for a tensor (a learning
    rate on the card, which `set_lr` rewrites in place), else a float."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.bfloat16).to(torch.float32)
    return _rounded(float(v), torch.bfloat16)


class _Leafwise:
    """What the optimizers over bf16 parameters share. `step(grads)` takes
    the gradients in the parameters' order (each in its own dtype; None for
    `p.grad`); a moment is created in its gradient's dtype and promoted to
    the dtype of a wider gradient, as optax's state follows (an f32 gradient
    beside a bf16 parameter gives an f32 moment from the first step on);
    `load_state_dict` keeps each moment's dtype, where torch's would cast it
    to its parameter's."""

    def _leaves(self, grads):
        """(group, parameter, gradient) for every parameter with a gradient."""
        params = [(group, p) for group in self.param_groups for p in group["params"]]
        grads = [p.grad for _, p in params] if grads is None else list(grads)
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} parameters")
        return [(group, p, g) for (group, p), g in zip(params, grads) if g is not None]

    def _moment(self, p, key: str, dtype):
        """The state `key` of p, created as zeros of `dtype` or promoted to it
        (and the step count beside it, an f32 tensor on p's card)."""
        st = self.state[p]
        if "step" not in st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        if key not in st:
            st[key] = torch.zeros_like(p, dtype=dtype)
        elif st[key].dtype != torch.promote_types(st[key].dtype, dtype):
            st[key] = st[key].to(torch.promote_types(st[key].dtype, dtype))
        return st[key]

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        params = [p for group in self.param_groups for p in group["params"]]
        saved = itertools.chain.from_iterable(g["params"] for g in state_dict["param_groups"])
        for p, i in zip(params, saved):
            for key, v in state_dict["state"].get(i, {}).items():
                if isinstance(v, torch.Tensor):
                    self.state[p][key] = v.to(
                        device=p.device, dtype=torch.float32 if key == "step" else v.dtype,
                        copy=True)


class LeafwiseRMSprop(_Leafwise, torch.optim.RMSprop):
    """The JAX package's RMSProp (stemgnn_tpu/train/optim.py `_torch_rmsprop`
    under `inject_hyperparams`) over bf16 parameters, leaf by leaf, each op in
    the dtype of the leaf's gradient: lr, alpha and eps rounded to bf16,
    nu <- alpha nu + (1 - alpha) g g, p <- bf16(p + -lr g / (sqrt(nu) + eps)).
    Its state is torch's (`square_avg`, `step`)."""

    def __init__(self, params, lr, alpha: float = 0.99, eps: float = 1e-8):
        super().__init__(params, lr=lr, alpha=alpha, eps=eps, foreach=False)

    @torch.no_grad()
    def step(self, grads=None):
        for group, p, g in self._leaves(grads):
            lr, alpha, eps = (_bf16(group[k]) for k in ("lr", "alpha", "eps"))
            nu = self._moment(p, "square_avg", g.dtype)
            nu.copy_(alpha * nu + (1.0 - alpha) * g * g)
            p.copy_(p + -lr * g / (nu.sqrt() + eps))
            self.state[p]["step"] += 1


class LeafwiseAdam(_Leafwise, torch.optim.Adam):
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) under the JAX
    package's `inject_hyperparams` over bf16 parameters, leaf by leaf, each op
    in the dtype of the leaf's gradient: lr rounded to bf16, b1, b2 and eps
    rounded to that dtype (Python numbers meeting its arrays); mu <- (1 - b1)
    g + b1 mu, nu <- (1 - b2) g g + b2 nu; the bias corrections 1 - b^t in f32,
    rounded to that dtype; p <- bf16(p + -lr (mu / c1) / (sqrt(nu / c2) +
    eps)). Its state is torch's (`exp_avg`, `exp_avg_sq`, `step`)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps, foreach=False)

    @torch.no_grad()
    def step(self, grads=None):
        for group, p, g in self._leaves(grads):
            (b1, b2), lr = group["betas"], _bf16(group["lr"])
            c1, d1, c2, d2, eps = (_rounded(v, g.dtype) for v in
                                   (1 - b1, b1, 1 - b2, b2, group["eps"]))
            mu = self._moment(p, "exp_avg", g.dtype)
            nu = self._moment(p, "exp_avg_sq", g.dtype)
            count = self.state[p]["step"]
            count += 1
            mu.copy_(c1 * g + d1 * mu)
            nu.copy_(c2 * (g * g) + d2 * nu)
            bc1, bc2 = ((1.0 - b ** count).to(g.dtype) for b in (b1, b2))
            p.copy_(p + -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)))


def make_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    """RMSProp if name == 'RMSProp' else Adam (handler.py:126-129), over
    `params`, an iterable of leaf tensors: torch's own over f32 parameters,
    `LeafwiseRMSprop` / `LeafwiseAdam` where any is bf16 (param_dtype
    "bfloat16"; step(grads) then takes each leaf's gradient in its dtype)."""
    params = list(params)
    kwargs = {}
    on_card = bool(params) and params[0].device.type == "cuda"
    if on_card:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    if any(p.dtype == torch.bfloat16 for p in params):
        cls = LeafwiseRMSprop if name == "RMSProp" else LeafwiseAdam
        return cls(params, lr=lr)
    if on_card:
        kwargs["capturable"] = True
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
