"""Plain PyTorch StemGNN: the model of microsoft/StemGNN `models/base_model.py`,
its MSE loss and torch's RMSprop, written out from the paper's code.

This is the benchmark's yardstick. It imports nothing of the program under
test and takes nothing the program made: the benchmark hands it the raw
series, the initial weights (a flat dict of "/"-joined names, linear weights
stored [in, out]), the window end indices and the seed of the dropout
stream, and it works out the rest itself: the z-score normalization, each
step's dropout mask, the forward, the gradients and the updates.

Departures from the paper's code, none of which changes the arithmetic:
the GRU runs through `torch.nn.GRU` (as there) over the node axis; the
attention's scores are formed by broadcasting where the paper repeats and
views; `torch.fft` replaces the removed `torch.rfft` / `torch.irfft`
(onesided=False: the full spectrum, the real part of the inverse).

On a card, products run in f32 unless the caller turns TF32 on
(`precision`), which is how the benchmark's control computes it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

GRU_LEAVES = {"gru/w_ih": "weight_ih_l0", "gru/w_hh": "weight_hh_l0",
              "gru/b_ih": "bias_ih_l0", "gru/b_hh": "bias_hh_l0"}


@contextlib.contextmanager
def precision(tf32: bool):
    """Products of cuBLAS and cuDNN in TF32 (`tf32`) or in f32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def normalize(raw: np.ndarray) -> np.ndarray:
    """z-score by column over the whole series, a zero deviation taken as 1
    (forecast_dataloader.py:15-22), as float32."""
    mean = np.mean(raw, axis=0)
    std = np.std(raw, axis=0)
    std = np.where(std == 0, 1.0, std)
    return np.ascontiguousarray((raw - mean) / std, dtype=np.float32)


def windows(data: torch.Tensor, hi: torch.Tensor, w: int, horizon: int):
    """x = data[hi-W:hi] as [B, W, N], y = data[hi:hi+horizon] as [B, horizon, N]."""
    hi = hi.to(data.device)
    x = data[hi[:, None] - w + torch.arange(w, device=data.device)]
    y = data[hi[:, None] + torch.arange(horizon, device=data.device)]
    return x, y


def draw_masks(seed: int, shape, keep: float, device):
    """Each step's attention dropout mask, in step order: a draw of
    torch.rand(shape) < keep from a generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield torch.rand(shape, generator=gen, device=device) < keep


class StemGNN:
    """The model's parameters (leaf tensors that require grad) and forward."""

    def __init__(self, cfg: dict, flat: dict, device):
        self.cfg = cfg
        n, w = cfg["units"], cfg["window_size"]
        self.gru = torch.nn.GRU(w, n).to(device)
        self.gru.train()  # cuDNN differentiates an RNN only in training mode
        with torch.no_grad():
            for name, attr in GRU_LEAVES.items():
                getattr(self.gru, attr).copy_(flat[name])
        self.p = {k: v.detach().clone().to(device).requires_grad_(True)
                  for k, v in flat.items() if k not in GRU_LEAVES}

    def leaves(self) -> dict:
        """Every parameter under its "/"-joined name."""
        out = dict(self.p)
        out.update({name: getattr(self.gru, attr) for name, attr in GRU_LEAVES.items()})
        return out

    def _linear(self, x, name):
        return x @ self.p[f"{name}/w"] + self.p[f"{name}/b"]

    def _glu(self, x, name):
        return self._linear(x, f"{name}/left") * torch.sigmoid(self._linear(x, f"{name}/right"))

    def latent_correlation(self, x, mask=None):
        """base_model.py:136-162: mul_L [4, N, N]."""
        cfg = self.cfg
        seq, _ = self.gru(x.permute(2, 0, 1).contiguous())  # [N_seq, B, H]
        enc = seq.permute(1, 2, 0)  # [B, H, N_seq]
        key = enc @ self.p["weight_key"]  # [B, N, 1]
        query = enc @ self.p["weight_query"]
        scores = F.leaky_relu(key + query.transpose(1, 2), cfg["leaky_rate"])
        attention = torch.softmax(scores, dim=2)
        if mask is not None:
            attention = attention * mask * (1.0 / (1.0 - cfg["dropout_rate"]))
        attention = attention.mean(dim=0)
        degree = attention.sum(dim=1)
        attention = 0.5 * (attention + attention.T)
        degree_l = torch.diag(degree)
        hat = torch.diag(1.0 / (torch.sqrt(degree) + 1e-7))
        lap = hat @ ((degree_l - attention) @ hat)
        first = torch.zeros_like(lap)
        third = 2.0 * (lap @ lap) - first
        fourth = 2.0 * (lap @ third) - lap
        return torch.stack([first, lap, third, fourth])

    def spe_seq_cell(self, x, i):
        """base_model.py:46-59 on [B, 4, N, W] -> [B, 4, N, W * multi]."""
        b, k, n, w = x.shape
        ff = torch.fft.fft(x, dim=-1)
        real = ff.real.permute(0, 2, 1, 3).reshape(b, n, k * w)
        imag = ff.imag.permute(0, 2, 1, 3).reshape(b, n, k * w)
        for j in range(3):
            real = self._glu(real, f"blocks/{i}/glu/{2 * j}")
            imag = self._glu(imag, f"blocks/{i}/glu/{2 * j + 1}")
        real = real.reshape(b, n, k, -1).permute(0, 2, 1, 3)
        imag = imag.reshape(b, n, k, -1).permute(0, 2, 1, 3)
        return torch.fft.ifft(torch.complex(real, imag), dim=-1).real

    def block(self, x, mul_L, i):
        """StockBlockLayer.forward (base_model.py:61-75); x [B, N, W]."""
        gfted = mul_L[None] @ x[:, None]  # [B, 4, N, W]
        gconv = self.spe_seq_cell(gfted, i)
        igfted = (gconv @ self.p[f"blocks/{i}/weight"][None]).sum(dim=1)  # [B, N, Wm]
        source = torch.sigmoid(self._linear(igfted, f"blocks/{i}/forecast"))
        forecast = self._linear(source, f"blocks/{i}/forecast_result")
        if i == 0:
            short = self._linear(x, f"blocks/{i}/backcast_short_cut")
            return forecast, torch.sigmoid(self._linear(igfted, f"blocks/{i}/backcast") - short)
        return forecast, None

    def forward(self, x, mask=None):
        """x [B, W, N] -> forecast [B, horizon, N] (base_model.py:167-179)."""
        mul_L = self.latent_correlation(x, mask)
        feat = x.permute(0, 2, 1)
        out = 0.0
        for i in range(self.cfg["stack_cnt"]):
            forecast, backcast = self.block(feat, mul_L, i)
            out = out + forecast
            if backcast is not None:
                feat = backcast
        h = F.leaky_relu(self._linear(out, "fc1"), 0.01)
        return self._linear(h, "fc2").permute(0, 2, 1)


class RMSprop:
    """torch.optim.RMSprop(lr, alpha, eps) without momentum, not centered:
    nu <- alpha nu + (1 - alpha) g^2; p <- p - lr g / (sqrt(nu) + eps).
    A leaf the loss does not reach keeps nu and p as they are."""

    def __init__(self, leaves: dict, lr: float, alpha: float, eps: float):
        self.leaves, self.lr, self.alpha, self.eps = leaves, lr, alpha, eps
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self):
        for k, p in self.leaves.items():
            if p.grad is None:
                continue
            g = p.grad
            self.nu[k].mul_(self.alpha).addcmul_(g, g, value=1.0 - self.alpha)
            p.addcdiv_(g, self.nu[k].sqrt().add_(self.eps), value=-self.lr)


# the leaves a fault of a kernel family's backward leaves without gradient:
# the GRU's, and the attention's with the GRU's, which only it feeds
FAULT_LEAVES = {"gru_backward": tuple(GRU_LEAVES),
                "attention_backward": ("weight_key", "weight_query") + tuple(GRU_LEAVES)}


def train_steps(model: StemGNN, opt: RMSprop, data, hi_matrix, masks, fault=None,
                keep_after: int = 1):
    """One step a row of hi_matrix [n, B]: forward with that step's mask from
    `masks`, MSE, backward, RMSprop. Returns (losses [n] as float64 numpy,
    each leaf's gradient norm at the first step as RMSprop gets it, the
    leaves after `keep_after` steps). `fault` breaks the step as the
    benchmark's fault checks plant it: "unchanged" takes no update, "half"
    trains on the first half of each batch, "altered" returns the fourth
    step's loss 1% high, "gru_backward" and "attention_backward" give the
    leaves that the family's backward feeds (FAULT_LEAVES) zero gradients."""
    cfg = model.cfg
    losses, first_grads, after = [], None, None
    for i, hi in enumerate(hi_matrix):
        mask = next(masks)
        x, y = windows(data, hi, cfg["window_size"], cfg["horizon"])
        if fault == "half":
            half = x.shape[0] // 2
            x, y, mask = x[:half], y[:half], mask[:half]
        for p in opt.leaves.values():
            p.grad = None
        loss = torch.mean((model.forward(x, mask) - y) ** 2)
        loss.backward()
        for k in FAULT_LEAVES.get(fault, ()):
            opt.leaves[k].grad.zero_()
        if first_grads is None:
            first_grads = {k: (0.0 if p.grad is None else float(p.grad.double().norm()))
                           for k, p in opt.leaves.items()}
        if fault != "unchanged":
            opt.step()
        value = float(loss.detach())
        if fault == "altered" and i == 3:
            value *= 1.01
        losses.append(value)
        if i + 1 == keep_after:
            after = {k: p.detach().clone() for k, p in opt.leaves.items()}
    return np.asarray(losses, dtype=np.float64), first_grads, after


@torch.no_grad()
def forecast(model: StemGNN, data, batches, fault=None):
    """Forecasts [windows, horizon, N] (float64) of every batch of window end
    indices in `batches`, in order, each batch one forward. `fault` as in
    `train_steps`: "half" forecasts each batch from its first half alone (the
    rest left out), "altered" moves the first forecast by 1% of the largest."""
    cfg = model.cfg
    out = []
    for hi in batches:
        x, _ = windows(data, hi, cfg["window_size"], cfg["horizon"])
        if fault == "half":
            x = x[:max(1, x.shape[0] // 2)]
        out.append(model.forward(x).double().cpu().numpy())
    f = np.concatenate(out)
    if fault == "altered":
        f[0, 0, 0] += 0.01 * np.abs(f).max()
    return f
