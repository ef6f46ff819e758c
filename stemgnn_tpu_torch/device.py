"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes device="cpu". A
request for CUDA on a machine without it raises: nothing falls back to
the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def card_info(device="cuda") -> dict:
    """What a measurement is written down with: {"device": the device's name,
    "power_limit": the card's power limit as nvidia-smi prints it ("700.00 W"),
    None where nvidia-smi cannot be asked}. For the CPU: {"device": "cpu",
    "power_limit": None}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={index}"], capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            limit = smi.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit}
