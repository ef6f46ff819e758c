"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/stemgnn_tpu_torch/<hash>/lib<name>.so`, the nvcc of every source
started together at first use. The directory is keyed on a hash of all the
sources, their shared headers (`csrc/*.cuh`) and the flags, so an edit rebuilds and an unchanged tree reuses the
libraries. Libraries are loaded with ctypes (each wrapper caches its own);
every C entry returns the error of its shared-memory opt-in or
`cudaGetLastError()` after its launch, and `check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "stemgnn_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the headers the sources include count too: an edit to one rebuilds
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build_all() -> tuple[Path, float]:
    """Compile every source not yet built, all nvcc processes at once.

    Returns (build directory, seconds spent compiling)."""
    out_dir = _build_dir()
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out_dir, time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """Load `lib<name>.so`, building every source first if need be."""
    with _lock:
        out_dir, _ = build_all()
    return ctypes.CDLL(str(out_dir / f"lib{name}.so"))


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} at launch (1, cudaErrorInvalidValue, is also "
            "the error of shapes that need more shared memory than a block has)")


def stream_ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on these tensors: the wrappers
    then go through their autograd.Function, which saves what the backward
    kernel reads; otherwise they launch the forward kernel alone."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def bf16_arm(fn, doc: str, suffix: str = "_bf16", **fixed):
    """A function that calls the wrapper `fn` at compute_dtype "bfloat16" (and
    the keywords `fixed`) and holds the launch count of that arm of fn's
    kernel (`fn` counts its f32 arm's)."""
    def arm(*args):
        return fn(*args, compute_dtype="bfloat16", **fixed)

    arm.__name__, arm.__doc__, arm.launches = fn.__name__ + suffix, doc, 0
    return arm


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one card."""
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and {tensors[0].device}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
