"""Where the port's entry points put new tensors, and at what precision
the filters multiply.

No counterpart in ``tpunav`` (JAX places arrays on its default backend).
Every entry point that creates state (``init_controls``, ``course_init``,
``pf_init``, ``grid_init``, ...) takes ``device=`` and defaults to the CUDA
card. Without CUDA it raises: the port never falls back to the CPU on its
own. The CPU is used only when the caller asks for it (``device="cpu"``),
as the CPU tests do.
"""

from __future__ import annotations

import contextlib
import functools

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and this
    process has no CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpunav_torch defaults to the CUDA card, but CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return device


@functools.cache
def constant(values, dtype, device) -> torch.Tensor:
    """``values`` (a number or a tuple of them, hashable) as a tensor of
    ``dtype`` on ``device``, built once per (values, dtype, device) and
    the same tensor on every later call. A step reads its configuration's
    constants without a host-to-device copy, which under CUDA graph
    capture is refused or recorded from a freed host buffer. The cache
    holds one small tensor per configuration triple seen in the process;
    callers must not write to it."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


@contextlib.contextmanager
def full_precision_matmul():
    """float32 matmuls at full precision (no TF32) for the duration, then
    the caller's setting back. The EKF's covariance algebra spans about
    1e-10 .. 1e3, and reduced-precision products (TF32, the card's "high"
    setting) destroy its innovation and Mahalanobis scales; the circle
    detector's moment sums feed an ill-conditioned 4x4 fit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
