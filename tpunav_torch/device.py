"""Where the port's entry points put new tensors.

No counterpart in ``tpunav`` (JAX places arrays on its default backend).
Every entry point that creates state (``init_controls``, ``course_init``,
``pf_init``, ``grid_init``, ...) takes ``device=`` and defaults to the CUDA
card. Without CUDA it raises: the port never falls back to the CPU on its
own. The CPU is used only when the caller asks for it (``device="cpu"``),
as the CPU tests do.
"""

from __future__ import annotations

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
