"""Philox4x32-10 and Box-Muller in plain PyTorch: the stream that the
fused MPPI solve draws its perturbations from, frozen here so that the
reference regenerates a solve's noise from its seed alone.

The stream of the fused solve: key (seed, 0), counter (k, t, 0, 0) for
rollout k at horizon step t. Output words 0 and 1 give u1, u2 in (0, 1]
from their top 24 bits (exact in float32), and Box-Muller gives
g0 = sqrt(-2 log u1) cos(2π u2), g1 = sqrt(-2 log u1) sin(2π u2).

Words are held in int64 tensors with values in [0, 2**32). The 32×32→64
``mulhi`` is done in 16-bit limbs, since a 64-bit signed product of two
uint32 overflows.
"""

from __future__ import annotations

import math

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m·b, b in [0, 2**32)."""
    p_lo = m * (b & 0xFFFF)            # < 2**48
    p_hi = m * (b >> 16)               # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32 with 10 rounds (Random123's philox4x32_R(10, ...)).

    ctr: 4 int64 tensors (broadcastable) of 32-bit words; key: 2 of them.
    Returns the 4 output words as int64 tensors.
    """
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform01(word: torch.Tensor) -> torch.Tensor:
    """float32 uniform in (0, 1] from the top 24 bits of a 32-bit word."""
    return ((word >> 8) + 1).to(torch.float32) * (2.0 ** -24)


def box_muller(w0: torch.Tensor, w1: torch.Tensor):
    """Two standard normals (float32) from two 32-bit words."""
    u1 = uniform01(w0)
    u2 = uniform01(w1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * u2
    return r * torch.cos(ang), r * torch.sin(ang)


def mppi_noise(seeds: torch.Tensor, rollouts: int, steps: int,
               sig0: float, sig1: float) -> torch.Tensor:
    """The solves' perturbations, (S, N, K, 2) float32, for S seeds
    ((S,) integers; the low 32 bits of each are key word 0)."""
    seed = (seeds.to(torch.int64) & _MASK)[:, None, None]
    dev = seed.device
    k = torch.arange(rollouts, dtype=torch.int64, device=dev)[None, None, :]
    t = torch.arange(steps, dtype=torch.int64, device=dev)[None, :, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w = philox4x32_10((k, t, zero, zero), (seed, zero))
    g0, g1 = box_muller(w[0], w[1])
    return torch.stack([g0 * sig0, g1 * sig1], dim=-1)
