"""Random sampling helpers over an explicit ``torch.Generator``.

Port of ``tpunav/core/randoms.py`` (the reference's Mersenne-twister
helpers, rigid2d/src/rigid2d/utilities.cpp:12-56). Where ``tpunav`` takes a
``jax.random`` key, these take a ``torch.Generator``; the draws land on the
generator's device.
"""

from __future__ import annotations

import torch


def sample_normal(generator: torch.Generator, mean, std, shape=(),
                  dtype=torch.float32):
    """Gaussian draw (ref: sampleNormalDistribution utilities.cpp:20-24)."""
    return mean + std * torch.randn(shape, generator=generator, dtype=dtype,
                                    device=generator.device)


def sample_uniform(generator: torch.Generator, lo, hi, shape=(),
                   dtype=torch.float32):
    """Uniform draw on [lo, hi) (ref: sampleUniformDistribution
    utilities.cpp:27-31)."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return lo + (hi - lo) * u


def sample_multivariate(generator: torch.Generator, cov, shape=()):
    """Zero-mean multivariate Gaussian via the Cholesky factor of ``cov``
    (ref: sampleMultivariateDistribution utilities.cpp:46-56). As in
    ``tpunav`` (``jnp.linalg.cholesky``), a ``cov`` whose factor fails gives
    NaN draws."""
    n = cov.shape[-1]
    fac = torch.linalg.cholesky_ex(cov)
    chol = torch.where((fac.info == 0)[..., None, None], fac.L, float("nan"))
    z = torch.randn((*shape, n), generator=generator, dtype=cov.dtype,
                    device=cov.device)
    return torch.einsum("...ij,...j->...i", chol, z)


def euclidean_distance(x0, y0, x1, y1):
    """(ref: euclideanDistance utilities.cpp:59-63)."""
    return torch.hypot(torch.as_tensor(x1) - x0, torch.as_tensor(y1) - y0)
