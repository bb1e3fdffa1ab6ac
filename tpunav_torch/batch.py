"""Seed batches: a per-seed step mapped over B seeds as one program.

``tpunav`` runs a statistical demo's seeds as one compiled program,
``jax.jit(jax.vmap(course))(seeds)``. The port maps its per-seed step
bodies with ``torch.func.vmap``, so every operation of a step runs once for
the whole batch, and a CUDA graph of the mapped step (``capture.Graph``)
replays all B seeds' tick with one launch. The kernels join the batch
through their wrappers: K1 takes a problem axis
(``ops.fused_mppi.mppi_solve_fused_batch``, called between two mapped
halves of a tick), and the eigensolver and the EKF step are
``torch.library`` ops whose batching rules fold the mapped batch into their
own (``ops.sym_eig.eigh``, ``ops.ekf_rows.ekf_step``).

:func:`vmap` refuses what would break that:

- an operation with no batching rule, which ``torch.func.vmap`` would
  otherwise run seed by seed in a hidden loop (its fallback is switched
  off, so such an operation raises);
- a random draw inside the body (``randomness="error"``): a
  ``torch.Generator`` cannot be mapped, so each seed's draws are made
  eagerly from its own generator into static tensors, as the serial loops
  do (the ``noise=`` seams).

Each seed of a batch gets the bits of its own serial step wherever the
batched operation rounds as the single one does: elementwise operations,
the reductions the filter sums its few-term products with
(``estimation/ekf/filter.py:_dot``), and the kernels. A library's matrix
product may round a batch otherwise than one matrix.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_fallback():
    """Within it, an operation that ``torch.func.vmap`` would run through
    its per-sample fallback (a hidden loop over the batch) raises
    instead."""
    functorch = torch._C._functorch
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        functorch._set_vmap_fallback_enabled(was)


def vmap(fn, in_dims=0, out_dims=0):
    """``torch.func.vmap(fn)`` with no per-sample fallback and no random
    draw inside ``fn`` (see the module's docstring)."""
    mapped = torch.func.vmap(fn, in_dims, out_dims, randomness="error")

    def run(*args):
        with no_fallback():
            return mapped(*args)

    return run


def over(fn, batched: bool):
    """``fn`` mapped over a leading batch dimension when ``batched``, else
    ``fn`` itself: one body serves a serial step and a batch of them."""
    return vmap(fn) if batched else fn
