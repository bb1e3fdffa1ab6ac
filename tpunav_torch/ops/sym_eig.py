"""The batched symmetric eigensolver: its wrapper and its plain version.

No Pallas kernel in ``tpunav`` computes it: there ``jnp.linalg.eigh`` is
XLA's (``tpunav/estimation/landmarks.py:130,146``, the circle fit's two
batched 4×4 calls, and ``tpunav/estimation/ekf/spd.py:36``, the (S, S)
SPD repair). ``torch.linalg.eigh`` on a CUDA tensor reads its error code
on the host, which a CUDA graph capture refuses, so the port solves with
a kernel of its own, ``csrc/sym_eig.cu``, hand-written for Hopper.

``eigh(a)`` returns (w ascending, V) with ``a = V diag(w) Vᵀ`` for a batch
of real symmetric float64 matrices (..., S, S); like ``torch.linalg.eigh``
it reads the lower triangle. The algorithm is the cyclic two-sided Jacobi
method in parallel (round-robin) order:

- A sweep is S' − 1 rounds (S' = S rounded up to even). Round r pairs the
  indices by the circle method: (S' − 1, r) and ((r + i) mod (S' − 1),
  (r − i) mod (S' − 1)) for i = 1 … S'/2 − 1; a pair holding index S (S
  odd) does nothing. A round's S'/2 rotations touch disjoint rows and
  columns, so they apply at once.
- Each pair (p, q) takes Rutishauser's rotation: θ = (a_qq − a_pp)/(2a_pq),
  t = sign(θ)/(|θ| + √(θ² + 1)) (t = 1/(2θ) when |θ| > 1e150), c =
  1/√(t² + 1), s = t·c; a_pq = 0 rotates nothing. The round applies the
  rows' rotations, then the columns', sets a_pp − t·a_pq, a_qq + t·a_pq
  and a zero (p, q) entry, and keeps the upper triangle's values in both
  triangles, so A stays exactly symmetric. V's columns take the same
  rotations.
- Before each sweep, the squared off-diagonal norm Σ_{p<q} a_pq² is held
  against ``TOL``² times the input's squared Frobenius norm; a matrix
  below it stops, and none runs more than ``MAX_SWEEPS`` sweeps. Distinct
  eigenvalues converge quadratically (a random S=103 matrix in ~9 sweeps);
  an exactly repeated eigenvalue converges linearly, as in the row-cyclic
  order (S=103 with three eigenvalues: ~25 sweeps). The
  rotations feed the off-diagonal entries only from off-diagonal entries,
  so the norm falls to the tolerance without a floor from rounding, and
  small eigenvalues keep their relative accuracy (the detector's moment
  matrices span about nine decades).
- The eigenvalues (A's diagonal) are sorted ascending, ties by index and
  NaN last, and V's columns follow them.

``skip``: an optional device bool (one value for the batch). Where it is
set, no sweep runs: w is the sorted diagonal and V its permutation matrix.
``estimation/ekf/spd.py`` passes its ``is_spd`` flag, so the repair of an
SPD covariance, which the caller then discards through a ``torch.where``,
costs no sweeps (``tpunav``'s ``lax.cond``).

A CPU tensor takes the plain version (:func:`eigh_reference`): the same
rotations, in the same order and with the same rounding of each operation,
vectorised over each round's pairs and over the batch; only the norm's sum
runs in another order. A CUDA tensor launches the kernels, or raises:
``sym_eig_small`` for S ≤ 8 (a matrix in registers, one lane per pair of a
round), and for S > 8 ``sym_eig_kernel`` (A's sweeps, one block per
matrix, each round's rotations logged to a device scratch) then
``sym_eig_vectors`` (V from the log, a block per eight columns);
:func:`layout` places A. ``EIG_LAUNCHES`` counts the kernels' launches
(:func:`kernels_per_call` per call). ``eigh`` goes through a
``torch.library`` op (``tpunav_torch::sym_eig``) whose batching rule folds
a ``torch.func.vmap`` batch into its own: a seed batch's detector makes
one call for all its scans.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import check_launch, check_shared_memory, load

TOL = 2.0 ** -52            # off-diagonal norm / Frobenius norm at the stop
MAX_SWEEPS = 30             # sweep cap (see the module's docstring)
BIG_THETA = 1e150           # above it, t = 1/(2θ) (θ² would overflow)
EIG_LAUNCHES = 0            # kernel launches


class _KernelParams(ctypes.Structure):
    """Mirror of ``SymEigParams`` in csrc/sym_eig.cu."""

    _fields_ = [("batch", ctypes.c_int), ("n", ctypes.c_int),
                ("layout", ctypes.c_int),
                ("region", ctypes.c_int),
                ("max_sweeps", ctypes.c_int), ("tol2", ctypes.c_double),
                ("big_theta", ctypes.c_double)]


def _pairs(n: int) -> int:
    return (n + (n & 1)) // 2


@functools.cache
def schedule(n: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The rotation pairs (p < q) of each round of a sweep at size ``n``,
    without the pairs that hold the padding index ``n``."""
    m = n + (n & 1)
    rounds = []
    for r in range(m - 1):
        pairs = [(m - 1, r)]
        pairs += [((r + i) % (m - 1), (r - i) % (m - 1))
                  for i in range(1, m // 2)]
        rounds.append(tuple((min(a, b), max(a, b)) for a, b in pairs
                            if max(a, b) < n))
    return tuple(rounds)


# ── The plain version: the kernel's rotations in plain torch ──


def _rotation(app, aqq, apq):
    """(c, s, t) of each pair's rotation, each operation rounded on its
    own as the kernel rounds it (tensor / tensor: true divisions)."""
    one = torch.ones_like(apq)
    theta = (aqq - app) / (2.0 * apq)
    mag = theta.abs()
    t = one / (mag + torch.sqrt(theta * theta + 1.0))
    t = torch.where(theta < 0, -t, t)
    t = torch.where(mag > BIG_THETA, (0.5 * one) / theta, t)
    t = torch.where(apq == 0, torch.zeros_like(t), t)
    c = one / torch.sqrt(t * t + 1.0)
    return c, t * c, t


def _round(a, u, p, q, upper):
    """One round of disjoint rotations at pairs (p, q) on (B, n, n)
    matrices ``a`` (symmetric) and row-stacked eigenvectors ``u``."""
    b = torch.arange(a.shape[0], device=a.device)[:, None]
    app, aqq, apq = a[b, p, p], a[b, q, q], a[b, p, q]
    c, s, t = _rotation(app, aqq, apq)
    cr, sr = c[..., None], s[..., None]                 # rows: (B, P, 1)
    ap, aq = a[:, p, :], a[:, q, :]
    a = a.index_copy(1, p, cr * ap - sr * aq)
    a = a.index_copy(1, q, sr * ap + cr * aq)
    cc, sc = c[:, None, :], s[:, None, :]               # columns: (B, 1, P)
    ap, aq = a[:, :, p], a[:, :, q]
    a = a.index_copy(2, p, cc * ap - sc * aq)
    a = a.index_copy(2, q, sc * ap + cc * aq)
    a[b, p, p] = app - t * apq
    a[b, q, q] = aqq + t * apq
    a[b, p, q] = 0.0
    a[b, q, p] = 0.0
    a = torch.where(upper, a, a.transpose(-1, -2))
    up, uq = u[:, p, :], u[:, q, :]
    u = u.index_copy(1, p, cr * up - sr * uq)
    u = u.index_copy(1, q, sr * up + cr * uq)
    return a, u


def _sorted(a, u):
    """Eigenvalues ascending (ties by index, NaN last) and V's columns."""
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    key = torch.where(torch.isnan(w), float("inf"), w)
    order = torch.argsort(key, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    v = torch.gather(u, 1, order[..., None].expand_as(u)).transpose(-1, -2)
    return w, v


def _jacobi(a, skip):
    """The sweeps on (B, n, n) ``a``: (A, row-stacked eigenvectors, the
    sweeps each matrix ran)."""
    n = a.shape[-1]
    low = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    a = torch.where(low, a, a.transpose(-1, -2))        # the lower triangle
    u = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a).clone()
    norm2 = (a * a).sum(dim=(-1, -2))
    upper = low.T
    strict = torch.ones_like(low).triu(1)
    rounds = [tuple(torch.tensor(x, device=a.device) for x in zip(*pairs))
              for pairs in schedule(n) if pairs]
    live = torch.ones_like(norm2, dtype=torch.bool)
    if skip is not None:
        live = torch.logical_and(live, ~skip.to(a.device).reshape(()))
    sweeps = torch.zeros_like(norm2, dtype=torch.int64)
    for _ in range(MAX_SWEEPS):
        off2 = torch.where(strict, a * a, 0.0).sum(dim=(-1, -2))
        live = torch.logical_and(live, ~(off2 <= (TOL * TOL) * norm2))
        if not bool(live.any()):
            break
        sweeps += live
        for p, q in rounds:
            a_new, u_new = _round(a, u, p, q, upper)
            a = torch.where(live[:, None, None], a_new, a)
            u = torch.where(live[:, None, None], u_new, u)
    return a, u, sweeps


def eigh_reference(a, skip: Optional[torch.Tensor] = None):
    """The kernel's Jacobi in plain torch: (w, V) of (..., S, S) float64
    symmetric ``a`` (its lower triangle). Its convergence test reads the
    host once per sweep, so it serves CPU tensors and checks."""
    n, batch = a.shape[-1], a.shape[:-2]
    a, u, _ = _jacobi(a.reshape(-1, n, n), skip)
    w, v = _sorted(a, u)
    return w.reshape(*batch, n), v.reshape(*batch, n, n)


# ── The kernels ──

SMALL_MAX = 8               # S ≤ 8: one thread per matrix, in registers
# Where A lies while the sweeps run (SymEigParams.layout in the .cu):
# registers (S ≤ 8), its upper triangle packed in shared memory, packed in a
# device scratch.
LAYOUTS = ("registers", "shared_packed", "global_packed")


def small_lanes(n: int) -> int:
    """Threads per matrix of the register kernel (S ≤ 8): one per pair a
    round rotates, rounded up to a power of two (csrc/sym_eig.cu)."""
    return 1 if n <= 3 else 2 if n <= 5 else 4


BLOCK_THREADS = 512         # threads per block of the A phase (S > 8)


def layout(n: int, smem_limit: int):
    """(layout, region, shared bytes) of the A phase at size ``n`` on a card
    whose blocks may opt in to ``smem_limit`` bytes: where A lies
    (``LAYOUTS``), the bytes of shared memory that hold it, and the block's
    dynamic shared memory."""
    if n <= SMALL_MAX:
        return "registers", 0, 0
    extras = 40 * 2 * _pairs(n) + 8 * (32 + n)      # keep in step: the .cu
    packed = 4 * n * (n + 1)
    if extras + packed <= smem_limit:
        kind, region = "shared_packed", packed
    else:
        kind, region = "global_packed", 0
    return kind, region, extras + region


VECTOR_COLUMNS = 8          # U's columns per block of the V phase


def vector_blocks(n: int, batch: int):
    """(blocks, threads, shared bytes) of the V phase (S > 8): one block per
    VECTOR_COLUMNS of each matrix's U, a thread per pair and column quad."""
    pairs = _pairs(n)
    return (batch * -(-n // VECTOR_COLUMNS),
            min(1024, -(-pairs * VECTOR_COLUMNS // 4 // 32) * 32),
            16 * 4 * pairs + 8 * n * VECTOR_COLUMNS)


def kernels_per_call(n: int) -> int:
    """Kernel launches of one :func:`eigh` call on the card (counted in
    ``EIG_LAUNCHES``): the register kernel, or the A and V phases."""
    return 1 if n <= SMALL_MAX else 2


def layout_spans(smem_limit: int, largest: int = 320):
    """[(layout, first S, last S)] for S = 1 … ``largest`` on a card whose
    blocks may opt in to ``smem_limit`` bytes: where each layout begins and
    ends (``chip_smoke.py`` checks the kernels on both sides of each
    boundary)."""
    spans = []
    for n in range(1, largest + 1):
        kind = layout(n, smem_limit)[0]
        if spans and spans[-1][0] == kind:
            spans[-1][2] = n
        else:
            spans.append([kind, n, n])
    return [tuple(x) for x in spans]


def scratch_doubles(n: int, batch: int, kind: str) -> int:
    """Doubles of device scratch a launch takes: the rotation log (c, s of
    every pair of every round the sweep cap allows), each matrix's rounds
    run and ranking, then A's packed planes where they lie in device
    memory."""
    if n <= SMALL_MAX:
        return 0
    m = n + (n & 1)
    log = 2 * batch * MAX_SWEEPS * (m - 1) * (m // 2)
    meta = (batch * (n + 1) + 1) // 2       # rounds run and ranking, ints
    return log + meta + (batch * n * (n + 1) // 2
                         if kind == "global_packed" else 0)


def _launch(a, skip):
    global EIG_LAUNCHES
    lib = load()
    n = a.shape[-1]
    batch = a.numel() // (n * n) if n else 0
    w = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
    v = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if batch == 0:
        return w, v
    kind, region, smem = layout(n, lib.tpunav_max_dynamic_smem())
    check_shared_memory(lib, smem, f"the eigensolver at S={n}")
    if n > SMALL_MAX:
        check_shared_memory(lib, vector_blocks(n, batch)[2],
                            f"the eigensolver's vectors at S={n}")
    count = scratch_doubles(n, batch, kind)
    scratch = (torch.empty(count, dtype=a.dtype, device=a.device)
               if count else None)
    params = _KernelParams(batch, n, LAYOUTS.index(kind), region,
                           MAX_SWEEPS, TOL * TOL, BIG_THETA)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_sym_eig(
            ctypes.addressof(params), a.data_ptr(),
            None if skip is None else skip.data_ptr(), w.data_ptr(),
            v.data_ptr(), None if scratch is None else scratch.data_ptr(),
            stream)
    check_launch(lib, err, "symmetric eigensolver")
    EIG_LAUNCHES += kernels_per_call(n)
    return w, v


@torch.library.custom_op("tpunav_torch::sym_eig", mutates_args=())
def _eigh_op(a: torch.Tensor, skip: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not a.is_contiguous():
        raise ValueError("eigh takes a contiguous tensor")
    if a.is_cuda:
        return _launch(a, skip)
    if a.device.type != "cpu":
        raise ValueError(f"no eigensolver for device {a.device}")
    return eigh_reference(a, skip)


@_eigh_op.register_vmap
def _eigh_vmap(info, in_dims, a, skip):
    """Under ``torch.func.vmap``: one call on the batch folded into the
    leading dimensions. A per-matrix ``skip`` becomes one flag, set only
    where every matrix may skip: a matrix that might have skipped then runs
    its sweeps, and its caller discards the result (``spd.py``)."""
    a_dim, skip_dim = in_dims
    a = (a.expand(info.batch_size, *a.shape) if a_dim is None
         else a.movedim(a_dim, 0))
    if skip is not None and skip_dim is not None:
        skip = skip.all()
    return _eigh_op(a.contiguous(), skip), (0, 0)


def eigh(a, skip: Optional[torch.Tensor] = None):
    """(w ascending, V) of the float64 symmetric (..., S, S) ``a`` (its
    lower triangle), eigenvector signs free; the leading dimensions fold
    into one batch, one call of the kernels. ``skip``: an optional one-value
    bool tensor on ``a``'s device; where True, no sweep runs (see the
    module's docstring). A CUDA tensor launches ``csrc/sym_eig.cu``. Under
    ``torch.func.vmap`` the mapped batch joins the leading dimensions: one
    call for the whole batch."""
    if a.dtype != torch.float64:
        raise TypeError(f"eigh takes float64, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"eigh takes (..., S, S), got {tuple(a.shape)}")
    if skip is not None and (skip.device != a.device or
                             skip.dtype != torch.bool or skip.numel() != 1):
        raise ValueError("skip must be one bool value on a's device")
    return _eigh_op(a, skip)
