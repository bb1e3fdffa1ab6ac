"""The port's symmetric eigensolver (``tpunav_torch/ops/sym_eig.py``) on
the CPU, where a tensor takes the kernel's plain version: the same
round-robin Jacobi rotations the card's kernel (``csrc/sym_eig.cu``)
applies.

- Against ``numpy.linalg.eigh`` and ``jnp.linalg.eigh`` (what ``tpunav``
  calls in its circle fit and SPD repair) on random SPD, indefinite,
  rank-deficient, graded (nine decades) and repeated-eigenvalue float64
  matrices at S ∈ {4, 17, 53, 103}: eigenvalues within 1e-12 of the
  largest, reconstruction V diag(w) Vᵀ and orthogonality within 1e-12,
  ascending order; eigenvector signs are free.
- The batch, the lower triangle, the skip flag, NaN, the input checks, the
  rotation schedule and the kernel's memory layouts.
- The SPD repair gated by ``is_spd``'s flag: an SPD input comes back bit
  for bit, a non-SPD one as ``tpunav``'s ``repair_if_needed`` at rtol 1e-9.
- No ``torch.linalg.eigh`` call is left in the package.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.estimation.ekf import spd as jspd
from tpunav_torch.estimation.ekf import spd
from tpunav_torch.ops import sym_eig

torch.set_num_threads(1)

SIZES = (4, 17, 53, 103)
KINDS = ("spd", "indefinite", "rank_deficient", "graded", "repeated")
BAR = 1e-12


def _matrix(kind, n, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.normal(size=(n, n))
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    if kind == "spd":
        return x @ x.T + 0.1 * np.eye(n)
    if kind == "indefinite":
        return x + x.T
    if kind == "rank_deficient":
        z = rng.normal(size=(n, max(1, n // 3)))
        return z @ z.T
    if kind == "graded":                       # eigenvalues 1e-9 … 1
        return (q * np.logspace(-9, 0, n)) @ q.T
    d = np.repeat([1.0, 2.0, 3.0], -(-n // 3))[:n]     # "repeated"
    return (q * d) @ q.T


def _check(a, w, v):
    """Eigenvalues against numpy's and tpunav's eigh, reconstruction and
    orthogonality, each relative to the largest |eigenvalue|."""
    w, v = w.numpy(), v.numpy()
    want = np.linalg.eigvalsh(a)
    theirs = np.asarray(jnp.linalg.eigh(jnp.asarray(a))[0])
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(w - want) / scale).max() <= BAR
    assert (np.abs(w - theirs) / scale).max() <= BAR
    rec = v @ (w[..., None] * np.swapaxes(v, -1, -2))
    assert (np.abs(rec - a) / scale[..., None]).max() <= BAR
    n = a.shape[-1]
    assert np.abs(np.swapaxes(v, -1, -2) @ v - np.eye(n)).max() <= BAR
    assert (np.diff(w, axis=-1) >= 0).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_eigh_matches_numpy_and_tpunav(kind, n):
    a = _matrix(kind, n)
    w, v = sym_eig.eigh(torch.from_numpy(a))
    assert w.dtype == v.dtype == torch.float64
    assert w.shape == (n,) and v.shape == (n, n)
    _check(a, w, v)


def test_eigh_takes_a_batch_and_reads_the_lower_triangle():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 4, 4))
    a = x @ np.swapaxes(x, -1, -2)
    w, v = sym_eig.eigh(torch.from_numpy(a))
    assert w.shape == (2, 3, 4) and v.shape == (2, 3, 4, 4)
    _check(a, w, v)
    # Garbage above the diagonal is not read.
    junk = a + np.triu(rng.normal(size=a.shape), 1)
    w2, v2 = sym_eig.eigh(torch.from_numpy(junk))
    assert torch.equal(w, w2) and torch.equal(v, v2)


def test_eigh_of_the_detectors_batch():
    """The circle fit's (32, 4, 4) batch: moment matrices of small
    circles (nine decades), and the identity of an empty slot."""
    rng = np.random.default_rng(4)
    mats = []
    for i in range(31):
        ang = rng.uniform(0, np.pi, size=8)
        pts = 0.04 * np.stack([np.cos(ang), np.sin(ang)], -1)
        pts += 1e-3 * rng.normal(size=pts.shape)
        pts -= pts.mean(0)
        z = (pts ** 2).sum(-1)
        zm = np.stack([z, pts[:, 0], pts[:, 1], np.ones(8)], -1)
        mats.append(zm.T @ zm)
    mats.append(np.eye(4))
    a = np.stack(mats)
    w, v = sym_eig.eigh(torch.from_numpy(a))
    _check(a, w, v)
    assert torch.equal(w[-1], torch.ones(4, dtype=torch.float64))


def test_skip_flag_runs_no_sweep():
    a = torch.tensor([[3.0, 0.5, 0.0], [0.5, 1.0, 0.0], [0.0, 0.0, 2.0]],
                     dtype=torch.float64)
    w, v = sym_eig.eigh(a, skip=torch.tensor(True))
    assert w.tolist() == [1.0, 2.0, 3.0]
    assert v.tolist() == [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0]]
    w, _ = sym_eig.eigh(a, skip=torch.tensor(False))
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a.numpy()),
                               rtol=0, atol=1e-15)


def test_nan_sorts_last_and_zero_is_exact():
    a = torch.zeros((2, 5, 5), dtype=torch.float64)
    a[1, 2, 2] = float("nan")
    w, v = sym_eig.eigh(a)
    assert torch.equal(w[0], torch.zeros(5, dtype=torch.float64))
    assert torch.equal(v[0], torch.eye(5, dtype=torch.float64))
    assert torch.isnan(w[1, -1]) and not torch.isnan(w[1, :-1]).any()


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.eye(3), TypeError),
    (lambda: torch.zeros((3, 4), dtype=torch.float64), ValueError),
    (lambda: torch.eye(4, dtype=torch.float64)[:, ::2][:2], ValueError),
])
def test_eigh_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        sym_eig.eigh(bad())


def test_skip_must_be_one_bool():
    with pytest.raises(ValueError, match="skip"):
        sym_eig.eigh(torch.eye(3, dtype=torch.float64),
                     skip=torch.tensor([True, False]))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 53])
def test_schedule_pairs_every_index_once_per_sweep(n):
    """Each round's pairs are disjoint; a sweep meets every pair once."""
    seen = []
    for pairs in sym_eig.schedule(n):
        flat = [i for pq in pairs for i in pq]
        assert len(flat) == len(set(flat))
        assert all(p < q < n for p, q in pairs)
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(n)
                            for q in range(p + 1, n)]


def test_layouts_fit_the_cards_shared_memory():
    """On an H100 (232,448 bytes a block may opt in to): both planes in
    shared memory at the repair's S = 53 and 103, A alone at S = 150,
    neither at S = 203; the detector's 4×4 in a warp."""
    limit = 232_448
    assert sym_eig.layout(53, limit)[:2] == (True, True)
    assert sym_eig.layout(103, limit)[:2] == (True, True)
    assert sym_eig.layout(150, limit)[:2] == (True, False)
    assert sym_eig.layout(203, limit)[:2] == (False, False)
    assert all(sym_eig.layout(n, limit)[3] <= limit
               for n in (4, 53, 103, 150, 203))
    assert sym_eig.layout(103, limit)[2] % 2 == 1
    assert sym_eig._threads(4) == 32


# ------------------------------------------------------ the gated repair --

def _repair_cases():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6))
    good = a @ a.T + 0.1 * np.eye(6)
    big = rng.normal(size=(53, 53))
    return {"good": (good, True),
            "indefinite": (np.array([[1.0, 2.0], [2.0, 1.0]]), False),
            "rank_one": (np.outer(a[0], a[0]), False),
            "negative_diag": (-np.eye(3), False),
            "ekf_sized_indefinite": (big + big.T, False),
            "ekf_sized_spd": (big @ big.T + np.eye(53), True)}


@pytest.mark.parametrize("name", sorted(_repair_cases()))
def test_gated_repair_matches_tpunav(name):
    m, is_spd = _repair_cases()[name]
    t = torch.from_numpy(m)
    assert bool(spd.is_spd(t)) == is_spd
    got = spd.repair_if_needed(t)
    if is_spd:
        assert torch.equal(got, t)
    want = np.asarray(jspd.repair_if_needed(jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    if not is_spd:
        assert bool(spd.is_spd(got)) == bool(jspd.is_spd(jnp.asarray(want)))


def test_gated_repair_of_nan_is_nan():
    got = spd.repair_if_needed(torch.full((3, 3), float("nan"),
                                          dtype=torch.float64))
    want = np.asarray(jspd.repair_if_needed(jnp.full((3, 3), jnp.nan)))
    assert np.isnan(want).all() and torch.isnan(got).all()


def test_no_library_eigh_left_in_the_package():
    """The port's eigendecompositions go through ``ops/sym_eig.py``: no
    ``torch.linalg.eigh`` call (which reads its error code on the host)
    is left in ``tpunav_torch/``."""
    root = pathlib.Path(sym_eig.__file__).resolve().parents[1]
    call = re.compile(r"linalg\.eigh\s*\(|\beigh\s*=\s*torch\.linalg")
    found = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if call.search(p.read_text())]
    assert found == []
