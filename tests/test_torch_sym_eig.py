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

import functools
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


H100_SMEM = 232_448          # the shared memory an H100 block may opt in to


def test_layouts_fit_the_cards_shared_memory():
    """On an H100: every S from 2 to 320 gets a layout within the block's
    232,448 bytes, and so does the V phase's block; the register kernel
    takes S ≤ 8, A lies packed in shared memory to S = 234, then in device
    memory, where ``chip_smoke.py`` checks both sides of each boundary
    (``layout_spans``)."""
    spans = sym_eig.layout_spans(H100_SMEM)
    assert spans == [("registers", 1, 8), ("shared_packed", 9, 234),
                     ("global_packed", 235, 320)]
    for n in range(2, 321):
        kind, region, smem = sym_eig.layout(n, H100_SMEM)
        assert smem <= H100_SMEM
        if kind == "registers":
            assert n <= sym_eig.SMALL_MAX and smem == 0
            assert sym_eig.kernels_per_call(n) == 1
            continue
        assert sym_eig.kernels_per_call(n) == 2
        assert region == {"shared_packed": 4 * n * (n + 1),
                          "global_packed": 0}[kind]
        blocks, threads, vsmem = sym_eig.vector_blocks(n, 3)
        assert blocks == 3 * -(-n // sym_eig.VECTOR_COLUMNS)
        assert threads % 32 == 0 and threads <= 1024 and vsmem <= H100_SMEM
    # The repair at capacity 25 and 50, and S = 203.
    assert sym_eig.layout(53, H100_SMEM)[0] == "shared_packed"
    assert sym_eig.layout(103, H100_SMEM)[0] == "shared_packed"
    assert sym_eig.layout(203, H100_SMEM)[0] == "shared_packed"
    assert sym_eig.layout(4, H100_SMEM)[0] == "registers"
    # The rotation log ((c, s) of each pair of each round, MAX_SWEEPS deep),
    # each matrix's rounds and ranking, then packed planes in device memory.
    assert sym_eig.scratch_doubles(4, 32, "registers") == 0
    assert (sym_eig.scratch_doubles(103, 1, "shared_packed")
            == 2 * sym_eig.MAX_SWEEPS * 103 * 52 + 52)
    assert (sym_eig.scratch_doubles(237, 2, "global_packed")
            == 2 * 2 * sym_eig.MAX_SWEEPS * 237 * 119 + 238
            + 2 * 237 * 238 // 2)


# ------------------------- a mirror of sym_eig_kernel's index arithmetic --
# csrc/sym_eig.cu gives a round's work out as flat items (the upper
# triangle's 2x2 blocks at pair indices i <= j, i-major), each thread a run
# of them, has the thread that writes the entry of a next-round pair take
# that pair's rotation, and builds U from the rotation log over (column,
# pair) threads. The mirror below repeats that arithmetic in numpy.

KFOUND = 4      # next-round pairs a thread holds back a round (kFound)


def _wrap(x, k):
    return np.where(x < 0, x + k, np.where(x >= k, x - k, x))


def _pair(r, i, m):
    """(p, q) of pairs i (array) of round r: pair_lo, pair_hi."""
    a, b = _wrap(r + i, m - 1), _wrap(r - i, m - 1)
    lo = np.where(i == 0, r, np.minimum(a, b))
    hi = np.where(i == 0, m - 1, np.maximum(a, b))
    return lo, hi


def _partner(x, r, m):
    y = _wrap(2 * r - x, m - 1)
    return np.where(x == m - 1, r, np.where(y == x, m - 1, y))


def _pair_index(x, r, m):
    k = _wrap(x - r, m - 1)
    return np.where(k > m // 2 - 1, m - 1 - k, k)


@functools.cache
def _thread_runs(P, threads=sym_eig.BLOCK_THREADS):
    """Each thread's items as sym_eig_kernel walks them, (thread, e, i, j)
    rows: thread t takes items e0 = t·per up to e1 (per = ⌈items/threads⌉,
    both clamped to the items), from row i0 (the first row whose items
    reach past e0) and column j0, i-major, the column wrapping to
    (i + 1, i + 1) when it reaches P."""
    items = P * (P + 1) // 2
    per = -(-items // threads)
    rows = []
    for tid in range(threads):
        e0 = min(tid * per, items)
        e1 = min(e0 + per, items)
        i0 = 0
        while i0 + 1 < P and (i0 + 1) * P - (i0 + 1) * i0 // 2 <= e0:
            i0 += 1
        j0 = i0 + e0 - (i0 * P - i0 * (i0 - 1) // 2)
        i, j = i0, j0 - 1
        for e in range(e0, e1):
            j += 1
            if j == P:
                i += 1
                j = i
            rows.append((tid, e, i, j))
    return np.array(rows, dtype=np.int64).reshape(-1, 4)


def _items(P):
    """(i, j) of each item e, in e's order, and the thread that takes it."""
    runs = _thread_runs(P)
    order = np.argsort(runs[:, 1], kind="stable")
    return runs[order, 2], runs[order, 3], runs[order, 0]


@pytest.mark.parametrize("n", [5, 17, 53, 103, 203, 235])
def test_kernel_thread_runs_cover_the_items_once(n):
    """The runs of the A phase's threads cover a round's P(P+1)/2 items
    exactly once, each thread's run is consecutive, and item e is block
    (i, j) of the i-major order: row i begins at item i·P − i(i−1)/2."""
    P = (n + (n & 1)) // 2
    items = P * (P + 1) // 2
    runs = _thread_runs(P)
    assert sorted(runs[:, 1].tolist()) == list(range(items))
    for t in np.unique(runs[:, 0]):
        e = runs[runs[:, 0] == t, 1]
        assert (np.diff(e) == 1).all()
    i, j, _ = _items(P)
    want = [(a, b) for a in range(P) for b in range(a, P)]
    assert list(zip(i.tolist(), j.tolist())) == want
    start = i * P - i * (i - 1) // 2
    assert (start + (j - i) == np.arange(items)).all()


def _next_pair(lo, hi, r1, m):
    """The next round's pair index of entry (lo, hi), else -1."""
    k = np.where(_wrap(lo + hi, m - 1) == _wrap(2 * r1, m - 1),
                 _pair_index(lo, r1, m), -1)
    return np.where(hi == m - 1, np.where(lo == r1, 0, -1), k)


def _round_entries(n, r):
    """Every (item, lo, hi) entry a round's items write, and the entries'
    4-index block positions (R[u], C[v])."""
    P = (n + (n & 1)) // 2
    m = 2 * P
    i, j, _ = _items(P)
    pi, qi = _pair(r, i, m)
    pj, qj = _pair(r, j, m)
    out = []
    diag = (i == j) & (qi < n)
    for a, c in ((pi, pi), (qi, qi), (pi, qi)):
        out.append((a[diag], c[diag], np.full(diag.sum(), -1)))
    off = i != j
    for ra, va in ((pi, True), (qi, qi < n)):
        for ca, vc in ((pj, True), (qj, qj < n)):
            live = off & va & vc
            lo, hi = np.minimum(ra, ca)[live], np.maximum(ra, ca)[live]
            out.append((lo, hi, np.nonzero(live)[0]))
    return [np.concatenate(x) for x in zip(*out)]


@pytest.mark.parametrize("n", [5, 17, 53, 103, 203])
def test_kernel_work_items_cover_each_round_once(n):
    """Per round of ``schedule(n)`` and of the sweep's wrap to round 0:
    the kernel's pair arithmetic gives the schedule's pairs; its items
    write every entry of A's upper triangle exactly once (but the
    diagonal of an index the round leaves unpaired); every pair of
    the next round gets its rotation from exactly one entry, the pair's
    own; each index finds its pair (or none) for its new diagonal; and
    the V phase rotates every (pair, column) of U exactly once."""
    P = (n + (n & 1)) // 2
    m = 2 * P
    rounds = sym_eig.schedule(n)
    upper = np.triu(np.ones((n, n), dtype=bool))
    for r in range(m - 1):
        lo, hi = _pair(r, np.arange(P), m)
        real = hi < n
        assert sorted(zip(lo[real].tolist(), hi[real].tolist())) == sorted(
            rounds[r])
        a, c, item = _round_entries(n, r)
        hits = np.zeros((n, n), dtype=np.int64)
        np.add.at(hits, (a, c), 1)
        want = upper.astype(np.int64)
        alone = _partner(np.arange(n), r, m) >= n   # unpaired: diagonal kept
        want[alone, alone] = 0
        assert (hits == want).all()
        r1 = 0 if r + 1 == m - 1 else r + 1
        # Only the off-diagonal blocks' entries are tested (item >= 0), and
        # of those only the blocks the kernel tests: (0, 1), (0, 2),
        # (i, i + 2) and (i, 2P - 3 - i).
        k = np.where(item >= 0, _next_pair(a, c, r1, m), -1)
        found = k >= 0
        nlo, nhi = _pair(r1, k[found], m)
        assert (nlo == a[found]).all() and (nhi == c[found]).all()
        bi, bj, bt = _items(P)
        bi, bj, bt = bi[item[found]], bj[item[found]], bt[item[found]]
        assert (((bi == 0) & (bj <= 2)) | (bj - bi == 2)
                | (bi + bj == 2 * P - 3)).all()
        # Each thread holds its pairs' inputs back to the end of its run; at
        # these S none finds more than kFound (the rest it would rotate at
        # once).
        assert np.bincount(bt).max(initial=0) <= KFOUND
        want = sorted(i for i, pq in enumerate(zip(*_pair(r1, np.arange(P),
                                                          m)))
                      if pq[1] < n)
        assert sorted(k[found].tolist()) == want
        x = np.arange(n)
        y = _partner(x, r, m)
        for xi, yi in zip(x.tolist(), y.tolist()):
            if yi >= n:
                assert all(xi not in pq for pq in rounds[r])
                continue
            idx = 0 if xi == m - 1 or yi == m - 1 else int(
                _pair_index(xi, r, m))
            assert tuple(sorted((xi, yi))) == tuple(
                int(v) for v in (lo[idx], hi[idx]))
        # The V phase: a block per VECTOR_COLUMNS columns; thread t → column
        # quad t % Q of the block (Q quads), pairs g, g + G, … (g = t // Q,
        # G = threads // Q).
        done = np.zeros((P, n + 3), dtype=np.int64)
        threads = sym_eig.vector_blocks(n, 1)[1]
        quads = sym_eig.VECTOR_COLUMNS // 4
        for k0 in range(0, n, sym_eig.VECTOR_COLUMNS):
            groups = threads // quads
            t = np.arange(groups * quads)
            quad, g = t % quads, t // quads
            for step in range(-(-P // groups)):
                pair = g + step * groups
                ok = pair < P
                for c in range(4):
                    col = k0 + 4 * quad + c
                    keep = ok & (col < min(k0 + sym_eig.VECTOR_COLUMNS, n))
                    np.add.at(done, (pair[keep], col[keep]), 1)
        assert (done[real, :n] == 1).all() and (done[:, n:] == 0).all()


def _mirror_jacobi(a, sweeps):
    """``sweeps`` sweeps of the kernel's round as its items do them, on one
    (n, n) float64 matrix: entries from their blocks in their one order,
    each next round's rotation from the entry of its pair (looked for only
    in the blocks the kernel looks in) and the new diagonals kept with this
    round's rotations, U from the log. The rotations' arithmetic is the
    plain version's ``_rotation``."""
    n = a.shape[-1]
    P = (n + (n & 1)) // 2
    m = 2 * P
    A = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), a, a.T).clone()

    def rotations(app, aqq, apq):
        c, s, t = sym_eig._rotation(app, aqq, apq)
        return torch.stack([c, s, app - t * apq, aqq + t * apq], -1)

    lo, hi = _pair(0, np.arange(P), m)
    real = torch.from_numpy(hi < n)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(np.minimum(hi, n - 1))
    cur = rotations(A[lo_t, lo_t], A[hi_t, hi_t], A[lo_t, hi_t])
    log = []
    i_it, j_it, _ = _items(P)
    for rho in range(sweeps * (m - 1)):
        r = rho % (m - 1)
        r1 = 0 if r + 1 == m - 1 else r + 1
        log.append((r, cur[:, :2].clone()))
        nxt = torch.zeros_like(cur)
        pi, qi = _pair(r, i_it, m)
        pj, qj = _pair(r, j_it, m)
        new = A.clone()
        for e in range(len(i_it)):
            i, j = int(i_it[e]), int(j_it[e])
            vi, vj = qi[e] < n, qj[e] < n
            if i == j:
                if vi:
                    new[pi[e], pi[e]] = cur[i, 2]
                    new[qi[e], qi[e]] = cur[i, 3]
                    new[pi[e], qi[e]] = 0.0
                continue
            R, C = (int(pi[e]), int(qi[e])), (int(pj[e]), int(qj[e]))
            X = [[A[min(R[u], C[v]), max(R[u], C[v])] if (u == 0 or vi) and
                  (v == 0 or vj) else torch.zeros((), dtype=A.dtype)
                  for v in range(2)] for u in range(2)]

            def rot(h, cs, x, y):
                c, s = cs
                return s * x + c * y if h else c * x - s * y

            ri, rj = cur[i, :2], cur[j, :2]
            for u in range(2):
                for v in range(2):
                    if (u == 1 and not vi) or (v == 1 and not vj):
                        continue
                    if R[u] < C[v]:
                        g = [rot(u, ri, X[0][k], X[1][k]) if vi else X[u][k]
                             for k in range(2)]
                        val = rot(v, rj, g[0], g[1]) if vj else g[0]
                    else:
                        g = [rot(v, rj, X[k][0], X[k][1]) if vj else X[k][v]
                             for k in range(2)]
                        val = rot(u, ri, g[0], g[1]) if vi else g[0]
                    x0, x1 = min(R[u], C[v]), max(R[u], C[v])
                    new[x0, x1] = val
                    if not ((i == 0 and j <= 2) or j - i == 2
                            or i + j == 2 * P - 3):
                        continue                  # no next-round pair here
                    k = int(_next_pair(np.array(x0), np.array(x1), r1, m))
                    if k < 0:
                        continue
                    dd = []
                    for y in (x0, x1):
                        py = int(_partner(np.array(y), r, m))
                        if py >= n:
                            dd.append(A[y, y])
                        else:
                            iy = 0 if py == m - 1 or y == m - 1 else int(
                                _pair_index(np.array(y), r, m))
                            dd.append(cur[iy, 2] if y < py else cur[iy, 3])
                    nxt[k] = rotations(dd[0].reshape(1), dd[1].reshape(1),
                                       val.reshape(1))[0]
        A, cur = new, nxt
    U = torch.eye(n, dtype=a.dtype)
    for r, cs in log:
        lo, hi = _pair(r, np.arange(P), m)
        for i in np.nonzero(hi < n)[0]:
            p, q = int(lo[i]), int(hi[i])
            c, s = cs[i]
            U[p], U[q] = c * U[p] - s * U[q], s * U[p] + c * U[q]
    A = torch.where(torch.ones(n, n, dtype=torch.bool).triu(), A, A.T)
    return sym_eig._sorted(A[None], U[None])


@pytest.mark.parametrize("n", [9, 12, 17])
def test_kernel_round_mirror_gives_the_plain_versions_bits(n):
    """The kernel's scheme, mirrored item by item (``_mirror_jacobi``): the
    entries in their one order, the next round's rotation taken by the
    thread that writes its pair's entry from this round's kept diagonals,
    and U replayed from the rotation log, gives the plain version's bits
    after as many sweeps as the plain version runs."""
    x = np.random.default_rng(n).normal(size=(n, n))
    a = torch.from_numpy(x + x.T)
    sweeps = int(sym_eig._jacobi(a[None], None)[2][0])
    w, v = _mirror_jacobi(a, sweeps)
    wp, vp = sym_eig.eigh_reference(a)
    assert torch.equal(w[0], wp) and torch.equal(v[0], vp)


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
