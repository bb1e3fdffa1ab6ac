"""The port's process-group layer (``tpunav_torch.runtime.distributed``)
and its two-process demos (``examples_torch``) on the CPU.

The single-host no-op and the partial-configuration check of
tests/test_runtime.py:308-317 and ``tpunav/runtime/distributed.py:29-41``;
then the spawning of child processes that the launchers share, and each
demo's launcher, two spawned gloo ranks, whose ranks must hold the same
bits and equal the demo's ``run_course`` in one rank at
tests/test_distributed.py's tolerances.
"""

import multiprocessing as mp
import sys
import time

import numpy as np
import pytest
import torch

from examples_torch import mppi_two_process, rbpf_two_process, spawn
from tpunav_torch.parallel import rollout_mesh
from tpunav_torch.runtime import distributed

torch.set_num_threads(1)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_single_host_noop(clean_env):
    """initialize() contacts nothing single-host; the role helpers report
    the local layout, and the mesh is the one-shard identity."""
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_leader()
    info = distributed.process_info()
    assert set(info) == {"process_index", "process_count", "local_devices",
                         "global_devices"}
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["global_devices"] >= 1
    distributed.shutdown()
    mesh = rollout_mesh(device="cpu")
    assert (mesh.group, mesh.index, mesh.size) == (None, 0, 1)
    t = torch.arange(6.0).reshape(3, 2)
    for reduce in (mesh.min_, mesh.sum_, mesh.all_gather):
        assert torch.equal(reduce(t), t)


@pytest.mark.parametrize("kwargs,env", [
    ({"coordinator_address": "localhost:1"}, {}),
    ({"num_processes": 2}, {}),
    ({"num_processes": 2, "process_id": 0}, {}),
    ({}, {"MASTER_ADDR": "localhost"}),
    ({}, {"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "WORLD_SIZE": "2"}),
])
def test_partial_configuration_raises(clean_env, kwargs, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    with pytest.raises(ValueError, match="partial multi-process"):
        distributed.initialize(**kwargs, device="cpu")
    assert not torch.distributed.is_initialized()


def _exit_with(code):
    sys.exit(code)


def _sleep(seconds):
    time.sleep(seconds)


def _put(results, key):
    results.put((key, np.arange(1 << 18)))      # 2 MB: more than a pipe holds


def test_spawn_collects_results_and_raises_on_a_failed_child():
    """Every child's result arrives, a large one too (the queue is drained
    while the children run); a child that exits nonzero fails the call."""
    results = mp.get_context("spawn").Queue()
    out = spawn([(_put, (results, k)) for k in range(2)], 120, results,
                expect=2)
    assert sorted(out) == [0, 1]
    np.testing.assert_array_equal(out[1], np.arange(1 << 18))
    with pytest.raises(RuntimeError, match="exit codes"):
        spawn([(_sleep, (0.0,)), (_exit_with, (3,))], 120)


def test_spawn_times_out_and_leaves_no_child():
    """A child that outlives the timeout fails the call and is killed."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn([(_sleep, (600.0,))], 5)
    assert time.monotonic() - t0 < 60
    assert not mp.active_children()


def test_mppi_two_process_matches_one_rank():
    """The launcher's two ranks (global noise, gloo) hold the same bits and
    equal the one-rank course (tests/test_distributed.py:64-70)."""
    a, _ = mppi_two_process.launcher("cpu", "gloo", noise="global",
                                     rollouts=1024, timeout=300)
    one = mppi_two_process.run_course(rollout_mesh(device="cpu"), "cpu",
                                      rollouts=1024, noise="global")
    assert (a["shards"], one["shards"]) == (2, 1)
    np.testing.assert_allclose(a["cmd"], one["cmd"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a["u"], one["u"], rtol=1e-4, atol=1e-5)


def test_mppi_two_process_in_kernel_noise_ranks_agree():
    """The demo's default: per-shard in-kernel Philox (K1's plain version
    on the CPU); the launcher raises unless the ranks agree."""
    a, b = mppi_two_process.launcher("cpu", "gloo", rollouts=1024,
                                     solves=5, timeout=300)
    assert np.isfinite(a["u"]).all() and a["solves_per_sec"] > 0


def test_rbpf_two_process_matches_one_rank():
    """The forced-resample course in two ranks (the launcher checks the
    ranks' bits and the clones) equals it in one rank
    (tests/test_distributed.py:103-110)."""
    a, _ = rbpf_two_process.launcher("cpu", "gloo", timeout=300)
    one = rbpf_two_process.run_course(rollout_mesh(device="cpu"), "cpu")
    np.testing.assert_allclose(a["poses"], one["poses"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(a["log_weights"], one["log_weights"],
                               rtol=1e-4, atol=1e-5)
    assert one["clones"] >= rbpf_two_process.P_TOTAL - 2
    assert len(np.unique(np.round(a["poses"], 6), axis=0)) < \
        rbpf_two_process.P_TOTAL
