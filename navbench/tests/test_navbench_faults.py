"""A run with the timed path broken underneath must come out not correct.

Each case drives a whole run of a cell on the CPU at a small size (the
harness's look for a card is what ``main`` does, and these tests call the
run itself), with one fault planted in the program before the run builds
it: a step that returns its state unchanged; half of the batch left out,
the mean taken over the rest; an answer altered where it is produced. The
cells run on one chip, so no exchange between chips can be left out. The
same run without a fault must come out correct.
"""

import dataclasses

import pytest
import torch

from navbench import harness

CELLS = {c["name"]: c for c in harness.benchmark()["workloads"]}
SMALL = {
    "mppi_course_k4096": {"rollouts": 64, "chunk_ticks": 10,
                          "check_steps": [0, 40, 40], "courses": 4},
    "mppi_tick_k49152": {"rollouts": 64, "chunk_ticks": 1,
                         "check_steps": [0, 60, 30], "courses": 4},
    "rbpf_update_p500": {"particles": 24, "sessions": 2,
                         "updates_per_session": 8,
                         "check_steps": [2, 10, 4]},
    "rbpf_explore_p500": {"particles": 16, "rollouts": 64, "sessions": 3,
                          "scans_per_session": 8, "scans_per_read": 4,
                          "check_steps": [0, 16, 4],
                          "control_steps": [0, 16, 16]},
}
# The faults that a cell with K1 on its path can have, planted at the
# cells' own sizes on the card.
K1_CELLS = ("mppi_course_k4096", "mppi_tick_k49152", "rbpf_explore_p500")
CARD_SEEDS = (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203)


def run(name, seconds=6.0):
    return harness.run_cell(CELLS[name], 2 ** 31 + 17, seconds, False,
                            device="cpu", sizes=SMALL[name])


def half_rollouts(monkeypatch):
    from tpunav_torch.ops import fused_mppi as fm

    orig = fm._solve_update

    def half(cfg, *a, **k):
        return orig(dataclasses.replace(cfg, rollouts=cfg.rollouts // 2),
                    *a, **k)

    monkeypatch.setattr(fm, "_solve_update", half)


def altered_command(monkeypatch):
    from tpunav_torch.ops import fused_mppi as fm

    orig = fm.mppi_solve_fused_packed
    monkeypatch.setattr(fm, "mppi_solve_fused_packed",
                        lambda *a, **k: (lambda c, u: (c + 0.05, u))(
                            *orig(*a, **k)))


def course_unchanged(monkeypatch):
    from tpunav_torch.control import waypoint_loop

    monkeypatch.setattr(waypoint_loop, "_tick",
                        lambda cfg, course, model, w, st, *a, **k: st)


def rbpf_unchanged(monkeypatch):
    from tpunav_torch.estimation.rbpf import particle_filter as pf

    monkeypatch.setattr(pf, "pf_slam_step", lambda cfg, st, *a, **k: st)


def rbpf_half_samples(monkeypatch):
    from tpunav_torch.estimation.rbpf import particle_filter as pf

    orig = pf.likelihood_field_batch

    def half(g, dists, ranges, samples, table=None):
        lp = orig(g, dists, ranges, samples, table)
        k = lp.shape[1] // 2
        return torch.cat([lp[:, :k], lp[:, :k].mean(1, keepdim=True)
                          .expand(-1, lp.shape[1] - k)], dim=1)

    monkeypatch.setattr(pf, "likelihood_field_batch", half)


def rbpf_altered(monkeypatch):
    from tpunav_torch.estimation.rbpf import particle_filter as pf

    orig = pf.pf_slam_step

    def moved(cfg, st, *a, **k):
        out = orig(cfg, st, *a, **k)
        return out._replace(poses=out.poses + 0.01)

    monkeypatch.setattr(pf, "pf_slam_step", moved)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name, fault", [
    ("mppi_course_k4096", course_unchanged),
    ("mppi_course_k4096", half_rollouts),
    ("mppi_course_k4096", altered_command),
    ("mppi_tick_k49152", course_unchanged),
    ("mppi_tick_k49152", half_rollouts),
    ("mppi_tick_k49152", altered_command),
    ("rbpf_update_p500", rbpf_unchanged),
    ("rbpf_update_p500", rbpf_half_samples),
    ("rbpf_update_p500", rbpf_altered),
    ("rbpf_explore_p500", rbpf_unchanged),
    ("rbpf_explore_p500", half_rollouts),
    ("rbpf_explore_p500", rbpf_half_samples),
    ("rbpf_explore_p500", rbpf_altered),
])
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", K1_CELLS)
def test_half_the_rollouts_is_caught_on_the_card(card, monkeypatch, name):
    """K1 solving with half of the cell's rollouts, at the cell's own size:
    every seed's run must come out not correct."""
    half_rollouts(monkeypatch)
    for seed in CARD_SEEDS:
        out = harness.run_cell(CELLS[name], seed, 8.0, False)
        print(f"{name} half_rollouts seed {seed}: correct "
              f"{out['correct']} checks {out['checks']} info "
              f"{out['info']}", flush=True)
        assert not out["correct"], out["checks"]
