"""The control must come out not correct: the reference, computed in
bfloat16 (the step below the configurations' float32) and put in the
program's place, fails at least one of its cell's limits, while the
program passes every one. On the CPU at a small size; on the card at each
cell's own size, on three seeds."""

import pytest

from navbench import calibrate, harness

CELLS = {c["name"]: c for c in harness.benchmark()["workloads"]}
SMALL = {
    "mppi_course_k4096": {"rollouts": 64, "chunk_ticks": 30,
                          "check_steps": [0, 20, 20], "courses": 4},
    "mppi_tick_k49152": {"rollouts": 64, "chunk_ticks": 1,
                         "check_steps": [0, 60, 30], "courses": 4},
    "rbpf_update_p500": {"particles": 24, "sessions": 2,
                         "updates_per_session": 8,
                         "check_steps": [2, 10, 4]},
    "rbpf_explore_p500": {"particles": 24, "rollouts": 64, "sessions": 2,
                          "scans_per_session": 8, "scans_per_read": 4,
                          "check_steps": [1, 8, 4],
                          "control_steps": [0, 16, 16]},
}


def held(cell: dict, r: dict):
    limits = harness.traffic(cell["traffic"])["limits"]
    program = all(r["program"][k] <= v for k, v in limits.items())
    control = all(r["control"][k] <= v for k, v in limits.items())
    return program, control


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_on_the_cpu(name):
    r = calibrate.readings(CELLS[name], 2 ** 31 + 9, 5.0, device="cpu",
                           sizes=SMALL[name])
    program, control = held(CELLS[name], r)
    assert program, r["program"]
    assert not control, r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_on_the_card(card, name):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = calibrate.readings(CELLS[name], seed, 8.0)
        program, control = held(CELLS[name], r)
        assert program, r["program"]
        assert not control, r["control"]
