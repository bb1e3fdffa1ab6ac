"""The harness's bookkeeping: the files it finds, the names and units of
BENCHMARK.json, the frozen work counts, and the modules a run loads."""

import json
import os
import re
import subprocess
import sys

import pytest

from navbench import harness, peaks

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_discovers_exactly_the_files_present():
    found = harness.discover()
    for kind, ext in (("configs", ".json"), ("traffic", ".json"),
                      ("metrics", ".py")):
        on_disk = sorted(f[:-len(ext)] for f in os.listdir(
            os.path.join(harness.ROOT, kind))
            if f.endswith(ext) and not f.startswith("_"))
        assert found[kind] == on_disk


def test_every_named_piece_has_its_file():
    bench = harness.benchmark()
    found = harness.discover()
    for c in bench["configs"]:
        assert c["name"] in found["configs"]
        assert harness.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["config"] in found["configs"]
        assert w["traffic"] in found["traffic"]
        mix = harness.traffic(w["traffic"])
        harness.driver(mix["driver"])          # importable
    for m in bench["per_layer"]:
        # A split quantity (``<quantity>.<cells>``) may share one reader.
        assert (m["name"] in found["metrics"] or
                m["name"].split(".", 1)[0] in found["metrics"])
        assert callable(harness.reader(m["name"]))


def test_a_split_metric_without_a_file_is_read_by_its_quantity():
    read = harness.reader("device_idle_pct.any_cells")
    assert read({"busy_s": 0.75, "window_s": 1.0}) == pytest.approx(25.0)


def test_names_and_units_use_only_the_allowed_characters():
    bench = harness.benchmark()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    names += [w[k] for w in bench["workloads"] for k in ("config",
                                                          "traffic")]
    names += [r for c in bench["configs"] for r in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[kind]]
        assert len(got) == len(set(got))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("k, n, us", [(4096, 50, 0.52), (49152, 50, 6.27),
                                      (4096, 100, 1.05),
                                      (49152, 100, 12.54)])
def test_k1_work_reproduces_its_bounds(k, n, us):
    t, by = peaks.bound_s(*peaks.k1_work(k, n))
    assert by == "operations"
    assert round(t * 1e6, 2) == us


def test_rbpf_work_reproduces_its_bounds():
    work = peaks.rbpf_work(500, 51, 80, 80, 360, 340)
    assert round(work["K2"][0] / 1e6, 1) == 13.2
    assert round(work["K3"][0] / 1e6, 1) == 38.4
    t2, by2 = peaks.bound_s(*work["K2"])
    t3, by3 = peaks.bound_s(*work["K3"])
    assert (by2, by3) == ("bytes", "bytes")
    assert (round(t2 * 1e6, 2), round(t3 * 1e6, 2)) == (3.94, 11.46)


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.', 1)[0] "
        "for m in sys.modules}))")], cwd=harness.REPO, capture_output=True,
        text=True, check=True, env=dict(os.environ, USE_FLAX="0"))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_tpunav():
    tops = _loaded(
        "import navbench.harness as h, navbench.calibrate, navbench.trace\n"
        "for w in h.benchmark()['workloads']:\n"
        "    h.driver(h.traffic(w['traffic'])['driver'])\n"
        "for m in h.benchmark()['per_layer']:\n"
        "    h.reader(m['name'])\n"
        "import tpunav_torch.control.waypoint_loop, "
        "tpunav_torch.estimation.rbpf.particle_filter, "
        "tpunav_torch.ops.fused_mppi, tpunav_torch.capture")
    assert not tops & {"jax", "jaxlib", "flax", "tpunav"}, tops


def test_the_references_load_nothing_of_the_program():
    tops = _loaded("import navbench.reference.mppi, navbench.reference.rbpf,"
                   " navbench.reference.philox")
    assert not tops & {"tpunav_torch", "tpunav", "jax"}, tops
