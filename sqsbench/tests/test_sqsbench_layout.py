"""The host readings printed beside each window, the control's verdict
through the cell's limits, and the data layout: every file the harness
finds by name is read by some entry of BENCHMARK.json."""
import json
import pathlib

import pytest

import control
from harness import host

HERE = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def test_host_readings_between_two_snapshots():
    a = host.snapshot()
    b = dict(a, t=a["t"] + 2.0, utime=a["utime"] + 1.0,
             stime=a["stime"] + 0.5)
    d = host.between(a, b)
    assert d["proc_cpu_per_wall"] == pytest.approx(0.75)
    assert d["proc_sys_per_wall"] == pytest.approx(0.25)
    assert d["cores"] >= 1
    assert host.line(d).startswith("host: proc_cpu_per_wall 0.7500")


def test_host_readings_of_a_busy_window():
    a = host.snapshot()
    while host.snapshot()["t"] - a["t"] < 0.2:
        pass
    d = host.between(a, host.snapshot())
    assert 0.5 < d["proc_cpu_per_wall"] < 1.5


def test_control_verdict_goes_through_the_limits():
    limits = {"draft_gap": 0.4, "verify_gap": 0.2}
    assert control.judged({"draft_gap": 0.1, "verify_gap": 0.05,
                           "draft_steps": 9}, limits) == \
        (True, {"draft_gap": 0.1, "verify_gap": 0.05})
    assert control.judged({"draft_gap": 1.02, "verify_gap": 0.05},
                          limits)[0] is False
    assert control.judged({"draft_gap": 0.1}, limits)[0] is False


@pytest.mark.parametrize("folder,key", [("traffic", "traffic"),
                                        ("limits", "name")])
def test_every_data_file_is_read_by_a_cell(folder, key):
    named = {w[key] for w in BENCH["workloads"]}
    files = {p.stem for p in (HERE / folder).glob("*.json")}
    assert files == named


def test_every_reader_is_read_by_a_metric():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (HERE / "metrics").glob("*.py")}
    assert files == named
