"""The readers of the program's own spans and counters (lib/spans.py) on
tiny appended phases of each driver, run on the host: every new metric
reads a number, the live spans tile each set's wait, and each reader
returns None where the port has no tracer."""

import pytest
import torch

from portbench.lib import manifest, spans
from portbench.tests import tiny

NEW = {
    "live": ["live.sync_hold_ms_p50", "live.sync_hold_ms_p95", "live.handoff_ms_p50",
             "device_idle_share.live", "live.fusion_ms_p50", "live.tracking_ms_p50",
             "live.prior_ms_p50", "live.feedback_ms_p50", "live.fusion_kernels",
             "live.tracking_kernels"],
    "offline": ["offline.fusion_ms_per_frame", "offline.smoothing_ms_per_frame",
                "offline.tracker_ms_per_frame", "offline.feedback_ms_per_frame",
                "offline.fusion_kernels_per_frame", "offline.pre_graph_ms_p50",
                "offline.post_graph_ms_p50"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_the_seed_comes_from_the_command_line():
    assert spans.run_seed(["--workload", "x", "--seed", "2147483999"]) == 2147483999
    assert spans.run_seed(["--seed=12"]) == 12
    assert spans.run_seed([]) == 0


@pytest.mark.parametrize("driver", ["live", "offline"])
def test_new_metrics_read_the_programs_spans(driver, monkeypatch):
    cell = tiny.cell(driver)
    listed = {m["name"] for m in cell.per_layer}
    assert set(NEW[driver]) <= listed
    monkeypatch.setattr(spans, "run_phase", lambda c, seed: spans.phase(c, seed, 24, 3))
    monkeypatch.setattr(spans, "_device", lambda: torch.device("cpu"))
    ctx = {"mode": driver, "cell": cell, "frames": 12}
    values = {n: manifest.metric_reader(n)(ctx) for n in NEW[driver]}
    # Kernel counters exist only where a graph is captured (on a card).
    counted = {n for n in values if "kernels" in n}
    assert all(values[n] is None for n in counted), values
    assert all(isinstance(values[n], float) for n in set(values) - counted), \
        {n: type(v) for n, v in values.items()}
    prog = ctx["program"]
    if driver == "live":
        assert 0 <= values["live.sync_hold_ms_p50"] <= values["live.sync_hold_ms_p95"]
        assert values["live.handoff_ms_p50"] > 0
        # The benchmark's wait of each set less its spans before the step is
        # the generator's lateness of its newest message, and a little
        # Python between the generator's stamp and the push.
        due, late = prog["due"], prog["late"]
        for row, step in zip(prog["sets"], prog["steps"]):
            newest = max(step.handles, key=lambda h: due[h - 1]) - 1
            gap = (step.entry - due[newest]) * 1e9 - (row[5] - row[1]) - late[newest] * 1e9
            assert 0 <= gap < 2e6, gap
    else:
        assert values["offline.pre_graph_ms_p50"] >= 0
        assert values["offline.post_graph_ms_p50"] >= 0


def test_the_phase_runs_in_a_process_of_its_own(monkeypatch):
    """`run_phase` runs `python -m portbench.lib.spans` for the cell and
    reads its pickled records back; a failing phase raises."""
    import subprocess

    seen = []

    def fake(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, b"\x80\x04K\x07.", b"spans: a note\n")

    monkeypatch.setattr(subprocess, "run", fake)
    assert spans.run_phase(tiny.cell("live"), 5) == 7
    assert seen[0][1:] == ["-m", "portbench.lib.spans", "--workload", "demo16_live_30hz",
                           "--seed", "5"]
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, b"", b""))
    with pytest.raises(RuntimeError, match="exited with 1"):
        spans.run_phase(tiny.cell("live"), 5)


def test_readers_return_none_without_a_tracer(monkeypatch):
    monkeypatch.setattr(spans, "traced_port", lambda: False)
    for driver, names in NEW.items():
        ctx = {"mode": driver, "cell": tiny.cell(driver), "frames": 12}
        assert all(manifest.metric_reader(n)(ctx) is None for n in names)
