"""A run with the timed path broken underneath has to come out not
correct, and a sound one correct: tiny runs of each driver on the host
(the harness's look for a card skipped), with the cells' own limits."""

import pytest
import torch

from portbench.tests import tiny
from smartedgesensor3dhumanpose_tpu_torch.types import Frame


def stale_state(entry):
    """The step (or call) returns the state it was given."""
    def fault(pipe):
        inner = getattr(pipe, entry)
        setattr(pipe, entry, lambda state, x: (state, inner(state, x)[1]))
    return fault


def altered_answer(entry):
    """Every published joint moved by 2 cm where it is produced."""
    def fault(pipe):
        inner = getattr(pipe, entry)

        def run(state, x):
            state, out = inner(state, x)
            fused = out.fused._replace(xyz=out.fused.xyz + 0.02)
            return state, out._replace(fused=fused)
        setattr(pipe, entry, run)
    return fault


def half_cameras(pipe):
    """Half of a frame's cameras left out of the step."""
    inner = pipe._step

    def run(state, frame):
        keep = torch.arange(frame.det_valid.shape[0]) < frame.det_valid.shape[0] // 2
        return inner(state, frame._replace(det_valid=frame.det_valid & keep[:, None]))
    pipe._step = run


def half_frames(pipe):
    """Half of a sequence's frames left out: the call replays the first half
    and repeats its outputs for the rest."""
    inner = pipe._offline

    def run(state, frames):
        n = frames.kp2d.shape[0]
        state, out = inner(state, Frame(*(x[:n // 2] for x in frames)))
        return state, torch.utils._pytree.tree_map(
            lambda t: torch.cat([t, t])[:n] if t.dim() else t, out)
    pipe._offline = run


FAULTS = [
    ("live", stale_state("_step")),
    ("live", altered_answer("_step")),
    ("live", half_cameras),
    ("offline", stale_state("_offline")),
    ("offline", altered_answer("_offline")),
    ("offline", half_frames),
]


@pytest.mark.parametrize("driver", ["live", "offline"])
def test_sound_run_is_correct(driver):
    result, checks = tiny.run(driver)
    assert result["correct"], checks
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("driver,fault", FAULTS,
                         ids=["live-stale", "live-altered", "live-half", "offline-stale",
                              "offline-altered", "offline-half"])
def test_broken_run_is_not_correct(driver, fault):
    result, checks = tiny.run(driver, fault=fault)
    assert not result["correct"], checks


def test_altered_set_is_not_correct(monkeypatch):
    """A synchronized set altered where it is produced: the packer shifts
    one camera's stamp by a microsecond."""
    from smartedgesensor3dhumanpose_tpu_torch.io import replay

    pack = replay.SynchronizedReplay._pack

    def shifted(self, stamps, handles):
        fd = pack(self, stamps, handles)
        fd["cam_stamp"] = fd["cam_stamp"] + (torch.arange(len(stamps)) == 0).numpy() * 1e-6
        return fd
    monkeypatch.setattr(replay.SynchronizedReplay, "_pack", shifted)
    result, checks = tiny.run("live")
    assert not result["correct"] and checks["sync_sets_wrong"]["value"] > 0, checks


@pytest.mark.parametrize("driver", ["live", "offline"])
def test_altered_triangulation_is_not_correct(monkeypatch, driver):
    """Every triangulated joint moved by 1 cm where the fusion produces it,
    so that smoothing, tracking and reprojection follow the moved joints."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion

    triangulate = fusion.triangulate_hypotheses

    def moved(*args, **kwargs):
        persons = triangulate(*args, **kwargs)
        shift = torch.where(persons.score[..., None] > 0, 0.01, 0.0)
        return persons._replace(xyz=persons.xyz + shift)
    monkeypatch.setattr(fusion, "triangulate_hypotheses", moved)
    result, checks = tiny.run(driver)
    assert not result["correct"], checks
