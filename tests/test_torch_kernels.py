"""The port's one seam to its CUDA kernels (`_kernels.launch`), on the CPU:
the kernel library and torch.cuda's device and streams stood in for."""

import collections
import contextlib
import types

import pytest
import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels

pytestmark = pytest.mark.torch_port


class _StubLib:
    """One entry point that records its arguments and returns `code`."""

    def __init__(self):
        self.code = 0
        self.calls = []

    def ses3d_stub(self, *args):
        self.calls.append(args)
        return self.code


def test_launch_passes_the_stream_last_and_counts_only_success(monkeypatch):
    stub = _StubLib()
    dev = torch.device("cuda", 1)
    entered, streams = [], []

    def device(d):
        entered.append(d)
        return contextlib.nullcontext()

    def current_stream(d=None):
        streams.append(d)
        return types.SimpleNamespace(cuda_stream=1234)

    monkeypatch.setattr(_kernels, "library", lambda: stub)
    monkeypatch.setattr(_kernels, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)

    stub.code = 7
    with pytest.raises(RuntimeError, match="stub launch \\(n=3\\): CUDA error 7"):
        _kernels.launch("stub", "ses3d_stub", dev, 11, 3.5, None, what="stub launch (n=3)")
    assert stub.calls == [(11, 3.5, None, 1234)]
    assert _kernels.LAUNCHES == collections.Counter()

    stub.code = 0
    _kernels.launch("stub", "ses3d_stub", dev, 12, what="stub launch")
    assert stub.calls[-1] == (12, 1234)
    assert _kernels.LAUNCHES == collections.Counter(stub=1)
    assert entered == streams == [dev, dev]
