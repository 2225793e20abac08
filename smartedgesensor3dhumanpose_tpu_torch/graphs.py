"""CUDA graphs: the port's counterpart of `jax.jit` on its entry points.

The JAX package runs each entry point as one compiled program: `step` is
jitted, the per-frame chain is a `lax.scan` over it, and the LM iteration
and the track-merge fixpoint are `lax.while_loop`s on the device. The port
captures each entry point as a CUDA graph instead and replays it.

`CapturedFunction(fn)` warms `fn` up once on a side stream (the kernel
library loads, `linalg.constant` uploads its tables), then captures it once
per signature of its inputs (the tree of NamedTuples and tuples, and each
tensor's shape, dtype and device), as `jax.jit` compiles once per shape.
While a stream captures (`linalg.capturing`), the merge
(`tracking._merge_tracks`) and the LM of the dense solver
(`prior.optimize`) are each one CUDA-graph WHILE node whose body the
device runs while the loop's test holds (ops/loops.py), with no host test
of a device value; both loops equal their eager runs bit for bit (the
tree solver's LM is one launch of kernel L1 on CUDA). A call copies its
inputs into the graph's static input tensors, replays the graph and
returns fresh copies of the static outputs: the entry points stay
functional (the caller's tensors are never written and a result survives
the next call), where the JAX package donates its state buffers instead.

Each graph holds a private memory pool for its intermediates, and one for
the bodies of its loops (`loops.Bodies`), as long as it is kept. A
`CapturedFunction` keeps the graphs of its `max_graphs` most recently used
signatures and drops the least recently used beyond that (its pools go
back to the allocator; a later call of that signature captures again).
Graphs capture on a stream of their inputs' device, one kept per device,
and replay on the caller's current stream, so graphs of one card may be
replayed at once on several streams (parallel/sharding.py).

The kernel wrappers count their launches on the host, by kernel name
(`_kernels.LAUNCHES`): the warm-up launches each kernel of `fn` once, the capture records it once, and a
replay adds nothing there. A replay's launches are the tracer's per-stage
counters instead (tracing.py): the graphs of a `Pipeline(..., trace=True)`
count their kernel nodes per stage at capture (`<stage>.kernels`), and
their stage marks time each replay on the device. While a tracer records,
a call also records its host spans `graph.copy_in`, `graph.replay` (the
launch call) and `graph.copy_out`. A capture that fails raises, naming the
line of the port that broke it; nothing falls back to eager execution.
"""

from __future__ import annotations

import collections
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import tracing
from smartedgesensor3dhumanpose_tpu_torch.ops import loops

_PACKAGE = Path(__file__).resolve().parent


# ------------------------------------------------------------------ trees --

def flatten(tree):
    """(tensors, spec) of a tensor or a tuple / NamedTuple tree of them."""
    leaves = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return None
        if isinstance(node, tuple):
            return type(node), tuple(walk(x) for x in node)
        raise TypeError(f"a captured function takes and returns tensors, got {type(node)}")

    return leaves, walk(tree)


def unflatten(spec, leaves):
    """The tree of `spec` holding `leaves` in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, children = node
        values = [build(c) for c in children]
        return kind(*values) if hasattr(kind, "_fields") else kind(values)

    return build(spec)


def copy_all(dsts, srcs) -> None:
    """dst.copy_(src) for every pair, as few launches as the copies allow
    (one per dtype where every tensor is dense)."""
    groups: dict = {}
    for d, s in zip(dsts, srcs, strict=True):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


# ---------------------------------------------------------------- capture --

def _where(exc: BaseException) -> str:
    """The innermost line of the port (outside this module) in the
    tracebacks of `exc` and the exceptions it was raised from or during."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        frames = [
            f for f in traceback.extract_tb(exc.__traceback__)
            if Path(f.filename).resolve().is_relative_to(_PACKAGE)
            and Path(f.filename).name != "graphs.py"
        ]
        if frames:
            f = frames[-1]
            return f"{Path(f.filename).relative_to(_PACKAGE)}:{f.lineno} ({f.name}): {f.line}"
        exc = exc.__context__ or exc.__cause__
    return "no line of the port in the traceback"


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list       # static input tensors, in flatten order
    outputs: list      # static output tensors, in flatten order
    out_spec: object
    bodies: loops.Bodies  # its loops' body stream and memory pool


# device index -> the stream graphs of that device capture on. torch's own
# default (`torch.cuda.graph` without `stream=`) is one stream of whichever
# device was current at the process's first capture.
_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


class CapturedFunction:
    """`fn` over tensors on one CUDA device, captured as a CUDA graph per
    input signature and replayed (see the module docstring). `fn` must be
    functional and read nothing but its arguments and tensors that outlive
    the graph (a rig, a model's parameters, `linalg.constant` tables).
    One caller at a time: calls share the graph's static buffers.
    `marks`: the tracing.StageMarks that `fn` writes its stage marks to (a
    traced pipeline's), or None; the loops of its captures then record
    into that ring's tracer."""

    # Signatures whose graphs are kept (each graph holds its own pool).
    max_graphs = 4
    # Keep each graph's cudaGraph_t after instantiation, for
    # `CUDAGraph.raw_cuda_graph()` (to count its nodes).
    keep_graph = False

    def __init__(self, fn, name: str, marks=None):
        self.fn = fn
        self.name = name
        self.marks = marks
        self.graphs: collections.OrderedDict = collections.OrderedDict()

    def _capture(self, leaves, spec) -> _Graph:
        dev = leaves[0].device
        if dev.type != "cuda" or any(t.device != dev for t in leaves):
            raise ValueError(f"{self.name}: every input must lie on one CUDA device")
        with torch.cuda.device(dev):
            inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in leaves]
            copy_all(inputs, leaves)
            args = unflatten(spec, inputs)
            stream = _capture_stream(dev)
            bodies = loops.Bodies(dev, stream)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(*args)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
            tracer = tracing.active() if self.marks is None else self.marks.tracer
            try:
                with torch.cuda.graph(graph, stream=stream), loops.capturing_into(bodies), \
                        tracing.recording(tracer):
                    out = self.fn(*args)
            except Exception as exc:
                raise RuntimeError(
                    f"capturing {self.name} as a CUDA graph failed at {_where(exc)}: {exc}"
                ) from exc
            outputs, out_spec = flatten(out)
        return _Graph(graph, inputs, outputs, out_spec, bodies)

    def _graph_for(self, leaves, spec) -> _Graph:
        """The graph of this input signature, captured on first use; the
        least recently used beyond `max_graphs` is dropped."""
        key = spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
        if key in self.graphs:
            self.graphs.move_to_end(key)
        else:
            self.graphs[key] = self._capture(leaves, spec)
            while len(self.graphs) > self.max_graphs:
                self.graphs.popitem(last=False)
        return self.graphs[key]

    def __call__(self, *args):
        leaves, spec = flatten(args)
        g = self._graph_for(leaves, spec)
        tracer = tracing.active()
        if tracer is None and self.marks is None:
            copy_all(g.inputs, leaves)
            g.graph.replay()
            return self._outputs(g)
        now = time.perf_counter_ns
        t0 = now()
        copy_all(g.inputs, leaves)
        t1 = now()
        g.graph.replay()
        t2 = now()
        out = self._outputs(g)
        t3 = now()
        replay = None
        if tracer is not None:
            tracer.span("graph.copy_in", t0, t1)
            replay = tracer.span("graph.replay", t1, t2)
            tracer.span("graph.copy_out", t2, t3)
        if self.marks is not None:
            self.marks.replayed(parent=replay)
        return out

    @staticmethod
    def _outputs(g: _Graph):
        """Fresh copies of a replay's static outputs."""
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in g.outputs]
        copy_all(outs, g.outputs)
        return unflatten(g.out_spec, outs)
