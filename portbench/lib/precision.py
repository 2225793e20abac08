"""The arithmetic of the control of `correct`: the plain reference put in
the program's place and computed below the configuration's IEEE float32.

    tf32   float32 with TF32 matrix products on the card: the rung that the
           configuration's "no TF32" names. It reaches the products alone.
    bf16   every float32 result rounded to bfloat16, the inputs too, as a
           program that keeps its values in bfloat16 computes: it reaches
           the elementwise arithmetic of the triangulation, the smoothing
           and the reprojection, which TF32 does not.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

PRECISIONS = ("tf32", "bf16")


@contextlib.contextmanager
def tf32():
    """Float32 products in TF32, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
        torch.set_float32_matmul_precision(flags[2])


def _rounded(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _is_f32(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.float32


class RoundToBf16(TorchDispatchMode):
    """Rounds every float32 result of an operation to bfloat16: a fresh
    result is replaced, one written in place is rounded where it lies, and
    a view is left as it is (its base already is)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aliases = [r.alias_info for r in func._schema.returns if r.alias_info is not None]
        if not aliases:
            return tree_map(lambda t: _rounded(t) if _is_f32(t) else t, out)
        if any(a.is_write for a in aliases):
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if _is_f32(t):
                    t.copy_(_rounded(t))
        return out


def arithmetic(precision: str):
    """A context in which the reference computes at `precision`."""
    if precision == "tf32":
        return tf32()
    if precision == "bf16":
        return RoundToBf16()
    raise ValueError(f"no precision {precision!r}; there are {PRECISIONS}")


def on(tree, device, precision: str):
    """A tuple tree of tensors on `device`, floats in float32 (rounded to
    bfloat16 for `bf16`)."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_floating_point():
            return tree.to(device)
        t = tree.to(device=device, dtype=torch.float32)
        return _rounded(t) if precision == "bf16" else t
    values = [on(x, device, precision) for x in tree]
    return type(tree)(*values) if hasattr(tree, "_fields") else tuple(values)
