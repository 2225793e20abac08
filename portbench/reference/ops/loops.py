"""The LM's and the track merge's loop, eagerly: a host test before each
trip, at most `max_trips` trips (frozen copy of the port's eager
`ops/loops.py::while_loop`; the reference has no CUDA-graph path)."""

from __future__ import annotations


def while_loop(cond, body, carry: tuple, max_trips: int) -> tuple:
    """`carry = body(carry)` while `cond(carry)` holds, at most `max_trips`
    times; returns the last carry."""
    for _ in range(max_trips):
        if not bool(cond(carry)):
            break
        carry = body(carry)
    return carry
