"""Median over the traced calls of the `fusion.triangulate` stage's device
time (every chunk's triangulation: F1, its wide variant or the plain
body) over the call's frames, between its stage marks
(portbench/lib/spans.py); nothing where the program marks no such
stage."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_stage(ctx, "fusion.triangulate")
