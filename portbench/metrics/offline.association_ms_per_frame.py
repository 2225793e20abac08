"""Median over the traced calls of the `fusion.associate` stage's device
time (every chunk's normalisation, pair costs and association:
the fold, or the camera scan's steps) over the call's frames, between its
stage marks (portbench/lib/spans.py); nothing where the program marks no
such stage."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_stage(ctx, "fusion.associate")
