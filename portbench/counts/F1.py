"""Kernel F1 (csrc/triangulation.cu, the fusion's triangulation) on
`hyps` hypothesis slots of `cameras` views each: the slots' keypoints,
covariances and camera masks and the rig's P and F read once, the
21-joint persons written once.

The operations counted are those F1 runs whatever views a slot holds:
per joint every view's weighted and unweighted normal-matrix
coefficients and contributions and their sums, the base solve, the
drop's pass over the views, the unscented transform's base solve and the
covariance's sums over every view's four sigma-point slots; per fusion
joint the gates. The work of the views present (their reprojections,
leave-one-out solves, three-view scores and sigma-point solves) is left
out, since the benchmark does not see which views are present: the bound
is the least a launch needs, and the roofline share reads low, never
high, by that work's share (chip_smoke.py's phase 16 counts it from the
hypotheses). A 4x4 solve (the adjugate's 16 cofactors, the column norms,
two power steps, the normalisation and de-homogenisation) is ~350
float32 operations; a multiply-add counts two.
"""

from portbench.lib.peaks import bound_ms

# The kernel's names in a device trace.
TRACE_NAMES = ("triangulation_kernel",)

J = 17   # input joints
K = 21   # fusion joints
SYM = 10  # unique entries of a symmetric 4x4
SOLVE_OPS = 4 + 16 * 14 + 4 * 7 + 2 * (16 + 12 + 7 + 1 + 4) + 8 + 1 + 4 + 3
VIEW_COEFF_OPS = 23          # the two rows' norms, reciprocals, five coefficients
CONTRIB_OPS = SYM * 5 * 2    # sum_k coeff_k K_k, five multiply-adds an entry
# A view of a joint: the weighted coefficients (the confidence squared),
# their contribution and its share of M0's sum; the unweighted
# coefficients and their share of the UT's M0 (one multiply-add chain).
VIEW_OPS = (1 + VIEW_COEFF_OPS + CONTRIB_OPS + SYM) + (VIEW_COEFF_OPS + CONTRIB_OPS)
COV_TERM_OPS = 6 * 3         # a sigma-point slot's weighted products, added
COV_OPS = 3 + 2 + 9 * 3      # the base point's offset, its weight and term
GATE_OPS = 40                # a fusion joint's limb, inflation and root distance


def ops_per_joint(cameras: int) -> int:
    c = cameras
    # Views, the base and the UT's base solves, the drop's pass over the
    # views, the covariance's sums over 4 C sigma-point slots.
    return c * VIEW_OPS + 2 * SOLVE_OPS + c + 4 * c * COV_TERM_OPS + COV_OPS


def nbytes(hyps: int, cameras: int) -> int:
    c = cameras
    inputs = hyps * c * (2 * J * 3 * 4 + 1) + c * 12 * 4 + c * c * 9 * 4
    outputs = hyps * (K * 3 * 4 + K * 4 + K * 9 * 4 + 1 + 4)
    return inputs + outputs


def ops(hyps: int, cameras: int) -> int:
    return hyps * (J * ops_per_joint(cameras) + K * GATE_OPS)


def bound(hyps: int, cameras: int) -> float:
    """Milliseconds one launch over `hyps` slots needs at the least."""
    return bound_ms(nbytes(hyps, cameras), ops(hyps, cameras))
