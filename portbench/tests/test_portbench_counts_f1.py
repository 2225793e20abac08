"""Kernel F1's roofline count on hand-counted shapes: one slot of one
view, and the demo's live frame (16 slots, 16 views) and offline chunk
(32 frames x 16 slots)."""

import pytest

from portbench.lib import manifest, peaks


def test_f1_one_slot_one_view():
    f1 = manifest.kernel_count("F1")
    # kp and cov 2 x 17 x 3 x 4 (408) and the mask (1), P (48), F (36);
    # xyz 252, score 84, cov 756, valid 1, id 4.
    assert f1.nbytes(1, 1) == 409 + 48 + 36 + 1097
    # A solve: diagonal 4, cofactors 16 x 14, norms 4 x 7, two power steps
    # of 40, the last norm 8, its root, 4 divisions, 3 de-homogenising.
    assert f1.SOLVE_OPS == 352
    # A view: weighted 1 + 23 + 100 + 10, unweighted 23 + 100.
    assert f1.VIEW_OPS == 257
    # Per joint at one view: the view 257, two solves 704, the drop's pass
    # 1, four sigma-point slots of six products 72, the base point's 32.
    assert f1.ops_per_joint(1) == 257 + 704 + 1 + 72 + 32
    assert f1.ops(1, 1) == 17 * 1066 + 21 * 40


@pytest.mark.parametrize("hyps, nbytes", [(16, 132_240), (512, 3_922_176)])
def test_f1_demo_shapes(hyps, nbytes):
    f1 = manifest.kernel_count("F1")
    assert f1.nbytes(hyps, 16) == nbytes
    # Per joint at 16 views: 16 x 257 + 704 + 16 + 64 x 18 + 32.
    assert f1.ops_per_joint(16) == 6_016
    assert f1.ops(hyps, 16) == hyps * (17 * 6_016 + 21 * 40)
    assert f1.bound(hyps, 16) == pytest.approx(peaks.bound_ms(nbytes, f1.ops(hyps, 16)))
    # Read and written once, the demo's slots need more time for their
    # bytes than for the operations every slot runs.
    assert peaks.bound_by(nbytes, f1.ops(hyps, 16)) == "bytes"
