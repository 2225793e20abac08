"""The roofline counts on hand-counted shapes, and the LM's constants
against the port's."""

import pytest

from portbench.lib import manifest, peaks


def count(kernel):
    return manifest.kernel_count(kernel)


def test_bound_is_the_larger_time():
    assert peaks.bound_ms(3.35e12, 0) == pytest.approx(1e3)
    assert peaks.bound_ms(0, 67e12) == pytest.approx(1e3)
    assert peaks.bound_by(3.35e9, 1.0) == "bytes"
    assert peaks.bound_by(1.0, 67e9) == "operations"


def test_k1():
    k1 = count("K1")
    # cost 2 x 3 float32 (24), the row mask (2), the answer (8); rows x n
    # compares (6) and 4 steps of 3 columns x 4 operations (48).
    assert k1.nbytes(2, 3) == 34
    assert k1.ops(2, 3, 4) == 54
    assert k1.bound(2, 3, 4) == pytest.approx(peaks.bound_ms(34, 54))


def test_k2():
    k2 = count("K2")
    # One frame, 2 cameras of 1 detection, 1 slot: table 16, flags 8, mask
    # 2, slots 8, counters 8; one pair's compare (1) and 2 x 1 x 2 x 1 x 4.
    assert k2.nbytes(1, 2, 1, 1) == 42
    assert k2.ops(1, 2, 1, 1) == 17
    assert k2.nbytes(3, 2, 1, 1) == 3 * 42


def test_k3():
    k3 = count("K3")
    # inputs 504 + 16 + 42 + 2 + 20 + 84, state 558 read and written,
    # outputs 252 + 5 + 4.
    assert k3.nbytes(1, 1, 1, 1) == 668 + 2 * 558 + 261
    # cost 399, JV 8, velocity 567, no merge with one slot.
    assert k3.ops(1, 1, 1, 1) == 974


def test_l1_matches_the_ports_lm_constants():
    from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior

    l1 = count("L1")
    assert l1.TRIP_OPS_PER_PERSON == lm_prior.TRIP_OPS_PER_PERSON
    for persons, running in ((16, 11), (512, 500), (1, 0)):
        assert l1.nbytes(persons, running) == lm_prior.trip_bytes(running, persons)
    assert l1.bound(16, 11, 0) == pytest.approx(peaks.bound_ms(l1.nbytes(16, 11), 0))
