"""Kernel L1 (csrc/lm_prior.cu `lm_trip_kernel`: the whole LM of every
person in one launch) on `persons` persons of which `running` start
undone: every person's flag and each running person's inputs read once
and outputs written once, the bone tables and the loop's counters; and
~9,200 float32 operations for each trip of each person, with the trips
the plain reference's LM takes on these inputs. Copied from the port's
`ops/lm_prior.py` (`trip_bytes`, `TRIP_OPS_PER_PERSON`) as kernel_ab.py
uses them.
"""

from portbench.lib.peaks import bound_ms

# The kernel's names in a device trace.
TRACE_NAMES = ("lm_trip_kernel",)

K_JOINTS = 21
N_BONES = 21
_BONE_DIR = 3 + 5 + 1 + 3 + 1 + 1     # d, |d|^2, sqrt, u, r_b, wb
_INC_ENTRIES = 2 * N_BONES            # a bone's two joints
TRIP_OPS_PER_PERSON = (
    N_BONES * (_BONE_DIR + 4 + 12)    # linearise: + wb r_b u, wb u u^T
    + K_JOINTS * (3 + 15 + 3)         # r, C r, act (C r)
    + _INC_ENTRIES * (6 + 9)          # the joint's bones: gradient, block
    + K_JOINTS * (9 + 18 + 6)         # C + ., + lam eye, -(g_u + .)
    + N_BONES * (9 + 42 + 2 * 45 + 9 + 15 + 3 + 12)  # eliminate, parent update
    + K_JOINTS * (42 + 15)            # inverses, own solves
    + N_BONES * (9 + 15 + 3 + 15)     # back-substitute
    + K_JOINTS * 6                    # the finite test, x + delta
    + K_JOINTS * (3 + 15 + 5 + 1)     # joint error terms
    + N_BONES * (_BONE_DIR - 3 + 2)   # bone error terms (no u)
    + (K_JOINTS + N_BONES + 1) + 10   # the two sums, the rules
)
_F32 = 4


def nbytes(persons: int, running: int) -> int:
    per = _F32 * (2 * K_JOINTS * 3 + K_JOINTS * 9 + 2) + K_JOINTS + N_BONES
    out = _F32 * (K_JOINTS * 3 + 2) + 1
    return persons + running * (per + out) + _F32 * 2 * N_BONES + 2 * (4 + 1)


def bound(persons: int, running: int, person_trips: int) -> float:
    """Milliseconds one launch needs at the least."""
    return bound_ms(nbytes(persons, running), TRIP_OPS_PER_PERSON * person_trips)
