"""The port's JV assignment (ops/hungarian.py, kernel K1's plain version)
against scipy and against the JAX package's TPU kernel in interpret mode.

On the CPU `linear_sum_assignment` runs the plain version; the CUDA kernel is
held to it bit for bit on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from smartedgesensor3dhumanpose_tpu.ops import hungarian_pallas
from smartedgesensor3dhumanpose_tpu_torch import _kernels
from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian

pytestmark = pytest.mark.torch_port


def check_against_scipy(cost, row_active=None):
    got = hungarian.linear_sum_assignment(
        torch.from_numpy(cost),
        None if row_active is None else torch.from_numpy(row_active),
    ).numpy()
    assert got.dtype == np.int32
    rows = np.arange(cost.shape[0]) if row_active is None else np.nonzero(row_active)[0]
    sub = cost[rows]
    r, c = scipy_lsa(sub)
    assigned = got[rows] >= 0
    assert assigned.sum() == min(sub.shape)
    used = got[rows][assigned]
    assert len(np.unique(used)) == len(used)
    # The optimal total (assignments may differ on exact ties). float64
    # inputs: the solver's own rounding only, hence 1e-9.
    np.testing.assert_allclose(
        sub[np.nonzero(assigned)[0], used].sum(), sub[r, c].sum(), rtol=1e-9, atol=1e-9
    )
    if row_active is not None:
        assert (got[~row_active] == -1).all()
    return got


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 24, 64])
def test_square_random(rng, n):
    for _ in range(5):
        check_against_scipy(rng.uniform(size=(n, n)))


@pytest.mark.parametrize(
    "shape", [(2, 5), (5, 2), (1, 7), (7, 1), (16, 9), (3, 16), (16, 24), (24, 16)]
)
def test_rectangular(rng, shape):
    for _ in range(5):
        check_against_scipy(rng.uniform(size=shape))


def test_degenerate_and_placeholder_costs(rng):
    check_against_scipy(np.full((4, 6), 1e3))  # an all-veto matrix
    cost = rng.uniform(size=(6, 6))
    cost[rng.uniform(size=(6, 6)) < 0.4] = 1e3  # clipped placeholders
    check_against_scipy(cost)
    check_against_scipy(np.array([[1.0, 1.0, 2.0], [1.0, 2.0, 1.0], [2.0, 1.0, 1.0]]))


def test_float32_total(rng):
    cost = rng.uniform(size=(8, 8)).astype(np.float32)
    got = hungarian.linear_sum_assignment(torch.from_numpy(cost)).numpy()
    r, c = scipy_lsa(cost.astype(np.float64))
    # float32 solve: totals agree to float32 rounding (~1e-7 per entry).
    np.testing.assert_allclose(cost[np.arange(8), got].sum(), cost[r, c].sum(), rtol=1e-5)


def test_row_active_skips_rows(rng):
    """The tracker's use: invalid persons' rows sit on a constant tier above
    every real cost and are skipped; active rows get the optimum of their
    own subproblem and skipped rows return -1."""
    for _ in range(5):
        cost = rng.uniform(0.0, 8.0, size=(16, 24))
        act = rng.uniform(size=16) < 0.5
        cost[~act] = 1e3
        check_against_scipy(cost, act)


def test_matches_tpu_kernel_single_with_row_active(rng):
    """Same algorithm and tie rules as hungarian_pallas._jv_kernel (interpret
    mode, float32): equal col_of_row on every active row. (The TPU kernel's
    inversion writes 0, not -1, for skipped rows; its consumer ignores
    them.)"""
    for valid in (16, 9, 3):
        cost = rng.uniform(0.0, 8.0, size=(16, 24)).astype(np.float32)
        act = np.zeros(16, bool)
        act[rng.permutation(16)[:valid]] = True
        cost[~act] = 1e3
        want = np.asarray(
            hungarian_pallas._lsa_pallas_single(jnp.asarray(cost), jnp.asarray(act))
        )
        got = hungarian.linear_sum_assignment(
            torch.from_numpy(cost), torch.from_numpy(act)
        ).numpy()
        np.testing.assert_array_equal(got[act], want[act])
        assert (got[~act] == -1).all()


@pytest.mark.parametrize("shape", [(40, 64), (64, 64)])
def test_matches_tpu_kernel_single_wide(rng, shape):
    """As above at n >= 32, where the CUDA kernel holds 2 or 3 register
    slots per lane: tracker-style rows, the invalid ones on the 1e3 tier
    and skipped, against _lsa_pallas_single with the same row_active."""
    r, c = shape
    cost = rng.uniform(0.0, 8.0, size=shape).astype(np.float32)
    act = rng.uniform(size=r) < 0.7
    cost[~act] = 1e3
    want = np.asarray(
        hungarian_pallas._lsa_pallas_single(jnp.asarray(cost), jnp.asarray(act))
    )
    got = hungarian.linear_sum_assignment(
        torch.from_numpy(cost), torch.from_numpy(act)
    ).numpy()
    np.testing.assert_array_equal(got[act], want[act])
    assert (got[~act] == -1).all()


@pytest.mark.parametrize("shape", [(5, 8, 12), (3, 12, 8), (2, 16, 16), (2, 40, 40)])
def test_batched_matches_tpu_kernel(rng, shape):
    """Against linear_sum_assignment_pallas_batched (interpret mode):
    random continuous costs have unique optima, so col_of_row is equal."""
    cost = rng.uniform(size=shape).astype(np.float32)
    want = np.asarray(
        hungarian_pallas.linear_sum_assignment_pallas_batched(
            jnp.asarray(cost), interpret=True
        )
    )
    got = hungarian.linear_sum_assignment_batched(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 7, 8, 64])
def test_jv_plan_every_shape(batch):
    """K1's launch layout across its domain: one warp per problem, an odd
    row stride, one int per column slot, every block within the H100's
    232,448 bytes; chip_smoke.py holds the byte count to the kernel's."""
    for rows in range(1, hungarian.MAX_N + 1):
        for cols in range(1, hungarian.MAX_N + 1):
            plan = hungarian.jv_plan(batch, rows, cols)
            n = max(rows, cols)
            assert 32 * plan.slots > n >= 32 * (plan.slots - 1)
            assert plan.stride % 2 == 1 and cols <= plan.stride <= cols + 1
            problem = 4 * (rows * plan.stride + 32 * plan.slots)
            assert plan.smem_bytes == plan.per_block * problem <= hungarian.SMEM_LIMIT
            assert 1 <= plan.per_block <= min(hungarian.WARPS_PER_BLOCK, batch)
            assert (plan.per_block + 1) * problem > hungarian.SMEM_LIMIT or plan.per_block == min(
                hungarian.WARPS_PER_BLOCK, batch)
            assert plan.blocks == -(-batch // plan.per_block)
    # The online tracker problem is one warp; a 120 x 120 tile needs the
    # opt-in above 48 KB, and three fit a block.
    assert hungarian.jv_plan(1, 16, 24) == hungarian.JvPlan(1, 25, 1, 1728, 1)
    assert hungarian.jv_plan(batch, 120, 120).per_block == min(3, batch)


def test_plain_counts_search_steps():
    """The plain version counts its search steps (K1's bound counts the
    work these inputs need): none when the row reduction places every row."""
    before = hungarian.PLAIN_SEARCH_STEPS
    hungarian.linear_sum_assignment(torch.eye(4) * -1.0 + 1.0)
    assert hungarian.PLAIN_SEARCH_STEPS == before
    hungarian.linear_sum_assignment(torch.tensor([[1.0, 2.0], [1.0, 3.0]]))
    assert hungarian.PLAIN_SEARCH_STEPS > before


def test_wrapper_contract():
    cost = torch.rand(4, 4)
    with pytest.raises(ValueError):
        hungarian.linear_sum_assignment(torch.rand(2, 3, 4))
    # The plain version takes any width (the wide parity cases below); the
    # kernel's plan refuses past MAX_N_WIDE.
    assert hungarian.linear_sum_assignment(torch.rand(121, 121)).shape == (121,)
    with pytest.raises(ValueError, match="up to 8192"):
        hungarian.jv_plan(1, 8193, 8)
    with pytest.raises(ValueError):
        hungarian.linear_sum_assignment(cost.to("meta"))
    # The CPU path never touches the kernel or its launch count.
    before = _kernels.LAUNCHES["jv_assign"]
    hungarian.linear_sum_assignment(cost)
    assert _kernels.LAUNCHES["jv_assign"] == before
    empty = hungarian.linear_sum_assignment_batched(torch.rand(0, 3, 4))
    assert empty.shape == (0, 3) and empty.dtype == torch.int32


@pytest.mark.parametrize("shape", [(121, 121), (128, 128), (160, 150), (140, 160)])
def test_wide_matches_jax_xla_jv(rng, shape):
    """Past the warp kernel's 120 columns (the wide routine's range on the
    card), the plain JV against the JAX package's XLA JV, its route there
    beyond its TPU kernel: the same decisions on untied costs, the same
    optimal total on tied ones (the two searches break ties differently)."""
    import jax

    from smartedgesensor3dhumanpose_tpu.ops import hungarian as jax_hungarian

    solve = jax.jit(lambda c: jax_hungarian.linear_sum_assignment(c, use_pallas=False))
    untied = rng.uniform(size=shape)
    got = hungarian.linear_sum_assignment(torch.from_numpy(untied)).numpy()
    np.testing.assert_array_equal(got, np.asarray(solve(jnp.asarray(untied))))
    check_against_scipy(untied)
    tied = rng.integers(0, 4, size=shape).astype(np.float64)
    got = hungarian.linear_sum_assignment(torch.from_numpy(tied)).numpy()
    want = np.asarray(solve(jnp.asarray(tied)))

    def total(col_of_row):
        rows = np.nonzero(col_of_row >= 0)[0]
        assert len(rows) == min(shape) and len(np.unique(col_of_row[rows])) == len(rows)
        return tied[rows, col_of_row[rows]].sum()

    assert total(got) == total(want)


def test_jv_plan_past_the_warp_width():
    """Past MAX_N: one warp per problem with register slots up to MAX_N_REG,
    one problem per block of ~n / 128 warps past it, the tile staged where
    one problem with it fits a block (the C entry recomputes the bytes on the
    card)."""
    for n in (121, 128, 255, 256, 1024, hungarian.MAX_N_WIDE):
        plan = hungarian.jv_plan(5, n, n)
        assert plan.slots == (n // 32 + 1 if n <= hungarian.MAX_N_REG else 0)
        assert plan.warps == (0 if n <= hungarian.MAX_N_REG else hungarian.block_warps(n))
        assert plan.staged == (n <= 240)
        assert plan.smem_bytes <= hungarian.SMEM_LIMIT
    assert hungarian.jv_plan(5, 1024, 1024) == hungarian.JvPlan(
        0, 1025, 1, hungarian.BLOCK_POST_BYTES + hungarian.wide_state_bytes(1024), 5, False, 9)
    assert hungarian.jv_plan(1, 16, 130) == hungarian.JvPlan(5, 131, 1, 4 * (16 * 131 + 160), 1, True)
    assert hungarian.wide_state_bytes(8192) == 25 * 8208
    assert [hungarian.block_warps(n) for n in (256, 383, 384, 1024, 2048, 8192)] == [3, 3, 4, 9, 16, 16]


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_jv_plan_every_wide_width(batch):
    """K1's plan for every n from 121 to 1024 (n x n, a tall n x 8 and a wide
    16 x n): the register routine with n // 32 + 1 slots up to 255 columns,
    as many problems per block as fit, at most 4; past it one problem per
    block of block_warps(n) warps, its posts and state; the tile staged
    exactly where one problem with it fits the H100's 232,448 bytes; every
    block within the limit."""
    for n in range(hungarian.MAX_N + 1, 1025):
        for rows, cols in ((n, n), (n, 8), (16, n)):
            plan = hungarian.jv_plan(batch, rows, cols)
            assert plan.stride == cols | 1
            tile = 4 * rows * plan.stride
            if n <= hungarian.MAX_N_REG:
                assert plan.slots == n // 32 + 1 and 32 * plan.slots > n and plan.warps == 0
                fixed = 4 * 32 * plan.slots
                most = min(hungarian.WARPS_PER_BLOCK, batch)
            else:
                # ~4 columns per thread, at most 4 up to 2047 columns.
                assert plan.slots == 0 and plan.warps == hungarian.block_warps(n)
                assert 2 <= plan.warps <= 16 and n + 1 <= 4 * 32 * plan.warps
                fixed = 384 + 25 * (-(-(n + 1) // 16) * 16)
                most = 1
            assert plan.staged == (fixed + tile <= hungarian.SMEM_LIMIT)
            problem = fixed + (tile if plan.staged else 0)
            assert plan.smem_bytes == plan.per_block * problem <= hungarian.SMEM_LIMIT
            assert 1 <= plan.per_block <= most
            assert plan.per_block == most or (plan.per_block + 1) * problem > hungarian.SMEM_LIMIT
            assert plan.blocks == -(-batch // plan.per_block)
    # The camera scan's 128 x 8 problems: four per block, 4.6 KB tiles.
    assert hungarian.jv_plan(batch, 128, 8).per_block == min(4, batch)
    assert hungarian.jv_plan(1, 128, 8).smem_bytes == 4 * (128 * 9 + 160)


TALL = {
    "random": lambda rng: rng.uniform(size=(128, 8)),
    "trivial": lambda rng: (np.arange(128)[:, None] != np.arange(8)[None, :]).astype(np.float64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("matrix", list(TALL))
def test_plain_tall_with_every_row_off_or_on(rng, matrix, dtype):
    """A tall 128 x 8 problem, as the camera scan solves it at
    max_hypotheses=128: every row off returns -1 everywhere and runs no
    search (the scan's discarded problems); every row on equals no mask."""
    cost = torch.from_numpy(TALL[matrix](rng)).to(dtype)
    before = hungarian.PLAIN_SEARCH_STEPS
    off = hungarian.linear_sum_assignment(cost, torch.zeros(128, dtype=torch.bool))
    assert hungarian.PLAIN_SEARCH_STEPS == before
    assert off.dtype == torch.int32 and bool((off == -1).all())
    on = hungarian.linear_sum_assignment(cost, torch.ones(128, dtype=torch.bool))
    assert hungarian.PLAIN_SEARCH_STEPS > before  # the rows past 8 search
    assert torch.equal(on, hungarian.linear_sum_assignment(cost))
    assert int((on >= 0).sum()) == 8
    batched = hungarian.linear_sum_assignment_batched(
        torch.stack([cost, cost]), torch.tensor([[False] * 128, [True] * 128]))
    assert torch.equal(batched, torch.stack([off, on]))
