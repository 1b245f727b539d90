"""2^30 readiness: memory budgets and plan validation, with the byte limit
taken from the devices or passed explicitly.
"""

import jax
import pytest

from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, TEST_GENERATOR, TEST_MODULUS
from sventt_tpu.parallel import distributed_memory_budget, validate_2p30
from sventt_tpu.plan import NttConfig


def _cfg30():
    return NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 30, strategy="six_step"
    )


GIB = 1 << 30


def test_2p30_fits_8_chips():
    b = validate_2p30(8, hbm_bytes=16 * GIB)
    # 1 GiB shard + 1 GiB all-to-all transient + 1 GiB w-only twiddles
    assert b.coefficients == (1 << 30) // 8 * 8
    assert b.inter_step_twiddles == b.coefficients  # companion-free
    assert b.total < 4 * (1 << 30)
    assert b.fits(16 * GIB)


def test_2p30_two_chip_margin():
    """Even D=2 fits one direction with donation (12 GiB of 15.5);
    keeping both directions AND the caller's buffer does not."""
    b1 = distributed_memory_budget(
        _cfg30(), 2, enable_inverse=False, donate_input=True
    )
    assert b1.fits(int(15.5 * GIB))
    b2 = distributed_memory_budget(_cfg30(), 2, donate_input=False)
    assert not b2.fits(int(15.5 * GIB))
    with pytest.raises(ValueError, match="per device"):
        validate_2p30(2, hbm_bytes=8 * GIB)


def test_budget_rejects_bad_mesh():
    with pytest.raises(ValueError, match="divisible"):
        distributed_memory_budget(_cfg30(), 3)


def test_companion_threshold_reflected():
    """Mid-size transforms keep the Montgomery companion (2x bytes/point);
    2^26+ drops it."""
    mid = distributed_memory_budget(
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 20, strategy="six_step"), 8
    )
    assert mid.inter_step_twiddles == 2 * mid.coefficients
    big = distributed_memory_budget(_cfg30(), 8)
    assert big.inter_step_twiddles == big.coefficients


@pytest.mark.parametrize("engine", ["jnp", "mxu"])
def test_leaf_table_bytes_matches_actual(engine):
    """_leaf_table_bytes must track the REAL per-leaf device bytes of
    PlanTables for every engine (round-4 VERDICT weak 4: the mxu branch
    was priced with the jnp formula, ~17x under).  The estimate must be
    within 2x of actual and never under-count by more than 10%."""
    from sventt_tpu.field.limb import FieldConsts
    from sventt_tpu.field.modulus import Modulus
    from sventt_tpu.parallel.budget import _leaf_table_bytes
    from sventt_tpu.plan import planner

    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    plan = planner.build_plan(1 << 10, engine, max_fused=256)
    tables = planner.PlanTables(plan, mod, fc, inverse=False)

    def nbytes(obj):
        leaves = jax.tree_util.tree_leaves(obj)
        return sum(v.size * v.dtype.itemsize for v in leaves)

    actual = sum(nbytes(t) for t in tables.leaf.values())
    est = _leaf_table_bytes(plan)
    assert est <= 2 * actual + 4096
    assert est >= 0.9 * actual




def test_budget_refuses_device_without_memory_limit():
    """The CPU backend reports no memory limit: the budget never assumes
    a size for it, the caller passes the bytes."""
    from sventt_tpu.parallel import device_bytes_limit

    with pytest.raises(ValueError, match="hbm_bytes"):
        device_bytes_limit()
    with pytest.raises(ValueError, match="hbm_bytes"):
        distributed_memory_budget(_cfg30(), 4).fits()
    with pytest.raises(ValueError, match="hbm_bytes"):
        validate_2p30(4)
    assert validate_2p30(4, hbm_bytes=60 * GIB).fits(60 * GIB)


def test_budget_reads_device_memory_stats(monkeypatch):
    """With devices that report ``bytes_limit`` (GPUs), the smallest one
    is the budget's default."""
    from sventt_tpu.parallel import budget as B

    class Fake:
        platform = "gpu"

        def __init__(self, limit):
            self.limit = limit

        def memory_stats(self):
            return {"bytes_limit": self.limit, "bytes_in_use": 0}

    devs = [Fake(60 * GIB), Fake(59 * GIB)]
    assert B.device_bytes_limit(devs) == 59 * GIB
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    b = distributed_memory_budget(_cfg30(), 4)
    assert b.fits()  # 2^30 over 4 devices: a few GiB of 59
    assert not distributed_memory_budget(_cfg30(), 4).fits(GIB)
