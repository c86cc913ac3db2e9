"""repro_torch.core.cache against repro.core.cache over multi-step runs:
every ``CachePlan`` field and every ``CacheState`` field after
``apply_plan`` agree bitwise (the tracker's float leaves within the stated
fp32 tolerance of ``torch_parity``), for all four policies, both planning
routes (``use_pallas_plan`` off and on) and writeback on and off, and for
fp16 / int8 tiered arenas (tier promotion and demotion counters included).

Tiered runs apply the reference's plans eagerly, with one transmitter
round per move (``buffer_rows`` = capacity): compiled (under ``jax.jit``,
or in the ``fori_loop`` of a multi-round move) XLA may fuse the int8
decode into an FMA and its encode's scale may come out an ulp off, which
the port (like the eager reference) never does.  Eagerly, arena and host table agree
bitwise too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import cache as jcache
from repro.core.policies import Policy as JPolicy
from repro.store.host_store import HostStore as JHostStore
from repro_torch.convert import to_numpy
from repro_torch.core import cache
from repro_torch.core.policies import Policy
from repro_torch.store.host_store import HostStore

CPU = torch.device("cpu")
# one compile per configuration instead of one eager dispatch per op
_jit_plan = jax.jit(jcache.plan_prepare, static_argnums=0)
_jit_apply = jax.jit(jcache.apply_plan, static_argnums=0)


def _pair(policy, pallas, writeback, warm, **kw):
    geo = {**dict(vocab=128, capacity=32, ids_per_step=16, buffer_rows=8, writeback=writeback,
                  use_pallas_plan=pallas), **kw}
    jcfg = jcache.CacheConfig(policy=JPolicy(policy.value), **geo)
    tcfg = cache.CacheConfig(policy=policy, **geo)
    rng = np.random.default_rng(0)
    table = rng.normal(size=(128, 8)).astype(np.float32)
    jfull = JHostStore.create({"weight": jnp.asarray(table)})
    tfull = HostStore.create({"weight": torch.from_numpy(table.copy())})
    jst = jcache.init_cache(jcfg, {"weight": jnp.zeros((8,), jnp.float32)})
    tst = cache.init_cache(tcfg, {"weight": torch.zeros((8,))}, CPU)
    if warm:
        jfull, jst = jcache.warmup(jcfg, jfull, jst)
        tfull, tst = cache.warmup(tcfg, tfull, tst)
    return (jcfg, jfull, jst), (tcfg, tfull, tst), rng


def _run(policy, pallas, writeback, warm=False, steps=4, jit_apply=True, **kw):
    (jcfg, jfull, jst), (tcfg, tfull, tst), rng = _pair(policy, pallas, writeback, warm, **kw)
    japply = _jit_apply if jit_apply else jcache.apply_plan
    assert_tree_equal(jax_to_numpy(jst), to_numpy(tst), "init")
    for step in range(steps):
        # skewed ids with repeats and -1 padding lanes
        rows = np.minimum(rng.zipf(1.3, size=16) - 1, 127).astype(np.int32)
        rows[rng.random(16) < 0.15] = -1
        jplan = _jit_plan(jcfg, jst, jnp.asarray(rows))
        tplan = cache.plan_prepare(tcfg, tst, torch.from_numpy(rows))
        assert_tree_equal(jax_to_numpy(jplan), to_numpy(tplan), f"plan{step}")
        jfull, jst = japply(jcfg, jfull, jst, jplan)
        tfull, tst = cache.apply_plan(tcfg, tfull, tst, tplan)
        assert_tree_equal(jax_to_numpy(jst), to_numpy(tst), f"state{step}")
        assert_tree_equal(jax_to_numpy(jfull), to_numpy(tfull), f"full{step}")
    return tst


@pytest.mark.parametrize("writeback", [False, True])
@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("policy", list(Policy))
def test_plan_and_apply_match_reference(policy, pallas, writeback):
    _run(policy, pallas, writeback)


@pytest.mark.parametrize("pallas", [False, True])
def test_warm_cache_with_isin_protection_matches_reference(pallas):
    _run(Policy.FREQ_LFU, pallas, writeback=True, warm=True, protect_via_inverse=False)


@pytest.mark.parametrize("pallas", [False, True])
def test_unique_overflow_is_counted_like_reference(pallas):
    st = _run(Policy.LRU, pallas, writeback=False, max_unique_per_step=4)
    assert int(st.uniq_overflows) > 0


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("policy", [Policy.FREQ_LFU, Policy.LRU])
@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_tiered_arena_plan_and_apply_match_reference(precision, policy, warm):
    st = _run(policy, True, writeback=True, warm=warm, steps=6, jit_apply=False,
              buffer_rows=32, arena_precision=precision, arena_head_ratio=0.25)
    assert st.cached_rows.head_capacity == 8 and st.cached_rows.codec == precision
    if not warm:  # the first loads fill the empty fp32 head
        assert int(st.tier_promotions) >= 8
    if policy is Policy.LRU and warm:  # recency evicts head rows too
        assert int(st.tier_demotions) > 0


def test_flush_makes_the_host_table_authoritative():
    (jcfg, jfull, jst), (tcfg, tfull, tst), rng = _pair(
        Policy.FREQ_LFU, True, True, warm=True, buffer_rows=32, arena_precision="int8")
    for _ in range(3):
        rows = torch.from_numpy(rng.integers(-1, 128, size=16).astype(np.int32))
        tfull, tst, _ = cache.prepare(tcfg, tfull, tst, rows)
        jfull, jst, _ = jcache.prepare(jcfg, jfull, jst, jnp.asarray(rows.numpy()))
    tfull, tst = cache.flush(tcfg, tfull, tst)
    jfull, jst = jcache.flush(jcfg, jfull, jst)
    assert_tree_equal(jax_to_numpy(jfull), to_numpy(tfull), "flushed")
    resident = tst.slot_to_row >= 0
    slots = torch.arange(32, dtype=torch.int32)
    assert torch.equal(cache.lookup_slots(tst, slots)[resident],
                       tfull["weight"][tst.slot_to_row[resident].long()])


def test_prepare_then_lookup_is_the_uncached_table():
    (_, _, _), (tcfg, tfull, tst), rng = _pair(Policy.FREQ_LFU, True, True, warm=False)
    for _ in range(4):
        rows = torch.from_numpy(rng.integers(-1, 128, size=16).astype(np.int32))
        tfull, tst, slots = cache.prepare(tcfg, tfull, tst, rows)
        got = cache.lookup_slots(tst, slots)
        want = torch.where((rows >= 0)[:, None], tfull["weight"][rows.clamp(min=0).long()], 0.0)
        assert torch.equal(got, want)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="auto resolves above"):  # as the reference's
        cache.CacheConfig(vocab=8, capacity=4, ids_per_step=4, arena_precision="auto")
    with pytest.raises(ValueError):
        cache.CacheConfig(vocab=8, capacity=4, ids_per_step=4, arena_precision="bf16")
    with pytest.raises(ValueError, match="chunk_rows"):  # as the reference's
        cache.CacheConfig(vocab=8, capacity=4, ids_per_step=4, chunk_rows=-1)
