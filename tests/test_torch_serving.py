"""The port's serving pieces against the JAX package: the copied scheduler
(identical step plans on the same seeded streams), the page-pool
primitives and the paged-attention gather twin."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import paged_attention as jpa  # noqa: E402
from repro.serving import paged_cache as jpc  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402

from repro_torch.serving import paged_attention as tpa  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


# ---------------------------------------------------------------------------
# Scheduler copy: identical plans on identical streams
# ---------------------------------------------------------------------------

def _drive(mod, seed, num_pages, page_size, slots, chunk, prefix_cache,
           max_pages_per_seq, ticks=300):
    """A seeded admit/decode/evict stream against ``mod.Scheduler`` with a
    fake executor; returns every tick's plan and the final state.  Prompts
    share a base prefix over a 3-token alphabet so prefix matches occur."""
    rng = np.random.default_rng(seed)
    sched = mod.Scheduler(num_pages=num_pages, page_size=page_size,
                          max_concurrency=slots,
                          max_pages_per_seq=max_pages_per_seq,
                          prefill_chunk=chunk, prefix_cache=prefix_cache)
    base = [int(t) for t in rng.integers(1, 4, int(rng.integers(1, 12)))]
    n_req = int(rng.integers(2, 9))
    plans, rid = [], 0
    for _ in range(ticks):
        while rid < n_req and rng.integers(0, 2):
            prompt = base[:int(rng.integers(1, len(base) + 1))] \
                + [int(t) for t in rng.integers(1, 4, int(rng.integers(0, 5)))]
            req = mod.Request(rid=rid, prompt=prompt,
                              max_new_tokens=int(rng.integers(1, 5)))
            rid += 1
            try:
                sched.submit(req)
            except ValueError as err:       # can never fit: same in both
                plans.append(("rejected", str(err)))
        plan = sched.step()
        plans.append(plan)
        for c in plan.prefill:
            sched.record_prefill(c.rid, c.end,
                                 first_token=7 if c.last else None)
        for r, _ in plan.decode:
            sched.record_decode(r, 7)
        if sched.done and rid == n_req:
            break
    return plans, sched.done, sched.completed, sched.prefix_stats


def _as_tuples(plans):
    out = []
    for p in plans:
        if isinstance(p, tuple):
            out.append(p)
        else:
            out.append((p.admit, tuple((c.rid, c.slot, c.start, c.end, c.last,
                                        c.cached_upto) for c in p.prefill),
                        p.decode, p.evict))
    return out


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_scheduler_copy_plans_equal_reference(prefix_cache):
    for seed in range(30):
        rng = np.random.default_rng(1000 + seed)
        kw = dict(num_pages=int(rng.integers(4, 15)),
                  page_size=int(rng.integers(1, 6)),
                  slots=int(rng.integers(1, 4)),
                  chunk=None if rng.integers(0, 2) else int(rng.integers(1, 5)),
                  prefix_cache=prefix_cache,
                  max_pages_per_seq=int(rng.integers(1, 6)))
        ours = _drive(tsched, seed, **kw)
        ref = _drive(jsched, seed, **kw)
        assert _as_tuples(ours[0]) == _as_tuples(ref[0]), (seed, kw)
        assert ours[1:] == ref[1:], (seed, kw)


def test_scheduler_copy_inherits_reference_prefix_stall():
    """The reference's prefix-cache scheduler can stop draining with 4
    pages of 2 tokens and one slot (a known reference fault): the copy
    behaves identically on such streams, tick for tick."""
    stalled = 0
    for seed in range(60):
        kw = dict(num_pages=4, page_size=2, slots=1, chunk=None,
                  prefix_cache=True, max_pages_per_seq=5, ticks=60)
        ours = _drive(tsched, seed, **kw)
        ref = _drive(jsched, seed, **kw)
        assert _as_tuples(ours[0]) == _as_tuples(ref[0]), seed
        assert ours[1:] == ref[1:], seed
        stalled += not ref[1]
    assert stalled > 0, "no stalling stream in the sweep"


# ---------------------------------------------------------------------------
# Page pools
# ---------------------------------------------------------------------------

def test_append_gather_and_prefix_write_match_reference():
    rng = np.random.default_rng(0)
    P, page, kvh, d = 7, 4, 2, 3
    pool = rng.standard_normal((P, page, kvh, d)).astype(np.float32)
    table = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    # slot 1 writes past its two-page row: redirected to the scratch page
    lens = np.array([2, 7, 0], np.int32)
    new = rng.standard_normal((3, 2, kvh, d)).astype(np.float32)
    ref = np.asarray(jpc.append_pages(jnp.asarray(pool), jnp.asarray(new),
                                      jnp.asarray(table), jnp.asarray(lens)))
    ours = tpc.append_pages(torch.from_numpy(pool.copy()),
                            torch.from_numpy(new), torch.from_numpy(table),
                            torch.from_numpy(lens))
    # the scratch page absorbs colliding writes in an unspecified order
    np.testing.assert_array_equal(ours.numpy()[1:], ref[1:])
    np.testing.assert_array_equal(
        tpc.gather_pages(ours, torch.from_numpy(table)).numpy()[:2],
        np.asarray(jpc.gather_pages(jnp.asarray(ref),
                                    jnp.asarray(table)))[:2])

    L, s = 2, 6
    stacked = rng.standard_normal((L, P, page, kvh, d)).astype(np.float32)
    pf = {"k": rng.standard_normal((L, 1, s, kvh, d)).astype(np.float32)}
    row = np.array([5, 6], np.int32)
    ref = jpc.write_prefill_prefix(
        {"pos0": {"mixer": {"k_pages": jnp.asarray(stacked)}}},
        {"pos0": {"mixer": {"k": jnp.asarray(pf["k"])}}},
        jnp.asarray(row), 0)["pos0"]["mixer"]["k_pages"]
    ours = tpc.write_prefill_prefix(
        {"k_pages": torch.from_numpy(stacked.copy())},
        {"k": torch.from_numpy(pf["k"])}, torch.from_numpy(row), 0)
    np.testing.assert_array_equal(ours["k_pages"].numpy(), np.asarray(ref))
    copied = tpc.copy_page({"k_pages": ours["k_pages"]}, 5, 2)["k_pages"]
    np.testing.assert_array_equal(copied[:, 2].numpy(),
                                  copied[:, 5].numpy())


@pytest.mark.parametrize("policy", ["fp32_vpu", "bf16x6"])
def test_paged_gather_twin_matches_reference(policy):
    rng = np.random.default_rng(5)
    P, page, kvh, rep, d = 9, 4, 2, 7, 8
    kp = rng.standard_normal((P, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((P, page, kvh, d)).astype(np.float32)
    q = rng.standard_normal((3, kvh * rep, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:6].reshape(3, 2)
    table = table.astype(np.int32)
    lens = np.array([1, 8, 5], np.int32)
    ref = jpa.paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), policy=policy)
    t = torch.from_numpy
    ours = tpa.paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens),
                                      policy=policy)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
