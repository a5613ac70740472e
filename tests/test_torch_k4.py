"""K4, paged decode attention (``csrc/paged_attention.cu``): its plan
(``k4_plan``), the passes it runs (``k4_passes``), its split plain version
against the JAX package's Pallas kernel, and K3's plain version at the head
dims the kernels now take.

On this CPU host the wrappers run their plain versions and the reference's
Pallas kernels run in interpret mode, as its own tests run them.  Inputs are
made with numpy from a seed (bf16x1 on a 1/8 grid, so every score is exact
in fp32 whatever the summation order: ROADMAP Queue 3 D2).  Tolerances:
1e-5 absolute and relative (K4, K3), 1e-4 (K9 at block_n 8192, on the card).
Tests marked ``cuda`` need a card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.serving.paged_attention import (  # noqa: E402
    paged_decode_attention_pallas as jax_paged)

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_KV, flash_attention, flash_attention_plain)
from repro_torch.kernels.tcec_matmul import k2_passes  # noqa: E402
from repro_torch.serving.paged_attention import (  # noqa: E402
    CHUNK, K4_BLOCKS_PER_SM, K4_MIN_CHUNKS, k4_passes, k4_plan,
    paged_decode_attention_kernel, paged_decode_attention_plain)
from repro_torch.serving.paged_cache import pages_needed  # noqa: E402

H100_SMS = 132
POLICIES = ("bf16x1", "bf16x3", "bf16x6")
#: (d, dv) of the parity tests: every kernel bucket, and MLA-like d != dv.
DIMS = ((16, 16), (32, 32), (128, 128), (256, 256), (192, 128))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def _draw(rng, policy, *shapes):
    """Seeded operands: a 1/8 grid under bf16x1, normal draws otherwise."""
    if policy == "bf16x1":
        return [(rng.integers(-8, 9, s) / 8.0).astype(np.float32)
                for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# The plan and the passes
# ---------------------------------------------------------------------------

def _plans():
    for b, kvh, rep, npages, page, dv, sms in itertools.product(
            (1, 3, 4), (1, 2), (1, 7, 9), (1, 3, 19, 32, 128), (1, 8, 16),
            (16, 64, 128), (8, 132)):
        yield b, kvh, rep, npages, page, dv, sms


def test_k4_plan_covers_the_chunks_once_in_order():
    """Split s covers chunks [s * per, min(chunks, (s + 1) * per)): every
    chunk of the block table once, in order; every split but the last holds
    at least K4_MIN_CHUNKS when there are splits; a pure function."""
    for b, kvh, rep, npages, page, dv, sms in _plans():
        plan = k4_plan(b, kvh, rep, npages, page, sms, dv=dv)
        assert plan == k4_plan(b, kvh, rep, npages, page, sms, dv=dv)
        assert plan.chunks == -(-npages * page // CHUNK)
        ranges = [(s * plan.per, min(plan.chunks, (s + 1) * plan.per))
                  for s in range(plan.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.chunks
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2 and hi - lo == plan.per
        assert all(hi > lo for lo, hi in ranges)
        if plan.splits > 1:
            assert plan.per >= K4_MIN_CHUNKS
        units = b * kvh * -(-rep // 8) * -(-dv // 16)
        assert plan.blocks == units * plan.splits


@pytest.mark.parametrize("b,kvh,rep,npages,page,dv", [
    (4, 2, 7, 3, 16, 16),        # test_torch_kernels' paged shapes
    (4, 2, 2, 3, 16, 16),
    (4, 2, 7, 3, 16, 64),
    (2, 2, 2, pages_needed(16, 4), 4, 16),    # engine, max_seq_len 16
    (2, 2, 2, pages_needed(16, 8), 8, 16),
])
def test_k4_plan_does_not_split_the_existing_test_shapes(b, kvh, rep, npages,
                                                         page, dv):
    assert k4_plan(b, kvh, rep, npages, page, H100_SMS, dv=dv).splits == 1


def test_k4_plan_fills_the_card_at_the_serving_shape():
    """qwen2-0.5b serving: 4 slots, kv heads 2 (rep 7), head dim 64,
    max_seq_len 512 in pages of 16: at least two blocks per SM."""
    plan = k4_plan(4, 2, 7, pages_needed(512, 16), 16, H100_SMS, dv=64)
    assert plan.blocks >= K4_BLOCKS_PER_SM * H100_SMS
    assert plan.splits > 1 and plan.per >= K4_MIN_CHUNKS


def test_k4_passes_is_k2s_rule():
    dts = (torch.float32, torch.bfloat16)
    for name in ("bf16x1", "bf16x3", "bf16x6"):
        pol = get_policy(name)
        for q_dt, p_dt in itertools.product(dts, dts):
            assert k4_passes(pol, q_dt, p_dt) == k2_passes(pol, q_dt, p_dt)
    six = get_policy("bf16x6")
    assert k4_passes(six, torch.float32, torch.bfloat16) == \
        ((2, 0), (1, 0), (0, 0))
    assert len(k4_passes(six, torch.float32, torch.float32)) == 6
    assert k4_passes(six, torch.bfloat16, torch.bfloat16) == ((0, 0),)


# ---------------------------------------------------------------------------
# The split plain version against the reference
# ---------------------------------------------------------------------------

def _paged_case(rng, policy, d, dv, page=16, npages=8, kvh=2, rep=4,
                lens=(0, 37, 128)):
    b = len(lens)
    n_phys = 1 + b * npages
    table = rng.permutation(np.arange(1, n_phys)).reshape(b, npages)
    kp, vp, q = _draw(rng, policy, (n_phys, page, kvh, d),
                      (n_phys, page, kvh, dv), (b, kvh * rep, d))
    return q, kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("d,dv", DIMS)
@pytest.mark.parametrize("policy", POLICIES)
def test_k4_split_plain_matches_reference(policy, d, dv):
    """At a shape the plan splits (3 slots, kv heads 2, rep 4, 8 pages of
    16, lengths 0/37/128), every bucket of head dims and d != dv."""
    rng = np.random.default_rng(d * 7 + dv + len(policy))
    q, kp, vp, table, lens = _paged_case(rng, policy, d, dv)
    plan = k4_plan(3, 2, 4, table.shape[1], 16, H100_SMS, dv=dv)
    assert plan.splits > 1
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(lens), policy=policy,
                    interpret=True)
    t = torch.from_numpy
    ours = paged_decode_attention_kernel(t(q), t(kp), t(vp), t(table),
                                         t(lens), policy=policy)
    assert ours.shape == (3, 8, dv) and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)
    assert not ours[0].any()                     # zero length -> zeros


def test_k4_plain_reads_no_length_on_the_host(monkeypatch):
    """The plain version takes its plan from shapes: reading a length on
    the host (``int``/``item``/``tolist`` of seq_lens) is never needed."""
    rng = np.random.default_rng(1)
    q, kp, vp, table, lens = _paged_case(rng, "bf16x6", 16, 16)
    t = torch.from_numpy
    sl = t(lens)
    want = paged_decode_attention_plain(t(q), t(kp), t(vp), t(table), sl,
                                        scale=0.25,
                                        policy=get_policy("bf16x6"))

    def forbidden(*_a, **_k):
        raise AssertionError("a length was read on the host")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    got = paged_decode_attention_plain(t(q), t(kp), t(vp), t(table), sl,
                                       scale=0.25,
                                       policy=get_policy("bf16x6"))
    monkeypatch.undo()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K3's plain version at the same head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dv", DIMS)
@pytest.mark.parametrize("policy", POLICIES)
def test_flash_plain_matches_reference_at_head_dims(policy, d, dv):
    """Causal GQA prefill (1, 4 heads over 2, 20 positions) with kv_len
    18, every bucket of head dims and d != dv."""
    rng = np.random.default_rng(d * 5 + dv + len(policy))
    q, k, v = _draw(rng, policy, (1, 4, 20, d), (1, 2, 20, d),
                    (1, 2, 20, dv))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, block_q=8, block_k=BLOCK_KV,
                    interpret=True, policy=policy, kv_len=18)
    t = torch.from_numpy
    ours = flash_attention(t(q), t(k), t(v), causal=True, policy=policy,
                           kv_len=18)
    assert ours.shape == (1, 4, 20, dv)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: (d, dv, page dtype): every bucket, d != dv, a head dim whose rows are not
#: 16-byte multiples (element loads), fp32 pages.
CUDA_DIMS = ((16, 16, "bfloat16"), (64, 64, "bfloat16"),
             (128, 128, "bfloat16"), (256, 256, "bfloat16"),
             (192, 128, "bfloat16"), (20, 36, "bfloat16"),
             (64, 64, "float32"), (256, 256, "float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv,dtype", CUDA_DIMS)
@pytest.mark.parametrize("npages", [3, 40])
def test_cuda_k4_matches_plain(cuda_device, d, dv, dtype, npages):
    """Unsplit (3 pages) and split (40 pages) plans, every policy."""
    g = torch.Generator(device=cuda_device).manual_seed(d + dv + npages)
    kvh, rep, page = 2, 7, 16
    lens = [0, 5, min(37, npages * page), npages * page - 3]
    b = len(lens)
    n_phys = 1 + b * npages
    table = (torch.randperm(n_phys - 1, generator=g, device=cuda_device)
             + 1)[:b * npages].reshape(b, npages).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    dt = getattr(torch, dtype)
    normal = [torch.randn(s, generator=g, device=cuda_device)
              for s in ((n_phys, page, kvh, d), (n_phys, page, kvh, dv),
                        (b, kvh * rep, d))]
    plan = k4_plan(b, kvh, rep, npages, page, dv=dv,
                   sms=torch.cuda.get_device_properties(0)
                   .multi_processor_count)
    assert (plan.splits > 1) == (npages == 40)
    for name in POLICIES:
        xs = normal if name != "bf16x1" else [
            (torch.randint(-8, 9, x.shape, generator=g, device=cuda_device)
             / 8.0) for x in normal]
        kp, vp, q = xs[0].to(dt), xs[1].to(dt), xs[2]
        pol = get_policy(name)
        got = paged_decode_attention_kernel(q, kp, vp, table, sl, policy=pol)
        plain = paged_decode_attention_plain(
            q, kp, vp, table, sl, scale=1.0 / d ** 0.5, policy=pol)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(128, 128), (256, 256), (192, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_head_dims_match_plain(cuda_device, d, dv, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(d + dv)
    dt = getattr(torch, dtype)
    q = torch.randn(1, 6, 100, d, generator=g, device=cuda_device).to(dt)
    k = torch.randn(1, 2, 100, d, generator=g, device=cuda_device).to(dt)
    v = torch.randn(1, 2, 100, dv, generator=g, device=cuda_device).to(dt)
    for name in ("bf16x3", "bf16x6"):
        pol = get_policy(name)
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=True, policy=pol, kv_len=90),
            flash_attention_plain(q, k, v, pol, causal=True, kv_len=90),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_k4_and_k3_refuse_head_dims_above_256(cuda_device):
    q = torch.zeros(1, 2, 288, device=cuda_device)
    kp = torch.zeros(3, 16, 1, 288, device=cuda_device)
    table = torch.ones(1, 1, dtype=torch.int32, device=cuda_device)
    sl = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError):
        paged_decode_attention_kernel(q, kp, kp, table, sl, policy="bf16x3")
    x = torch.zeros(1, 1, 8, 288, device=cuda_device)
    with pytest.raises(NotImplementedError):
        flash_attention(x, x, x, policy="bf16x3")


@pytest.mark.cuda
def test_cuda_k9_takes_block_n_8192(cuda_device):
    from repro_torch.kernels import structured as st
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(40, 16384, generator=g, device=cuda_device)
    got = st.scan_cumsum(x, 8192)
    plain = st.scan_cumsum_plain(x, 8192)
    err = (got.double() - plain.double()).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.double().abs()).all())
