"""K3, prefill flash attention (``csrc/flash_attention.cu``): its plan
(``k3_plan``), the passes it runs (``k3_passes``), its split plain version
against the JAX package's Pallas kernel, and the rotary embedding's base
made without a host copy (ROADMAP Queue 3 D7).

On this CPU host the wrappers run their plain versions and the reference's
Pallas kernels run in interpret mode, as its own tests run them.  Inputs are
made with numpy from a seed (bf16x1 on a 1/8 grid, so every score is exact
in fp32 whatever the summation order: ROADMAP Queue 3 D2).  Tolerances:
1e-5 absolute and relative for the plain version against the reference;
the kernel against its plain version 1e-5 in the max-norm (max |x - ref| /
max |ref|, as ``chip_smoke.py`` holds every kernel: under bf16x3 P keeps
two bf16 words, so a score that differs in its last fp32 bit between two
summation orders can move one element by 2^-17 of its P, which an
elementwise 1e-5 can catch on millions of elements); the rope bitwise
against its earlier formula, and its frequencies within one fp32 ulp of the
reference's.  Tests marked ``cuda`` need a card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.base import rope_cos_sin as jax_rope  # noqa: E402

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_KV, K3_BLOCKS_PER_SM, NEG_INF, flash_attention,
    flash_attention_plain, k3_passes, k3_plan)
from repro_torch.kernels.tcec_core import dot_params, policy_dot  # noqa: E402
from repro_torch.kernels.tcec_matmul import k2_passes  # noqa: E402
from repro_torch.models import base as torch_base  # noqa: E402

H100_SMS = 132
POLICIES = ("bf16x1", "bf16x3", "bf16x6")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def _max_norm(got, ref):
    """max |got - ref| / max |ref|: the repository's max-norm error."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-300))


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
    """(b, h, kvh, sq, skv, causal, kv_len, sms) over prefill and
    cross-attention shapes, short and long, few and many SMs."""
    for b, (h, kvh), sq, causal, kv_frac, sms in itertools.product(
            (1, 3), ((14, 2), (4, 4)), (1, 20, 64, 130, 256, 2048),
            (True, False), (1.0, 0.5), (8, 132)):
        skv = sq if causal else sq + 37
        yield b, h, kvh, sq, skv, causal, int(skv * kv_frac), sms


def _kv_end(qt, plan, sq, skv, causal, kv_len):
    """The kernel's kv range of q tile qt (``csrc/flash_attention.cu``'s
    ``tiles_of``)."""
    end = min(kv_len, skv)
    if causal:
        end = min(end, min((qt + 1) * plan.block_q, sq))
    return end


@pytest.mark.parametrize("shape", list(_plans()))
def test_k3_plan_covers_every_tile_pair_once(shape):
    """Every (q tile, kv tile) pair that holds a valid (row, column) pair is
    visited by exactly one block, each split holds whole tiles, and no
    split is longer than ``per``."""
    b, h, kvh, sq, skv, causal, kv_len, sms = shape
    plan = k3_plan(b, h, kvh, sq, skv, causal, 64, 64, sms, kv_len=kv_len)
    assert plan.block_q == 4 * plan.warps and plan.warps in (4, 8)
    assert plan.q_tiles == -(-sq // plan.block_q)
    assert plan.blocks == b * h * plan.q_tiles * plan.splits
    seen = {}
    for qt in range(plan.q_tiles):
        nt = -(-_kv_end(qt, plan, sq, skv, causal, kv_len) // BLOCK_KV)
        for s in range(plan.splits):
            tiles = range(s * plan.per, min(nt, (s + 1) * plan.per))
            assert len(tiles) <= plan.per
            for j in tiles:
                seen[(qt, j)] = seen.get((qt, j), 0) + 1
    want = set()
    for r in range(sq):
        for c in range(min(kv_len, skv)):
            if not causal or r >= c:
                want.add((r // plan.block_q, c // BLOCK_KV))
    assert set(seen) == want
    assert all(n == 1 for n in seen.values())
    # Splits only where the grid is short of two blocks per SM.
    units = b * h * plan.q_tiles
    if units >= K3_BLOCKS_PER_SM * sms:
        assert plan.splits == 1


def test_k3_plan_is_a_function_of_host_ints(monkeypatch):
    """No tensor and no card: the same ints give the same plan, with
    torch.cuda unreachable."""
    def forbidden(*_a, **_k):
        raise AssertionError("k3_plan touched the card")

    for name in ("get_device_properties", "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    a = k3_plan(1, 14, 2, 256, 256, True, 64, 64, 132)
    assert a == k3_plan(1, 14, 2, 256, 256, True, 64, 64, 132)
    assert all(isinstance(x, int) for x in a.__dict__.values())


def test_k3_plan_splits_the_headline_not_the_long_prefill():
    """qwen2-0.5b's prefill (1, 14 heads over 2, 256 positions): 112 q
    tiles of 32 rows, short of two per SM, so each kv range is split in two
    tiles each; at 2048 positions 896 q tiles fill the card: one split."""
    head = k3_plan(1, 14, 2, 256, 256, True, 64, 64, H100_SMS)
    assert (head.block_q, head.warps, head.q_tiles) == (32, 8, 8)
    assert (head.kv_tiles, head.splits, head.per, head.blocks) == (4, 2, 2,
                                                                   224)
    long = k3_plan(1, 14, 2, 2048, 2048, True, 64, 64, H100_SMS)
    assert (long.q_tiles, long.splits, long.per) == (64, 1, 32)
    assert long.blocks == 896
    # A prompt of at most 16 rows takes one row group.
    assert k3_plan(1, 14, 2, 9, 9, True, 64, 64).warps == 4
    assert k3_plan(1, 14, 2, 40, 40, True, 64, 64).warps == 8


#: The shapes of the earlier K3 tests (tests/test_torch_kernels.py K3_CASES
#: and tests/test_torch_k4.py's head-dim test): (b, h, kvh, sq, skv, causal,
#: kv_len, d, dv).
EARLIER = ((1, 4, 2, 20, 20, True, None, 16, 16),
           (2, 14, 2, 9, 70, False, 45, 16, 16),
           (1, 7, 1, 70, 70, True, 50, 16, 16),
           (1, 2, 1, 5, 8, False, 0, 16, 16),
           (1, 4, 2, 20, 20, True, 18, 192, 128))


def _unsplit_plain(q, k, v, policy, causal, kv_len):
    """The plain version as it was before the plan: one online softmax over
    every kv block."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    kv_len = skv if kv_len is None else kv_len
    kw = dot_params(policy)
    kk = k.float().repeat_interleave(rep, dim=1)
    vv = v.float().repeat_interleave(rep, dim=1)
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, v.shape[-1]))
    rows = torch.arange(sq)[:, None]
    for j0 in range(0, kv_len, BLOCK_KV):
        kb, vb = kk[:, :, j0:j0 + BLOCK_KV], vv[:, :, j0:j0 + BLOCK_KV]
        s = policy_dot(q.float(), kb, "bhqd,bhkd->bhqk", **kw) * (
            1.0 / d ** 0.5)
        cols = j0 + torch.arange(kb.shape[2])[None]
        valid = cols < kv_len
        if causal:
            valid = valid & (rows >= cols)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(m_new > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + policy_dot(p, vb, "bhqk,bhkd->bhqd", **kw)
        m = m_new
    return torch.where(l > 0.0, acc / torch.where(l > 0.0, l, 1.0), 0.0)


@pytest.mark.parametrize("shape", EARLIER)
@pytest.mark.parametrize("policy", POLICIES)
def test_earlier_shapes_see_no_change(shape, policy):
    """At the earlier tests' shapes the plan has one split and the plain
    version gives the bits it gave before the plan."""
    b, h, kvh, sq, skv, causal, kv_len, d, dv = shape
    assert k3_plan(b, h, kvh, sq, skv, causal, d, dv,
                   kv_len=kv_len).splits == 1
    rng = np.random.default_rng(sq * 7 + d + len(policy))
    q, k, v = (torch.from_numpy(x) for x in _draw(
        rng, policy, (b, h, sq, d), (b, kvh, skv, d), (b, kvh, skv, dv)))
    pol = get_policy(policy)
    got = flash_attention_plain(q, k, v, pol, causal=causal, kv_len=kv_len)
    want = _unsplit_plain(q, k, v, pol, causal, kv_len)
    assert torch.equal(got, want)


@pytest.mark.parametrize("policy", POLICIES + ("bf16x9",))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_k3_passes_follow_k2_rule(policy, dt):
    pol = get_policy(policy)
    dtype = getattr(torch, dt)
    qk, pv = k3_passes(pol, dtype, dtype)
    assert qk == k2_passes(pol, dtype, dtype)
    assert pv == k2_passes(pol, torch.float32, dtype)
    if dt == "float32":                 # the serving path: every pass
        assert qk == pv == tuple(pol.schedule)
    else:                               # bf16 k, v: only word 0 of theirs
        assert qk == ((0, 0),)
        assert pv == tuple((i, j) for i, j in pol.schedule if j == 0)


# ---------------------------------------------------------------------------
# The split plain version against the reference
# ---------------------------------------------------------------------------

#: name -> (b, h, kvh, sq, skv, causal, kv_len, d, dv).  "split" and the
#: head-dim rows are split by the plan (130 positions: 3 kv tiles in 3
#: splits); "kv_len" masks past 100 of 130; "full" is not causal.
SPLIT_CASES = {
    "split_d16": (1, 4, 2, 130, 130, True, None, 16, 16),
    "split_d64": (1, 4, 2, 130, 130, True, None, 64, 64),
    "split_d128": (1, 2, 1, 130, 130, True, None, 128, 128),
    "split_d256": (1, 2, 1, 130, 130, True, None, 256, 256),
    "split_d192_dv128": (1, 2, 1, 130, 130, True, None, 192, 128),
    "kv_len": (1, 4, 2, 130, 130, True, 100, 32, 32),
    "full": (2, 4, 2, 70, 150, False, 140, 32, 32),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("policy", POLICIES)
def test_split_plain_matches_reference(case, policy):
    b, h, kvh, sq, skv, causal, kv_len, d, dv = SPLIT_CASES[case]
    plan = k3_plan(b, h, kvh, sq, skv, causal, d, dv, kv_len=kv_len)
    assert plan.splits > 1
    rng = np.random.default_rng(sq + d * 3 + dv + len(policy) + len(case))
    q, k, v = _draw(rng, policy, (b, h, sq, d), (b, kvh, skv, d),
                    (b, kvh, skv, dv))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=64, block_k=BLOCK_KV,
                    interpret=True, policy=policy, kv_len=kv_len)
    t = torch.from_numpy
    ours = flash_attention(t(q), t(k), t(v), causal=causal, policy=policy,
                           kv_len=kv_len)
    assert ours.shape == (b, h, sq, dv)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


def test_split_starts_from_the_max_before_it():
    """Under bf16x1, a split that started its running max afresh would
    round P at other places: the merged result then moves by more than the
    1e-5 the parity tests allow, which is why the splits start from the
    max before them.  Scores that fall along the kv axis make the afresh
    max differ."""
    rng = np.random.default_rng(5)
    b, h, sq, d = 1, 2, 192, 16
    q = (rng.integers(1, 9, (b, h, sq, d)) / 8.0).astype(np.float32)
    k = np.broadcast_to((np.arange(sq, 0, -1) / sq * 4)[None, None, :, None],
                        (b, h, sq, d))
    k = (np.round(k * 8) / 8).astype(np.float32)
    v = (rng.integers(-8, 9, (b, h, sq, d)) / 8.0).astype(np.float32)
    pol = get_policy("bf16x1")
    t = torch.from_numpy
    got = flash_attention_plain(t(q), t(k), t(v), pol)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, block_q=64, block_k=BLOCK_KV,
                    interpret=True, policy="bf16x1")
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    # The same splits, each from a fresh max, merged: the P of the later
    # splits is rounded elsewhere.
    kw = dot_params(pol)
    plan = k3_plan(b, h, h, sq, sq, True, d, d)
    assert plan.splits == 3
    parts = []
    for s in range(plan.splits):
        cols = slice(s * plan.per * BLOCK_KV, (s + 1) * plan.per * BLOCK_KV)
        kb, vb = t(k)[:, :, cols], t(v)[:, :, cols]
        sc = policy_dot(t(q), kb, "bhqd,bhkd->bhqk", **kw) / d ** 0.5
        c = torch.arange(sq)[cols][None]
        sc = torch.where(torch.arange(sq)[:, None] >= c, sc, NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(m > 0.5 * NEG_INF, torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      policy_dot(p, vb, "bhqk,bhkd->bhqd", **kw)))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.where(m > 0.5 * NEG_INF, torch.exp(m - big), 0.0)
         for m, _, _ in parts]
    afresh = sum(a * x for (_, _, a), x in zip(parts, w)) / \
        sum(l_ * x for (_, l_, _), x in zip(parts, w))
    assert float((afresh - got).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# D7: the rotary base without a host copy
# ---------------------------------------------------------------------------

def _rope_before(positions, head_dim, theta):
    """``rope_cos_sin`` as it was: the base as a tensor on the positions'
    device (on a card, a host-to-device copy)."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), expo)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang), freq


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_bitwise_as_before_and_within_an_ulp_of_reference(head_dim,
                                                                theta):
    pos = torch.arange(32768, dtype=torch.int64)[None]
    cos, sin = torch_base.rope_cos_sin(pos, head_dim, theta)
    cos0, sin0, freq0 = _rope_before(pos, head_dim, theta)
    assert torch.equal(cos, cos0) and torch.equal(sin, sin0)
    # freq itself: the new form's bits, and one ulp of the reference's.
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freq = torch.pow(float(theta), expo)
    assert torch.equal(freq, freq0)
    ref = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32)
                               / half), np.float32)
    ulps = np.abs(freq.numpy().view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # The reference's own rope at a small position holds to its angles.
    rc, rs = jax_rope(jnp.asarray(pos[:, :64].numpy()), head_dim, theta)
    np.testing.assert_allclose(_np(cos[:, :64]), np.asarray(rc, np.float64),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(sin[:, :64]), np.asarray(rs, np.float64),
                               rtol=0, atol=1e-6)


def test_rope_makes_no_tensor_from_a_python_number(monkeypatch):
    def forbidden(*_a, **_k):
        raise AssertionError("rope_cos_sin called torch.tensor")

    want = torch_base.rope_cos_sin(torch.arange(40)[None], 64, 1e6)
    monkeypatch.setattr(torch_base.torch, "tensor", forbidden)
    got = torch_base.rope_cos_sin(torch.arange(40)[None], 64, 1e6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: (name, b, h, kvh, sq, skv, causal, kv_len, d, dv): split and unsplit
#: plans at every head-dim bucket, d != dv, a head dim whose rows are not
#: 16-byte multiples in bf16 (element loads), kv_len masking, not causal.
CUDA_CASES = (
    ("split_d64", 1, 14, 2, 256, 256, True, None, 64, 64),
    ("unsplit_d64", 1, 14, 2, 1100, 1100, True, None, 64, 64),
    ("split_d32", 1, 6, 2, 200, 200, True, None, 32, 32),
    ("split_d128", 1, 6, 2, 200, 200, True, None, 128, 128),
    ("split_d256", 1, 6, 2, 200, 200, True, None, 256, 256),
    ("unsplit_d256", 3, 14, 2, 640, 640, True, None, 256, 256),
    ("d192_dv128", 1, 6, 2, 200, 200, True, None, 192, 128),
    ("d20_dv36", 2, 4, 2, 150, 150, True, None, 20, 36),
    ("kv_len", 2, 6, 3, 200, 200, True, 90, 64, 64),
    ("full", 2, 6, 3, 70, 330, False, 300, 64, 64),
    ("short", 1, 14, 2, 9, 9, True, None, 64, 64),
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k3_matches_plain(cuda_device, case, dtype):
    _, b, h, kvh, sq, skv, causal, kv_len, d, dv = case
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = k3_plan(b, h, kvh, sq, skv, causal, d, dv, sms, kv_len=kv_len)
    if case[0].startswith(("split", "unsplit")):
        assert (plan.splits > 1) == case[0].startswith("split")
    g = torch.Generator(device=cuda_device).manual_seed(sq + d + dv)
    dt = getattr(torch, dtype)
    normal = [torch.randn(s, generator=g, device=cuda_device)
              for s in ((b, h, sq, d), (b, kvh, skv, d), (b, kvh, skv, dv))]
    grid = [(torch.randint(-8, 9, x.shape, generator=g, device=cuda_device)
             / 8.0) for x in normal]
    for name in POLICIES:
        pol = get_policy(name)
        q, k, v = (x.to(dt) for x in (grid if name == "bf16x1" else normal))
        # The kernel's fp32 result (bf16x1 returns q's dtype: the cast of
        # it, bit for bit).
        got, launch = fa.launcher(q, k, v, pol, causal,
                                  skv if kv_len is None else kv_len)
        launch()
        plain = flash_attention_plain(q, k, v, pol, causal=causal,
                                      kv_len=kv_len)
        err = _max_norm(got, plain)
        assert err < 1e-5, f"{name}: max-norm error {err:.3e}"
        out = flash_attention(q, k, v, causal=causal, policy=pol,
                              kv_len=kv_len)
        want = got if pol.error_correction else got.to(q.dtype)
        assert out.dtype == want.dtype and torch.equal(out, want)


@pytest.mark.cuda
def test_cuda_k3_strided_views_and_zero_kv_len(cuda_device):
    """The model's layout (transposed views of (b, s, h, d)), a kv_len of
    0 (every row fully masked: exact zeros), and the same bits on two calls
    (the kernel's result is its own, equal to the wrapper's above)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(1, 256, 14, 64, generator=g, device=cuda_device)
    k = torch.randn(1, 256, 2, 64, generator=g, device=cuda_device)
    v = torch.randn(1, 256, 2, 64, generator=g, device=cuda_device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pol = get_policy("bf16x6")
    got = flash_attention(qt, kt, vt, policy=pol)
    want = flash_attention_plain(qt.contiguous(), kt.contiguous(),
                                 vt.contiguous(), pol)
    assert _max_norm(got, want) < 1e-5
    zero = flash_attention(qt, kt, vt, causal=False, policy=pol, kv_len=0)
    assert not zero.any()


@pytest.mark.cuda
def test_cuda_k3_launches_once_per_call(cuda_device):
    x = torch.randn(1, 14, 256, 64, device=cuda_device)
    kv = torch.randn(1, 2, 256, 64, device=cuda_device)
    before = fa.LAUNCHES.n
    flash_attention(x, kv, kv, policy="bf16x6")
    flash_attention_plain(x, kv, kv, get_policy("bf16x6"))
    assert fa.LAUNCHES.n == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_cuda_rope_bitwise_as_before(cuda_device, head_dim, theta):
    pos = torch.arange(32768, device=cuda_device)[None]
    cos, sin = torch_base.rope_cos_sin(pos, head_dim, theta)
    cos0, sin0, _ = _rope_before(pos, head_dim, theta)
    assert torch.equal(cos, cos0) and torch.equal(sin, sin0)
