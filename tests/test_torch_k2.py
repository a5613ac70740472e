"""K2, the serving path's TCEC matmul (``csrc/tcec_matmul_k2.cu``): its
plan (``k2_plan``), the passes it skips (``k2_passes``) and, on the card,
the kernel against its plain version.

The plan and the skipped passes are plain Python and torch, checked here on
the CPU; inputs come from numpy with a seed.  Tests marked ``cuda`` need a
card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels.tcec_core import policy_dot  # noqa: E402
from repro_torch.kernels.tcec_matmul import (  # noqa: E402
    K2_K_STEP, k2_passes, k2_plan, launcher, tcec_matmul_fused,
    tcec_matmul_plain)

H100_SMS = 132
#: qwen2-0.5b's dense layers as (k, n): the K2 calls of a serving tick.
SERVING = {"wq/wo": (896, 896), "wk/wv": (896, 128),
           "w_gate/w_up": (896, 4864), "w_down": (4864, 896)}


def _plans():
    ms = (1, 3, 4, 8, 16, 17, 64, 256, 288)
    ks = (0, 1, 15, 16, 17, 200, 896, 905, 4864)
    ns = (1, 100, 128, 4864)
    for m, k, n, batch, sms in itertools.product(ms, ks, ns, (1, 3),
                                                 (8, 132)):
        yield m, n, k, batch, sms


def test_k2_plan_covers_k_exactly_once_in_order():
    """Split s sums k in [s * chunk, min(k, (s + 1) * chunk)), as the
    kernel reads the plan."""
    for m, n, k, batch, sms in _plans():
        plan = k2_plan(m, n, k, batch, sms)
        assert plan == k2_plan(m, n, k, batch, sms)
        assert plan.tile == ("decode" if m <= 16 else "prefill")
        assert plan.chunk % K2_K_STEP == 0 and plan.chunk >= K2_K_STEP
        ranges = [(s * plan.chunk, min(k, (s + 1) * plan.chunk))
                  for s in range(plan.splits)]
        assert len(ranges) == plan.splits >= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2 and hi - lo == plan.chunk
        if k:
            assert all(hi > lo for lo, hi in ranges)
        tiles = -(-m // plan.bm) * -(-n // plan.bn) * batch
        assert plan.blocks == tiles * plan.splits


@pytest.mark.parametrize("layer", sorted(SERVING))
@pytest.mark.parametrize("m", [4, 64, 256])
def test_k2_plan_fills_the_card_at_serving_shapes(layer, m):
    """Every serving call launches two blocks per SM where k allows it (a
    split never goes below one k step of 16), and at least one per SM."""
    k, n = SERVING[layer]
    plan = k2_plan(m, n, k, 1, H100_SMS)
    tiles = -(-m // plan.bm) * -(-n // plan.bn)
    most = tiles * -(-k // K2_K_STEP)
    assert plan.blocks >= min(2 * H100_SMS, most)
    if m == 4:
        assert plan.tile == "decode" and plan.blocks >= H100_SMS


def test_k2_plan_splits_w_down_at_decode():
    plan = k2_plan(4, 896, 4864, 1, H100_SMS)
    assert (plan.tile, plan.bn, plan.splits, plan.chunk) == ("decode", 32,
                                                             11, 480)
    assert plan.blocks == 28 * 11


@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
def test_k2_passes_are_the_schedule_passes_with_nonzero_words(policy):
    pol = get_policy(policy)
    bf, f32 = torch.bfloat16, torch.float32
    assert k2_passes(pol, f32, f32) == tuple(pol.schedule)
    assert k2_passes(pol, bf, bf) == ((0, 0),)
    assert k2_passes(pol, f32, bf) == tuple(
        (i, j) for i, j in pol.schedule if j == 0)
    assert k2_passes(pol, bf, f32) == tuple(
        (i, j) for i, j in pol.schedule if i == 0)
    assert k2_passes(get_policy("bf16x6"), f32, bf) == ((2, 0), (1, 0),
                                                        (0, 0))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("dtypes", ["bf16,bf16", "fp32,bf16", "bf16,fp32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skipping_zero_word_passes_changes_no_bit(policy, dtypes, seed):
    """On bf16-exact operands, the plain ``policy_dot`` over K2's passes
    alone gives the same bits as over the full schedule: the skipped passes
    multiply words that are exactly 0.  Rows of exact zeros make sums that
    are exactly zero, whose sign is the one thing that may differ (the
    kernel's accumulator starts at +0 and never holds -0)."""
    pol = get_policy(policy)
    rng = np.random.default_rng(seed)
    m, k, n = 7, 48 + 16 * seed, 24
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    a[2] = -0.0
    a[5] = 0.0
    b[:, 3] = 0.0
    bf = torch.bfloat16
    a_dt, b_dt = (bf if d == "bf16" else torch.float32
                  for d in dtypes.split(","))
    if a_dt == bf:
        a = a.to(bf).float()
    if b_dt == bf:
        b = b.to(bf).float()
    full = policy_dot(a, b, n_words=pol.n_words, schedule=pol.schedule,
                      vpu=False)
    run = k2_passes(pol, a_dt, b_dt)
    assert len(run) < len(pol.schedule)
    skipped = policy_dot(a, b, n_words=pol.n_words, schedule=run, vpu=False)
    assert torch.equal(full, skipped)
    nonzero = full != 0
    assert torch.equal(_bits(full)[nonzero], _bits(skipped)[nonzero])
    assert bool((full[~nonzero] == 0).all())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _max_rel(x, ref) -> float:
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max())


#: (name, m, k, n, lhs dtype, bias, activation): phase 1's four layer
#: shapes at decode and prefill, and ragged shapes (m of 1, 3, 17; n not a
#: multiple of 8; k not a multiple of 16).
CUDA_CASES = [
    (f"{name}-m{m}", m, k, n, a_dt, bias, act)
    for m in (4, 256)
    for name, k, n, a_dt, bias, act in (
        ("wo", 896, 896, "float32", False, None),
        ("wk/wv", 896, 128, "bfloat16", True, None),
        ("w_gate", 896, 4864, "bfloat16", False, "silu"),
        ("w_down", 4864, 896, "bfloat16", False, None))
] + [("ragged-m1", 1, 200, 100, "bfloat16", True, "gelu"),
     ("ragged-m3", 3, 905, 131, "float32", False, "silu"),
     ("ragged-m17", 17, 72, 250, "bfloat16", True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_cuda_k2_matches_plain_and_repeats_its_bits(cuda_device, case,
                                                    policy):
    _, m, k, n, a_dt, has_bias, act = case
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(m * 7919 + k + n)
    x = torch.randn(m, k, generator=g, device=dev).to(getattr(torch, a_dt))
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16) \
        if has_bias else None
    pol = get_policy(policy)
    got = tcec_matmul_fused(x, w, pol, bias=bias, activation=act)
    again = tcec_matmul_fused(x, w, pol, bias=bias, activation=act)
    plain = tcec_matmul_plain(x, w, pol, bias=bias, activation=act)
    assert _max_rel(got, plain) < 1e-5
    assert torch.equal(_bits(got), _bits(again))
    _, _, launch = launcher(x, w, pol, bias=bias, activation=act)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert launch.plan == k2_plan(m, n, k, 1, sms)


# ---------------------------------------------------------------------------
# The frag= arm on the card
# ---------------------------------------------------------------------------

#: (name, lhs lead dims, m, rule, n, lhs dtype, bias, activation, residual,
#: out dtype): the prefill tile with 4 splits (the cumsum block), the decode
#: tile with k splits and the whole epilogue, a band with a residual, a 3-D
#: lhs whose k rows are not 16-byte multiples (element copies), and a rule
#: whose columns end inside a tile.
K2F_CASES = [
    ("cumsum-m4096", (), 4096, "upper", 256, "float32", False, None, False,
     None),
    ("identity-decode", (), 4, "identity", 896, "bfloat16", True, "silu",
     False, "bfloat16"),
    ("banded-residual", (), 288, "banded", 1000, "float32", False, None,
     True, None),
    ("lower-strict-3d", (3,), 37, "lower_strict", 45, "float32", True,
     "gelu", False, None),
    ("upper-strict-m17", (), 17, "upper_strict", 200, "bfloat16", False,
     "tanh", True, None),
]


def _menu_rule(kind: str, n: int):
    from repro_torch import tcec
    dev = "cuda"
    return {"upper": lambda: tcec.triangular(n, device=dev),
            "upper_strict": lambda: tcec.triangular(n, strict=True,
                                                    device=dev),
            "lower_strict": lambda: tcec.triangular(n, False, True,
                                                    device=dev),
            "identity": lambda: tcec.identity(n, device=dev),
            "banded": lambda: tcec.banded(n, 3, 1, device=dev)}[kind]()


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    return x.dtype == y.dtype and torch.equal(x.contiguous().view(view),
                                              y.contiguous().view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("case", K2F_CASES, ids=[c[0] for c in K2F_CASES])
def test_cuda_frag_arm_is_k2_on_the_built_rule(cuda_device, case, policy):
    """The arm gives K2's bits on the rule built as a bf16 (k, n) tensor
    (same plan, same passes, same order), is within 1e-5 (max-norm) of its
    plain version (a bf16 store: the cast of its own fp32 result), and
    moves only its own counter."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    _, lead, m, kind, n, a_dt, has_bias, act, has_res, out_dt = case
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(m * 31 + n)
    x = torch.randn(*lead, m, n, generator=g, device=dev).to(
        getattr(torch, a_dt))
    kw = dict(
        bias=torch.randn(n, generator=g, device=dev) if has_bias else None,
        residual=torch.randn(*lead, m, n, generator=g, device=dev)
        if has_res else None,
        activation=act,
        out_dtype=None if out_dt is None else getattr(torch, out_dt))
    op = _menu_rule(kind, n)
    pol = get_policy(policy)
    reset_launch_counts()
    got = tcec_matmul_fused(x, None, pol, frag=op, **kw)
    counts = launch_counts()
    assert counts["tcec_matmul_frag"] == 1 and counts["tcec_matmul"] == 0
    k2 = tcec_matmul_fused(x, op.build().to(torch.bfloat16), pol, **kw)
    assert _same_bits(got, k2)
    kw32 = dict(kw, out_dtype=None)
    got32 = tcec_matmul_fused(x, None, pol, frag=op, **kw32)
    assert _max_rel(got32, tcec_matmul_plain(x, None, pol, frag=op,
                                             **kw32)) < 1e-5
    assert _same_bits(got, got32.to(got.dtype))
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6"])
def test_cuda_frag_arm_nonfinite_lhs(cuda_device, policy):
    """±inf and NaN in the lhs give the plain version's pattern, and K2's
    bits on the built rule (the fix-up takes the rule's values)."""
    dev = cuda_device
    x = torch.randn(64, 256, generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
    x[1, 3], x[4, 255], x[7, 0], x[9, 100] = (float("inf"), float("-inf"),
                                              float("nan"), float("inf"))
    op = _menu_rule("upper", 256)
    pol = get_policy(policy)
    got = tcec_matmul_fused(x, None, pol, frag=op, activation="tanh")
    plain = tcec_matmul_plain(x, None, pol, frag=op, activation="tanh")
    assert not bool(torch.isfinite(plain).all())
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.equal(torch.isinf(got), torch.isinf(plain))
    fin = torch.isfinite(plain)
    assert torch.equal(got[torch.isinf(got)], plain[torch.isinf(plain)])
    assert float((got[fin] - plain[fin]).abs().max()) < 1e-4
    k2 = tcec_matmul_fused(x, op.build().to(torch.bfloat16), pol,
                           activation="tanh")
    assert _same_bits(got, k2)


@pytest.mark.cuda
def test_cuda_frag_arm_raises_off_the_menu_and_einsum_never_builds(
        cuda_device, monkeypatch):
    from repro_torch import tcec
    from repro_torch.tcec.operands import FragmentOperand
    x = torch.randn(8, 64, device=cuda_device)
    off = FragmentOperand(lambda i, j: (i == j).to(torch.float32), (64, 64))
    with pytest.raises(NotImplementedError, match="off the kernel's menu"):
        tcec_matmul_fused(x, None, "bf16x6", frag=off)
    built = []
    orig = FragmentOperand.build
    monkeypatch.setattr(FragmentOperand, "build",
                        lambda self: (built.append(self), orig(self))[1])
    with tcec.trace_plans() as log:
        y = tcec.einsum("mk,kn->mn", x, tcec.triangular(64),
                        policy="bf16x6_pallas")
        y_off = tcec.einsum("mk,kn->mn", x, off, policy="bf16x6_pallas")
    assert [r.backend for r in log] == ["pallas_fragment", "xla"]
    assert built == [off]
    assert _max_rel(y, torch.cumsum(x, dim=-1)) < 2e-6
    assert _max_rel(y_off, x) < 2e-6
