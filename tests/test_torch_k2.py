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
