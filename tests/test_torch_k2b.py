"""K2b (``tcec_matmul_pallas``) as redesigned for Hopper: its plan
(``k2b_plan``: persistent grid, copy widths), its warp tiles and shared
memory, the tuner's per-process plans, and its plain version against the
JAX package's ``tcec_matmul_pallas`` at an unaligned shape and a batched
lhs against a shared rhs.

On this CPU host the wrapper runs its plain PyTorch version; the
reference's kernel runs in interpret mode, as its own tests run it.  Inputs
are made with numpy from a seed and fed to both.  Tests marked ``cuda``
hold the kernel against K5 and K6 bit for bit and need a card.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import tcec_matmul as jkm  # noqa: E402

from repro_torch import tune  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import tcec_matmul as km  # noqa: E402
from repro_torch.tune import model as tune_model  # noqa: E402

#: name -> (lhs shape, rhs shape): k and n not multiples of 4 (every row of
#: A and B after the first off a 16-byte boundary: 4-byte copies), and a
#: batched lhs against one shared rhs.
CASES = {"unaligned": ((3, 37, 45), (45, 29)),
         "shared_rhs": ((4, 40, 48), (48, 24))}
POLICIES = ["bf16x1", "bf16x3", "bf16x6", "fp32_vpu"]
#: Blocks for the reference that divide none of the dims above.
JAX_BLOCK = (8, 128, 128)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def test_plan_one_block_per_tile_up_to_the_card():
    # b8_s32 at the 32 x 32 tile: 8 output tiles, one k tile each; the card
    # holds more blocks than that, so each block takes one tile.
    p = km.k2b_plan(32, 32, 32, 8, (32, 32, 32), resident=4)
    assert (p.items, p.steps, p.grid, p.per_block) == (8, 1, 8, 1)
    assert (p.vec_a, p.vec_b, p.vec) == (True, True, 3)
    # b256_s128 at 128 x 128: 256 tiles of 4 k tiles on 132 resident
    # blocks (one per SM): blocks take 2 tiles at most.
    p = km.k2b_plan(128, 128, 128, 256, (128, 128, 32), resident=1)
    assert (p.items, p.steps, p.grid, p.per_block) == (256, 4, 132, 2)
    # 4096^3 at 128 x 128: 1024 tiles of 128 k tiles, 8 tiles at most each.
    p = km.k2b_plan(4096, 4096, 4096, 1, (128, 128, 32), resident=1)
    assert (p.items, p.steps, p.grid, p.per_block) == (1024, 128, 132, 8)
    # w_gate at 64 x 64 on a card that holds 3 blocks per SM: 304 tiles fit.
    p = km.k2b_plan(256, 4864, 896, 1, (64, 64, 32), resident=3)
    assert (p.items, p.steps, p.grid, p.per_block) == (304, 28, 304, 1)
    # Another card: the grid follows its SM count.
    p = km.k2b_plan(4096, 4096, 4096, 1, (128, 128, 32), resident=2, sms=10)
    assert (p.grid, p.per_block) == (20, 52)


def test_plan_ragged_tiles_and_empty_k():
    p = km.k2b_plan(37, 29, 45, 3, (32, 32, 32), resident=4)
    assert (p.items, p.steps) == (3 * 2 * 1, 2)
    # k = 0: one k tile of zeros, so the outputs are written (as zeros).
    assert km.k2b_plan(8, 8, 0, 1, (32, 32, 32), resident=4).steps == 1


@pytest.mark.parametrize("k, n, a_ptr, b_ptr, vec_a, vec_b", [
    (64, 64, 0, 0, True, True),
    (45, 29, 0, 0, False, False),       # the unaligned case
    (44, 29, 0, 0, True, False),        # rows of A whole chunks, B's not
    (45, 28, 0, 0, False, True),
    (64, 64, 8, 0, False, True),        # A's base off 16 bytes
    (64, 64, 1024, 4, True, False),     # B's base off 16 bytes
])
def test_plan_copy_width_from_shape_and_alignment(k, n, a_ptr, b_ptr,
                                                  vec_a, vec_b):
    p = km.k2b_plan(16, n, k, 2, (32, 32, 32), resident=4, a_ptr=a_ptr,
                    b_ptr=b_ptr)
    assert (p.vec_a, p.vec_b) == (vec_a, vec_b)
    assert p.vec == int(vec_a) | int(vec_b) << 1


def test_plan_counts_tiles_in_32_bits():
    with pytest.raises(ValueError, match="32 bits"):
        km.k2b_plan(1 << 16, 1 << 16, 32, 1 << 10, (32, 32, 32), resident=1)


# ---------------------------------------------------------------------------
# Warp tiles and shared memory
# ---------------------------------------------------------------------------

def test_warp_tiles_cover_the_menu():
    assert set(_build.K2B_WARP_TILES) == {t[:2] for t in _build.TILES}
    for (bm, bn), (wm, wn) in _build.K2B_WARP_TILES.items():
        assert bm % wm == 0 and bn % wn == 0
        assert wm % 16 == 0 and wn % 16 == 0     # m16 tiles, n8 pairs
        threads = _build.tile_threads(bm, bn, "fused")
        assert threads == (bm // wm) * (bn // wn) * 32
        assert _build.tile_threads(bm, bn, "vpu") == threads
        # Every thread copies whole 16-byte chunks of both tiles.
        assert (bm * 32 // 4) % threads == 0 and (32 * bn // 4) % threads == 0
    # K5/K6 keep one warp per 32 x 32 outputs.
    assert _build.tile_threads(128, 128) == 512
    assert _build.tile_threads(128, 128, "fused") == 256
    assert _build.tile_threads(32, 32, "fused") == 128


def test_footprint_is_two_slots_of_padded_fp32_tiles():
    fp = roofline.matmul_tile_footprint
    for bm, bn, bk in _build.TILES:
        slot = 4 * (bm * (bk + 8) + bk * (bn + 4))
        assert fp(bm, bn, bk, 3, "fused") == 2 * slot
        # The same for any number of words: no word is staged.
        assert fp(bm, bn, bk, 1, "fused") == fp(bm, bn, bk, 3, "vpu")
    assert fp(32, 32, 32, 3, "fused") == 19456


# ---------------------------------------------------------------------------
# The tuner's plans are kept per process
# ---------------------------------------------------------------------------

def test_second_call_with_the_same_key_scores_no_candidate(monkeypatch,
                                                           tmp_path):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("REPRO_CHIP", raising=False)
    calls = []
    score = tune_model.score_matmul

    def counting(*args, **kw):
        calls.append(args)
        return score(*args, **kw)

    monkeypatch.setattr(tune_model, "score_matmul", counting)
    tune.clear_plan_cache()
    try:
        with tune.tune_mode("analytic"):
            kw = dict(policy="bf16x6", batch=256, site="auto")
            p1 = tune.matmul_plan(128, 128, 128, **kw)
            first = len(calls)
            assert first == len(tune.matmul_candidates(
                128, 128, 128, get_policy("bf16x6")))
            p2 = tune.matmul_plan(128, 128, 128, **kw)
            assert len(calls) == first and p2 == p1
            # Another key scores its own candidates.
            tune.matmul_plan(64, 64, 64, **kw)
            assert len(calls) == 2 * first
            # A cleared cache scores again, to the same plan.
            tune.clear_plan_cache()
            assert tune.matmul_plan(128, 128, 128, **kw) == p1
            assert len(calls) == 3 * first
        # Off returns None without scoring.
        with tune.tune_mode("off"):
            assert tune.matmul_plan(128, 128, 128, **kw) is None
        assert len(calls) == 3 * first
    finally:
        tune.clear_plan_cache()


def test_plans_follow_the_chip_spec(monkeypatch):
    """A plan kept for one chip spec is not the plan of another."""
    tune.clear_plan_cache()
    try:
        with tune.tune_mode("analytic"):
            monkeypatch.delenv("REPRO_CHIP", raising=False)
            h100 = tune.matmul_plan(512, 512, 512, policy="bf16x6")
            monkeypatch.setenv("REPRO_CHIP", "tpu-v5e")
            tpu = tune.matmul_plan(512, 512, 512, policy="bf16x6")
        assert h100.block in _build.TILES
        assert tpu.block not in _build.TILES
    finally:
        tune.clear_plan_cache()


def test_auto_keeps_its_plan_and_its_result(monkeypatch):
    """tcec_matmul_auto's second call scores nothing and gives the same
    bits."""
    calls = []
    score = tune_model.score_matmul
    monkeypatch.setattr(tune_model, "score_matmul",
                        lambda *a, **k: calls.append(a) or score(*a, **k))
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((3, 16, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    tune.clear_plan_cache()
    try:
        with tune.tune_mode("analytic"):
            first = km.tcec_matmul_auto(a, b, "bf16x6")
            n = len(calls)
            assert n > 0
            second = km.tcec_matmul_auto(a, b, "bf16x6")
        assert len(calls) == n and torch.equal(first, second)
    finally:
        tune.clear_plan_cache()


# ---------------------------------------------------------------------------
# The plain version against the reference
# ---------------------------------------------------------------------------

def _inputs(case, policy):
    """Operands of ``case``; under bf16x1 on a 1/8 grid, like the other
    kernels' bf16x1 parity inputs (every product and sum exact in fp32)."""
    rng = np.random.default_rng(zlib.crc32(f"k2b/{case}/{policy}".encode()))
    sa, sb = CASES[case]
    if policy == "bf16x1":
        return [(rng.integers(-8, 9, s) / 8.0).astype(np.float32)
                for s in (sa, sb)]
    return [rng.standard_normal(s).astype(np.float32) for s in (sa, sb)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_matches_pallas(case, policy):
    """1e-5 (relative and absolute): the plain version sums over the whole
    k at once, the reference per k block; only fp32 summation order
    differs."""
    a, b = _inputs(case, policy)
    ref = jkm.tcec_matmul_pallas(jnp.asarray(a), jnp.asarray(b), policy,
                                 JAX_BLOCK, interpret=True)
    ours = km.tcec_matmul_pallas(torch.from_numpy(a), torch.from_numpy(b),
                                 policy)
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(ours.double().numpy(),
                               np.asarray(ref, np.float64), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
def test_cuda_k2b_k5_k6_bitwise(cuda_device, case, policy):
    a, b = (torch.from_numpy(x).to(cuda_device) for x in _inputs(case,
                                                                   policy))
    base = km.tcec_matmul_pallas(a, b, policy)
    for tile in _build.TILES:
        assert torch.equal(km.tcec_matmul_pallas(a, b, policy, tile), base)
        assert torch.equal(km.tcec_matmul_staged(a, b, policy, tile), base)
        assert torch.equal(km.tcec_matmul_staged_db(a, b, policy, tile),
                           base)
    plain = km.tcec_matmul_plain(a, b, get_policy(policy))
    torch.testing.assert_close(base, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_unaligned_bases_take_4_byte_copies(cuda_device, policy):
    """Operands that start 4 bytes off a 16-byte boundary (views into a
    larger tensor) take the 4-byte copies and give the aligned call's
    bits."""
    a, b = (torch.from_numpy(x).to(cuda_device)
            for x in _inputs("shared_rhs", policy))
    a_off = torch.empty(a.numel() + 1, device=cuda_device)[1:].view(a.shape)
    b_off = torch.empty(b.numel() + 1, device=cuda_device)[1:].view(b.shape)
    a_off.copy_(a)
    b_off.copy_(b)
    pol = get_policy(policy)
    _, _, launch = km.pallas_launcher(a_off, b_off, pol)
    assert (launch.plan.vec_a, launch.plan.vec_b) == (False, False)
    for tile in _build.TILES:
        assert torch.equal(km.tcec_matmul_pallas(a_off, b_off, pol, tile),
                           km.tcec_matmul_pallas(a, b, pol, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("shapes", [((3, 37, 45), (45, 29)),
                                    ((2, 64, 64), (64, 48))])
def test_cuda_values_beyond_bf16_max_take_k1s_saturated_words(
        cuda_device, policy, shapes):
    """Finite values beyond ±BF16_MAX (word 0 clamped: the rare path the
    guard's pass over the staged tile signals, through 4- and 16-byte
    copies) give the bits of K5 and K6, whose words the host splits with
    K1's saturating rule, and the plain version's values (1e-5)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(shapes[0]).astype(np.float32)
    b = (rng.standard_normal(shapes[1]) * 1e-3).astype(np.float32)
    a[1, 5, 7], a[0, 30, 44 % shapes[0][2]] = 3.4e38, -3.39e38
    a, b = torch.from_numpy(a).to(cuda_device), \
        torch.from_numpy(b).to(cuda_device)
    base = km.tcec_matmul_pallas(a, b, policy)
    assert bool(torch.isfinite(base).all())
    for tile in _build.TILES:
        assert torch.equal(km.tcec_matmul_pallas(a, b, policy, tile), base)
        assert torch.equal(km.tcec_matmul_staged(a, b, policy, tile), base)
        assert torch.equal(km.tcec_matmul_staged_db(a, b, policy, tile),
                           base)
    torch.testing.assert_close(
        base, km.tcec_matmul_plain(a, b, get_policy(policy)), rtol=1e-5,
        atol=1e-5)
