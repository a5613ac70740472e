"""K5 (``tcec_matmul_staged``), the paper's staged WMMA-API baseline, as
redesigned for Hopper: its plain version against the JAX package's
``tcec_matmul_staged`` at an unaligned shape and a batched lhs against a
shared rhs, its H100 footprint (one slot of every word tile), the reference
specs' footprints, and the policies it refuses.

On this CPU host the wrapper runs its plain PyTorch version; the
reference's kernel runs in interpret mode, as its own tests run it.  Inputs
are made with numpy from a seed and fed to both.  Tests marked ``cuda``
hold the kernel against K2b and K6 bit for bit, its launch counter and its
local memory, and need a card.
"""
import re
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import roofline as jroof  # noqa: E402
from repro.kernels import tcec_matmul as jkm  # noqa: E402

from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import tcec_matmul as km  # noqa: E402

#: name -> (lhs shape, rhs shape): k and n not multiples of 8 (the host pads
#: the word rows), and a batched lhs against one shared rhs.
CASES = {"unaligned": ((3, 37, 45), (45, 29)),
         "shared_rhs": ((4, 40, 48), (48, 24))}
POLICIES = ["bf16x1", "bf16x3", "bf16x6"]
#: Blocks for the reference that divide none of the dims above.
JAX_BLOCK = (8, 128, 128)
#: Words per operand under each pass count the kernels are built for.
WORDS = {1: 1, 3: 2, 6: 3}


def _inputs(case, policy):
    """Operands of ``case``; under bf16x1 on a 1/8 grid, like the other
    kernels' bf16x1 parity inputs (every product and sum exact in fp32)."""
    rng = np.random.default_rng(zlib.crc32(f"k5/{case}/{policy}".encode()))
    sa, sb = CASES[case]
    if policy == "bf16x1":
        return [(rng.integers(-8, 9, s) / 8.0).astype(np.float32)
                for s in (sa, sb)]
    return [rng.standard_normal(s).astype(np.float32) for s in (sa, sb)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", POLICIES)
def test_k5_plain_matches_reference_staged(case, policy):
    a, b = _inputs(case, policy)
    ref = jkm.tcec_matmul_staged(jnp.asarray(a), jnp.asarray(b), policy,
                                 JAX_BLOCK, interpret=True)
    ours = km.tcec_matmul_staged(torch.from_numpy(a), torch.from_numpy(b),
                                 policy)
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(ours.double().numpy(),
                               np.asarray(ref, np.float64), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Footprints
# ---------------------------------------------------------------------------

def _staged_source_constant(name: str) -> int:
    text = (_build.CSRC / "tcec_staged.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_word_pad_is_the_kernels():
    assert roofline.CUDA_WORD_PAD == _staged_source_constant("WPAD") == 8


@pytest.mark.parametrize("words", sorted(WORDS.values()))
def test_h100_staged_footprint_is_one_slot_of_every_word_tile(words):
    """K5 holds one slot: n_words A word tiles [bm][bk + 8] and n_words B
    word tiles [bk][bn + 8] of 2-byte words; K6 two such slots."""
    fp = roofline.matmul_tile_footprint
    for bm, bn, bk in _build.TILES:
        slot = words * 2 * (bm * (bk + 8) + bk * (bn + 8))
        assert fp(bm, bn, bk, words, "staged") == slot
        assert fp(bm, bn, bk, words, "staged_db") == 2 * slot
        assert fp(bm, bn, bk, words, "staged") <= 227 * 1024
    assert fp(128, 128, 32, 3, "staged") == 56832


@pytest.mark.parametrize("name", ["tpu-v5e", "a100-sxm4", "v100-sxm2"])
def test_reference_spec_footprints_unchanged(name):
    chip = roofline.CHIPS[name]
    for words in sorted(WORDS.values()):
        for variant in roofline.MATMUL_VARIANTS:
            for blk in ((8, 128, 128), (64, 64, 32), (128, 256, 512)):
                assert roofline.matmul_tile_footprint(
                    *blk, words, variant, chip) == \
                    jroof.matmul_tile_footprint(*blk, words, variant)


@pytest.mark.parametrize("policy", ["fp32_vpu", "int8x2"])
def test_k5_rejects_vpu_and_int8(policy):
    a = np.ones((8, 16), np.float32)
    with pytest.raises(ValueError):
        jkm.tcec_matmul_staged(jnp.asarray(a), jnp.asarray(a.T), policy,
                               interpret=True)
    with pytest.raises(ValueError):
        km.tcec_matmul_staged(torch.from_numpy(a),
                              torch.from_numpy(a.T.copy()), policy)
    with pytest.raises(ValueError):
        km.tcec_matmul_staged_plain(torch.from_numpy(a),
                                    torch.from_numpy(a.T.copy()),
                                    get_policy(policy))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(dev, lhs, rhs):
    g = torch.Generator(device=dev).manual_seed(1)
    return [torch.randn(s, generator=g, device=dev) for s in (lhs, rhs)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shapes", [CASES["unaligned"], CASES["shared_rhs"],
                                    ((2, 130, 200), (2, 200, 72))])
def test_cuda_k5_bitwise_k2b_and_k6_at_every_tile(cuda_device, policy,
                                                  shapes):
    a, b = _card_inputs(cuda_device, *shapes)
    base = km.tcec_matmul_pallas(a, b, policy)
    for tile in _build.TILES:
        k5 = km.tcec_matmul_staged(a, b, policy, tile)
        assert torch.equal(k5, base), tile
        assert torch.equal(km.tcec_matmul_staged_db(a, b, policy, tile), k5)
    torch.testing.assert_close(base, km.tcec_matmul_staged_plain(
        a, b, get_policy(policy)), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_k5_counter_moves_once_per_call(cuda_device):
    a, b = _card_inputs(cuda_device, (3, 64, 96), (96, 40))
    reset_launch_counts()
    for n in (1, 2, 3):
        km.tcec_matmul_staged(a, b, "bf16x6")
        counts = launch_counts()
        assert counts["tcec_matmul_staged"] == n
        assert counts["tcec_matmul_staged_db"] == 0
        assert counts["tcec_matmul_pallas"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("passes", sorted(WORDS))
def test_cuda_k5_allocates_its_footprint_and_does_not_spill(cuda_device,
                                                            passes):
    policy = {1: "bf16x1", 3: "bf16x3", 6: "bf16x6"}[passes]
    for tile in _build.TILES:
        got = km.kernel_attrs("staged", tile, policy)
        assert got["smem_bytes"] == roofline.matmul_tile_footprint(
            *tile, WORDS[passes], "staged")
        assert got["threads"] == _build.tile_threads(*tile[:2], "staged")
        assert got["local_bytes"] == 0, (tile, got)
        assert got["blocks_per_sm"] >= 1
        db = km.kernel_attrs("staged_db", tile, policy)
        assert db["smem_bytes"] == roofline.matmul_tile_footprint(
            *tile, WORDS[passes], "staged_db")
