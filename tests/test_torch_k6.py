"""K6 (``tcec_matmul_staged_db``), the paper's double-buffered staged
baseline, as redesigned for Hopper: its plain version against the JAX
package's ``tcec_matmul_staged_db`` at an unaligned shape and a batched lhs
against a shared rhs.  (Its footprint and refused policies are held in
``test_torch_k5.py``, ``test_torch_tune.py`` and ``test_torch_staged.py``.)

On this CPU host the wrapper runs its plain PyTorch version; the
reference's kernel runs in interpret mode, as its own tests run it.  Inputs
are made with numpy from a seed and fed to both.  Tests marked ``cuda``
hold the kernel against K2b and K5 bit for bit, its launch counter, its
shared memory and its local memory, and need a card.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import tcec_matmul as jkm  # noqa: E402

from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import tcec_matmul as km  # noqa: E402

#: name -> (lhs shape, rhs shape): K5's cases (k and n not multiples of 8,
#: so the host pads the word rows; a batched lhs against one shared rhs).
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
    rng = np.random.default_rng(zlib.crc32(f"k6/{case}/{policy}".encode()))
    sa, sb = CASES[case]
    if policy == "bf16x1":
        return [(rng.integers(-8, 9, s) / 8.0).astype(np.float32)
                for s in (sa, sb)]
    return [rng.standard_normal(s).astype(np.float32) for s in (sa, sb)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", POLICIES)
def test_k6_plain_matches_reference_staged_db(case, policy):
    a, b = _inputs(case, policy)
    ref = jkm.tcec_matmul_staged_db(jnp.asarray(a), jnp.asarray(b), policy,
                                    JAX_BLOCK, interpret=True)
    ours = km.tcec_matmul_staged_db(torch.from_numpy(a), torch.from_numpy(b),
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


def _card_inputs(dev, lhs, rhs):
    g = torch.Generator(device=dev).manual_seed(2)
    return [torch.randn(s, generator=g, device=dev) for s in (lhs, rhs)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shapes", [CASES["unaligned"], CASES["shared_rhs"],
                                    ((2, 130, 200), (2, 200, 72)),
                                    ((96, 1000), (1000, 136))])
def test_cuda_k6_bitwise_k2b_and_k5_at_every_tile(cuda_device, policy,
                                                  shapes):
    a, b = _card_inputs(cuda_device, *shapes)
    base = km.tcec_matmul_pallas(a, b, policy)
    for tile in _build.TILES:
        k6 = km.tcec_matmul_staged_db(a, b, policy, tile)
        assert torch.equal(k6, base), tile
        assert torch.equal(km.tcec_matmul_staged(a, b, policy, tile), k6)
    # Within 1e-5 of the plain version in the max-norm, the port's bound for
    # kernel against plain (the plain version sums k in another order).
    plain = km.tcec_matmul_staged_plain(a, b, get_policy(policy)).double()
    err = (k6.double() - plain).abs().max() / plain.abs().max()
    assert float(err) < 1e-5


@pytest.mark.cuda
def test_cuda_k6_counter_moves_once_per_call(cuda_device):
    a, b = _card_inputs(cuda_device, (3, 64, 96), (96, 40))
    reset_launch_counts()
    for n in (1, 2, 3):
        km.tcec_matmul_staged_db(a, b, "bf16x6")
        counts = launch_counts()
        assert counts["tcec_matmul_staged_db"] == n
        assert counts["tcec_matmul_staged"] == 0
        assert counts["tcec_matmul_pallas"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("passes", sorted(WORDS))
def test_cuda_k6_allocates_two_slots_and_does_not_spill(cuda_device, passes):
    policy = {1: "bf16x1", 3: "bf16x3", 6: "bf16x6"}[passes]
    for tile in _build.TILES:
        got = km.kernel_attrs("staged_db", tile, policy)
        assert got["smem_bytes"] == roofline.matmul_tile_footprint(
            *tile, WORDS[passes], "staged_db")
        assert got["threads"] == _build.tile_threads(*tile[:2], "staged_db")
        assert got["local_bytes"] == 0, (tile, got)
        assert got["blocks_per_sm"] >= 1
