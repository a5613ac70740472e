"""The port's K2b, K5 and K6 (``tcec_matmul_pallas``, ``tcec_matmul_staged``,
``tcec_matmul_staged_db``) against the JAX package's Pallas kernels.

On this CPU host the port's wrappers run their plain PyTorch versions; the
reference's kernels run in interpret mode, as its own tests run them.
Inputs are made with numpy from a seed and fed to both.  Tests marked
``cuda`` hold the CUDA kernels against their plain versions and against
each other, and need a card.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import tcec_matmul as jkm  # noqa: E402

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import tcec_matmul as km  # noqa: E402

CASES = {
    # name: (lhs shape, rhs shape)
    "ragged": ((40, 72), (72, 136)),
    "batched": ((2, 24, 40), (2, 40, 56)),
    "broadcast_rhs": ((3, 16, 48), (48, 24)),
}
#: Blocks for the reference that divide none of the dims above.
JAX_BLOCK = (8, 128, 128)
STAGED = {"staged": (km.tcec_matmul_staged, jkm.tcec_matmul_staged),
          "staged_db": (km.tcec_matmul_staged_db, jkm.tcec_matmul_staged_db)}


def _inputs(case, policy):
    """Operands of ``case``; under bf16x1 on a 1/8 grid, like the other
    kernels' bf16x1 parity inputs (every product and sum exact in fp32)."""
    rng = np.random.default_rng(zlib.crc32(f"{case}/{policy}".encode()))
    sa, sb = CASES[case]
    if policy == "bf16x1":
        return [(rng.integers(-8, 9, s) / 8.0).astype(np.float32)
                for s in (sa, sb)]
    return [rng.standard_normal(s).astype(np.float32) for s in (sa, sb)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def _check(ours, ref):
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6",
                                    "fp32_vpu"])
def test_k2b_plain_matches_pallas(case, policy):
    a, b = _inputs(case, policy)
    ref = jkm.tcec_matmul_pallas(jnp.asarray(a), jnp.asarray(b), policy,
                                 JAX_BLOCK, interpret=True)
    _check(km.tcec_matmul_pallas(torch.from_numpy(a), torch.from_numpy(b),
                                 policy), ref)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("variant", sorted(STAGED))
def test_staged_plain_matches_pallas(case, policy, variant):
    ours_fn, ref_fn = STAGED[variant]
    a, b = _inputs(case, policy)
    ref = ref_fn(jnp.asarray(a), jnp.asarray(b), policy, JAX_BLOCK,
                 interpret=True)
    _check(ours_fn(torch.from_numpy(a), torch.from_numpy(b), policy), ref)


@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
def test_k2b_k5_k6_plain_bitwise_equal(policy):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((3, 33, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, 45)).astype(np.float32))
    k2b = km.tcec_matmul_pallas(a, b, policy)
    assert torch.equal(k2b, km.tcec_matmul_staged(a, b, policy))
    assert torch.equal(k2b, km.tcec_matmul_staged_db(a, b, policy))


@pytest.mark.parametrize("variant", sorted(STAGED))
@pytest.mark.parametrize("policy", ["fp32_vpu", "int8x2"])
def test_staged_rejects_vpu_and_int8(variant, policy):
    ours_fn, ref_fn = STAGED[variant]
    a = np.ones((8, 16), np.float32)
    with pytest.raises(ValueError):
        ref_fn(jnp.asarray(a), jnp.asarray(a.T), policy, interpret=True)
    with pytest.raises(ValueError):
        ours_fn(torch.from_numpy(a), torch.from_numpy(a.T.copy()), policy)


@pytest.mark.parametrize("policy", ["bf16x1", "bf16x6", "fp32_vpu"])
def test_nonfinite_pattern_matches_reference(policy):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((12, 40)).astype(np.float32)
    b = rng.standard_normal((40, 20)).astype(np.float32)
    a[2, 5], a[7, 0], b[3, 9] = np.inf, np.nan, -np.inf
    ref = jkm.tcec_matmul_pallas(jnp.asarray(a), jnp.asarray(b), policy,
                                 interpret=True)
    t = torch.from_numpy
    outs = [km.tcec_matmul_pallas(t(a), t(b), policy)]
    if policy != "fp32_vpu":
        outs += [fn(t(a), t(b), policy) for fn, _ in STAGED.values()]
    for ours in outs:
        np.testing.assert_array_equal(np.isnan(_np(ours)),
                                      np.isnan(_np(ref)))
        np.testing.assert_array_equal(_np(ours)[~np.isfinite(_np(ref))],
                                      _np(ref)[~np.isfinite(_np(ref))])
        fin = np.isfinite(_np(ref))
        np.testing.assert_allclose(_np(ours)[fin], _np(ref)[fin],
                                   rtol=1e-5, atol=1e-5)


def test_cpu_tile_is_not_validated_but_cuda_menu_is_the_build_menu():
    """The plain versions have no tile; the CUDA wrappers take the compiled
    menu only (checked before anything is built)."""
    a = torch.ones(4, 8)
    km.tcec_matmul_pallas(a, a.T.contiguous(), "bf16x3", (8, 128, 128))
    assert _build.DEFAULT_TILE in _build.TILES
    with pytest.raises(ValueError):
        km._tile((8, 128, 128), "test")
    assert km._tile(None, "test") == _build.DEFAULT_TILE


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_inputs(dev, lhs, rhs, grid=False):
    g = torch.Generator(device=dev).manual_seed(0)
    if grid:
        return [(torch.randint(-8, 9, s, generator=g, device=dev) / 8.0)
                for s in (lhs, rhs)]
    return [torch.randn(s, generator=g, device=dev) for s in (lhs, rhs)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6",
                                    "fp32_vpu"])
@pytest.mark.parametrize("shapes", [((37, 200), (200, 150)),
                                    ((3, 40, 72), (72, 136)),
                                    ((4, 64, 100), (4, 100, 50))])
def test_cuda_k2b_k5_k6_match_plain(cuda_device, policy, shapes):
    a, b = _card_inputs(cuda_device, *shapes, grid=policy == "bf16x1")
    pol = get_policy(policy)
    plain = km.tcec_matmul_plain(a, b, pol)
    fns = [km.tcec_matmul_pallas]
    if policy != "fp32_vpu":
        fns += [km.tcec_matmul_staged, km.tcec_matmul_staged_db]
    for fn in fns:
        torch.testing.assert_close(fn(a, b, pol), plain, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6",
                                    "fp32_vpu"])
def test_cuda_bitwise_across_variants_and_tiles(cuda_device, policy):
    a, b = _card_inputs(cuda_device, (2, 70, 130), (130, 90))
    base = km.tcec_matmul_pallas(a, b, policy)
    for tile in _build.TILES:
        assert torch.equal(km.tcec_matmul_pallas(a, b, policy, tile), base)
        if policy != "fp32_vpu":
            assert torch.equal(km.tcec_matmul_staged(a, b, policy, tile),
                               base)
            assert torch.equal(km.tcec_matmul_staged_db(a, b, policy, tile),
                               base)
