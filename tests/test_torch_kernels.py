"""The port's kernels (K1-K4) against the JAX package's Pallas kernels.

On this CPU host the port's wrappers run their plain PyTorch versions; the
reference's Pallas kernels run in interpret mode, as its own tests run them.
Inputs are made with numpy from a seed and fed to both.  Tests marked
``cuda`` hold the CUDA kernels against their plain versions and need a card.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jax_policy  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.tcec_core import split_vregs as jax_split  # noqa: E402
from repro.kernels.tcec_matmul import tcec_matmul_fused as jax_fused  # noqa: E402
from repro.serving.paged_attention import (  # noqa: E402
    paged_decode_attention_pallas as jax_paged)

from repro_torch.core.policy import SCHEDULES, get_policy  # noqa: E402
from repro_torch.kernels import tcec_core  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_KV, flash_attention, flash_attention_plain)
from repro_torch.kernels.tcec_matmul import (  # noqa: E402
    tcec_matmul_fused, tcec_matmul_plain)
from repro_torch.models.convert import to_torch  # noqa: E402
from repro_torch.serving.paged_attention import (  # noqa: E402
    paged_decode_attention_kernel, paged_decode_attention_plain)


def _np(x):
    """torch/jax array -> float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def _attn_inputs(rng, policy, *shapes):
    """Attention operands.  Under bf16x1, P is rounded to one bf16 word, so
    scores that differ in the last fp32 bit (another summation order) can
    round P to neighbouring words; operands on a 1/8 grid make every score
    exact in fp32 whatever the order.  Corrected policies take normal
    draws."""
    if policy == "bf16x1":
        return [(rng.integers(-8, 9, s) / 8.0).astype(np.float32)
                for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bits16(x):
    """bf16 words as their uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# K1: split words and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_split_words_bitwise_equal_reference(n_words):
    rng = np.random.default_rng(n_words)
    x = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    # finite values above BF16_MAX saturate (corrected splits) or overflow
    # (plain cast) identically; fp32 max, subnormals and zeros ride along
    x[:6] = [3.4e38, -3.4e38, np.finfo(np.float32).max, 1e-42, 0.0, -0.0]
    ours = tcec_core.split_vregs(torch.from_numpy(x), n_words)
    ref = jax_split(jnp.asarray(x), n_words)
    assert len(ours) == len(ref) == n_words
    for w_t, w_j in zip(ours, ref):
        np.testing.assert_array_equal(_bits16(w_t), _bits16(w_j))


def test_schedules_equal_reference():
    from repro.core.policy import SCHEDULES as JAX_SCHEDULES
    from repro.core.policy import registered_policies as jax_registered
    from repro_torch.core.policy import registered_policies
    assert SCHEDULES == JAX_SCHEDULES
    assert registered_policies() == jax_registered()
    for name in registered_policies():
        a, b = get_policy(name), jax_policy(name)
        assert (a.passes, a.backend, a.kernel, a.word_dtype, a.fragment_gen,
                a.schedule, a.n_words) == (b.passes, b.backend, b.kernel,
                                           b.word_dtype, b.fragment_gen,
                                           b.schedule, b.n_words)


# ---------------------------------------------------------------------------
# K2: fused TCEC matmul
# ---------------------------------------------------------------------------

K2_CASES = {
    # name: (batch, m, k, n, bias, activation, residual, out_dtype)
    "bias_silu": (0, 24, 40, 56, True, "silu", False, None),
    "gelu_residual": (0, 16, 72, 24, False, "gelu", True, None),
    "decode_m4_bf16_out": (0, 4, 136, 40, True, None, False, "bfloat16"),
    "batched_relu": (2, 12, 32, 20, True, "relu", True, None),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
def test_tcec_matmul_plain_matches_pallas(case, policy):
    nb, m, k, n, has_bias, act, has_res, out_dt = K2_CASES[case]
    rng = np.random.default_rng(zlib.crc32(f"{case}/{policy}".encode()))
    lead = (nb,) if nb else ()
    a = rng.standard_normal(lead + (m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if has_bias else None
    res = rng.standard_normal(lead + (m, n)).astype(np.float32) \
        if has_res else None
    block = (8, 128, 128)           # blocks that do not divide m, n or k
    ref = jax_fused(jnp.asarray(a), jnp.asarray(b), policy,
                    bias=None if bias is None else jnp.asarray(bias),
                    residual=None if res is None else jnp.asarray(res),
                    activation=act, out_dtype=out_dt, block=block,
                    interpret=True)
    t = torch.from_numpy
    ours = tcec_matmul_fused(
        t(a), t(b), policy, bias=None if bias is None else t(bias),
        residual=None if res is None else t(res), activation=act,
        out_dtype=None if out_dt is None else getattr(torch, out_dt))
    assert tuple(ours.shape) == tuple(ref.shape)
    if out_dt is None:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)
    else:
        # bf16 store: the fp32 values differ in summation order only, so
        # the stored words agree to one bf16 ulp.
        assert ours.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(ours), _np(ref), rtol=2.0 ** -8,
                                   atol=1e-5)


def test_tcec_matmul_bf16_weights_and_nonfinite_guard():
    """bf16 weights are read at their dtype; a non-finite input gives the
    fp32 reference's ±inf/NaN pattern through the epilogue, as in the
    reference kernel."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((6, 48)).astype(np.float32)
    a[1, 3] = np.inf
    a[4, 0] = np.nan
    w = rng.standard_normal((48, 24)).astype(np.float32)
    w_bf = jnp.asarray(w).astype(jnp.bfloat16)
    ref = jax_fused(jnp.asarray(a), w_bf, "bf16x3", activation="tanh",
                    interpret=True)
    ours = tcec_matmul_fused(torch.from_numpy(a),
                             to_torch(np.asarray(w_bf), "cpu"), "bf16x3",
                             activation="tanh")
    np.testing.assert_array_equal(np.isfinite(_np(ours)),
                                  np.isfinite(_np(ref)))
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K3: flash attention
# ---------------------------------------------------------------------------

K3_CASES = {
    # name: (b, h, kvh, sq, skv, causal, kv_len)
    "causal_rep2": (1, 4, 2, 20, 20, True, None),
    "kv_len_rep7": (2, 14, 2, 9, 70, False, 45),
    "causal_kv_len_rep7": (1, 7, 1, 70, 70, True, 50),
    "fully_masked": (1, 2, 1, 5, 8, False, 0),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x6"])
def test_flash_attention_plain_matches_pallas(case, policy):
    b, h, kvh, sq, skv, causal, kv_len = K3_CASES[case]
    d = 16
    rng = np.random.default_rng(len(case) * 31 + len(policy))
    q, k, v = _attn_inputs(rng, policy, (b, h, sq, d), (b, kvh, skv, d),
                           (b, kvh, skv, d))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=8, block_k=BLOCK_KV,
                    interpret=True, policy=policy, kv_len=kv_len)
    t = torch.from_numpy
    ours = flash_attention(t(q), t(k), t(v), causal=causal, policy=policy,
                           kv_len=kv_len)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)
    if kv_len == 0:
        assert not ours.any()


# ---------------------------------------------------------------------------
# K4: paged decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["bf16x1", "bf16x6"])
@pytest.mark.parametrize("kvh,rep", [(2, 7), (2, 2)])
def test_paged_decode_plain_matches_pallas(policy, kvh, rep):
    rng = np.random.default_rng(rep * 10 + len(policy))
    page, d, b = 16, 16, 4
    lens = np.array([0, 5, 37, 48], np.int32)
    npages = 3
    n_phys = 1 + b * npages
    table = rng.permutation(np.arange(1, n_phys)).reshape(b, npages)
    table = table.astype(np.int32)
    kp, vp, q = _attn_inputs(rng, policy, (n_phys, page, kvh, d),
                             (n_phys, page, kvh, d), (b, kvh * rep, d))
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(lens), policy=policy,
                    interpret=True)
    t = torch.from_numpy
    ours = paged_decode_attention_kernel(t(q), t(kp), t(vp), t(table),
                                         t(lens), policy=policy)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)
    assert not ours[0].any()                     # zero length -> zeros


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
def test_cuda_tcec_matmul_matches_plain(cuda_device, policy):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(37, 200, generator=g, device=cuda_device)
    w = torch.randn(200, 150, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    bias = torch.randn(150, generator=g, device=cuda_device)
    pol = get_policy(policy)
    got = tcec_matmul_fused(a, w, pol, bias=bias, activation="silu")
    ref = tcec_matmul_plain(a, w, pol, bias=bias, activation="silu")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6"])
def test_cuda_flash_and_paged_match_plain(cuda_device, policy):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    pol = get_policy(policy)
    q = torch.randn(1, 14, 100, 64, generator=g, device=cuda_device)
    k = torch.randn(1, 2, 100, 64, generator=g, device=cuda_device)
    v = torch.randn(1, 2, 100, 64, generator=g, device=cuda_device)
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True, policy=pol, kv_len=90),
        flash_attention_plain(q, k, v, pol, causal=True, kv_len=90),
        rtol=1e-5, atol=1e-5)
    kp = torch.randn(9, 16, 2, 64, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    vp = torch.randn(9, 16, 2, 64, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    table = torch.randperm(8, generator=g, device=cuda_device)[:8] + 1
    table = table.reshape(2, 4).to(torch.int32)
    lens = torch.tensor([0, 53], dtype=torch.int32, device=cuda_device)
    qd = torch.randn(2, 14, 64, generator=g, device=cuda_device)
    torch.testing.assert_close(
        paged_decode_attention_kernel(qd, kp, vp, table, lens, policy=pol),
        paged_decode_attention_plain(qd, kp, vp, table, lens,
                                     scale=0.125, policy=pol),
        rtol=1e-5, atol=1e-5)
