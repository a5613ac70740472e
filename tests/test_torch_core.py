"""The port's package boundary and core numerics: it imports no JAX, its
entry points never fall back to the CPU on their own, and its policy
context, planner and einsum twin agree with the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from subproc import run_python  # noqa: E402

from repro import tcec as jtcec  # noqa: E402
from repro.core import context as jctx  # noqa: E402

from repro_torch import tcec  # noqa: E402
from repro_torch.core import context as ctx  # noqa: E402


def test_import_loads_no_jax_and_nothing_of_repro():
    out = run_python(
        "import sys\n"
        "import repro_torch, repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels, repro_torch.models.convert\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.tcec_matmul\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', bad)\n", devices=1)
    assert "LOADED []" in out, out


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params, init_paged_decode_caches
    from repro_torch.serving import PagedServingEngine
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_decode_caches(cfg, 2, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--paged", "--reduced"])
    eng = PagedServingEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        PagedServingEngine(cfg, params, device="cpu", prefix_cache=True)


def test_policy_context_resolves_like_reference():
    for mod in (ctx, jctx):
        with mod.policy_defaults({"default": "bf16x3", "lm_head": "bf16x6"}):
            with mod.policy_scope("bf16x6_pallas", attn="fp32_vpu"):
                got = (mod.resolve("ffn").passes, mod.resolve("attn").backend,
                       mod.resolve("ffn").kernel)
            outside = (mod.resolve("lm_head").passes, mod.resolve().passes)
        assert got == (6, "vpu", "pallas")
        assert outside == (6, 3)


EQUATIONS = ["aby,yz->abz", "bmk,bkn->bmn", "aby,zy->abz",
             "bqgrd,bkgd->bgrqk", "mk,kn->mn", "bmk,kn->bmn"]


def test_planner_classifies_like_reference():
    from repro.core.policy import get_policy as jpol
    from repro_torch.core.policy import get_policy
    for eq in EQUATIONS:
        ia, ib, out = tcec.parse_equation(eq)
        assert (ia, ib, out) == jtcec.parse_equation(eq)
        assert tcec.matmul_pattern(ia, ib, out) == \
            jtcec.matmul_pattern(ia, ib, out)
        for name in ("bf16x6", "bf16x6_pallas", "fp32_vpu"):
            ours = tcec.plan_einsum(ia, ib, out, get_policy(name), True)
            ref = jtcec.plan_einsum(ia, ib, out, jpol(name), False, False,
                                    len(ib), True)
            assert (ours.backend, ours.pattern) == (ref.backend, ref.pattern)


# (equation, lhs shape, rhs shape): attention scores, and the tied LM head.
TWIN_EQUATIONS = {"scores": ("bqgd,bkgd->bgqk", (2, 5, 3, 8), (2, 7, 3, 8)),
                  "tied_head": ("aby,zy->abz", (2, 5, 8), (7, 8))}


@pytest.mark.parametrize("policy", ["fp32_vpu", "bf16x1", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("case", sorted(TWIN_EQUATIONS))
def test_einsum_twin_matches_reference(policy, case):
    eq, a_shape, b_shape = TWIN_EQUATIONS[case]
    rng = np.random.default_rng(11)
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    ref = jtcec.einsum(eq, jnp.asarray(a), jnp.asarray(b), policy=policy,
                       epilogue=jtcec.Epilogue(scale=0.5,
                                               bias=jnp.asarray(bias),
                                               activation="gelu"))
    ours = tcec.einsum(eq, torch.from_numpy(a), torch.from_numpy(b),
                       policy=policy,
                       epilogue=tcec.Epilogue(scale=0.5,
                                              bias=torch.from_numpy(bias),
                                              activation="gelu"))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    with tcec.trace_plans() as log:
        tcec.matmul(torch.from_numpy(rng.standard_normal((5, 8),
                                                         np.float32)),
                    torch.from_numpy(rng.standard_normal((8, 7),
                                                         np.float32)),
                    site="ffn", policy=policy)
    assert [(r.eq, r.site, r.backend) for r in log] == \
        [("ay,yz->az", "ffn", "xla")]
