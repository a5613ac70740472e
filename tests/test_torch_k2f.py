"""K2's in-kernel fragment rhs (``tcec_matmul_fused(a, None, policy,
frag=...)``, the reference's ``"pallas_fragment"`` plan) against the JAX
package.

On this CPU host the port's wrapper runs its plain version (the menu rule
built on the lhs's device, then ``tcec_matmul_plain``); the reference's
``_fused_kernel`` runs in interpret mode with blocks that divide neither m,
n nor k, so its masked edge blocks run.  Inputs are made with numpy from a
seed and fed to both.  The CUDA kernel's own tests (bitwise against K2 on
the built bf16 rhs) are ``cuda``-marked in ``tests/test_torch_k2.py``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import tcec as jtcec  # noqa: E402
from repro.core.policy import get_policy as jpol  # noqa: E402
from repro.kernels.tcec_matmul import tcec_matmul_fused as jax_fused  # noqa: E402

from repro_torch import tcec  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.tcec_matmul import (  # noqa: E402
    k2_passes, tcec_matmul_fused, tcec_matmul_plain)
from repro_torch.tcec.operands import (  # noqa: E402
    MENU_RULES, FragmentOperand, MenuRule)

CPU = "cpu"
#: The reference's block for the parity cases: (8, 128, 128) divides none of
#: their m, n or k.
BLOCK = (8, 128, 128)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def _rules():
    """name -> (port operand, reference operand, n) for every menu rule."""
    out = {}
    for upper in (True, False):
        for strict in (True, False):
            out[f"triangular-{upper}-{strict}"] = (
                tcec.triangular(45, upper, strict, device=CPU),
                jtcec.triangular(45, upper, strict), 45)
    out["identity"] = (tcec.identity(24, device=CPU), jtcec.identity(24), 24)
    out["banded"] = (tcec.banded(40, 3, 1, device=CPU),
                     jtcec.banded(40, 3, 1), 40)
    out["banded-wide"] = (tcec.banded(136, 70, 0, device=CPU),
                          jtcec.banded(136, 70, 0), 136)
    return out


RULES = _rules()


# ---------------------------------------------------------------------------
# The menu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RULES))
def test_menu_values_are_the_rule_and_the_reference(name):
    """The operand's rule is the menu rule whose spec the kernel takes, and
    its values (the plain version of the kernel's ``rule_at``) are the
    bits of the reference's built operand."""
    ours, ref, n = RULES[name]
    assert isinstance(ours.rule, MenuRule) and ours.menu == ours.rule.spec
    assert ours.menu[0] == MENU_RULES[name.split("-")[0]]
    vals = ours.build()
    assert vals.dtype == torch.float32 and tuple(vals.shape) == (n, n)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref.build()))
    assert set(np.unique(vals.numpy())) <= {0.0, 1.0}


def test_fragment_operand_keeps_its_positional_fields_and_hash():
    rule = (lambda i, j: (i + j).to(torch.float32))
    op = FragmentOperand(rule, (3, 4), torch.float32, "sum", CPU)
    assert op.menu is None and hash(op) == hash(
        FragmentOperand(rule, (3, 4), torch.float32, "sum", CPU))
    assert tcec.triangular(45, device=CPU) is tcec.triangular(45, device=CPU)
    assert tcec.triangular(45, device=CPU).menu == (0, 1, 0)
    assert tcec.banded(40, 3, 1, device=CPU).menu == (2, 3, 1)
    assert tcec.identity(24, device=CPU).menu == (1, 0, 0)
    assert {tcec.triangular(8, device=CPU): 1}[tcec.triangular(8, device=CPU)]
    # A menu rule hashes by its spec: the same rule, the same operand.
    assert FragmentOperand(MenuRule(2, 3, 1), (40, 40), name="banded",
                           device=CPU) == tcec.banded(40, 3, 1, device=CPU)
    with pytest.raises(ValueError, match="menu rule"):
        MenuRule(7)
    with pytest.raises(ValueError, match="menu rule"):
        MenuRule(2, 2 ** 31, 0)


@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
def test_k2_passes_take_a_menu_rhs_as_one_bf16_word(policy):
    pol = get_policy(policy)
    for a_dt in (torch.float32, torch.bfloat16):
        assert k2_passes(pol, a_dt, None) == k2_passes(pol, a_dt,
                                                       torch.bfloat16)
    assert k2_passes(get_policy("bf16x6"), torch.float32, None) == (
        (2, 0), (1, 0), (0, 0))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def _off_menu():
    """A data-free rule that is not on the menu, in both packages."""
    return (FragmentOperand(lambda i, j: ((i + 2 * j) % 3 == 0).to(
        torch.float32), (45, 45), name="mod3", device=CPU),
            jtcec.FragmentOperand(lambda i, j: ((i + 2 * j) % 3 == 0).astype(
                jnp.float32), (45, 45), name="mod3"))


def _plans(eq, a, b, ja, jb, policy):
    with tcec.trace_plans() as log:
        tcec.einsum(eq, a, b, policy=policy)
    with jtcec.trace_plans() as jlog:
        jtcec.einsum(eq, ja, jb, policy=policy)
    return [r.backend for r in log], [r.backend for r in jlog]


PLAN_POLICIES = ["bf16x6", "bf16x3_pallas", "bf16x6_pallas"]


@pytest.mark.parametrize("policy", PLAN_POLICIES)
@pytest.mark.parametrize("name", sorted(RULES))
def test_menu_rules_plan_as_the_reference(name, policy):
    """A menu rhs under a kernel policy plans ``"pallas_fragment"`` in both
    packages (the twin under a twin policy), through the frontend and in
    ``plan_einsum``."""
    ours, ref, n = RULES[name]
    x = np.random.default_rng(n).standard_normal((6, n)).astype(np.float32)
    got, want = _plans("mk,kn->mn", torch.from_numpy(x), ours,
                       jnp.asarray(x), ref, policy)
    assert got == want == ["pallas_fragment" if policy.endswith("_pallas")
                           else "xla"]
    plan = tcec.plan_einsum("mk", "kn", "mn", get_policy(policy), True,
                            False, True, 2)
    jplan = jtcec.plan_einsum("mk", "kn", "mn", jpol(policy), False, True,
                              2, True)
    assert (plan.backend, plan.pattern) == (jplan.backend, jplan.pattern)


@pytest.mark.parametrize("policy", PLAN_POLICIES)
def test_plan_diverges_only_for_a_data_free_rule_off_the_menu(policy):
    """The one stated divergence: a data-free rule without a menu spec takes
    the twin here (the CUDA kernel cannot compile a Python rule) where the
    reference plans ``"pallas_fragment"``.  Data-carrying rhs rules and lhs
    fragments take the twin in both packages."""
    ours, ref = _off_menu()
    x = np.random.default_rng(5).standard_normal((6, 45)).astype(np.float32)
    got, want = _plans("mk,kn->mn", torch.from_numpy(x), ours,
                       jnp.asarray(x), ref, policy)
    pallas = policy.endswith("_pallas")
    assert got == ["xla"]
    assert want == ["pallas_fragment" if pallas else "xla"]
    assert tcec.plan_einsum("mk", "kn", "mn", get_policy(policy), True,
                            False, True, 2, b_frag_on_menu=False
                            ).backend == "xla"
    # A rule that closes over a tensor: the twin in both.
    v = np.random.default_rng(6).standard_normal(45).astype(np.float32)
    v /= np.linalg.norm(v)
    got, want = _plans("mk,kn->mn", torch.from_numpy(x),
                       tcec.householder_operand(torch.from_numpy(v)),
                       jnp.asarray(x),
                       jtcec.householder_operand(jnp.asarray(v)), policy)
    assert got == want == ["xla"]
    # An lhs fragment, even on the menu: the twin in both.
    got, want = _plans("mk,kn->mn", tcec.triangular(45, device=CPU),
                       torch.from_numpy(x.T.copy()), jtcec.triangular(45),
                       jnp.asarray(x.T.copy()), policy)
    assert got == want == ["xla"]
    # A batched (3-D) rhs fragment cannot take the kernel: the twin in both.
    assert tcec.plan_einsum("bmk", "bkn", "bmn", get_policy(policy), True,
                            False, True, 3).backend == "xla"
    assert jtcec.plan_einsum("bmk", "bkn", "bmn", jpol(policy), False, True,
                             3, True).backend == "xla"


# ---------------------------------------------------------------------------
# The arm against the reference's _fused_kernel (interpret mode)
# ---------------------------------------------------------------------------

#: name -> (rule, lhs lead shape, m, bias, activation, residual, out dtype)
K2F_CASES = {
    "triangular-3d": ("triangular-False-True", (3,), 7, False, None, False,
                      None),
    "triangular-upper": ("triangular-True-False", (), 13, True, "gelu",
                         False, None),
    "identity-bias-silu-bf16": ("identity", (), 4, True, "silu", False,
                                "bfloat16"),
    "banded-residual": ("banded", (), 9, False, None, True, None),
    "banded-wide-relu": ("banded-wide", (2,), 5, True, "relu", True, None),
}


def _case_inputs(case, policy):
    rule, lead, m, has_bias, act, has_res, out_dt = K2F_CASES[case]
    ours, ref, n = RULES[rule]
    rng = np.random.default_rng(zlib.crc32(f"{case}/{policy}".encode()))
    a = rng.standard_normal(lead + (m, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if has_bias else None
    res = rng.standard_normal(lead + (m, n)).astype(np.float32) \
        if has_res else None
    return ours, ref, a, bias, res, act, out_dt


def _both(ours, ref, a, bias, res, act, out_dt, policy):
    t = torch.from_numpy
    j = jnp.asarray
    want = jax_fused(j(a), None, policy, frag=ref,
                     bias=None if bias is None else j(bias),
                     residual=None if res is None else j(res),
                     activation=act, out_dtype=out_dt, block=BLOCK,
                     interpret=True)
    got = tcec_matmul_fused(
        t(a), None, policy, frag=ours, bias=None if bias is None else t(bias),
        residual=None if res is None else t(res), activation=act,
        out_dtype=None if out_dt is None else getattr(torch, out_dt))
    return got, want


@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("case", sorted(K2F_CASES))
def test_frag_arm_matches_the_reference_fused_kernel(case, policy):
    """rtol = atol = 1e-5 against the reference's ``_fused_kernel`` with the
    rule made in its body; a bf16 store to one bf16 ulp (2^-8), since the
    fp32 values differ in summation order only.  The arm equals the plain
    version on the built rule (no launch counted on the CPU)."""
    ours, ref, a, bias, res, act, out_dt = _case_inputs(case, policy)
    reset_launch_counts()
    got, want = _both(ours, ref, a, bias, res, act, out_dt, policy)
    assert not any(launch_counts().values())
    assert tuple(got.shape) == tuple(want.shape)
    if out_dt is None:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -8,
                                   atol=1e-5)
    t = torch.from_numpy
    built = ours.build().to(torch.bfloat16)
    plain = tcec_matmul_plain(
        t(a), built, get_policy(policy),
        bias=None if bias is None else t(bias),
        residual=None if res is None else t(res), activation=act,
        out_dtype=None if out_dt is None else getattr(torch, out_dt))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6"])
def test_frag_arm_nonfinite_lhs_pattern_is_the_reference(policy):
    """±inf and NaN in the lhs: the guarded policies give the reference's
    ±inf/NaN pattern (only the lhs is checked; rule values are finite), the
    finite values within 1e-5."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal((12, 45)).astype(np.float32)
    a[1, 3], a[4, 44], a[7, 0], a[7, 20] = np.inf, -np.inf, np.nan, np.inf
    a[9, 10], a[9, 30] = np.inf, -np.inf
    for name in ("triangular-True-False", "triangular-False-True"):
        ours, ref, _ = RULES[name]
        got, want = _both(ours, ref, a, None, None, "tanh", None, policy)
        assert not np.isfinite(_np(want)).all()
        np.testing.assert_array_equal(np.isnan(_np(got)),
                                      np.isnan(_np(want)))
        np.testing.assert_array_equal(np.isinf(_np(got)),
                                      np.isinf(_np(want)))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_frag_arm_off_the_menu_runs_its_rule_on_the_cpu():
    """Called directly on a CPU tensor, the plain version evaluates a rule
    off the menu (the reference's kernel takes any data-free rule)."""
    ours, ref = _off_menu()
    a = np.random.default_rng(8).standard_normal((5, 45)).astype(np.float32)
    got, want = _both(ours, ref, a, None, None, None, None, "bf16x6")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_wrapper_errors_are_the_reference():
    a = torch.zeros(4, 45)
    u = tcec.triangular(45, device=CPU)
    with pytest.raises(ValueError, match="exactly one of b= and frag="):
        tcec_matmul_fused(a, torch.zeros(45, 45), "bf16x6", frag=u)
    with pytest.raises(ValueError, match="exactly one of b= and frag="):
        tcec_matmul_fused(a, None, "bf16x6")
    flat = FragmentOperand(lambda i, j: (i == j).to(torch.float32),
                           (2, 45, 45), device=CPU)
    with pytest.raises(ValueError, match="must be 2-D"):
        tcec_matmul_fused(a, None, "bf16x6", frag=flat)
    with pytest.raises(ValueError, match="does not contract"):
        tcec_matmul_fused(torch.zeros(4, 44), None, "bf16x6", frag=u)
    with pytest.raises(ValueError, match="does not contract"):
        tcec_matmul_fused(torch.zeros(45), None, "bf16x6", frag=u)
    ja = jnp.zeros((4, 45))
    with pytest.raises(ValueError, match="exactly one of b= and frag="):
        jax_fused(ja, None, "bf16x6", interpret=True)
    with pytest.raises(ValueError, match="does not contract"):
        jax_fused(jnp.zeros((4, 44)), None, "bf16x6",
                  frag=jtcec.triangular(45), interpret=True)


# ---------------------------------------------------------------------------
# Through the frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["bf16x3_pallas", "bf16x6_pallas"])
def test_einsum_hands_the_rule_to_the_kernel_unbuilt(policy, monkeypatch):
    """The frontend passes the operand as ``frag=`` and never builds it (the
    counterpart of the reference's
    ``test_fragment_never_materialized_by_frontend``); fold pattern with a
    3-D lhs and the whole epilogue, within 1e-5 of the reference's einsum
    (a bf16 store to 2^-8)."""
    built = []
    orig = FragmentOperand.build
    monkeypatch.setattr(FragmentOperand, "build",
                        lambda self: (built.append(self), orig(self))[1])
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    res = rng.standard_normal((2, 5, 40)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    ep = tcec.Epilogue(bias=t(bias), activation="silu", residual=t(res))
    jep = jtcec.Epilogue(bias=j(bias), activation="silu", residual=j(res))
    with tcec.trace_plans() as log:
        got = tcec.einsum("bmk,kn->bmn", t(x), tcec.banded(40, 3, 1,
                                                           device=CPU),
                          policy=policy, epilogue=ep)
        got16 = tcec.einsum(
            "mk,kn->mn", t(x[0]), tcec.identity(40, device=CPU),
            policy=policy, epilogue=tcec.Epilogue(out_dtype=torch.bfloat16))
    assert [r.backend for r in log] == ["pallas_fragment"] * 2
    assert built == []
    want = jtcec.einsum("bmk,kn->bmn", j(x), jtcec.banded(40, 3, 1),
                        policy=policy, epilogue=jep)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    want16 = jtcec.einsum("mk,kn->mn", j(x[0]), jtcec.identity(40),
                          policy=policy,
                          epilogue=jtcec.Epilogue(out_dtype="bfloat16"))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got16), _np(want16), rtol=2.0 ** -8,
                               atol=1e-5)
