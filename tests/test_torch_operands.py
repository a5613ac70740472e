"""The port's fragment operands (``repro_torch.tcec.operands``) and the
einsum frontend's handling of them and of ``precision="strict"``, against
the JAX package's ``repro.tcec``.

Inputs are made with numpy from a seed and fed to both packages; the rules
are evaluated on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import tcec as jtcec  # noqa: E402
from repro.core.policy import get_policy as jpol  # noqa: E402

from repro_torch import tcec  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402

CPU = "cpu"


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _max_rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _unit_rows(b, m, seed):
    v = np.random.default_rng(seed).standard_normal((b, m)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _pairs():
    """(name, port operand, reference operand) for every prebuilt rule."""
    v = _unit_rows(3, 20, 0)
    theta = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    out = []
    for upper in (True, False):
        for strict in (True, False):
            out.append((f"triangular-{upper}-{strict}",
                        tcec.triangular(17, upper, strict, device=CPU),
                        jtcec.triangular(17, upper, strict)))
    out += [
        ("identity", tcec.identity(9, device=CPU), jtcec.identity(9)),
        ("banded", tcec.banded(20, 2, 3, device=CPU), jtcec.banded(20, 2, 3)),
        ("householder-batched", tcec.householder_operand(torch.from_numpy(v)),
         jtcec.householder_operand(jnp.asarray(v))),
        ("householder-1d", tcec.householder_operand(torch.from_numpy(v[1])),
         jtcec.householder_operand(jnp.asarray(v[1]))),
        ("givens-scalar", tcec.givens_operand(16, 1, 9, torch.tensor(0.7)),
         jtcec.givens_operand(16, 1, 9, jnp.float32(0.7))),
        ("givens-batched",
         tcec.givens_operand(16, 1, 9, torch.from_numpy(theta)),
         jtcec.givens_operand(16, 1, 9, jnp.asarray(theta))),
    ]
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("name,ours,ref", PAIRS, ids=[p[0] for p in PAIRS])
def test_build_is_bitwise_the_reference(name, ours, ref):
    """Bitwise, except that Givens' c and s come from two libm
    implementations (torch's and XLA's), which may differ in the last fp32
    bit (tests/test_torch_structured.py::
    test_fragment_givens_is_the_reference_up_to_libm): there the map-set
    structure is bitwise and c, s within one ulp."""
    assert ours.shape == tuple(ref.shape) and ours.ndim == ref.ndim
    built = ours.build()
    assert built.dtype == torch.float32 and built.device.type == "cpu"
    got, want = built.numpy(), np.asarray(ref.build())
    rot = np.zeros(got.shape[-2:], bool)
    if name.startswith("givens"):
        rot[[1, 9, 1, 9], [1, 9, 9, 1]] = True
        np.testing.assert_array_max_ulp(got[..., rot], want[..., rot],
                                        maxulp=1)
    np.testing.assert_array_equal(_bits(got[..., ~rot]),
                                  _bits(want[..., ~rot]))


@pytest.mark.parametrize("name,ours,ref", PAIRS, ids=[p[0] for p in PAIRS])
def test_closes_over_arrays_answers_as_the_reference(name, ours, ref):
    assert ours.closes_over_arrays() == ref.closes_over_arrays()
    assert ours.closes_over_arrays() == name.startswith(("householder",
                                                         "givens"))


def test_custom_rule_and_shape_checks():
    rule = (lambda i, j: (3 * i - j).to(torch.float32))
    ours = tcec.FragmentOperand(rule, (2, 5, 7), device=CPU).build()
    ref = jtcec.FragmentOperand(lambda i, j: (3 * i - j).astype(jnp.float32),
                                (2, 5, 7)).build()
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))
    with pytest.raises(ValueError, match=">=2-D"):
        tcec.FragmentOperand(rule, (5,), device=CPU)


def test_data_free_constructors_are_cached():
    assert tcec.triangular(96, device=CPU) is tcec.triangular(96, device=CPU)
    assert tcec.banded(8, 1, 2, device=CPU) is tcec.banded(8, 1, 2,
                                                          device=CPU)
    assert tcec.triangular(96, device=CPU) is not tcec.triangular(
        96, strict=True, device=CPU)


@pytest.mark.parametrize("policy", ["bf16x6", "bf16x6_pallas",
                                    "bf16x3_pallas"])
@pytest.mark.parametrize("a_frag,b_frag", [(True, False), (False, True)])
def test_planner_sends_fragments_to_the_twin(policy, a_frag, b_frag):
    """An lhs fragment takes the twin; a 2-D data-free rhs on the menu
    takes the kernel's ``frag=`` arm under a kernel policy, as in the
    reference (the defaults: a 2-D rhs whose rule carries a menu spec)."""
    ours = tcec.plan_einsum("mk", "kn", "mn", get_policy(policy), True,
                            a_frag, b_frag)
    kernel = b_frag and policy.endswith("_pallas")
    assert ours.backend == ("pallas_fragment" if kernel else "xla")
    ref = jtcec.plan_einsum("mk", "kn", "mn", jpol(policy), a_frag, b_frag,
                            2, True)
    assert ref.backend == ours.backend


def test_einsum_with_fragments_records_the_twin_and_matches_reference():
    """A data-free rhs on the menu and a data-carrying lhs, under a kernel
    policy: the port records the kernel's ``frag=`` arm for the rhs (its
    plain version on the CPU) and the twin for the lhs, as the reference
    does, within 1e-6 of the reference and 2^-20 of the fp64 oracle."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((48, 96)).astype(np.float32)
    v = _unit_rows(4, 32, 3)
    a = rng.standard_normal((4, 32, 16)).astype(np.float32)
    with tcec.trace_plans() as log:
        y = tcec.einsum("mk,kn->mn", torch.from_numpy(x),
                        tcec.triangular(96, device=CPU),
                        policy="bf16x6_pallas")
        h = tcec.einsum("bij,bjk->bik",
                        tcec.householder_operand(torch.from_numpy(v)),
                        torch.from_numpy(a), policy="bf16x6_pallas")
    assert [r.backend for r in log] == ["pallas_fragment", "xla"]
    y_ref = jtcec.einsum("mk,kn->mn", jnp.asarray(x), jtcec.triangular(96),
                         policy="bf16x6_pallas")
    h_ref = jtcec.einsum("bij,bjk->bik",
                         jtcec.householder_operand(jnp.asarray(v)),
                         jnp.asarray(a), policy="bf16x6_pallas")
    assert _max_rel(y.numpy(), y_ref) <= 1e-6
    assert _max_rel(h.numpy(), h_ref) <= 1e-6
    u64 = np.triu(np.ones((96, 96)))
    assert _max_rel(y.numpy(), x.astype(np.float64) @ u64) <= 2.0 ** -20
    v64 = v.astype(np.float64)
    h64 = np.eye(32)[None] - 2.0 * v64[:, :, None] * v64[:, None, :]
    assert _max_rel(h.numpy(), h64 @ a.astype(np.float64)) <= 2.0 ** -20


@pytest.mark.parametrize("policy", ["bf16x1", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("precision", ["native", "strict"])
def test_precision_conventions_match_reference(policy, precision):
    """``strict`` splits even a one-pass policy into bf16 words (on the CPU
    ``native`` computes in fp32, as the reference's CPU backend does);
    within 1e-6 of the reference's einsum under the same convention."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    ours = tcec.einsum("mk,kn->mn", torch.from_numpy(a), torch.from_numpy(b),
                       policy=policy, precision=precision).numpy()
    ref = jtcec.einsum("mk,kn->mn", jnp.asarray(a), jnp.asarray(b),
                       policy=policy, precision=precision)
    assert _max_rel(ours, ref) <= 1e-6
    if policy == "bf16x1":
        a16 = torch.from_numpy(a).to(torch.bfloat16).float()
        b16 = torch.from_numpy(b).to(torch.bfloat16).float()
        words = (a16 @ b16).numpy()
        fp32 = a @ b
        assert _max_rel(ours, words if precision == "strict" else fp32) \
            <= 1e-6
        assert _max_rel(words, fp32) > 1e-4


def test_bad_precision_raises():
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="precision"):
        tcec.einsum("mk,kn->mn", a, a.T, precision="loose")
