"""The port's structured ops (``repro_torch.kernels.ops.householder``,
``givens``, ``cumsum``: K7-K9) and rule-made fragments against the JAX
package.

On this CPU host the kernel wrappers of ``repro_torch.kernels.structured``
run their plain PyTorch versions, held against the reference's Pallas
kernels in interpret mode, as its own tests run them; the public ops of
``repro_torch.kernels.ops`` run the reference's fallback (the rule as a
``FragmentOperand`` through the einsum frontend at the ``"structured"``
site), held against the reference's own ``repro.kernels.ops`` on its
default CPU path under the default policy and under a corrected one.
Inputs are made with numpy from a seed (normal numbers only) and fed to
both.  Tests marked ``cuda`` hold the CUDA kernels against their plain
versions and need a card.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fragment as jfrag  # noqa: E402
from repro.core.context import policy_scope as jpolicy_scope  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch import tcec  # noqa: E402
from repro_torch.core import fragment  # noqa: E402
from repro_torch.core.context import policy_scope  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    launch_counts, ops, reset_launch_counts, structured)

#: The shapes of tests/test_kernels_structured.py, plus one ragged shape
#: per op (m, k, rows and a block that no 16-wide tile divides).
HOUSEHOLDER = [(1, 16, 16), (4, 32, 64), (8, 64, 128), (2, 128, 128),
               (3, 20, 24)]
GIVENS = [(2, 16, 32, 1, 9), (8, 64, 64, 3, 60), (4, 128, 128, 0, 127),
          (3, 20, 24, 2, 11)]
CUMSUM = [(8, 256, 128), (16, 512, 256), (8, 1024, 128), (32, 128, 128),
          (24, 96, 48), (5, 60, 20)]
BIG = 3.4e38  # finite in fp32, above the bf16 maximum: bf16 rounds it to inf


def _unit_rows(rng, b, m):
    v = rng.standard_normal((b, m)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _householder_inputs(b, m, k):
    rng = np.random.default_rng(b * m + k)
    return _unit_rows(rng, b, m), \
        rng.standard_normal((b, m, k)).astype(np.float32)


def _givens_inputs(b, m, k, gi):
    rng = np.random.default_rng(b + m + gi)
    return rng.standard_normal(b).astype(np.float32), \
        rng.standard_normal((b, m, k)).astype(np.float32)


def _cumsum_input(rows, n):
    return np.random.default_rng(rows + n).standard_normal(
        (rows, n)).astype(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _same_nonfinite(ours, ref):
    """Same NaN positions, same ±inf values, finite parts within 1e-5."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    inf = np.isinf(ref)
    np.testing.assert_array_equal(ours[inf], ref[inf])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,m,k", HOUSEHOLDER)
def test_householder_matches_reference(b, m, k):
    v, a = _householder_inputs(b, m, k)
    ref = jops.householder(jnp.asarray(v), jnp.asarray(a), interpret=True)
    ours = structured.householder_apply(torch.from_numpy(v),
                                        torch.from_numpy(a))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (b, m, k)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_householder_keeps_column_norms():
    rng = np.random.default_rng(3)
    v = _unit_rows(rng, 2, 32)
    a = rng.standard_normal((2, 32, 16)).astype(np.float32)
    out = ops.householder(torch.from_numpy(v), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1),
                               np.linalg.norm(a, axis=1), rtol=2e-2)


@pytest.mark.parametrize("b,m,k,gi,gj", GIVENS)
def test_givens_matches_reference(b, m, k, gi, gj):
    th, a = _givens_inputs(b, m, k, gi)
    ref = jops.givens(jnp.asarray(th), jnp.asarray(a), gi, gj,
                      interpret=True)
    ours = structured.givens_apply(torch.from_numpy(th), torch.from_numpy(a),
                                   gi, gj)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # The rows G leaves alone are bf16(A) exactly: one product by 1.
    keep = [i for i in range(m) if i not in (gi, gj)]
    np.testing.assert_array_equal(ours.numpy()[:, keep], _bf16(a)[:, keep])


@pytest.mark.parametrize("rows,n,block", CUMSUM)
def test_cumsum_matches_reference(rows, n, block):
    x = _cumsum_input(rows, n)
    ref = jops.cumsum(jnp.asarray(x), block, interpret=True)
    ours = structured.scan_cumsum(torch.from_numpy(x), block).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4, atol=1e-4)
    exact = np.cumsum(x.astype(np.float64), axis=-1)
    assert np.max(np.abs(ours - exact)) / np.max(np.abs(exact)) < 2e-2


@pytest.mark.parametrize("n,block", [(96, 40), (100, 64)])
def test_cumsum_rejects_a_block_that_does_not_divide_n(n, block):
    x = torch.zeros(4, n)
    with pytest.raises(ValueError, match="n % block_n"):
        ops.cumsum(x, block)
    with pytest.raises(ValueError, match="n % block_n"):
        structured.scan_launcher(x, block)
    # the reference refuses it too (its kernel path asserts)
    with pytest.raises((AssertionError, ValueError)):
        jops.cumsum(jnp.zeros((4, n)), block, interpret=True)


def test_cumsum_block_is_cut_to_n():
    x = _cumsum_input(4, 48)
    np.testing.assert_array_equal(ops.cumsum(torch.from_numpy(x), 256),
                                  ops.cumsum(torch.from_numpy(x), 48))


@pytest.mark.parametrize("op", ["householder", "givens", "cumsum"])
def test_bf16_overflow_gives_the_reference_nonfinite_pattern(op):
    """An fp32 value above the bf16 maximum rounds to ±inf (a plain cast,
    not the TCEC split's saturating word), and inf · 0 = NaN spreads as
    in the reference: nothing skips G's zeros or U's zero triangle."""
    if op == "cumsum":
        x = _cumsum_input(8, 64)
        x[1, 5], x[3, 40] = BIG, -BIG
        ref = jops.cumsum(jnp.asarray(x), 32, interpret=True)
        ours = structured.scan_cumsum(torch.from_numpy(x), 32)
    elif op == "givens":
        th, a = _givens_inputs(2, 16, 24, 1)
        a[0, 4, 7], a[1, 9, 0] = BIG, -BIG
        ref = jops.givens(jnp.asarray(th), jnp.asarray(a), 1, 9,
                          interpret=True)
        ours = structured.givens_apply(torch.from_numpy(th),
                                       torch.from_numpy(a), 1, 9)
    else:
        v, a = _householder_inputs(2, 16, 24)
        a[0, 4, 7], a[0, 6, 7], a[1, 9, 0] = BIG, -BIG, BIG
        ref = jops.householder(jnp.asarray(v), jnp.asarray(a),
                               interpret=True)
        ours = structured.householder_apply(torch.from_numpy(v),
                                            torch.from_numpy(a))
    assert not np.isfinite(np.asarray(ref)).all()
    _same_nonfinite(ours.numpy(), ref)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_fragment_matrices_are_bitwise_the_reference():
    cpu = {"device": "cpu"}
    pairs = [(fragment.identity(24, **cpu), jfrag.identity(24)),
             (fragment.banded(20, 2, 3, **cpu), jfrag.banded(20, 2, 3))]
    for upper in (True, False):
        for strict in (True, False):
            pairs.append((fragment.triangular_ones(17, upper, strict, **cpu),
                          jfrag.triangular_ones(17, upper, strict)))
    v, _ = _householder_inputs(3, 20, 1)
    pairs.append((fragment.householder(torch.from_numpy(v)),
                  jfrag.householder(jnp.asarray(v))))
    pairs.append((fragment.householder(torch.from_numpy(v[1])),
                  jfrag.householder(jnp.asarray(v[1]))))
    pairs.append((fragment.foreach_ij(lambda i, j: (3 * i - j).float(), 5, 7,
                                      **cpu),
                  jfrag.foreach_ij(lambda i, j: (3 * i - j), 5, 7)))
    for ours, ref in pairs:
        assert tuple(ours.shape) == tuple(ref.shape)
        np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))
    h = fragment.householder(torch.from_numpy(v))
    np.testing.assert_array_equal(
        _bits(fragment.map_get(fragment.map_set(h, 2, 5, 7.0), 2, 5)),
        _bits(jfrag.map_get(jfrag.map_set(jnp.asarray(h.numpy()), 2, 5,
                                          7.0), 2, 5)))


@pytest.mark.parametrize("theta", [0.0, 0.7, -2.0319412])
def test_fragment_givens_is_the_reference_up_to_libm(theta):
    """The map-set structure is bitwise the reference's; c and s come from
    two libm implementations (torch's and XLA's), which may differ in the
    last fp32 bit (at theta = -2.0319412 they do)."""
    ours = fragment.givens(16, 1, 9, torch.tensor(theta, dtype=torch.float32))
    ref = np.asarray(jfrag.givens(16, 1, 9, jnp.float32(theta)))
    rot = np.zeros((16, 16), bool)
    rot[[1, 9, 1, 9], [1, 9, 9, 1]] = True
    np.testing.assert_array_equal(_bits(ours.numpy()[~rot]), _bits(ref[~rot]))
    np.testing.assert_array_max_ulp(ours.numpy()[rot], ref[rot], maxulp=1)


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    """On the CPU the kernel wrappers run their plain versions, and the
    public ops run the frontend at the "structured" site (strict, one
    record per contraction), which honours the site's policy; nothing
    counts a launch."""
    reset_launch_counts()
    t = torch.from_numpy
    v, a = _householder_inputs(2, 16, 8)
    th, ag = _givens_inputs(2, 16, 8, 0)
    x = _cumsum_input(4, 64)
    assert torch.equal(structured.householder_apply(t(v), t(a)),
                       structured.householder_plain(t(v), t(a)))
    assert torch.equal(structured.givens_apply(t(th), t(ag), 0, 3),
                       structured.givens_plain(t(th), t(ag), 0, 3))
    assert torch.equal(structured.scan_cumsum(t(x), 16),
                       structured.scan_cumsum_plain(t(x), 16))
    with tcec.trace_plans() as log:
        ops.householder(t(v), t(a))
        ops.givens(t(th), t(ag), 0, 3)
        ops.cumsum(t(x), 16)
    assert len(log) == 2 + 64 // 16
    assert {(r.site, r.backend, r.policy.passes) for r in log} == \
        {("structured", "xla", 1)}
    with policy_scope(structured="bf16x6"), tcec.trace_plans() as log:
        h6 = ops.householder(t(v), t(a))
    assert [r.policy.passes for r in log] == [6]
    assert not torch.equal(h6, structured.householder_plain(t(v), t(a)))
    counts = launch_counts()
    assert {"householder_apply", "givens_apply", "scan_cumsum"} <= set(counts)
    assert not any(counts.values())


def _max_rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


#: (op, shape) of the ops-level cases: the acceptance shapes (Householder
#: b=4, m=32, k=64; cumsum 8x512, block 128), a Givens shape, and a ragged
#: shape each.
OPS_CASES = [("householder", (4, 32, 64)), ("householder", (3, 20, 24)),
             ("givens", (8, 64, 64, 3, 60)), ("givens", (3, 20, 24, 2, 11)),
             ("cumsum", (8, 512, 128)), ("cumsum", (5, 60, 20))]


def _run_op(op, shape, lib, jax_side: bool):
    t = jnp.asarray if jax_side else torch.from_numpy
    if op == "householder":
        v, a = _householder_inputs(*shape)
        return lib.householder(t(v), t(a))
    if op == "givens":
        b, m, k, gi, gj = shape
        th, a = _givens_inputs(b, m, k, gi)
        return lib.givens(t(th), t(a), gi, gj)
    rows, n, block = shape
    return lib.cumsum(t(_cumsum_input(rows, n)), block)


@pytest.mark.parametrize("policy", [None, "bf16x6", "bf16x3"])
@pytest.mark.parametrize("op,shape", OPS_CASES,
                         ids=[f"{o}-{s}" for o, s in OPS_CASES])
def test_ops_follow_the_structured_site_policy_as_the_reference(op, shape,
                                                                 policy):
    """``ops.*`` on the CPU against ``repro.kernels.ops.*`` on its default
    CPU path (the frontend fallback), under the default policy and under
    ``policy_scope(structured=...)``: within 1e-6 of the reference's output,
    max-norm relative."""
    def scope(policy_scope_of):
        return policy_scope_of(structured=policy) if policy \
            else contextlib.nullcontext()

    with scope(jpolicy_scope):
        ref = np.asarray(_run_op(op, shape, jops, True))
    with scope(policy_scope):
        ours = _run_op(op, shape, ops, False)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert _max_rel(ours.numpy(), ref) <= 1e-6


def test_mixed_devices_and_bad_shapes_raise():
    a = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="operands on"):
        ops.householder(torch.zeros(2, 16, device="meta"), a)
    with pytest.raises(ValueError, match="operands on"):
        ops.givens(torch.zeros(2, device="meta"), a, 0, 1)
    with pytest.raises(ValueError, match="expects"):
        ops.householder(torch.zeros(3, 16), a)
    with pytest.raises(ValueError, match="expects"):
        ops.givens(torch.zeros(2, 1), a, 0, 1)
    with pytest.raises(ValueError, match="rows, n"):
        ops.cumsum(torch.zeros(2, 3, 4))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k", HOUSEHOLDER)
def test_cuda_householder_matches_plain(cuda_device, b, m, k):
    v, a = (torch.from_numpy(x).to(cuda_device)
            for x in _householder_inputs(b, m, k))
    reset_launch_counts()
    got = ops.householder(v, a)
    assert launch_counts()["householder_apply"] == 1
    torch.testing.assert_close(got, structured.householder_plain(v, a),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,gi,gj", GIVENS)
def test_cuda_givens_matches_plain(cuda_device, b, m, k, gi, gj):
    th, a = (torch.from_numpy(x).to(cuda_device)
             for x in _givens_inputs(b, m, k, gi))
    reset_launch_counts()
    got = ops.givens(th, a, gi, gj)
    assert launch_counts()["givens_apply"] == 1
    torch.testing.assert_close(got, structured.givens_plain(th, a, gi, gj),
                               rtol=1e-5, atol=1e-5)
    keep = [i for i in range(m) if i not in (gi, gj)]
    assert torch.equal(got[:, keep], a.to(torch.bfloat16).float()[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,block", CUMSUM)
def test_cuda_cumsum_matches_plain(cuda_device, rows, n, block):
    x = torch.from_numpy(_cumsum_input(rows, n)).to(cuda_device)
    reset_launch_counts()
    got = ops.cumsum(x, block)
    assert launch_counts()["scan_cumsum"] == 1
    torch.testing.assert_close(got, structured.scan_cumsum_plain(x, block),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_nonfinite_pattern_matches_plain(cuda_device):
    dev = cuda_device
    v, a = _householder_inputs(2, 16, 24)
    a[0, 4, 7], a[0, 6, 7], a[1, 9, 0] = BIG, -BIG, BIG
    v, a = torch.from_numpy(v).to(dev), torch.from_numpy(a).to(dev)
    _same_nonfinite(ops.householder(v, a).cpu(),
                    structured.householder_plain(v, a).cpu())
    th = torch.linspace(-3, 3, 2, device=dev)
    _same_nonfinite(ops.givens(th, a, 1, 9).cpu(),
                    structured.givens_plain(th, a, 1, 9).cpu())
    x = _cumsum_input(8, 64)
    x[1, 5], x[3, 40] = BIG, -BIG
    x = torch.from_numpy(x).to(dev)
    _same_nonfinite(ops.cumsum(x, 32).cpu(),
                    structured.scan_cumsum_plain(x, 32).cpu())
