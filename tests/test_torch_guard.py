"""The non-finite guard on the card (``repro_torch.kernels.nonfinite``).

On the CPU: the fix-up's plain version (a device flag as a tensor,
``torch.where`` on it) is bitwise what ``core.tcec.nonfinite_guard`` gives,
never calls the host check ``all_finite``, and the einsum-to-batched-matmul
views the fix-up kernel reads are right.  Inputs come from numpy with a
seed.  Tests marked ``cuda`` need a card: there the fix-up is held against
the plain pattern on K2, K2b, K5, K6 and the twin's tied head, and the
guarded calls make no host sync.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tcec as core_tcec  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tcec import nonfinite_guard, split_contract  # noqa: E402
from repro_torch.kernels import tcec_matmul as tm  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    launch_counts, reset_launch_counts)
from repro_torch.kernels.nonfinite import (  # noqa: E402
    bmm_views, einsum_fixup, nonfinite_fixup_plain, nonfinite_flag)
from repro_torch import tcec  # noqa: E402

#: Where the non-finite values go: in a, in b, in both.
PATTERNS = ("a", "b", "both")
#: Epilogues: none, or bias + silu + residual with a bf16 store.
EPILOGUES = ("none", "bias_silu_residual_bf16")


def _bits(x: torch.Tensor) -> np.ndarray:
    """Bit patterns (NaN payloads included), for bitwise comparison."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.view(torch.int32).numpy()


def _operands(rng, pattern, m=6, k=40, n=12):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if pattern in ("a", "both"):
        a[1, 3], a[m - 1, 0], a[m - 1, 7] = np.inf, np.nan, -np.inf
    if pattern in ("b", "both"):
        b[2, 5], b[9, 11], b[k - 1, 5] = -np.inf, np.nan, np.inf
    return torch.from_numpy(a), torch.from_numpy(b)


def _epilogue(rng, kind, m, n):
    if kind == "none":
        return {}, None
    kw = dict(bias=torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)), activation="silu",
        residual=torch.from_numpy(rng.standard_normal((m, n)).astype(
            np.float32)))
    return kw, torch.bfloat16


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("kind", EPILOGUES)
def test_fixup_plain_is_bitwise_the_host_guard(pattern, kind):
    """Same ±inf/NaN positions, same values, same bits elsewhere."""
    rng = np.random.default_rng(len(pattern) * 7 + len(kind))
    a, b = _operands(rng, pattern)
    kw, out_dtype = _epilogue(rng, kind, a.shape[0], b.shape[1])
    post = functools.partial(tm._epilogue_ref, scale=1.0, **kw) if kw \
        else None
    # What the guard sees: a split schedule's result on sanitized operands,
    # through the epilogue.
    y = tm.tcec_matmul_plain(core_tcec.sanitize_nonfinite(a),
                             core_tcec.sanitize_nonfinite(b),
                             get_policy("bf16x6"), **kw,
                             out_dtype=out_dtype)
    flag = nonfinite_flag(a, b)
    assert flag.dtype == torch.int32 and flag.tolist() == [1]
    ours = nonfinite_fixup_plain(y, a, b, flag, tm._matmul32, post)
    ref = nonfinite_guard(y, a, b, tm._matmul32, post=post)
    assert ours.dtype == ref.dtype == (out_dtype or torch.float32)
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    assert not bool(torch.isfinite(ours.float()).all())


@pytest.mark.parametrize("kind", EPILOGUES)
def test_fixup_plain_keeps_finite_results(kind):
    """All inputs finite: the flag is clear and nothing changes."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((5, 33), (33, 9)))
    kw, out_dtype = _epilogue(rng, kind, 5, 9)
    post = functools.partial(tm._epilogue_ref, scale=1.0, **kw) if kw \
        else None
    y = tm.tcec_matmul_plain(a, b, get_policy("bf16x3"), **kw,
                             out_dtype=out_dtype)
    flag = nonfinite_flag(a, b)
    assert flag.tolist() == [0]
    ours = nonfinite_fixup_plain(y, a, b, flag, tm._matmul32, post)
    np.testing.assert_array_equal(_bits(ours), _bits(y))
    np.testing.assert_array_equal(
        _bits(ours), _bits(nonfinite_guard(y, a, b, tm._matmul32, post=post)))


def test_fixup_plain_never_calls_the_host_check(monkeypatch):
    """The plain fix-up and the flag read nothing on the host."""
    def forbidden(*xs):
        raise AssertionError("all_finite was called")

    monkeypatch.setattr(core_tcec, "all_finite", forbidden)
    rng = np.random.default_rng(5)
    a, b = _operands(rng, "both")
    y = torch.zeros(a.shape[0], b.shape[1])
    ours = nonfinite_fixup_plain(y, a, b, nonfinite_flag(a, b), tm._matmul32)
    ref = tm._matmul32(a, b)
    bad = ~torch.isfinite(ref)
    np.testing.assert_array_equal(_bits(ours[bad]), _bits(ref[bad]))
    assert not ours[~bad].any()
    with pytest.raises(AssertionError, match="all_finite"):
        nonfinite_guard(y, a, b, tm._matmul32)


#: (equation, lhs shape, rhs shape, lhs layout, rhs layout): a layout is a
#: permutation the operand is stored in (its view then permuted back).
EQUATIONS = {
    "tied_head": ("ay,zy->az", (4, 24), (50, 24), None, None),
    "tied_head_3d": ("aby,zy->abz", (2, 3, 24), (50, 24), None, None),
    "dense": ("aby,yz->abz", (2, 3, 24), (24, 10), None, None),
    "scores": ("bgrd,bgsd->bgrs", (2, 3, 4, 16), (2, 3, 5, 16), None, None),
    "pv": ("bgrs,bgsd->bgrd", (2, 3, 4, 5), (2, 3, 5, 16), None, None),
    "strided_lhs": ("bgrd,bgsd->bgrs", (2, 3, 4, 16), (2, 3, 5, 16),
                    (1, 0, 2, 3), None),
    "out_order": ("ij,jk->ki", (6, 8), (8, 5), None, (1, 0)),
    "split_rows": ("abk,kc->bca", (3, 4, 8), (8, 5), (1, 0, 2), None),
}


@pytest.mark.parametrize("name", sorted(EQUATIONS))
def test_bmm_views_reproduce_the_einsum(name):
    """The (B, M, K) x (B, K, N) -> (B, M, N) views the fix-up kernel reads
    compute the einsum, whatever the operands' and output's layouts."""
    eq, sa, sb, la, lb = EQUATIONS[name]
    rng = np.random.default_rng(len(name))

    def make(shape, layout):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if layout is None:
            return x
        inv = [layout.index(i) for i in range(len(layout))]
        return x.permute(layout).contiguous().permute(inv)

    a, b = make(sa, la), make(sb, lb)
    out = torch.einsum(eq, a, b)
    if name == "out_order":
        out = out.t().contiguous().t()
    out2, o3, a3, b3 = bmm_views(eq, out, a, b)
    torch.testing.assert_close(out2, torch.einsum(eq, a, b), rtol=0,
                               atol=0)
    torch.testing.assert_close(torch.matmul(a3, b3), o3, rtol=1e-5,
                               atol=1e-5)
    # o3 is a view of what the fix-up returns: writing it writes the result.
    o3.zero_()
    assert not out2.any()


def test_bmm_views_refuse_one_sided_sums():
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    with pytest.raises(NotImplementedError):
        bmm_views("ij,jk->k", torch.ones(5), a, b)
    with pytest.raises(NotImplementedError):
        bmm_views("ii,ik->ik", torch.ones(3, 5), torch.ones(3, 3), b[:3])


def test_cpu_split_contract_keeps_the_host_guard():
    """On CPU tensors the twin's guard is the host check: the reference's
    pattern, no fix-up launch counted."""
    rng = np.random.default_rng(9)
    a, b = _operands(rng, "both")
    reset_launch_counts()
    got = split_contract("mk,kn->mn", a, b, get_policy("bf16x6"))
    ref = torch.matmul(a, b)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert torch.equal(got[inf], ref[inf])
    counts = launch_counts()
    assert counts["nonfinite_fixup"] == 0
    assert counts["guard_host_sync"] == 0        # no card, no sync


def test_split_contract_takes_its_guard_from_the_caller():
    """``split_contract`` runs the guard it is given on the sanitized
    schedule's result and the fp32 operands; a guard that returns None
    leaves the product to the host check."""
    rng = np.random.default_rng(13)
    a, b = _operands(rng, "a")
    pol = get_policy("bf16x3")
    seen = []

    def declining(eq, out, a32, b32):
        seen.append((eq, out.clone(), a32, b32))
        return None

    ref = split_contract("mk,kn->mn", a, b, pol)
    got = split_contract("mk,kn->mn", a, b, pol, guard=declining)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    eq, out, a32, b32 = seen[0]
    assert eq == "mk,kn->mn" and a32.dtype == b32.dtype == torch.float32
    assert bool(torch.isfinite(out).all())          # sanitized operands
    np.testing.assert_array_equal(_bits(a32), _bits(a))
    marker = torch.full_like(out, 7.0)
    got = split_contract("mk,kn->mn", a, b, pol,
                         guard=lambda *args: marker)
    assert got is marker


def test_frontend_twin_on_cpu_keeps_the_host_guard():
    """The frontend's twin on CPU tensors: the reference pattern through
    the host check, no fix-up launched, no guard sync counted."""
    rng = np.random.default_rng(19)
    h, w = _operands(rng, "a", 4, 24, 50)
    reset_launch_counts()
    got = tcec.einsum("ay,zy->az", h, w.t().contiguous(), policy="bf16x6")
    ref = torch.einsum("ay,zy->az", h, w.t().contiguous())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert inf.any() and torch.equal(got[inf], ref[inf])
    counts = launch_counts()
    assert counts["nonfinite_fixup"] == 0 and counts["guard_host_sync"] == 0


def test_core_imports_no_kernel_module():
    """``repro_torch.core`` sits below the kernels: importing its TCEC
    module loads nothing of ``repro_torch.kernels``."""
    import os
    import subprocess
    import sys
    import repro_torch
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    code = ("import sys, repro_torch.core.tcec; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.kernels')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same_pattern(got, plain):
    """Same NaN positions, same ±inf values, finite parts within 1e-5."""
    got, plain = got.float().cpu(), plain.float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    inf = torch.isinf(plain)
    assert torch.equal(got[inf], plain[inf])
    fin = torch.isfinite(plain)
    torch.testing.assert_close(got[fin], plain[fin], rtol=1e-5, atol=1e-5)
    assert not bool(fin.all())


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("m,k,n", [(4, 896, 136), (40, 16, 136)])
def test_cuda_k2_fixup_matches_plain_pattern(cuda_device, pattern, m, k, n):
    """K2 with an fp32 lhs and bf16 weights (m = 4: the decode plan, which
    splits k and folds the fix-up into the reduce; k = 16, one k step: one
    split and the fix-up on its own), with an epilogue."""
    rng = np.random.default_rng(m + k)
    a, b = _operands(rng, pattern, m, k, n)
    a, w = a.to(cuda_device), b.to(cuda_device).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(cuda_device)
    for name in ("bf16x3", "bf16x6"):
        pol = get_policy(name)
        kw = dict(bias=bias, activation="tanh")
        _, _, launch = tm.launcher(a, w, pol, **kw)
        assert (launch.plan.splits > 1) == (m == 4)
        got = tm.tcec_matmul_fused(a, w, pol, **kw)
        plain = tm.tcec_matmul_plain(a.cpu(), w.cpu(), pol,
                                     bias=bias.cpu(), activation="tanh")
        if not bool(torch.isfinite(plain).all()):
            _same_pattern(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pallas", "staged", "staged_db"])
def test_cuda_k2b_k5_k6_fixup_matches_plain_pattern(cuda_device, variant):
    fn = {"pallas": tm.tcec_matmul_pallas, "staged": tm.tcec_matmul_staged,
          "staged_db": tm.tcec_matmul_staged_db}[variant]
    rng = np.random.default_rng(17)
    for pattern in PATTERNS:
        a, b = _operands(rng, pattern, 3 * 40, 72, 136)
        a = a.reshape(3, 40, 72)
        for name in ("bf16x3", "bf16x6"):
            got = fn(a.to(cuda_device), b.to(cuda_device), name)
            _same_pattern(got, tm.tcec_matmul_plain(a, b, get_policy(name)))


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [300, 80000])
def test_cuda_twin_head_fixup_matches_plain_pattern(cuda_device, vocab):
    """The tied head's ``ay,zy->az`` on the twin (the frontend's split
    schedule) with a non-finite hidden state: the transposed rhs is a
    stride.  At vocab 80000 the head has 320,000 outputs, more than one
    pass of the fix-up's grid (1024 blocks x 256 threads) covers, so its
    grid-stride loop runs."""
    rng = np.random.default_rng(23)
    h = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((vocab, 64)).astype(
        np.float32)).to(torch.bfloat16)
    h[1, 7], h[3, 0] = np.inf, np.nan
    reset_launch_counts()
    got = tcec.einsum("ay,zy->az", h.to(cuda_device), w.to(cuda_device),
                      policy="bf16x6")
    assert launch_counts()["nonfinite_fixup"] == 1
    _same_pattern(got, split_contract("ay,zy->az", h, w,
                                      get_policy("bf16x6")))


@pytest.mark.cuda
def test_cuda_fixup_covers_outputs_past_one_grid(cuda_device):
    """The fix-up kernel on its own over 4 x 90000 outputs (more than the
    262,144 one pass of its grid covers), bf16 rhs read transposed, against
    its plain version: the same bits everywhere."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    h = torch.randn(4, 96, generator=g, device=cuda_device)
    emb = torch.randn(90000, 96, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    h[0, 5], h[2, 50], h[3, 95] = float("inf"), float("nan"), float("-inf")
    out = torch.randn(4, 90000, generator=g, device=cuda_device)
    flag = nonfinite_flag(h, emb)
    got = einsum_fixup("ay,zy->az", out.clone(), h, emb, flag)
    plain = nonfinite_fixup_plain(
        out.clone(), h, emb, flag,
        lambda a_, b_: torch.einsum("ay,zy->az", a_.float(), b_.float()))
    _same_pattern(got, plain)
    assert bool(torch.isfinite(got[1]).all())
    assert torch.equal(got[1], out[1])


@pytest.mark.cuda
def test_cuda_guarded_calls_make_no_host_sync(cuda_device):
    """Under every wired guard, no host sync: the counter stays 0, and
    torch's sync debug mode set to raise lets each call through."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4, 896, generator=g, device=cuda_device)
    w = torch.randn(896, 256, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    a16, w16 = a[:, :16].contiguous(), w[:16].contiguous()  # one split
    a3 = torch.randn(2, 40, 72, generator=g, device=cuda_device)
    b = torch.randn(72, 136, generator=g, device=cuda_device)
    emb = torch.randn(300, 896, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    for name in ("bf16x3", "bf16x6"):
        tm.tcec_matmul_fused(a, w, name)          # builds before the check
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tm.tcec_matmul_fused(a, w, name, activation="silu")
            tm.tcec_matmul_fused(a16, w16, name)
            tm.tcec_matmul_pallas(a3, b, name)
            tm.tcec_matmul_staged(a3, b, name)
            tm.tcec_matmul_staged_db(a3, b, name)
            tcec.einsum("ay,zy->az", a, emb, policy=name)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["guard_host_sync"] == 0
        # K2 with one split, K2b, K5, K6, the twin
        assert counts["nonfinite_fixup"] == 5
