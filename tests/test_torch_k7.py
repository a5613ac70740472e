"""K7 (``householder_apply``) and K8 (``givens_apply``), whose kernel is one
template (``csrc/structured.cu::rule_apply_kernel``), as redesigned for
Hopper: a staged, pipelined pass whose work items are whole batches, column
slices of a batch's A, or (past M = 128) row groups whose contraction is
streamed in slabs of 128 rows.

On this CPU host the wrappers run their plain PyTorch versions, held here
against the reference's Pallas kernels in interpret mode at the edges of
the kernel's work items: M of 20, 144 and 272 (one slot, and past one),
K of 3 (not a multiple of 4), 36 and 1000 (several column slices), batch 1
and 37; and at inputs with ±inf, NaN or values whose products overflow,
held to the reference's ±inf/NaN pattern.  Inputs are made with numpy from
a seed.  Tests marked ``cuda`` hold the kernel against its plain version at
the same shapes and inputs, on an A whose data is not 16-byte aligned and
at a batch count larger than the kernel's grid, check K8's untouched rows
and one launch per call; they need a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import (  # noqa: E402
    launch_counts, reset_launch_counts, structured)

BIG = 3.4e38  # finite in fp32, above the bf16 maximum: bf16 rounds it to inf
INF, NAN = float("inf"), float("nan")

#: (batch, m, k): M of 20, 144, 272; K of 3, 36, 1000; batch 1 and 37.
HOUSEHOLDER = [(37, 20, 3), (1, 20, 1000), (37, 144, 36), (1, 144, 1000),
               (1, 272, 36), (37, 272, 3), (37, 20, 1000)]
#: (batch, m, k, gi, gj): gi and gj in different row tiles (and row
#: groups past M = 128), gi > gj, and both in one tile.
GIVENS = [(37, 20, 36, 3, 17), (1, 144, 1000, 5, 140), (37, 272, 3, 260, 2),
          (1, 20, 3, 1, 19), (2, 272, 36, 130, 131), (37, 20, 1000, 0, 19)]

#: name -> (op, batch, m, k, gi, gj, A's values as (batch, row, column,
#: value), v's as (batch, row, value)).  ±inf and NaN in A at a row tile's
#: edge (rows 15, 16), in a second column slice (columns past 128 at
#: M = 20) and in a later k slab (rows past 128); a finite v whose products
#: overflow fp32 and whose bf16 is ±inf; finite A values that bf16 rounds
#: to ±inf; K8 with gi and gj in different row tiles and row groups.
NONFINITE = {
    "hh_tile_edge_and_second_slice": (
        "hh", 3, 20, 300, 0, 0,
        [(1, 15, 7, INF), (1, 16, 200, NAN), (2, 19, 299, -INF)], []),
    "hh_later_slab": ("hh", 2, 272, 36, 0, 0,
                      [(0, 200, 35, INF), (1, 127, 3, NAN)], []),
    "hh_v_bf16_overflow": ("hh", 4, 32, 64, 0, 0, [], [(1, 7, BIG)]),
    "hh_a_bf16_overflow": ("hh", 3, 20, 24, 0, 0,
                           [(0, 4, 7, BIG), (0, 6, 7, -BIG),
                            (1, 9, 0, BIG)], []),
    "gv_tiles_apart": ("gv", 3, 144, 40, 5, 140,
                       [(0, 15, 3, INF), (2, 130, 39, NAN)], []),
    "gv_a_bf16_overflow": ("gv", 3, 20, 24, 3, 17,
                           [(0, 16, 7, BIG), (1, 17, 0, -BIG)], []),
}


def _inputs(op, b, m, k, bad=(), vbad=()):
    rng = np.random.default_rng(b * 1000 + m * 7 + k)
    a = rng.standard_normal((b, m, k)).astype(np.float32)
    for bi, i, j, val in bad:
        a[bi, i, j] = val
    if op == "hh":
        x = rng.standard_normal((b, m)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        for bi, i, val in vbad:
            x[bi, i] = val
    else:
        x = rng.standard_normal(b).astype(np.float32)
    return x, a


def _reference(op, x, a, gi=0, gj=0):
    if op == "hh":
        return np.asarray(jops.householder(jnp.asarray(x), jnp.asarray(a),
                                           interpret=True))
    return np.asarray(jops.givens(jnp.asarray(x), jnp.asarray(a), gi, gj,
                                  interpret=True))


def _ours(op, x, a, gi=0, gj=0):
    if op == "hh":
        return structured.householder_apply(x, a)
    return structured.givens_apply(x, a, gi, gj)


def _plain(op, x, a, gi=0, gj=0):
    if op == "hh":
        return structured.householder_plain(x, a)
    return structured.givens_plain(x, a, gi, gj)


def _same_nonfinite(ours, ref, tol=1e-5):
    """Same NaN positions, same ±inf values, finite parts within ``tol``."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    inf = np.isinf(ref)
    np.testing.assert_array_equal(ours[inf], ref[inf])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=tol, atol=tol)


def _max_norm(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("b,m,k", HOUSEHOLDER)
def test_householder_plain_matches_reference_at_the_item_edges(b, m, k):
    v, a = _inputs("hh", b, m, k)
    ref = _reference("hh", v, a)
    ours = _ours("hh", torch.from_numpy(v), torch.from_numpy(a)).numpy()
    assert ours.shape == (b, m, k) and ours.dtype == np.float32
    assert _max_norm(ours, ref) < 1e-5


@pytest.mark.parametrize("b,m,k,gi,gj", GIVENS)
def test_givens_plain_matches_reference_at_the_item_edges(b, m, k, gi, gj):
    th, a = _inputs("gv", b, m, k)
    ref = _reference("gv", th, a, gi, gj)
    ours = _ours("gv", torch.from_numpy(th), torch.from_numpy(a),
                 gi, gj).numpy()
    assert _max_norm(ours, ref) < 1e-5
    keep = [i for i in range(m) if i not in (gi, gj)]
    bf16_a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ours[:, keep], bf16_a[:, keep])


@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_plain_keeps_the_reference_nonfinite_pattern(case):
    op, b, m, k, gi, gj, bad, vbad = NONFINITE[case]
    x, a = _inputs(op, b, m, k, bad, vbad)
    ref = _reference(op, x, a, gi, gj)
    assert not np.isfinite(ref).all()
    _same_nonfinite(_ours(op, torch.from_numpy(x), torch.from_numpy(a),
                          gi, gj).numpy(), ref)


def test_householder_v_overflow_is_inf_in_the_rule():
    # v_7 = 3.4e38 (finite; its bf16 is inf, but v is never rounded): 2 v_7
    # overflows fp32, so row 7 and column 7 of H are ±inf and batch 1's row
    # 7 of the product is all ±inf/NaN; batch 0 stays finite.
    op, b, m, k, _, _, bad, vbad = NONFINITE["hh_v_bf16_overflow"]
    v, a = _inputs(op, b, m, k, bad, vbad)
    ours = _ours(op, torch.from_numpy(v), torch.from_numpy(a)).numpy()
    assert not np.isfinite(ours[1, 7]).any()
    assert np.isfinite(ours[0]).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card(op, b, m, k, dev, bad=(), vbad=(), offset=0):
    """The inputs on the card; A a contiguous view at ``offset`` elements
    into its storage."""
    x, a = _inputs(op, b, m, k, bad, vbad)
    base = torch.zeros(a.size + offset, dtype=torch.float32, device=dev)
    a_dev = base[offset:].view(b, m, k)
    a_dev.copy_(torch.from_numpy(a))
    return torch.from_numpy(x).to(dev), a_dev


def _launch_once(op, x, a, gi=0, gj=0):
    reset_launch_counts()
    out = _ours(op, x, a, gi, gj)
    torch.cuda.synchronize()
    name = "householder_apply" if op == "hh" else "givens_apply"
    assert {n: c for n, c in launch_counts().items() if c} == {name: 1}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HOUSEHOLDER + [(16384, 32, 64),
                                                 (512, 16, 64)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_householder_matches_plain(cuda_device, shape, offset):
    x, a = _card("hh", *shape, cuda_device, offset=offset)
    assert (a.data_ptr() % 16 == 0) == (offset == 0)
    got = _launch_once("hh", x, a)
    torch.testing.assert_close(got, _plain("hh", x, a), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GIVENS + [(32768, 32, 32, 3, 17)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_givens_matches_plain_and_keeps_rows(cuda_device, shape,
                                                  offset):
    b, m, k, gi, gj = shape
    x, a = _card("gv", b, m, k, cuda_device, offset=offset)
    got = _launch_once("gv", x, a, gi, gj)
    torch.testing.assert_close(got, _plain("gv", x, a, gi, gj), rtol=1e-5,
                               atol=1e-5)
    keep = [i for i in range(m) if i not in (gi, gj)]
    assert torch.equal(got[:, keep], a.to(torch.bfloat16).float()[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_cuda_keeps_the_plain_nonfinite_pattern(cuda_device, case):
    op, b, m, k, gi, gj, bad, vbad = NONFINITE[case]
    x, a = _card(op, b, m, k, cuda_device, bad, vbad)
    got = _launch_once(op, x, a, gi, gj)
    plain = _plain(op, x, a, gi, gj)
    assert not bool(torch.isfinite(plain).all())
    _same_nonfinite(got.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.cuda
def test_cuda_batches_past_the_grid_and_repeat_bits(cuda_device):
    # 40000 batches of (32, 36): more work items than the persistent grid
    # holds, so every block walks several; two calls give the same bits.
    x, a = _card("hh", 40000, 32, 36, cuda_device)
    got = _launch_once("hh", x, a)
    torch.testing.assert_close(got, _plain("hh", x, a), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, _ours("hh", x, a))
