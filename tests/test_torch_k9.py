"""K9 (``scan_cumsum``), the scan on the tensor cores, as redesigned for
Hopper: a streaming pass that multiplies by U's diagonal steps only, with a
running fp32 prefix over the steps' sums, and a stated non-finite rule in
place of the zero triangle's products.

On this CPU host the wrapper runs its plain PyTorch version (the full
product x·U per block), held here against the reference's Pallas kernel in
interpret mode where the zero triangle matters: a non-finite value at k > c
in c's block, and a finite value that bf16 rounds to ±inf.  The rule the
kernel states (column c is NaN when a non-finite bf16(x) sits at k > c in
its block) is held against the reference on inputs with one non-finite
value per row.  Inputs are made with numpy from a seed.  Tests marked
``cuda`` hold the kernel against its plain version (block_n 256, 8192, a
ragged block and an unaligned row length), the ±inf/NaN pattern across the
kernel's ring slots, and its launch counter; they need a card.
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

#: name -> (rows, n, block_n, [(row, column, value)]): non-finite values in
#: the zero triangle of a block (so earlier columns of that block turn
#: NaN), at a block's first and last column, in a second block, several in
#: one row, and finite values that bf16 rounds to ±inf.
NONFINITE = {
    "inf_mid_block": (4, 64, 32, [(1, 20, INF)]),
    "neg_inf_second_block": (4, 64, 32, [(2, 45, -INF)]),
    "nan_mid_block": (3, 48, 48, [(0, 30, NAN)]),
    "inf_block_edges": (4, 96, 48, [(0, 0, INF), (1, 47, INF),
                                    (2, 48, -INF)]),
    "two_in_one_row": (2, 128, 64, [(1, 10, INF), (1, 40, -INF),
                                    (0, 100, INF)]),
    "bf16_overflow": (5, 96, 32, [(1, 5, BIG), (3, 70, -BIG)]),
    "bf16_overflow_ragged": (3, 60, 20, [(0, 13, BIG), (2, 39, -BIG)]),
}


def _input(rows, n, bad=()):
    x = np.random.default_rng(rows * 1000 + n).standard_normal(
        (rows, n)).astype(np.float32)
    for r, c, v in bad:
        x[r, c] = v
    return x


def _same_nonfinite(ours, ref, tol=1e-5):
    """Same NaN positions, same ±inf values, finite parts within ``tol``."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    inf = np.isinf(ref)
    np.testing.assert_array_equal(ours[inf], ref[inf])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=tol, atol=tol)


def _reference(x, block_n):
    return np.asarray(jops.cumsum(jnp.asarray(x), block_n, interpret=True))


@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_plain_keeps_the_reference_nonfinite_pattern(case):
    rows, n, block_n, bad = NONFINITE[case]
    x = _input(rows, n, bad)
    ref = _reference(x, block_n)
    assert not np.isfinite(ref).all()
    _same_nonfinite(structured.scan_cumsum(torch.from_numpy(x),
                                           block_n).numpy(), ref)


def _rule_pattern(x, block_n):
    """The kernel's non-finite rule for inputs with at most one non-finite
    bf16 value per row (then nothing else can make a NaN but that value
    itself): column c of block b is NaN when the value sits in b at k > c,
    or when the value is a NaN at k <= c or in an earlier block; it is
    ±inf (the value's sign) at and after the value otherwise."""
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = np.full(x.shape, "fin", dtype="<U4")
    for r in range(x.shape[0]):
        pos = np.flatnonzero(~np.isfinite(xb[r]))
        assert len(pos) <= 1
        if not len(pos):
            continue
        k, v = int(pos[0]), xb[r, pos[0]]
        b0 = k - k % block_n
        for c in range(b0, x.shape[1]):
            want[r, c] = "nan" if np.isnan(v) else ("+inf" if v > 0
                                                     else "-inf")
        for c in range(b0, k):
            want[r, c] = "nan"
    return want


@pytest.mark.parametrize("case", ["inf_mid_block", "neg_inf_second_block",
                                  "nan_mid_block", "bf16_overflow"])
def test_the_nonfinite_rule_is_the_reference_pattern(case):
    rows, n, block_n, bad = NONFINITE[case]
    x = _input(rows, n, bad)
    ref = _reference(x, block_n)
    want = _rule_pattern(x, block_n)
    got = np.where(np.isnan(ref), "nan", np.where(
        np.isposinf(ref), "+inf", np.where(np.isneginf(ref), "-inf", "fin")))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

#: (rows, n, block_n): block_n 256 and 8192 at a few row tiles, a ragged
#: block (steps not all 16 wide), and row lengths that are not 16-byte
#: aligned (the kernel's 4-byte copies).
CARD = [(64, 2048, 256), (48, 16384, 8192), (24, 96, 48), (5, 60, 20),
        (7, 30, 10), (3, 35, 5), (17, 1000, 1000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,block_n", CARD)
def test_cuda_k9_matches_plain_with_one_launch(cuda_device, rows, n,
                                               block_n):
    x = torch.from_numpy(_input(rows, n)).to(cuda_device)
    reset_launch_counts()
    got = structured.scan_cumsum(x, block_n)
    torch.cuda.synchronize()
    assert launch_counts()["scan_cumsum"] == 1
    torch.testing.assert_close(got, structured.scan_cumsum_plain(x, block_n),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_k9_unaligned_view_matches_plain(cuda_device):
    # x's data starts 4 bytes into its storage: no 16-byte copies.
    base = torch.from_numpy(_input(9, 257)).to(cuda_device)
    x = base[:, 1:]
    got = structured.scan_cumsum(x, 64)
    torch.testing.assert_close(got, structured.scan_cumsum_plain(x, 64),
                               rtol=1e-4, atol=1e-4)


#: Non-finite values across the kernel's ring (slots of 128 columns):
#: in the zero triangle of the first slot, in later slots of the same
#: block, in a later block, at a block's last column, and a bf16 overflow.
CARD_NONFINITE = (40, 8192, 2048, [
    (1, 100, INF), (1, 1900, INF), (2, 3000, -BIG), (5, 700, NAN),
    (6, 4095, -INF), (17, 129, INF), (17, 127, -INF), (33, 8191, INF),
    (39, 6000, BIG)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["card"] + sorted(NONFINITE))
def test_cuda_k9_keeps_the_plain_nonfinite_pattern(cuda_device, case):
    rows, n, block_n, bad = CARD_NONFINITE if case == "card" \
        else NONFINITE[case]
    x = torch.from_numpy(_input(rows, n, bad)).to(cuda_device)
    got = structured.scan_cumsum(x, block_n)
    plain = structured.scan_cumsum_plain(x, block_n)
    assert not bool(torch.isfinite(plain).all())
    _same_nonfinite(got.cpu().numpy(), plain.cpu().numpy(), 1e-4)
