"""The structured-fragment kernels K7-K9 (``csrc/structured.cu``): the
paper's §4 workloads, each with a structured operand made from its rule in
the ``mma.sync`` registers and never stored.

Counterparts of ``repro.kernels.structured``.  Each wrapper launches its
CUDA kernel on CUDA tensors and runs its plain PyTorch version on CPU
tensors; there is no fallback from one to the other, and operands on two
devices raise.

  * ``householder_apply`` (K7) — (I - 2 v v^T) A per batch;
  * ``givens_apply`` (K8) — G(gi, gj, theta_b) A per batch; K7 and K8 are
    one kernel, a staged, pipelined pass: A through a ring of shared-memory
    slots by ``cp.async`` (each element read once from device memory where
    M <= 128), the rule's fragments made in registers, paired stores;
  * ``scan_cumsum`` (K9) — row-wise cumsum as blockwise x·U with the
    triangular ones U and a carried fp32 offset; the kernel computes only
    U's diagonal steps and a running prefix (``scan_launcher``).

All three run one bf16 pass: the structured operand and the data are
rounded to bf16 with the plain round-to-nearest-even cast (so a finite fp32
value above the bf16 maximum becomes ±inf, as in the reference), the
products are exact and summed in fp32.  The plain versions compute the
reference's oracles (``repro.kernels.ref``: ``householder_ref``,
``givens_ref``, ``scan_cumsum_ref``) with torch ops.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import fragment
from . import _build

__all__ = ["householder_apply", "givens_apply", "scan_cumsum",
           "householder_plain", "givens_plain", "scan_cumsum_plain",
           "householder_launcher", "givens_launcher", "scan_launcher"]

LAUNCHES_K7 = _build.counter("householder_apply")
LAUNCHES_K8 = _build.counter("givens_apply")
LAUNCHES_K9 = _build.counter("scan_cumsum")

_VP, _CI = ctypes.c_void_p, ctypes.c_int
#: C entry point -> argument types (library ``structured``, one pass).
_ENTRIES = {
    "repro_householder_apply": [_VP, _VP, _VP, _CI, _CI, _CI, _VP],
    "repro_givens_apply": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _VP],
    "repro_scan_cumsum": [_VP, _VP, _CI, _CI, _CI, _VP],
}


def _entry(name: str):
    lib = _build.load("structured", 1)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ENTRIES[name]
        fn.restype = _CI
    return lib, fn


def _bf16_mma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One bf16 pass: both operands rounded to bf16 (plain RNE), exact
    products summed in fp32."""
    return torch.matmul(x.to(torch.bfloat16).float(),
                        y.to(torch.bfloat16).float())


def _device(what: str, *xs: torch.Tensor) -> torch.device:
    """The one device of the operands; raises on mixed devices."""
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel or plain version on {dev}")
    return dev


def _batched(what: str, x: torch.Tensor, x_dims: str, a: torch.Tensor
             ) -> None:
    """Check that x is (b, m) or (b,) and a is (b, m, k) to match."""
    if x.dim() != len(x_dims.split(",")) or a.dim() != 3 \
            or tuple(a.shape[:x.dim()]) != tuple(x.shape):
        raise ValueError(f"{what}: expects ({x_dims}) and (b, m, k), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")


# ---------------------------------------------------------------------------
# K7: Householder
# ---------------------------------------------------------------------------

def householder_plain(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(b, m), (b, m, k) -> (I - 2 v v^T) A with one bf16 pass."""
    _batched("householder_apply", v, "b, m", a)
    return _bf16_mma(fragment.householder(v), a.float())


def householder_launcher(v: torch.Tensor, a: torch.Tensor):
    """Validate a K7 call on CUDA tensors and allocate its output; returns
    ``(out, launch)`` where ``launch()`` enqueues the kernel (counted)."""
    what = "householder_apply"
    _batched(what, v, "b, m", a)
    b, m, k = a.shape
    v32, a32 = v.float().contiguous(), a.float().contiguous()
    out = torch.empty(b, m, k, dtype=torch.float32, device=a.device)

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry("repro_householder_apply")
        rc = fn(v32.data_ptr(), a32.data_ptr(), out.data_ptr(), b, m, k,
                _build.stream_ptr(a.device))
        _build.check(lib, rc, what)
        LAUNCHES_K7.hit()

    return out, launch


def householder_apply(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(b, m) vectors + (b, m, k) matrices -> (b, m, k) = (I - 2vv^T) A,
    fp32, with H made from v in registers (K7) on CUDA tensors."""
    if _device("householder_apply", v, a).type == "cpu":
        return householder_plain(v, a)
    out, launch = householder_launcher(v, a)
    launch()
    return out


# ---------------------------------------------------------------------------
# K8: Givens
# ---------------------------------------------------------------------------

def givens_matrices(theta: torch.Tensor, m: int, gi: int, gj: int
                    ) -> torch.Tensor:
    """G(gi, gj, theta_b) for each angle, (b, m, m) fp32: the identity with
    c, c, s, -s set in the kernel's order (the last set wins)."""
    th = theta.float()
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    i = torch.arange(m, device=th.device)[:, None]
    j = torch.arange(m, device=th.device)[None, :]
    g = fragment.identity(m, device=th.device).expand(th.shape[0], m, m)
    g = torch.where((i == gi) & (j == gi), c, g)
    g = torch.where((i == gj) & (j == gj), c, g)
    g = torch.where((i == gi) & (j == gj), s, g)
    return torch.where((i == gj) & (j == gi), -s, g)


def givens_plain(theta: torch.Tensor, a: torch.Tensor, gi: int, gj: int
                 ) -> torch.Tensor:
    """(b,), (b, m, k) -> G(gi, gj, theta_b) A_b with one bf16 pass."""
    _batched("givens_apply", theta, "b", a)
    return _bf16_mma(givens_matrices(theta, a.shape[-2], gi, gj), a.float())


def givens_launcher(theta: torch.Tensor, a: torch.Tensor, gi: int, gj: int):
    """Validate a K8 call on CUDA tensors; returns ``(out, launch)``."""
    what = "givens_apply"
    _batched(what, theta, "b", a)
    b, m, k = a.shape
    th32, a32 = theta.float().contiguous(), a.float().contiguous()
    out = torch.empty(b, m, k, dtype=torch.float32, device=a.device)

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry("repro_givens_apply")
        rc = fn(th32.data_ptr(), a32.data_ptr(), out.data_ptr(), b, m, k,
                int(gi), int(gj), _build.stream_ptr(a.device))
        _build.check(lib, rc, what)
        LAUNCHES_K8.hit()

    return out, launch


def givens_apply(theta: torch.Tensor, a: torch.Tensor, gi: int, gj: int
                 ) -> torch.Tensor:
    """(b,) angles + (b, m, k) matrices -> G(gi, gj, theta_b) · A_b, fp32,
    with G made in registers (K8) on CUDA tensors.  ``gi``/``gj`` are
    runtime arguments of the kernel (the reference embeds them at trace
    time)."""
    if _device("givens_apply", theta, a).type == "cpu":
        return givens_plain(theta, a, gi, gj)
    out, launch = givens_launcher(theta, a, gi, gj)
    launch()
    return out


# ---------------------------------------------------------------------------
# K9: scan (cumsum) as x·U
# ---------------------------------------------------------------------------

def _scan_block(x: torch.Tensor, block_n: int) -> int:
    """The reference's block: ``min(block_n, n)``, which must divide n."""
    if x.dim() != 2:
        raise ValueError(f"scan_cumsum: x must be (rows, n), got "
                         f"{tuple(x.shape)}")
    n = x.shape[1]
    block_n = min(int(block_n), n)
    if block_n <= 0 or n % block_n:
        raise ValueError(f"cumsum needs n % block_n == 0, got {n} % "
                         f"{block_n}")
    return block_n


def scan_cumsum_plain(x: torch.Tensor, block_n: int = 256) -> torch.Tensor:
    """Blockwise bf16-pass cumsum: per block, x_blk · U plus the carried
    offset, whose new value is the block's last column."""
    block_n = _scan_block(x, block_n)
    rows, n = x.shape
    x = x.float()
    u = fragment.triangular_ones(block_n, device=x.device)
    outs = []
    carry = torch.zeros(rows, 1, dtype=torch.float32, device=x.device)
    for j0 in range(0, n, block_n):
        ob = _bf16_mma(x[:, j0:j0 + block_n], u) + carry
        carry = ob[:, -1:]
        outs.append(ob)
    return torch.cat(outs, dim=1)


def scan_launcher(x: torch.Tensor, block_n: int = 256):
    """Validate a K9 call on a CUDA tensor; returns ``(out, launch)``.  Any
    block_n that divides n.  The kernel streams x through a ring of fixed
    16 x 128 tiles whatever block_n is: per k16 step it multiplies by the
    diagonal step's triangle only, and a running fp32 prefix over the
    steps' sums (restarting at each block) stands in for the all-ones steps,
    the full product's sums in its order.  A non-finite bf16(x) at k > c
    in c's block makes column c NaN (the full product's inf * 0), so the
    result keeps the plain version's ±inf/NaN pattern."""
    what = "scan_cumsum"
    block_n = _scan_block(x, block_n)
    rows, n = x.shape
    x32 = x.float().contiguous()
    out = torch.empty(rows, n, dtype=torch.float32, device=x.device)

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry("repro_scan_cumsum")
        rc = fn(x32.data_ptr(), out.data_ptr(), rows, n, block_n,
                _build.stream_ptr(x.device))
        _build.check(lib, rc, what)
        LAUNCHES_K9.hit()

    return out, launch


def scan_cumsum(x: torch.Tensor, block_n: int = 256) -> torch.Tensor:
    """Row-wise cumulative sum of (rows, n) as blockwise x·U on the tensor
    cores with a carried block offset (two-level scan), fp32; K9 on a CUDA
    tensor.  ``block_n`` is cut to n and must divide it (``ValueError``)."""
    if _device("scan_cumsum", x).type == "cpu":
        return scan_cumsum_plain(x, block_n)
    out, launch = scan_launcher(x, block_n)
    launch()
    return out
