"""The TCEC matmul family: K2 (fused epilogue), K2b, K5, K6 and the
tuner-dispatched ``tcec_matmul_auto``.

Counterparts of ``repro.kernels.tcec_matmul`` (bf16 words; K2b also its vpu
arm).  Each wrapper launches its CUDA kernel on a CUDA tensor and runs its
plain PyTorch version on a CPU tensor; there is no fallback from one to the
other.

  * ``tcec_matmul_fused`` (K2, ``csrc/tcec_matmul_k2.cu``) — the epilogue
    (scale, bias, activation, residual, out dtype) fused into the store; the
    serving path's dense layers.  Any float input dtype: the kernel reads
    fp32 or bf16 operands at their own dtype — bf16 weights are never
    widened on the host.  Designed for decode shapes: ``k2_plan`` picks its
    tile from m and splits k across blocks so that a call fills the card;
    the split partials are added in split order by a second kernel that
    the same call enqueues.  Its ``frag=`` arm takes, in place of ``b``, a
    ``FragmentOperand`` on the rule menu (``tcec.triangular``, ``identity``,
    ``banded``) and makes the rule's values in the rhs fragment registers:
    no rhs byte is read or staged (the reference's ``"pallas_fragment"``).
  * ``tcec_matmul_pallas`` (K2b, ``csrc/tcec_matmul.cu``) — no epilogue,
    operands cast to fp32, fp32 out, over the tile menu (``_build.TILES``);
    words made in registers (the paper's WMMAe data flow); the vpu arm is a
    plain FFMA product (the paper's "FP32 SIMT" baseline).  ``k2b_plan``
    gives its persistent grid and its copy widths.
  * ``tcec_matmul_staged`` (K5, ``csrc/tcec_staged.cu``) and
    ``tcec_matmul_staged_db`` (K6) — the WMMA-API baseline: the host splits
    both operands into bf16 word arrays and the kernel stages every word
    tile in shared memory (K5 in one slot, each k step's copies all in
    flight before its passes; K6 through a two-slot ``cp.async``
    pipeline).  bf16 words only.  K2b, K5 and K6 give the same bits at the
    same tile.
  * ``tcec_matmul_auto`` — ``repro_torch.tune.matmul_plan`` picks (tile,
    variant) and the call goes to K2b, K5 or K6.

Shapes: a (m, k) or (b, m, k); b (k, n) or (b, k, n) (a batched rhs needs a
batched lhs).  Ragged edges are masked in the kernels, not padded on the
host.

The non-finite guard: corrected policies split sanitized operands and,
when an input was non-finite, the fp32 reference dot's ±inf/NaN entries
(through the epilogue) replace the kernel's at those positions.  On the card
it never reads the device from the host, as the reference's ``lax.cond``
does not: K2 and K2b raise a device flag while splitting, K5/K6 get theirs
from torch ops on the inputs, and the fix-up kernel
(``repro_torch.kernels.nonfinite``) reads the flag on the card and returns
at once when it is clear.  K2 enqueues the fix-up from its own entry point
(folded into its reduce kernel when the call has splits); the others call
it after their kernel.  The plain versions (CPU tensors) check on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch import tune
from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy, get_policy
from repro_torch.core.precision import split_words
from repro_torch.core.tcec import nonfinite_guard, sanitize_nonfinite
from repro_torch.tcec.epilogue import ACTIVATIONS
from repro_torch.tcec.operands import MENU_RULES, FragmentOperand
from . import _build
from .nonfinite import LAUNCHES as LAUNCHES_FIXUP
from .nonfinite import nonfinite_fixup, nonfinite_flag
from .tcec_core import dot_params, kernel_passes, policy_dot

__all__ = ["tcec_matmul_fused", "tcec_matmul_plain", "tcec_matmul_pallas",
           "tcec_matmul_staged", "tcec_matmul_staged_db",
           "tcec_matmul_staged_plain", "tcec_matmul_auto", "kernel_attrs",
           "k2_plan", "k2_passes", "K2Plan", "k2b_plan", "K2bPlan",
           "k2_attrs", "LAUNCHES"]

LAUNCHES = _build.counter("tcec_matmul")
#: K2's ``frag=`` arm (the rhs made from a menu rule in the kernel).
LAUNCHES_FRAG = _build.counter("tcec_matmul_frag")
#: K2's second kernel, which adds the split partials (calls with splits > 1).
LAUNCHES_REDUCE = _build.counter("tcec_matmul_reduce")
LAUNCHES_K2B = _build.counter("tcec_matmul_pallas")
LAUNCHES_K5 = _build.counter("tcec_matmul_staged")
LAUNCHES_K6 = _build.counter("tcec_matmul_staged_db")

_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
_FLOATS = (torch.float32, torch.bfloat16)
#: (m, k) | (b, m, k) against (k, n) | (b, k, n).
_EQ = "...mk,...kn->...mn"


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate (m,k)@(k,n) | (b,m,k)@(b,k,n) | (b,m,k)@(k,n); return
    (batch, m, n, k)."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"tcec matmul expects 2-D or 3-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 2 and b.dim() == 3:
        raise ValueError(f"broadcasting a 2-D lhs against a batched rhs is "
                         f"not supported: {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"contracting dims disagree: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch dims disagree: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    nb = a.shape[0] if a.dim() == 3 else 1
    return nb, m, n, k


def _needs_guard(pol: TcecPolicy) -> bool:
    return pol.backend == "mxu" and pol.error_correction


def _epilogue_ref(y: torch.Tensor, scale: float, bias, activation,
                  residual) -> torch.Tensor:
    if scale != 1.0:
        y = y * scale
    if bias is not None:
        y = y + bias.float()
    if activation is not None:
        y = ACTIVATIONS[activation](y)
    if residual is not None:
        y = y + residual.float()
    return y


def _matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 reference dot the non-finite guard takes its ±inf/NaN from."""
    return torch.matmul(a.float(), b.float())


def _check_frag(a: torch.Tensor, frag: FragmentOperand
                ) -> Tuple[int, int, int, int]:
    """Validate a (m, k) | (b, m, k) lhs against a (k, n) rhs rule; return
    (batch, m, n, k)."""
    if len(frag.shape) != 2:
        raise ValueError(f"in-kernel fragments must be 2-D (k, n), got "
                         f"{frag.shape}")
    k, n = frag.shape
    if a.dim() not in (2, 3) or a.shape[-1] != k:
        raise ValueError(f"lhs {tuple(a.shape)} does not contract with "
                         f"fragment {frag.shape}")
    return (a.shape[0] if a.dim() == 3 else 1), a.shape[-2], n, k


def _frag_rhs(a: torch.Tensor, frag: FragmentOperand) -> torch.Tensor:
    """The rule's (k, n) fp32 values on ``a``'s device, made as the kernel
    makes them, never built as an operand (a ``MenuRule``'s call is the
    plain version of the kernel's rule)."""
    _check_frag(a, frag)
    return frag.evaluate(a.device).to(torch.float32).broadcast_to(frag.shape)


def tcec_matmul_plain(a: torch.Tensor, b: Optional[torch.Tensor],
                      policy: TcecPolicy, *,
                      frag: Optional[FragmentOperand] = None, bias=None,
                      residual=None, scale: float = 1.0,
                      activation: Optional[str] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: ``policy_dot`` over the whole
    k on the sanitized operands (the kernel sums per k16 step; only the
    fp32 summation order differs), the epilogue, the guard.  With ``frag``
    (and ``b`` None) the rule is built on ``a``'s device first."""
    if frag is not None:
        b = _frag_rhs(a, frag)
    _check_shapes(a, b)
    guarded = _needs_guard(policy)
    aa, bb = (sanitize_nonfinite(a), sanitize_nonfinite(b)) if guarded \
        else (a, b)
    epilogue = functools.partial(_epilogue_ref, scale=scale, bias=bias,
                                 activation=activation, residual=residual)
    y = policy_dot(aa, bb, _EQ, **dot_params(policy))
    out = epilogue(y).to(out_dtype or torch.float32)
    if guarded:
        out = nonfinite_guard(out, a, b, _matmul32, post=epilogue)
    return out


# ---------------------------------------------------------------------------
# K2's plan
# ---------------------------------------------------------------------------

#: K2's tiles (``csrc/tcec_matmul_k2.cu``): name -> (code, rows, columns).
K2_TILES = {"decode": (0, 8, 32), "prefill": (1, 64, 64)}
#: The largest m that takes the decode tile.
K2_DECODE_M = 16
#: K2 aims at this many blocks per SM.
K2_BLOCKS_PER_SM = 2
#: The k granularity of a split (one mma.sync k step).
K2_K_STEP = 16


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """How K2 runs a call: ``tile`` (rows ``bm`` x columns ``bn`` per
    block), ``splits`` k ranges of ``chunk`` elements each (split s sums k
    in [s * chunk, min(k, (s + 1) * chunk))); ``blocks`` in all."""
    tile: str
    bm: int
    bn: int
    splits: int
    chunk: int
    blocks: int


def k2_plan(m: int, n: int, k: int, batch: int = 1, sms: int = 132
            ) -> K2Plan:
    """K2's plan for a (batch, m, k) @ (k, n) call on a card of ``sms``
    SMs: the decode tile up to m = 16, else the prefill tile; then as many
    splits of k (each a multiple of 16 elements, at least one k step) as
    bring the grid to at least ``K2_BLOCKS_PER_SM * sms`` blocks, where k
    allows.  A plain function of its arguments."""
    tile = "decode" if m <= K2_DECODE_M else "prefill"
    _, bm, bn = K2_TILES[tile]
    tiles = -(-n // bn) * -(-m // bm) * batch
    steps = max(1, -(-k // K2_K_STEP))
    want = -(-K2_BLOCKS_PER_SM * sms // tiles)
    splits = max(1, min(want, steps, 65535 // max(1, batch)))
    chunk_steps = steps // splits       # rounded down: at least `splits`
    splits = -(-steps // chunk_steps)
    return K2Plan(tile, bm, bn, splits, chunk_steps * K2_K_STEP,
                  tiles * splits)


def k2_passes(policy: TcecPolicy, a_dtype: torch.dtype,
              b_dtype: Optional[torch.dtype]) -> Tuple[Tuple[int, int], ...]:
    """The schedule passes (lhs word, rhs word) K2 runs for these operand
    dtypes, in schedule order: a bf16 operand is its own word 0 and its
    other words are exactly 0, so a pass that reads one of them adds
    nothing and is skipped.  ``b_dtype`` None: a menu rule rhs (``frag=``),
    whose values 0 and 1 are one bf16 word."""
    wa = 1 if a_dtype == torch.bfloat16 else policy.n_words
    wb = 1 if b_dtype in (torch.bfloat16, None) else policy.n_words
    return tuple((i, j) for i, j in policy.schedule if i < wa and j < wb)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_sms(dev: torch.device) -> int:
    """The SM count a plan is made for: the card's own, or an H100's 132
    for a CPU tensor (so a plain version splits as the kernel would
    there)."""
    if dev.type != "cuda":
        return 132
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
#: C entry point -> (library, argument types).
_ENTRIES = {
    "repro_tcec_matmul": ("tcec_matmul", [
        _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CLL, _CLL,
        _CI, _CI, _CI, ctypes.c_float, _CI, _CI, _CI, _CI,
        _CI, _CI, _CI, _VP, _CI, _CI, _CI, _VP]),
    "repro_tcec_matmul_passes_run": ("tcec_matmul", [_CI, _CI]),
    "repro_tcec_matmul_attrs": ("tcec_matmul", [
        _CI, _CI, _CI, _PI, _PI, _PI, _PI]),
    "repro_tcec_matmul_pallas": ("tcec_matmul_k2b", [
        _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CLL, _CLL, _CLL, _CI, _CI,
        _CI, _CI, _CI, _CI, _VP]),
    "repro_tcec_matmul_pallas_attrs": ("tcec_matmul_k2b", [
        _CI, _CI, _CI, _PI, _PI, _PI, _PI]),
    "repro_tcec_staged": ("tcec_staged", [
        _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CLL, _CLL, _CLL, _CLL,
        _CLL, _CI, _CI, _CI, _CI, _VP]),
    "repro_tcec_staged_attrs": ("tcec_staged", [
        _CI, _CI, _CI, _PI, _PI, _PI, _PI, _PI]),
}
#: What an attrs entry point reports, in its order.
_ATTRS = ("smem_bytes", "threads", "regs", "blocks_per_sm")
_ATTRS_STAGED = _ATTRS + ("local_bytes",)


def _entry(name: str, passes: int):
    """The loaded library holding C entry point ``name`` (built for
    ``passes``) and the entry point, argument types declared."""
    lib_name, argtypes = _ENTRIES[name]
    lib = _build.load(lib_name, passes)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _CI
    return lib, fn


def launcher(a, b, pol, bias=None, residual=None, scale=1.0,
             activation=None, out_dtype=None, frag=None):
    """Validate a CUDA call, plan it (``k2_plan``) and allocate its output
    and split workspace; ``frag`` (with ``b`` None) takes the ``frag=``
    arm, which raises on a rule off the menu.  Returns
    ``(out, flag, launch)`` where ``launch()``
    enqueues the call's device work on the current stream in one host call
    — K2 and, with more than one split, its reduce kernel (which under a
    guarded policy also runs the non-finite fix-up), else under a guarded
    policy the fix-up kernel; each counted, no host sync — and ``flag`` is
    the device int that a guarded policy's kernel sets on a non-finite input
    (``None`` when unguarded).  ``launch.plan`` is the plan.
    ``tcec_matmul_fused`` is this; timing code enqueues ``launch``."""
    what = "tcec_matmul"
    passes = kernel_passes(pol, what)
    if frag is None:
        nb, m, n, k = _check_shapes(a, b)
        rule = (-1, 0, 0)
    else:
        nb, m, n, k = _check_frag(a, frag)
        if frag.menu is None:
            raise NotImplementedError(
                f"{what}: the rule {frag.name!r} is off the kernel's menu "
                f"({', '.join(MENU_RULES)}); the frontend runs it on the "
                f"twin")
        rule = frag.menu
    dev = a.device
    for name, x in (("a", a), ("b", b), ("bias", bias), ("residual", residual)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, a on {dev}")
        if x.dtype not in _FLOATS:
            raise ValueError(f"{what}: {name} dtype {x.dtype} not in {_FLOATS}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if activation not in _ACT_CODES:
        raise ValueError(f"{what}: unknown activation {activation!r}")
    o_dt = out_dtype or torch.float32
    if o_dt not in _FLOATS:
        raise ValueError(f"{what}: out dtype {o_dt} not in {_FLOATS}")
    out_shape = (nb, m, n) if a.dim() == 3 else (m, n)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"{what}: residual {tuple(residual.shape)} != "
                         f"output {out_shape}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"{what}: bias shape {tuple(bias.shape)} != ({n},)")
    out = torch.empty(out_shape, dtype=o_dt, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev) \
        if _needs_guard(pol) else None
    plan = k2_plan(m, n, k, nb, _sm_count(dev.index if dev.index is not None
                                          else torch.cuda.current_device()))
    split = plan.splits > 1
    ws = torch.empty(plan.splits * out.numel(), dtype=torch.float32,
                     device=dev) if split else None
    bf = torch.bfloat16
    args = (a.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if flag is None else flag.data_ptr(),
            m, n, k, nb,
            m * k if a.dim() == 3 else 0,
            k * n if b is not None and b.dim() == 3 else 0,
            int(a.dtype == bf), int(b is None or b.dtype == bf), passes,
            float(scale), _ACT_CODES[activation],
            int(bias is not None and bias.dtype == bf),
            int(residual is not None and residual.dtype == bf),
            int(o_dt == bf), K2_TILES[plan.tile][0], plan.splits, plan.chunk,
            ws.data_ptr() if split else None, *rule)

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry("repro_tcec_matmul", passes)
        rc = fn(*args, _build.stream_ptr(dev))
        _build.check(lib, rc, what)
        (LAUNCHES if frag is None else LAUNCHES_FRAG).hit()
        if split:
            LAUNCHES_REDUCE.hit()
        elif flag is not None:
            LAUNCHES_FIXUP.hit()

    launch.plan = plan
    return out, flag, launch


def tcec_matmul_fused(a: torch.Tensor, b: Optional[torch.Tensor] = None,
                      policy: TcecPolicy | str | None = None, *,
                      frag: Optional[FragmentOperand] = None,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      scale: float = 1.0, activation: Optional[str] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """TCEC matmul with the epilogue applied at the store.  Pass exactly one
    of ``b`` (a tensor) and ``frag`` (a 2-D (k, n) ``FragmentOperand``,
    made in the kernel).

    A CUDA tensor launches the kernel (or raises on what it does not take:
    the vpu and int8 arms, non-contiguous operands, a rule off the menu); a
    CPU tensor runs the plain version.
    """
    if (b is None) == (frag is None):
        raise ValueError("pass exactly one of b= and frag=")
    pol = resolve_policy(policy)
    if a.is_cuda:
        out, _, launch = launcher(a, b, pol, bias, residual, scale,
                                  activation, out_dtype, frag)
        launch()
        return out
    return tcec_matmul_plain(a, b, pol, frag=frag, bias=bias,
                             residual=residual, scale=scale,
                             activation=activation, out_dtype=out_dtype)



# ---------------------------------------------------------------------------
# K2b, K5, K6: fp32 in, fp32 out, no epilogue, over the tile menu
# ---------------------------------------------------------------------------

def _tile(block, what: str) -> Tuple[int, int, int]:
    """The compiled tile for ``block`` (``None``: the default tile)."""
    tile = _build.DEFAULT_TILE if block is None else tuple(map(int, block))
    if tile not in _build.TILES:
        raise ValueError(f"{what}: tile {tile} is not compiled; the menu is "
                         f"{_build.TILES}")
    return tile


def _cuda_operands(a, b, what: str) -> Tuple[int, int, int, int]:
    nb, m, n, k = _check_shapes(a, b)
    if b.device != a.device:
        raise ValueError(f"{what}: b on {b.device}, a on {a.device}")
    return nb, m, n, k


def _out32(a: torch.Tensor, nb: int, m: int, n: int) -> torch.Tensor:
    return torch.empty((nb, m, n) if a.dim() == 3 else (m, n),
                       dtype=torch.float32, device=a.device)


def _fixup(out, pol, a, b, flag=None):
    """The non-finite guard of a corrected policy's result on the card: the
    fix-up kernel on ``flag`` (from torch ops on the inputs when the kernel
    raised none).  No host read."""
    if not _needs_guard(pol):
        return out
    a32, b32 = a.float(), b.float()
    if flag is None:
        flag = nonfinite_flag(a32, b32)
    return nonfinite_fixup(out, a32, b32, flag)


def _k2b_passes(pol: TcecPolicy, what: str) -> int:
    """The library K2b runs from: the vpu arm is built into the 1-pass
    library; the bf16 arms need their pass count."""
    return 1 if pol.backend == "vpu" else kernel_passes(pol, what)


#: K2b's k tile (``csrc/tcec_tile.cuh::BK``).
K2B_BK = 32


@dataclasses.dataclass(frozen=True)
class K2bPlan:
    """How K2b runs a call: ``items`` output tiles of ``steps`` k tiles
    each, walked by ``grid`` persistent blocks, ``per_block`` tiles at most
    each (block b takes tiles b, b + grid, ...); ``vec_a`` / ``vec_b``:
    whether A / B take 16-byte copies (else 4-byte)."""
    items: int
    steps: int
    grid: int
    per_block: int
    vec_a: bool
    vec_b: bool

    @property
    def vec(self) -> int:
        """The copy widths as the C entry point takes them."""
        return int(self.vec_a) | int(self.vec_b) << 1


def k2b_plan(m: int, n: int, k: int, batch: int, tile, resident: int,
             sms: int = 132, a_ptr: int = 0, b_ptr: int = 0) -> K2bPlan:
    """K2b's plan for a (batch, m, k) @ (k, n) call at ``tile`` (bm, bn, bk)
    on a card of ``sms`` SMs that holds ``resident`` of its blocks per SM:
    one block per output tile up to the blocks the card holds at once, and
    persistent blocks that share the tiles beyond that; 16-byte copies of an
    operand whose rows are whole 16-byte chunks (k, resp. n, a multiple of
    4) and whose base address ``a_ptr`` / ``b_ptr`` is 16-byte aligned.  A
    plain function of its arguments."""
    bm, bn = tile[0], tile[1]
    items = batch * -(-m // bm) * -(-n // bn)
    if items >= 2 ** 31:
        raise ValueError(f"tcec_matmul_pallas: {items} output tiles; the "
                         f"kernel counts them in 32 bits")
    grid = max(1, min(items, resident * sms))
    return K2bPlan(items, max(1, -(-k // K2B_BK)), grid, -(-items // grid),
                   k % 4 == 0 and a_ptr % 16 == 0,
                   n % 4 == 0 and b_ptr % 16 == 0)


@functools.lru_cache(maxsize=None)
def _k2b_resident(passes: int, vpu: bool, tile) -> int:
    """K2b's blocks per SM at ``tile`` as the card's occupancy calculator
    gives them (one query per kernel and process)."""
    return _attrs("repro_tcec_matmul_pallas_attrs", passes, int(vpu), tile,
                  "tcec_matmul_pallas")["blocks_per_sm"]


def pallas_launcher(a, b, pol: TcecPolicy, block=None):
    """Validate a K2b call, plan it (``k2b_plan``) and allocate its output;
    returns ``(out, flag, launch)`` as ``launcher`` does (``launch()``
    enqueues the kernel, counted; ``flag`` is the guard's device int or
    ``None``; ``launch.plan`` is the plan)."""
    what = "tcec_matmul_pallas"
    passes = _k2b_passes(pol, what)
    vpu = pol.backend == "vpu"
    tile = _tile(block, what)
    nb, m, n, k = _cuda_operands(a, b, what)
    a32, b32 = a.float().contiguous(), b.float().contiguous()
    out = _out32(a, nb, m, n)
    flag = torch.zeros(1, dtype=torch.int32, device=a.device) \
        if _needs_guard(pol) else None
    plan = k2b_plan(m, n, k, nb, tile, _k2b_resident(passes, vpu, tile),
                    plan_sms(a.device), a32.data_ptr(), b32.data_ptr())

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry("repro_tcec_matmul_pallas", passes)
        rc = fn(a32.data_ptr(), b32.data_ptr(), out.data_ptr(),
                None if flag is None else flag.data_ptr(), m, n, k, nb,
                m * k if a.dim() == 3 else 0, k * n if b.dim() == 3 else 0,
                m * n, passes, int(vpu), tile[0], tile[1], plan.grid,
                plan.vec, _build.stream_ptr(a.device))
        _build.check(lib, rc, what)
        LAUNCHES_K2B.hit()

    launch.plan = plan
    return out, flag, launch


def tcec_matmul_pallas(a: torch.Tensor, b: torch.Tensor,
                       policy: TcecPolicy | str | None = None,
                       block: Optional[Tuple[int, int, int]] = None
                       ) -> torch.Tensor:
    """K2b: C = A @ B at the policy's precision, words split in registers
    (vpu policies: a plain fp32 product).  fp32 out.

    On a CUDA tensor ``block`` is a tile of ``_build.TILES`` (``None``: the
    default tile) and the result is the same bits at every tile; a CPU
    tensor runs the plain version, which has no tile.
    """
    pol = resolve_policy(policy)
    if a.is_cuda:
        out, flag, launch = pallas_launcher(a, b, pol, block)
        launch()
        return _fixup(out, pol, a, b, flag)
    return tcec_matmul_plain(a.float(), b.float(), pol)


def _staged_policy(pol: TcecPolicy, what: str) -> None:
    if pol.backend == "vpu":
        raise ValueError(
            f"{what} stages bf16 split words by construction; a vpu "
            f"(plain-fp32) policy has no staged data flow — use "
            f"tcec_matmul_pallas, which honors backend=\"vpu\" exactly")
    if pol.word_dtype != "bf16":
        raise ValueError(
            f"{what} stages bf16 split words by construction; "
            f"word_dtype={pol.word_dtype!r} policies generate per-tile-"
            f"scaled words on the fly — use tcec_matmul_pallas")


def _staged_words(x: torch.Tensor, n_words: int, ld: int) -> torch.Tensor:
    """``(n_words, *x.shape[:-1], ld)`` bf16: the words of fp32 ``x``, rows
    zero-padded to ``ld`` elements (zero splits to zero words)."""
    if ld != x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, ld - x.shape[-1]))
    return torch.stack(split_words(x, n_words))


def staged_launcher(a, b, pol: TcecPolicy, block=None,
                    double_buffer: bool = False):
    """Validate a K5 (K6 with ``double_buffer``) call, split the operands
    into their word arrays on the host and allocate the output; returns
    ``(out, launch)``.  ``launch()`` enqueues the kernel alone (counted)."""
    what = "tcec_matmul_staged_db" if double_buffer else "tcec_matmul_staged"
    _staged_policy(pol, what)
    passes = kernel_passes(pol, what)
    tile = _tile(block, what)
    nb, m, n, k = _cuda_operands(a, b, what)
    a32, b32 = a.float(), b.float()
    if _needs_guard(pol):
        a32, b32 = sanitize_nonfinite(a32), sanitize_nonfinite(b32)
    # Rows of the word arrays are padded to 8 elements (16 bytes), so the
    # kernel's 16-byte copies stay aligned.
    ldk, ldn = -(-k // 8) * 8, -(-n // 8) * 8
    aw = _staged_words(a32, pol.n_words, ldk)
    bw = _staged_words(b32, pol.n_words, ldn)
    out = _out32(a, nb, m, n)
    counter = LAUNCHES_K6 if double_buffer else LAUNCHES_K5

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry("repro_tcec_staged", passes)
        rc = fn(aw.data_ptr(), bw.data_ptr(), out.data_ptr(), m, n, k, ldk,
                ldn, nb, aw[0].numel(), bw[0].numel(),
                m * ldk if a.dim() == 3 else 0,
                k * ldn if b.dim() == 3 else 0, m * n, passes, tile[0],
                tile[1], int(double_buffer), _build.stream_ptr(a.device))
        _build.check(lib, rc, what)
        counter.hit()

    return out, launch


def tcec_matmul_staged_plain(a: torch.Tensor, b: torch.Tensor,
                             policy: TcecPolicy) -> torch.Tensor:
    """The plain version of K5 and K6: the host split of both operands,
    then the scheduled passes on the words (``policy_dot``) and the guard —
    the arithmetic of ``tcec_matmul_pallas``'s plain version, which is why
    K2b, K5 and K6 agree bit for bit."""
    _staged_policy(policy, "tcec_matmul_staged")
    return tcec_matmul_plain(a.float(), b.float(), policy)


def _staged(a, b, policy, block, double_buffer):
    pol = resolve_policy(policy)
    if a.is_cuda:
        out, launch = staged_launcher(a, b, pol, block, double_buffer)
        launch()
        return _fixup(out, pol, a, b)
    return tcec_matmul_staged_plain(a, b, pol)


def tcec_matmul_staged(a: torch.Tensor, b: torch.Tensor,
                       policy: TcecPolicy | str | None = None,
                       block: Optional[Tuple[int, int, int]] = None
                       ) -> torch.Tensor:
    """K5, the WMMA-API baseline data flow: the bf16 words are split on the
    host and every word tile is staged in shared memory.  Same shapes and
    (bitwise) results as ``tcec_matmul_pallas``; bf16 words only (vpu and
    int8 policies raise ``ValueError``)."""
    return _staged(a, b, policy, block, False)


def tcec_matmul_staged_db(a: torch.Tensor, b: torch.Tensor,
                          policy: TcecPolicy | str | None = None,
                          block: Optional[Tuple[int, int, int]] = None
                          ) -> torch.Tensor:
    """K6: K5 with a two-slot ``cp.async`` pipeline — the copy of k tile
    k+1 overlaps the passes of tile k.  Same shapes, policies and (bitwise)
    results as ``tcec_matmul_staged``."""
    return _staged(a, b, policy, block, True)


def tcec_matmul_auto(a: torch.Tensor, b: torch.Tensor,
                     policy: TcecPolicy | str | None = None,
                     site: str = "auto") -> torch.Tensor:
    """Tuner-dispatched matmul: ``repro_torch.tune.matmul_plan`` picks
    (tile, variant) over the fused/staged/staged_db/vpu space and the call
    goes to K2b, K5 or K6.  With ``REPRO_TUNE=off`` it is
    ``tcec_matmul_pallas`` at the default tile.  ``measure`` times the
    kernels on the card, so it raises for a CPU tensor."""
    pol = resolve_policy(policy)
    nb, m, n, k = _check_shapes(a, b)
    if tune.mode() == "measure" and not a.is_cuda:
        raise ValueError(
            "tcec_matmul_auto: REPRO_TUNE=measure times the CUDA kernels; "
            "a CPU tensor has none (use 'analytic' or 'off')")
    plan = tune.matmul_plan(m, n, k, policy=pol, batch=nb,
                            rhs_batched=b.dim() == 3, site=site)
    if plan is None or plan.variant in ("fused", "vpu"):
        return tcec_matmul_pallas(a, b, pol,
                                  None if plan is None else plan.block)
    if plan.variant == "staged":
        return tcec_matmul_staged(a, b, pol, plan.block)
    return tcec_matmul_staged_db(a, b, pol, plan.block)


def kernel_attrs(variant: str, block, policy: TcecPolicy | str) -> dict:
    """What the card gives the kernel of ``variant`` at tile ``block`` under
    ``policy``'s pass count: the shared memory a block asks for (static +
    dynamic bytes), its threads, registers per thread, and how many of its
    blocks fit on one SM at once (the CUDA occupancy calculator); for K5
    and K6 also ``local_bytes``, local memory per thread (spills and
    stack)."""
    pol = get_policy(policy)
    tile = _tile(block, "kernel_attrs")
    if variant in ("fused", "vpu"):
        return _attrs("repro_tcec_matmul_pallas_attrs",
                      _k2b_passes(pol, "kernel_attrs"),
                      int(variant == "vpu"), tile, "kernel_attrs")
    if variant in ("staged", "staged_db"):
        return _attrs("repro_tcec_staged_attrs",
                      kernel_passes(pol, "kernel_attrs"),
                      int(variant == "staged_db"), tile, "kernel_attrs")
    raise ValueError(f"unknown variant {variant!r}")


def k2_attrs(tile: str, a_dtype: torch.dtype, b_dtype: Optional[torch.dtype],
             policy: TcecPolicy | str) -> dict:
    """What the card gives K2's kernel at ``tile`` (a key of ``K2_TILES``)
    for these operand dtypes (``b_dtype`` None: the ``frag=`` arm) under
    ``policy``'s pass count: its shared memory per block (all static), its
    threads, registers per thread and resident blocks per SM."""
    b_kind = 2 if b_dtype is None else int(b_dtype == torch.bfloat16)
    return _attrs("repro_tcec_matmul_attrs",
                  kernel_passes(get_policy(policy), "k2_attrs"),
                  2 * b_kind + int(a_dtype == torch.bfloat16),
                  K2_TILES[tile][1:], "k2_attrs")


def _attrs(entry: str, passes: int, which: int, tile, what: str) -> dict:
    lib, fn = _entry(entry, passes)
    keys = _ATTRS_STAGED if entry == "repro_tcec_staged_attrs" else _ATTRS
    vals = [ctypes.c_int() for _ in keys]
    rc = fn(which, tile[0], tile[1], *map(ctypes.byref, vals))
    _build.check(lib, rc, what)
    return dict(zip(keys, (v.value for v in vals)))
