"""Policy-based design for TCEC matmuls — mirrors WMMAe-TCEC's policy template.

A copy of ``repro.core.policy`` (pure Python, kept here so the port never
imports the JAX package).  The paper's WMMAe-TCEC fragment takes an optional
*policy* template parameter selecting (1) wmma vs mma instruction, (2) error
correction on/off, (3) Tensor Core vs software systolic backend.  The facets:

  * ``backend``      — "mxu" (tensor cores, low-precision passes) vs "vpu"
                       (plain FP32 dot; the FP32-SIMT analogue).
  * ``passes``       — error-correction depth: 1 (plain cast/quantize),
                       3 (2-word split, ~fp24), 6 (3-word split, ~fp32,
                       the paper-equivalent accuracy point), 9 (all terms).
  * ``word_dtype``   — what each split word is stored as: ``"bf16"``
                       (Dekker-exact mantissa splits, the paper's scheme) or
                       ``"int8"`` (per-tile-scaled quantization; not ported
                       yet — the port raises ``NotImplementedError``).
  * ``fragment_gen`` — "on_the_fly" (WMMAe: split words generated in
                       registers, no staged split matrices — the paper's
                       footprint reduction) vs "staged" (WMMA-API baseline).
  * ``kernel``       — "xla" runs the split schedule as plain torch ops (the
                       twin); "pallas" routes eligible sites onto the
                       hand-written CUDA kernels of ``repro_torch.kernels``.
                       The value keeps the reference's name so policy names
                       and tables stay identical across the two packages.

Policies live in a single process-wide *registry*: the built-in presets
plus anything added via ``register_policy(name, TcecPolicy(...))``.  ``PRESETS``
is a read-only live view of that registry.  Scoped resolution
(``policy_scope`` / ``resolve``) lives in ``repro_torch.core.context``.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Literal, Tuple

Backend = Literal["mxu", "vpu"]
FragmentGen = Literal["on_the_fly", "staged"]
Kernel = Literal["xla", "pallas"]
WordDtype = Literal["bf16", "int8"]

# ---------------------------------------------------------------------------
# Pass schedules — THE single source of truth for (word_dtype, passes).
#
# Each entry maps to the cross-term schedule ``((a_word_idx, b_word_idx), …)``
# in smallest-magnitude-first order so FP32 accumulation preserves low bits
# (word magnitudes: hi ~ 1, mid ~ 2^-8, lo ~ 2^-16 relative for bf16; for
# int8 each word's per-tile scale shrinks by ~2^-8 per level, so the same
# index-sum ordering holds).  ``TcecPolicy.n_words`` and ``VALID_PASSES`` are
# *derived* from this table — there is no second copy to drift (the old
# hand-synced triple of VALID_PASSES / an inline n_words dict /
# core.tcec._SCHEDULES failed silently at first dot when edited unevenly).
# ---------------------------------------------------------------------------
SCHEDULES: Dict[Tuple[str, int], Tuple[Tuple[int, int], ...]] = {
    ("bf16", 1): ((0, 0),),
    ("bf16", 3): ((1, 0), (0, 1), (0, 0)),
    ("bf16", 6): ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)),
    ("bf16", 9): (
        (2, 2), (2, 1), (1, 2),
        (2, 0), (1, 1), (0, 2),
        (1, 0), (0, 1), (0, 0),
    ),
    ("int8", 1): ((0, 0),),
    ("int8", 3): ((1, 0), (0, 1), (0, 0)),
    ("int8", 6): ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)),
}


def schedule_for(word_dtype: str, passes: int) -> Tuple[Tuple[int, int], ...]:
    """The cross-term pass schedule for a (word_dtype, passes) point."""
    try:
        return SCHEDULES[(word_dtype, passes)]
    except KeyError:
        valid = valid_passes(word_dtype)
        raise ValueError(
            f"no {word_dtype} schedule for passes={passes}; valid pass "
            f"counts for {word_dtype!r}: {valid}") from None


def schedule_n_words(schedule: Tuple[Tuple[int, int], ...]) -> int:
    """Words per operand a schedule requires (highest word index + 1)."""
    return 1 + max(max(i, j) for (i, j) in schedule)


def valid_passes(word_dtype: str) -> Tuple[int, ...]:
    return tuple(sorted(p for (dt, p) in SCHEDULES if dt == word_dtype))


#: Back-compat view: the bf16 pass counts (the original single-dtype table).
VALID_PASSES = valid_passes("bf16")


def _check_schedule_table() -> None:
    """Import-time consistency check over the schedule table.

    Raises immediately (not at first dot) if a schedule is malformed: word
    indices must be contiguous from 0 (a gap means a word is generated but
    never used, or used but never generated) and the pass count must equal
    the schedule length.
    """
    for (dt, passes), sched in SCHEDULES.items():
        if len(sched) != passes:
            raise RuntimeError(
                f"SCHEDULES[{(dt, passes)}] has {len(sched)} terms; the key "
                f"promises {passes} passes")
        used = {i for pair in sched for i in pair}
        nw = schedule_n_words(sched)
        if used != set(range(nw)):
            raise RuntimeError(
                f"SCHEDULES[{(dt, passes)}] uses word indices {sorted(used)}; "
                f"expected contiguous 0..{nw - 1}")


_check_schedule_table()


@dataclasses.dataclass(frozen=True)
class TcecPolicy:
    passes: int = 6
    backend: Backend = "mxu"
    fragment_gen: FragmentGen = "on_the_fly"
    #: Which implementation eligible sites dispatch to.  ``"xla"`` is the
    #: torch-op TCEC twin; ``"pallas"`` routes 2-D/batched matmuls, prefill
    #: attention and paged decode attention through the hand-written CUDA
    #: kernels (in-register splitting, the paper's footprint-reduced data
    #: flow).  Sites a kernel cannot express stay on the twin.
    kernel: Kernel = "xla"
    #: Storage dtype of each split word.  ``"bf16"`` words are Dekker-exact
    #: mantissa slices; ``"int8"`` words are per-tile-scaled quantizations of
    #: the running residual (int32 MMA accumulation, rescaled to fp32).
    word_dtype: WordDtype = "bf16"

    def __post_init__(self):
        if self.backend not in ("mxu", "vpu"):
            raise ValueError(f"bad backend {self.backend}")
        if self.fragment_gen not in ("on_the_fly", "staged"):
            raise ValueError(f"bad fragment_gen {self.fragment_gen}")
        if self.kernel not in ("xla", "pallas"):
            raise ValueError(f"bad kernel {self.kernel}")
        if self.word_dtype not in ("bf16", "int8"):
            raise ValueError(f"bad word_dtype {self.word_dtype}")
        if (self.word_dtype, self.passes) not in SCHEDULES:
            raise ValueError(
                f"passes must be one of {valid_passes(self.word_dtype)} for "
                f"word_dtype={self.word_dtype!r}, got {self.passes}")
        if self.word_dtype == "int8" and self.backend == "vpu":
            raise ValueError("int8 words require the mxu backend (the vpu "
                             "path is a plain fp32 dot)")
        if self.word_dtype == "int8" and self.fragment_gen == "staged":
            raise ValueError(
                "int8 words are generated on the fly (per-tile scales are "
                "resolved inside the split schedule; there is no staged "
                "int8 data flow)")

    @property
    def schedule(self) -> Tuple[Tuple[int, int], ...]:
        """The cross-term pass schedule this policy executes."""
        return schedule_for(self.word_dtype, self.passes)

    @property
    def n_words(self) -> int:
        """How many split words per input matrix this policy generates.

        Derived from the schedule (highest word index + 1) — never a second
        hand-maintained table.
        """
        return schedule_n_words(self.schedule)

    @property
    def error_correction(self) -> bool:
        return self.passes > 1

    def flops_multiplier(self) -> int:
        """MXU passes per logical matmul (the paper divides peak by 3 for fp16)."""
        return self.passes if self.backend == "mxu" else 1


# Presets -------------------------------------------------------------------
BF16X1 = TcecPolicy(passes=1)
BF16X3 = TcecPolicy(passes=3)
BF16X6 = TcecPolicy(passes=6)          # paper-equivalent accuracy point
BF16X9 = TcecPolicy(passes=9)
FP32_VPU = TcecPolicy(passes=1, backend="vpu")           # "FP32 SIMT" analogue
# WMMA-API-only baseline: error correction with *staged* split matrices.
BF16X3_STAGED = TcecPolicy(passes=3, fragment_gen="staged")
BF16X6_STAGED = TcecPolicy(passes=6, fragment_gen="staged")
# Kernel dispatch: eligible sites run the hand-written CUDA kernels.
BF16X3_PALLAS = TcecPolicy(passes=3, kernel="pallas")
BF16X6_PALLAS = TcecPolicy(passes=6, kernel="pallas")
# Quantized TCEC: int8 words with per-tile scales.  Named by WORD count
# (int8xN = N words), unlike the pass-count-named bf16 presets: each int8
# word is one byte, so the word count is the traffic story.
INT8X1 = TcecPolicy(passes=1, word_dtype="int8")
INT8X2 = TcecPolicy(passes=3, word_dtype="int8")
INT8X3 = TcecPolicy(passes=6, word_dtype="int8")
INT8X2_PALLAS = TcecPolicy(passes=3, word_dtype="int8", kernel="pallas")
INT8X3_PALLAS = TcecPolicy(passes=6, word_dtype="int8", kernel="pallas")

# ---------------------------------------------------------------------------
# Registry: built-in presets + user registrations, one namespace.
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, TcecPolicy] = {
    "bf16x1": BF16X1,
    "bf16x3": BF16X3,
    "bf16x6": BF16X6,
    "bf16x9": BF16X9,
    "fp32_vpu": FP32_VPU,
    "bf16x3_staged": BF16X3_STAGED,
    "bf16x6_staged": BF16X6_STAGED,
    "bf16x3_pallas": BF16X3_PALLAS,
    "bf16x6_pallas": BF16X6_PALLAS,
    "int8x1": INT8X1,
    "int8x2": INT8X2,
    "int8x3": INT8X3,
    "int8x2_pallas": INT8X2_PALLAS,
    "int8x3_pallas": INT8X3_PALLAS,
}
_BUILTIN_NAMES = frozenset(_REGISTRY)

# Every registered policy's (word_dtype, passes) must resolve to a schedule.
# TcecPolicy.__post_init__ enforces this for each instance, so the registry
# invariant holds for user registrations too; assert it once at import for
# the built-ins (a drifted table now fails here, not at first dot).
for _name, _pol in _REGISTRY.items():
    if (_pol.word_dtype, _pol.passes) not in SCHEDULES:
        raise RuntimeError(
            f"built-in policy {_name!r} has no schedule entry for "
            f"({_pol.word_dtype}, {_pol.passes})")

# Read-only live view of the registry.  Mutating it raises TypeError; user
# registrations made through register_policy() appear here immediately, so
# the preset table and the registry cannot drift apart.
PRESETS: types.MappingProxyType = types.MappingProxyType(_REGISTRY)


def register_policy(name: str, policy: TcecPolicy, *,
                    overwrite: bool = False) -> TcecPolicy:
    """Register a custom policy under ``name`` (e.g. a bespoke pass schedule
    point or a staged baseline variant) so it can be resolved anywhere a
    policy name is accepted — ``get_policy``, ``policy_scope``, config
    ``policy_overrides``, benchmark sweeps.

    Raises on duplicate names unless ``overwrite=True``; built-in presets can
    never be replaced.
    """
    if not isinstance(name, str) or not name:
        raise TypeError(f"policy name must be a non-empty str, got {name!r}")
    if not isinstance(policy, TcecPolicy):
        raise TypeError(f"policy must be a TcecPolicy, got {type(policy).__name__}")
    if name in _BUILTIN_NAMES:
        raise ValueError(f"cannot overwrite built-in policy {name!r}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"policy {name!r} is already registered; pass overwrite=True to "
            f"replace it")
    _REGISTRY[name] = policy
    return policy


def unregister_policy(name: str) -> None:
    """Remove a user-registered policy.  Built-ins are protected."""
    if name in _BUILTIN_NAMES:
        raise ValueError(f"cannot unregister built-in policy {name!r}")
    if name not in _REGISTRY:
        raise KeyError(f"policy {name!r} is not registered")
    del _REGISTRY[name]


def registered_policies() -> Tuple[str, ...]:
    """All resolvable policy names (built-in presets + user-registered)."""
    return tuple(sorted(_REGISTRY))


def get_policy(name_or_policy) -> TcecPolicy:
    if isinstance(name_or_policy, TcecPolicy):
        return name_or_policy
    try:
        return _REGISTRY[name_or_policy]
    except (KeyError, TypeError):
        raise KeyError(
            f"unknown TCEC policy {name_or_policy!r}; registered policies: "
            f"{sorted(_REGISTRY)}") from None
