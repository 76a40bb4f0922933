"""QuantPolicy: which dtype every piece of GaLore optimizer state uses.

Rides the SubspacePlan machinery in core/subspace.py — the policy is
resolved ONCE per leaf into `SubspacePlan.moments` / `SubspacePlan.proj_store`
and every consumer (state init, the fused kernels, the composable oracle,
sharding-axes derivation, checkpointing, memory accounting) reads the plan,
so a leaf can never be quantized in one layer and fp32 in another.

min_quant_size semantics (the historical inconsistency this fixes): the
floor is compared against the LEAF'S LOGICAL element count — the full
weight for galore leaves, the leaf itself for passthrough leaves. The old
galore(scale_by_adam8bit) composition compared the COMPACT moment size
(r × n), so a large weight whose projected moments dipped under the
threshold silently fell back to fp32 while its sharding axes and memory
accounting assumed int8. Deciding on the weight restores the bitsandbytes
intent: small leaves (biases, norms) stay fp32 because they are small
PARAMETERS, not because a projection shrank their statistics.
"""
from __future__ import annotations

import dataclasses

MIN_QUANT_SIZE = 4096

MOMENT_MODES = ("fp32", "int8")
PROJ_MODES = ("fp32", "bf16", "int4")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Low-precision storage policy for GaLore optimizer state.

    moments     "fp32" | "int8" — compact moments M/V of galore leaves AND
                full-shape moments of passthrough leaves (embeddings etc.),
                blockwise dynamic-exponent INT8 (quant/codec.py).
    projectors  "fp32" | "bf16" | "int4" — persistent storage of P; int4 is
                the packed Q-GaLore format (dequantized on read, ~8× smaller
                than fp32).
    min_quant_size  leaves with fewer LOGICAL elements than this stay fp32
                (see module docstring — the weight's size, not the compact
                moment's).
    lazy_refresh  int4 projectors only: when a refresh leaves the quantized
                codes bit-identical, keep the old state (no code/scale
                churn) — the Q-GaLore observation that most refreshes do not
                move the quantized projector. Composes with adaptive_t,
                which additionally stretches the period so the SVD itself
                is skipped on stable leaves.
    stochastic_round  int8 moments only: Q-GaLore stochastic rounding on the
                requant — codes round up with probability equal to the
                fractional position between bracketing codebook values,
                keyed on (element index, step count), so small-|m| updates
                are unbiased in expectation instead of repeatedly snapping
                to the same nearest code. Off by default (deterministic
                nearest-code stays the bitwise-reference behavior).
    overrides   ((path_substring, moments|"", projectors|""), ...) — first
                match wins, "" inherits the global mode; mirrors
                GaLoreConfig.rank_overrides.
    """

    moments: str = "fp32"
    projectors: str = "fp32"
    min_quant_size: int = MIN_QUANT_SIZE
    lazy_refresh: bool = False
    stochastic_round: bool = False
    overrides: tuple = ()

    def __post_init__(self):
        if self.moments not in MOMENT_MODES:
            raise ValueError(f"moments must be one of {MOMENT_MODES}, got {self.moments!r}")
        if self.projectors not in PROJ_MODES:
            raise ValueError(f"projectors must be one of {PROJ_MODES}, got {self.projectors!r}")

    @property
    def active(self) -> bool:
        """True when any leaf could store non-fp32 state."""
        if self.moments != "fp32" or self.projectors != "fp32":
            return True
        return any(m or p for _, m, p in self.overrides)

    @property
    def quantizes_moments(self) -> bool:
        if self.moments == "int8":
            return True
        return any(m == "int8" for _, m, _ in self.overrides)

    def resolve(self, path: str, logical_size: int) -> tuple[str, str]:
        """(moments_mode, projector_mode) for one leaf.

        `logical_size` is the leaf's full (pre-projection) element count —
        the min_quant_size gate applies to it for moments; projector storage
        has no size floor (a projector only exists for galore leaves, which
        already passed the rank gate)."""
        moments, proj = self.moments, self.projectors
        for pattern, m, p in self.overrides:
            if pattern in path:
                moments = m or moments
                proj = p or proj
                break
        if logical_size < self.min_quant_size:
            moments = "fp32"
        return moments, proj
