"""Model / training configuration dataclasses + the architecture registry.

The port's own copy of ``repro/configs/base.py``: ``ModelConfig`` whole, and
the ``GaLoreConfig`` / ``TrainConfig`` fields the ported training path reads,
the data-parallel ones included (``unit_costs``, ``zero``, ``tp_aware_side``,
``galore_dp_compress``, ``galore_refresh_shard``, ``galore_calibrate_costs``,
``galore_recalibrate_every``, ``galore_zero``; distributed/world.py). Field
names and defaults are the reference's, so a config built here means the
same run as one built there.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

from repro_torch.quant.policy import QuantPolicy


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_style: str = "rope"  # rope | mrope | none
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    attention_chunk: int = 0
    full_attn_every: int = 0
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (jamba) ---
    attn_every: int = 0
    attn_offset: int = 4
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- frontend stubs (vlm / audio) ---
    media_embeds: int = 0
    # --- misc ---
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sub_quadratic: bool = False
    remat: str = "none"
    scan_unroll: bool = False
    logit_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256; logits for pad slots
        are masked out."""
        return ((self.vocab_size + 255) // 256) * 256

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer % self.moe_every == self.moe_offset

    def is_attn_layer(self, layer: int) -> bool:
        if self.family != "hybrid":
            return True
        return layer % self.attn_every == self.attn_offset

    def uses_full_attn(self, layer: int) -> bool:
        if self.full_attn_every <= 0:
            return self.attention_chunk == 0
        return (layer + 1) % self.full_attn_every == 0

    def supports_shape(self, shape_name: str) -> tuple[bool, str]:
        cell = SHAPES[shape_name]
        if cell.name == "long_500k" and not self.sub_quadratic:
            return False, "long_500k skipped: pure full-attention arch"
        return True, ""


@dataclasses.dataclass(frozen=True)
class GaLoreConfig:
    rank: int = 128
    update_freq: int = 200  # T — subspace change frequency
    scale: float = 0.25  # alpha
    projector: str = "svd"  # svd | randomized | newton_schulz
    power_iters: int = 2  # subspace/power iterations for randomized modes
    min_dim: int = 0  # only project matrices with min(m, n) > max(rank, min_dim)
    # --- per-leaf subspace lifecycle policies (core/subspace.py) ---
    # every default keeps the paper's global-(rank, T) refresh and today's
    # state layout bit for bit
    rank_frac: float = 0.0  # >0: per-leaf rank = max(1, rank_frac * min(m, n))
    rank_overrides: tuple = ()  # ((path_substring, rank), ...): first match wins
    refresh_stagger: bool = False  # per-leaf refresh offsets (pos·T)//n_galore
    adaptive_t: bool = False  # overlap-gated per-leaf period (Q-GaLore-style)
    stagger_by_importance: bool = False  # order the offsets by importance_order
    importance_order: tuple = ()  # leaf paths by descending measured grad norm
    # (stamped by the launcher from one gradient; static, so every plan agrees)
    t_min: int = 0  # adaptive period floor; 0 -> max(1, update_freq // 4)
    t_max: int = 0  # adaptive period ceiling; 0 -> 8 * update_freq
    overlap_hi: float = 0.9  # double a leaf's period when its refresh overlap >= hi
    overlap_lo: float = 0.5  # halve it when the overlap < lo
    reproject_moments: bool = False  # on an async swap, rotate the compact
    # moments into the new basis: M <- (P_newᵀP_old)M, V <- (P_newᵀP_old)∘²V
    unit_costs: tuple = ()  # measured SVD seconds per (m, n, rank) shape,
    # (((m, n, rank), seconds), ...), stamped by --galore-calibrate-costs
    # (core/subspace.py::calibrate_unit_costs); empty: the leaf_unit_cost model
    guard_refresh: bool = False  # validate the refresh: a non-finite gradient
    # makes the whole refresh a no-op (every projector kept), and an SVD that
    # fails (non-finite P, or LinAlgError) falls back to the randomized
    # projector. Off: the unguarded refresh exactly.
    # low-precision optimizer state (int8 moments, bf16/int4 projectors);
    # resolved per leaf into SubspacePlan.moments / .proj_store
    quant: QuantPolicy = QuantPolicy()
    zero: int = 0  # GaLore-ZeRO: 0 every rank holds the whole optimizer state;
    # 1 each rank owns a rank block of every galore leaf's moments and
    # projector (and a block of dim -2 of the passthrough moments), and the
    # all-reduce sum of the owners' partial back-projections is the update
    # (int codes bit for bit, f32 within 2e-5); 2 also reduce-scatters the
    # compact gradient onto the owners (galore_dp_compress, fp32 moments)
    tp_aware_side: bool = False  # where exactly one dim of a weight carries a
    # tensor-parallel label (core/subspace.py::TP_LABELS), project along the
    # other one instead of by min(m, n)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adam | adamw | adam8bit (8-bit GaLore with GaLore, else
    # 8-bit Adam) | adafactor | sgd (momentum b1)
    galore: Optional[GaLoreConfig] = None
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    microbatch: int = 0  # >0 -> gradient accumulation
    galore_dp_compress: bool = False  # GaLore-DP: each rank projects its own
    # gradient and the mean runs on the compact r×n gradients
    galore_external_refresh: bool = False  # refresh P in a step of its own,
    # driven by the launcher (launch/train.py::make_refresh_caller)
    galore_refresh_async: bool = False  # double-buffered refresh: the due
    # leaves' P_next computed on a host thread and a CUDA stream of their own
    # from the previous step's batch, swapped in at the next step boundary
    # (implies the external refresh; launch/train.py::AsyncRefreshDriver)
    galore_refresh_shard: bool = False  # the due SVD units bin-packed over the
    # data-parallel ranks, each rank's P gathered to every rank (implies the
    # external refresh; distributed/step.py::make_refresh_step)
    galore_calibrate_costs: bool = False  # time one SVD per leaf shape at
    # start-up and bin-pack the sharded refresh on those times
    galore_recalibrate_every: int = 0  # async refresh: re-time them every N
    # dispatches and rebuild the refresh (0: never)
    galore_fused_adam: bool = False  # one fused kernel per GaLore leaf
    galore_fused_apply: bool = False  # fold W ← W + η(G̃ + wd·W) into that kernel
    # (requires galore_fused_adam; no full-size f32 update is written — the
    # emit path + chain remains the numerics oracle)
    galore_zero: int = 0  # GaLore-ZeRO stage, routed into GaLoreConfig.zero
    # by optim/factory.py::effective_galore_config
    z_loss: float = 0.0
    # --- fault tolerance (robust/) ---
    anomaly_guard: bool = False  # per-step guard: a non-finite loss or global
    # grad norm, or a loss z-score spike, makes the step a no-op (params and
    # optimizer state untouched). Changes the step signature to
    # (params, opt_state, guard, batch[, fault]).
    guard_zmax: float = 6.0  # trip when (loss - EMA mean) / EMA std > zmax
    guard_warmup: int = 8  # accepted steps before the z-score monitor arms
    guard_ema: float = 0.9  # decay of the running loss mean/variance EMAs
    fault_hooks: bool = False  # thread fault-injection scalars
    # ({"loss_add", "grad_scale"}) through the guarded step (robust/faults.py)
    # --- escalating recovery (launch/train.py) ---
    recover_max_skips: int = 3  # consecutive skips that trigger a rollback
    recover_max_rollbacks: int = 2  # rollbacks before TrainingFailure
    recover_backoff: float = 0.0  # seconds slept per accumulated rollback
    recover_lr_decay: float = 1.0  # <1: multiply lr by this on every rollback
    recover_resync: bool = False  # after a rollback, one force-all refresh
    # (external or async refresh, fixed period; as the reference)


# the architectures the port registers: every one of the reference's ARCH_IDS
ARCH_IDS = [
    "qwen2_vl_7b",
    "llama4_scout_17b_a16e",
    "grok_1_314b",
    "granite_20b",
    "minitron_4b",
    "internlm2_20b",
    "qwen2_7b",
    "jamba_1_5_large_398b",
    "whisper_small",
    "mamba2_130m",
]
NOT_PORTED: tuple[str, ...] = ()  # the reference's ids the port lacks: none

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """Full-size or smoke config by architecture id: one of ``ARCH_IDS`` or
    the paper's dense LLaMA family (``llama_60m`` … ``llama_7b``); any other
    id raises KeyError."""
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        module = key if key in ARCH_IDS else "llama_paper"
        importlib.import_module(f"repro_torch.configs.{module}")
    if key not in _REGISTRY:
        raise KeyError(f"architecture {name!r} is not ported; known: {sorted(_REGISTRY)}")
    table = _SMOKE_REGISTRY if smoke else _REGISTRY
    return table[key]()


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)
