"""Grok-1 314B [hf:xai-org/grok-1; unverified] — 8 experts, top-2."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128, n_experts=8,
        experts_per_token=2, logit_softcap=30.0, remat="full",
    )


def smoke():
    return ModelConfig(
        name="grok-1-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, n_experts=4,
        experts_per_token=2, logit_softcap=30.0, dtype="float32",
    )


register("grok_1_314b", full, smoke)
