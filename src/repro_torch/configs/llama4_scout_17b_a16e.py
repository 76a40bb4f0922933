"""Llama-4 Scout 17B-active/16E [hf:meta-llama; unverified] — MoE top-1, iRoPE.

Chunked local attention (8k) on 3 of 4 layers + rope-free global attention on
every 4th layer makes long-context cost O(S·chunk) — hence long_500k runs for
this arch.
"""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048, head_dim=128,
        n_experts=16, experts_per_token=1, rope_theta=5e5,
        attention_chunk=8192, full_attn_every=4, sub_quadratic=True, remat="full",
    )


def smoke():
    return ModelConfig(
        name="llama4-scout-smoke", family="moe", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, n_experts=4,
        experts_per_token=1, attention_chunk=8, full_attn_every=4,
        sub_quadratic=True, dtype="float32",
    )


register("llama4_scout_17b_a16e", full, smoke)
