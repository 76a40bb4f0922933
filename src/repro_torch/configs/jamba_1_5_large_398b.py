"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — Mamba:attn 7:1, MoE 16e top-2.

Period-8 blocks: attention at offset 4, SSM elsewhere; MoE FFN on odd layers
(expert_layer_period=2, offset=1). SSM follows the Jamba Mamba setting
(d_state=16, expand=2); our substrate computes it with the SSD chunked scan.
"""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=24576, vocab_size=65536, head_dim=128,
        n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
        attn_every=8, attn_offset=4, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
        sub_quadratic=True, remat="full",
    )


def smoke():
    return ModelConfig(
        name="jamba-smoke", family="hybrid", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, n_experts=4,
        experts_per_token=2, moe_every=2, moe_offset=1, attn_every=8,
        attn_offset=4, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        sub_quadratic=True, dtype="float32",
    )


register("jamba_1_5_large_398b", full, smoke)
