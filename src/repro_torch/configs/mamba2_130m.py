"""Mamba2-130M [arXiv:2405.21060; unverified] — SSD, attention-free."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="mamba2-130m", family="ssm", n_layers=24, d_model=768, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
        ssm_expand=2, ssm_chunk=256, rope_style="none", sub_quadratic=True,
        tie_embeddings=True, remat="full",
    )


def smoke():
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=64, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=512, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=8, rope_style="none", sub_quadratic=True, dtype="float32",
    )


register("mamba2_130m", full, smoke)
