"""Qwen2-7B [arXiv:2407.10671; hf] — GQA kv=4, QKV bias."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="qwen2-7b", family="dense", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
        rope_theta=1e6, remat="full",
    )


def smoke():
    return ModelConfig(
        name="qwen2-7b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, qkv_bias=True,
        dtype="float32",
    )


register("qwen2_7b", full, smoke)
