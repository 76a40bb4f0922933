"""Granite-20B code [arXiv:2405.04324; hf] — llama-arch with MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144, n_heads=48,
        n_kv_heads=1, d_ff=24576, vocab_size=49152, head_dim=128, remat="full",
    )


def smoke():
    return ModelConfig(
        name="granite-20b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
    )


register("granite_20b", full, smoke)
