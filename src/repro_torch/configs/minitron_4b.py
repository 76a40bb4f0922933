"""Minitron-4B [arXiv:2407.14679; hf] — pruned Nemotron, huge vocab."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="minitron-4b", family="dense", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=9216, vocab_size=256000, head_dim=128, remat="full",
    )


def smoke():
    return ModelConfig(
        name="minitron-4b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
    )


register("minitron_4b", full, smoke)
