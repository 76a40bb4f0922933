"""InternLM2-20B [arXiv:2403.17297; hf] — GQA kv=8."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="internlm2-20b", family="dense", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab_size=92544, head_dim=128, remat="full",
    )


def smoke():
    return ModelConfig(
        name="internlm2-20b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
    )


register("internlm2_20b", full, smoke)
