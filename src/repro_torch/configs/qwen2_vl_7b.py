"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf] — M-RoPE, stubbed ViT frontend."""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
        rope_style="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        media_embeds=256, remat="full",
    )


def smoke():
    return ModelConfig(
        name="qwen2-vl-7b-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, qkv_bias=True,
        rope_style="mrope", mrope_sections=(2, 3, 3), media_embeds=4, dtype="float32",
    )


register("qwen2_vl_7b", full, smoke)
