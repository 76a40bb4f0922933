"""Whisper-small [arXiv:2212.04356; unverified] — enc-dec; conv frontend stubbed.

Precomputed (B, 1500, 768) frame embeddings ("enc_frames" in the batch) take
the place of the log-mel + conv1d stem, as in the reference's config.
"""
from repro_torch.configs.base import ModelConfig, register


def full():
    return ModelConfig(
        name="whisper-small", family="audio", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab_size=51865, head_dim=64,
        is_encoder_decoder=True, n_enc_layers=12, enc_seq=1500,
        norm_type="layernorm", act="gelu", rope_style="none", remat="full",
    )


def smoke():
    return ModelConfig(
        name="whisper-smoke", family="audio", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512, head_dim=16,
        is_encoder_decoder=True, n_enc_layers=2, enc_seq=16,
        norm_type="layernorm", act="gelu", rope_style="none", dtype="float32",
    )


register("whisper_small", full, smoke)
