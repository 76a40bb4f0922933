"""LLaMA-style configs from the GaLore paper (Table 5)."""
from repro_torch.configs.base import ModelConfig, register

_SIZES = {
    "llama_60m": dict(n_layers=8, d_model=512, n_heads=8, d_ff=1376),
    "llama_130m": dict(n_layers=12, d_model=768, n_heads=12, d_ff=2048),
    "llama_350m": dict(n_layers=24, d_model=1024, n_heads=16, d_ff=2736),
    "llama_1b": dict(n_layers=32, d_model=2048, n_heads=24, d_ff=5461),
    "llama_7b": dict(n_layers=32, d_model=4096, n_heads=32, d_ff=11008),
}


def _make(name, smoke=False):
    kw = dict(_SIZES[name])
    if smoke:
        kw = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128)
    return ModelConfig(
        name=name, family="dense", vocab_size=512 if smoke else 32000,
        n_kv_heads=kw["n_heads"], dtype="float32" if smoke else "bfloat16", **kw,
    )


for _n in _SIZES:
    register(_n, (lambda n: lambda: _make(n))(_n), (lambda n: lambda: _make(n, True))(_n))
