"""Top-level model: init / forward / loss / caches for every family of the
reference (port of repro/models/model.py).

Families: dense | moe | vlm, through one decoder stack (models/stacks.py);
vlm mixes precomputed patch embeddings (the stubbed vision frontend) into the
first positions. ssm: the Mamba-2 stack of SSD layers (models/ssm.py),
attention-free. hybrid: Jamba's period blocks (``stacks.apply_jamba_stack``).
audio: Whisper's encoder-decoder, its conv frontend stubbed — precomputed
frame embeddings arrive in the batch as "enc_frames".

Batch keys: tokens (B, S) int64 (required), targets (B, S), loss_mask (B, S),
positions (B, S), or (3, B, S) under M-RoPE, media (B, M, D), enc_frames
(B, enc_seq, D) in the model's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import remat
from repro_torch.models import rope as rope_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import stacks
from repro_torch.models.layers import (
    MetaGenerator,
    apply_embedding,
    apply_norm,
    apply_unembed,
    embedding_axes,
    init_embedding,
    init_norm,
    norm_axes,
)
from repro_torch.utils import (
    canonical_dtype,
    from_full,
    is_dtensor,
    logical_constraint,
    resolve_device,
    tree_map,
    unstack,
)


PAGED_FAMILIES = ("dense", "moe", "vlm")  # pure-attention caches page cleanly
PORTED_FAMILIES = PAGED_FAMILIES + ("ssm", "hybrid", "audio")
DEC_POS = 8192  # rows of the audio decoder's learned position table


def check_ported(cfg) -> None:
    """Raise unless the port implements `cfg`: a family of the reference,
    RMSNorm or LayerNorm, SwiGLU or GELU, and one of the reference's
    activation-checkpointing policies, "none", "full", "scores" or "names"
    (models/remat.py)."""
    unported = {
        "family": cfg.family not in PORTED_FAMILIES,
        "norm_type": cfg.norm_type not in ("rmsnorm", "layernorm"),
        "act": cfg.act not in ("swiglu", "gelu"), "remat": cfg.remat not in remat.POLICIES,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not ported yet")


def init_params(cfg, seed: int = 0, device=None):
    """Random parameters from `seed`, drawn on `device` (``cuda`` unless given).

    Returns the reference's tree: {"embed", "final_norm", "blocks"} with the
    block leaves stacked (L, …) — MoE expert leaves (L, E, …), the router f32
    in any model dtype; the ssm family's blocks {"mix", "ln"}; the hybrid's a
    tuple of period sub-layers stacked over blocks; the audio family's
    {"encoder", "enc_norm", "blocks" (the cross-decoder), "dec_pos"
    (DEC_POS, D) zeros}. Every leaf requires grad. On the meta device (the
    dry run's) the same leaves, shapes and dtypes, with nothing drawn."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = canonical_dtype(cfg.dtype)
    gen = (MetaGenerator() if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    p = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": init_norm(cfg, dtype, device),
    }
    if cfg.family == "hybrid":
        p["blocks"] = stacks.init_jamba_stack(gen, cfg, dtype)
    elif cfg.family == "ssm":
        p["blocks"] = _init_ssm_stack(gen, cfg, dtype)
    elif cfg.family == "audio":
        p["encoder"] = stacks.init_encoder_stack(gen, cfg, dtype)
        p["enc_norm"] = init_norm(cfg, dtype, device)
        p["blocks"] = stacks.init_crossdecoder_stack(gen, cfg, dtype)
        p["dec_pos"] = torch.zeros((DEC_POS, cfg.d_model), dtype=dtype, device=device)
    else:
        p["blocks"] = stacks.init_decoder_stack(gen, cfg, dtype)
    return tree_map(lambda t: t.requires_grad_(True), p)


def param_axes(cfg):
    """The logical axis labels of every parameter, a tree with the params'
    paths (the reference's ``param_axes``): plain tuples of strings, read by
    the tp-aware side rule and the ZeRO maps (core/subspace.py)."""
    ax = {"embed": embedding_axes(), "final_norm": norm_axes(cfg)}
    if cfg.family == "hybrid":
        ax["blocks"] = stacks.jamba_stack_axes(cfg)
    elif cfg.family == "ssm":
        ax["blocks"] = stacks.stack_axes({"mix": ssm_lib.ssm_axes(cfg), "ln": norm_axes(cfg)})
    elif cfg.family == "audio":
        ax["encoder"] = stacks.encoder_stack_axes(cfg)
        ax["enc_norm"] = norm_axes(cfg)
        ax["blocks"] = stacks.crossdecoder_stack_axes(cfg)
        ax["dec_pos"] = (None, None)
    else:
        ax["blocks"] = stacks.decoder_stack_axes(cfg)
    return ax


def cache_axes(cfg):
    """Logical axes of the contiguous cache of the attention-decoder
    families ("layers" first, the reference's ``cache_axes``); the ssm,
    hybrid and audio caches are not placed on a mesh yet (ROADMAP A.13)."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise NotImplementedError(f"the {cfg.family} family's cache has no sharding rules in "
                                  f"the port yet (ROADMAP A.13)")
    return stacks.stack_axes(attn_lib.cache_axes())


def _init_ssm_stack(gen, cfg, dtype):
    L = cfg.n_layers
    return {"mix": ssm_lib.init_ssm(gen, cfg, dtype, lead=(L,)),
            "ln": init_norm(cfg, dtype, gen.device, lead=(L,))}


def init_cache(cfg, batch: int, max_len: int, device=None):
    """The contiguous cache in the model's dtype, zeroed, on `device`
    (``cuda`` unless given): a KV cache {"k", "v": (L, batch, max_len, KV,
    hd)}; for ssm the SSD state and conv histories {"state": (L, batch, H, P,
    N) f32, "conv_x" / "conv_B" / "conv_C": (L, batch, k−1, ·)}; for hybrid
    a tuple of the two kinds over Jamba's blocks (``stacks.init_jamba_cache``);
    for audio {"self": the KV cache, "cross_k", "cross_v": (L, batch,
    enc_seq, KV, hd)}, the encoder's K/V that a prefill writes."""
    check_ported(cfg)
    dtype, device = canonical_dtype(cfg.dtype), resolve_device(device)
    if cfg.family == "hybrid":
        return stacks.init_jamba_cache(cfg, batch, max_len, dtype, device)
    if cfg.family == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device, lead=(cfg.n_layers,))
    kv = attn_lib.init_cache(cfg, batch, max_len, dtype, device, lead=(cfg.n_layers,))
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"self": kv, "cross_k": torch.zeros(shape, dtype=dtype, device=device),
                "cross_v": torch.zeros(shape, dtype=dtype, device=device)}
    return kv


def init_paged_cache(cfg, num_blocks: int, block_size: int, device=None):
    """Stacked pooled KV blocks {"kp", "vp": (L, NB, bs, KV, hd)} in the
    model's dtype, zeroed, on `device` (``cuda`` unless given).

    One pool shared by every live request of the serving engine; per-request
    block tables and positions are supplied per call by the paged steps
    (distributed/step.py), not stored here."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged KV cache supports families {PAGED_FAMILIES}, not "
            f"{cfg.family!r} (recurrent/cross-attn state is not paged)")
    check_ported(cfg)
    return attn_lib.init_paged_cache(cfg, num_blocks, block_size, canonical_dtype(cfg.dtype),
                                     resolve_device(device), lead=(cfg.n_layers,))


def _angles(cfg, positions, seq, batch, device, offset=0):
    """Rope angles (B, S, hd/2) f32 from the batch's positions (or the
    default ones from `offset`), M-RoPE's from (3, B, S) positions; None for
    rope_style "none" and the attention-free ssm family."""
    if cfg.rope_style == "none" or cfg.family == "ssm":
        return None
    hd = cfg.resolved_head_dim
    if positions is None:
        positions = rope_lib.positions_for(cfg, batch, seq, offset, device=device)
    if cfg.rope_style == "mrope":
        return rope_lib.mrope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_lib.rope_angles(positions, hd, cfg.rope_theta)


def _embed_inputs(cfg, params, batch_dict):
    """Token embeddings; under a media frontend (vlm) the first M positions
    carry the batch's precomputed media embeddings (B, M, D) instead."""
    x = apply_embedding(params["embed"], batch_dict["tokens"])
    media = batch_dict.get("media")
    if media is not None and cfg.media_embeds > 0:
        M_ = media.shape[1]
        x = torch.cat([media.to(x.dtype), x[:, M_:]], dim=1)
    return x


def forward_with_aux(cfg, params, batch_dict, *, cache=None, cache_pos=None):
    """(logits (B, S, padded_vocab) f32, aux_loss 0-d f32): the MoE layers'
    load-balancing loss summed, 0 without experts."""
    check_ported(cfg)
    if cfg.family == "audio":
        logits = _forward_audio(cfg, params, batch_dict, cache=cache, cache_pos=cache_pos)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    tokens = batch_dict["tokens"]
    B, S = tokens.shape
    x = logical_constraint(_embed_inputs(cfg, params, batch_dict), "batch", "act_seq", None)
    angles = _angles(cfg, batch_dict.get("positions"), S, B, tokens.device,
                     0 if cache_pos is None else cache_pos)
    if cfg.family == "hybrid":
        x, aux = stacks.apply_jamba_stack(cfg, params["blocks"], x, angles=angles, cache=cache,
                                          cache_pos=cache_pos)
    elif cfg.family == "ssm":
        x, aux = _apply_ssm_stack(cfg, params["blocks"], x, cache)
    else:
        x, aux = stacks.apply_decoder_stack(cfg, params["blocks"], x, angles=angles,
                                            cache=cache, cache_pos=cache_pos)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = apply_unembed(params["embed"], x, cfg.logit_softcap, valid_vocab=cfg.vocab_size)
    return logical_constraint(logits, "batch", "act_seq", "vocab"), aux


def _apply_ssm_stack(cfg, p, x, cache):
    """x through the SSD layers (pre-norm residual); returns (x, a zero aux
    loss). A cache's per-layer ``select(0, l)`` views are written in place;
    without one each layer runs under cfg.remat (``stacks.run_units``)."""
    layers = unstack(p, cfg.n_layers)
    no_aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layer(x, layer):
        c = None if cache is None else {k: v.select(0, layer) for k, v in cache.items()}
        lp = layers[layer]
        return x + ssm_lib.apply_ssm(cfg, lp["mix"], apply_norm(cfg, lp["ln"], x), c), no_aux

    return stacks.run_units(cfg, run_layer, x, cfg.n_layers, cache)


def _forward_audio(cfg, params, batch_dict, *, cache=None, cache_pos=None):
    """Whisper's logits (B, S, padded_vocab) f32. A call with "enc_frames"
    runs the encoder, its final norm and every layer's cross K/V, and with a
    cache writes those K/V into it in place; a cached call without frames (a
    decode step) reads them from the cache. The decoder adds the learned
    positions dec_pos[pos0 : pos0 + S], pos0 = cache_pos or 0.

    Where the reference differs: its ``dynamic_slice`` of dec_pos clamps the
    start when pos0 + S > DEC_POS, and the decoder silently reuses earlier
    positions (ROADMAP C.22); here that raises ValueError."""
    tokens = batch_dict["tokens"]
    S = tokens.shape[1]
    pos0 = 0 if cache_pos is None else int(cache_pos)
    if pos0 + S > params["dec_pos"].shape[0]:
        raise ValueError(f"decoder positions {pos0} … {pos0 + S - 1} run past the "
                         f"{params['dec_pos'].shape[0]} learned positions (dec_pos)")
    x = apply_embedding(params["embed"], tokens) + params["dec_pos"][pos0:pos0 + S][None]
    self_cache = None if cache is None else cache["self"]
    if cache is not None and "enc_frames" not in batch_dict:
        enc_kv = (cache["cross_k"], cache["cross_v"])
    else:
        enc = stacks.apply_encoder_stack(cfg, params["encoder"], batch_dict["enc_frames"])
        enc_kv = stacks.compute_enc_kv(cfg, params["blocks"],
                                       apply_norm(cfg, params["enc_norm"], enc))
        if cache is not None:
            cache["cross_k"].copy_(enc_kv[0])
            cache["cross_v"].copy_(enc_kv[1])
    x = stacks.apply_crossdecoder_stack(cfg, params["blocks"], x, enc_kv, cache=self_cache,
                                        cache_pos=cache_pos)
    x = apply_norm(cfg, params["final_norm"], x)
    return apply_unembed(params["embed"], x, cfg.logit_softcap, valid_vocab=cfg.vocab_size)


def forward(cfg, params, batch_dict, *, cache=None, cache_pos=None):
    """Logits (B, S, padded_vocab), f32; with a KV cache see forward_cached."""
    return forward_with_aux(cfg, params, batch_dict, cache=cache, cache_pos=cache_pos)[0]


def forward_cached(cfg, params, batch_dict, *, cache, cache_pos=None):
    """Logits (B, S, padded_vocab) f32 and the cache, written in place.

    Contiguous cache: a prefill (S > 1) writes at 0, a decode step (tokens
    (B, 1)) at `cache_pos`, whose rope phase is cache_pos unless the batch
    carries "positions"; the SSD layers' state and conv histories advance
    in place (a prefill from a zero state); the audio family's prefill (with
    "enc_frames") writes the encoder's cross K/V, its decode steps read them.
    Paged cache ({"kp", "vp", "bt", "pos"}): the batch carries each row's
    "positions" (B, S) — (3, B, S) under M-RoPE — and K/V go through the
    block tables from each row's "pos"."""
    return forward(cfg, params, batch_dict, cache=cache, cache_pos=cache_pos), cache


def _token_terms(logits, targets):
    """(logsumexp over the vocabulary, the target's logit), each (B, S) f32.
    On a mesh the vocabulary is made whole on each rank first and the terms
    are computed on its own tokens (DTensor's gather would take a zero
    tensor of the global logits' size for its backward)."""
    if not is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, targets[..., None].long())[..., 0])
    from torch.distributed.tensor import DTensor, Replicate

    pl = list(logits.placements)
    if any(getattr(p, "dim", None) in (-1, logits.ndim - 1) for p in pl):
        pl = [Replicate() if getattr(p, "dim", None) in (-1, logits.ndim - 1) else p
              for p in pl]
        logits = logits.redistribute(logits.device_mesh, pl)
    targets = targets.redistribute(logits.device_mesh, pl) if is_dtensor(targets) else \
        from_full(targets, logits.device_mesh, pl)
    local = logits.to_local()
    lz, tl = _token_terms(local, targets.to_local())
    shape, mesh = targets.shape, logits.device_mesh
    return tuple(DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                    stride=targets.stride()) for t in (lz, tl))


def loss_fn(cfg, params, batch_dict, z_loss: float = 0.0):
    """Next-token cross entropy plus the MoE load-balancing loss. Returns
    (total, metrics): metrics are the reference's {"loss", "aux_loss",
    "ppl_proxy"}, 0-d f32 tensors on the loss's device ("loss" the cross
    entropy alone, aux_loss 0 without experts, ppl_proxy
    exp(min(loss, 20)))."""
    logits, aux = forward_with_aux(cfg, params, batch_dict)
    logits = logits.float()
    tokens = batch_dict["tokens"]
    targets = batch_dict.get("targets")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = batch_dict.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    logz, tgt_logit = _token_terms(logits, targets)
    nll = (logz - tgt_logit) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    total = loss + aux
    if z_loss > 0:
        total = total + z_loss * (logz.square() * mask).sum() / denom
    loss = loss.detach()
    return total, {"loss": loss, "aux_loss": aux.detach(),
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
