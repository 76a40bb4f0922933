"""Mamba-2's SSD (state-space duality) layer: the chunked linear-time scan for
training and prefill, the one-token recurrence for decode (port of
repro/models/ssm.py).

The sequence is split into chunks of ``ssm_chunk`` steps; within a chunk the
recurrence is a masked attention-like product, across chunks a loop carries
the (B, H, P, N) state in f32 (the reference's ``lax.scan``). Decode is the
O(1) single-step recurrence with a depthwise-conv history of the last k − 1
inputs. The log-decays' running sums are taken in f64 and each difference
of two is cast back to f32: the reference's f32 running sums reach −10³ and
beyond over a chunk of 256 steps, and the difference of two such sums then
loses the low bits of the short segments' decays (≈ 1e-4 relative), which the
decode recurrence, one step's decay at a time, does not. The z / x / B / C / dt projections are separate (d_in, d_out) leaves,
as in the reference; ``A_log``, ``D`` and ``dt_bias`` stay f32 in any model
dtype, and the gated RMSNorm before ``out_proj`` computes in f32.

Caches are written in place: {"state": (B, H, P, N) f32, "conv_x": (B, k−1,
d_inner), "conv_B" / "conv_C": (B, k−1, G·N)} in the model's dtype. A
prefill (S > 1) leaves the final state and the last k − 1 pre-conv inputs;
a decode step (S == 1) advances both by one token.

The depthwise conv sums its k products in f32, left to right, and rounds
once to the model's dtype, in the scan and in decode alike, so a decode step
gives bit for bit the conv output the scan gives at that position. The
reference computes the scan's conv in the model's dtype (every product and
sum rounded) and decode's as one contraction: in bf16 the two round apart,
and the model's state carries the difference into every later token (ROADMAP
C.21).

Where the reference differs: after a prefill it keeps ``xs[:, -(k-1):]`` as
the conv history, which holds only S rows when the prompt is shorter than
k − 1, so its first decode step raises (ROADMAP C.18). Here the history is
always k − 1 rows, left-padded with zeros — the values the causal conv's own
zero padding gives. Also, the reference's ``init_ssm`` draws ``in_dt`` and
``out_proj`` from one key; here every weight has its own draw.

Used by mamba2-130m (``model._apply_ssm_stack``) and as the SSM sub-layer of
the Jamba hybrid (``stacks.apply_jamba_stack``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_normal


def ssm_dims(cfg):
    """(d_inner, heads H, groups G, conv channels) of the SSD layer."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    groups = 1
    conv_ch = d_inner + 2 * groups * cfg.ssm_state
    return d_inner, n_heads, groups, conv_ch


def ssm_axes(cfg):
    """Logical axes of one SSD layer's parameters (the reference's)."""
    return {"in_z": ("embed", "ff"), "in_x": ("embed", "ff"), "in_B": ("embed", None),
            "in_C": ("embed", None), "in_dt": ("embed", None), "conv_x_w": (None, "ff"),
            "conv_x_b": ("ff",), "conv_B_w": (None, None), "conv_B_b": (None,),
            "conv_C_w": (None, None), "conv_C_b": (None,), "A_log": (None,), "D": (None,),
            "dt_bias": (None,), "norm_scale": ("ff",), "out_proj": ("ff", "embed")}


def init_ssm(gen, cfg, dtype, lead=()):
    """The reference's leaves, each with the leading dims `lead`: the five
    input projections (D, ·), the three depthwise convs (k, ·) with zero
    biases, ``A_log`` = log(1 … H), ``D`` = 1 and ``dt_bias`` = 0 in f32,
    ``norm_scale`` = 1 and ``out_proj`` (d_inner, D)."""
    lead = tuple(lead)
    D, k, N = cfg.d_model, cfg.ssm_conv, cfg.ssm_state
    d_inner, H, G, _ = ssm_dims(cfg)
    dev = gen.device

    def normal(shape, fan_in):
        return _init_normal(gen, lead + shape, dtype, fan_in=fan_in)

    def const(values, dt):
        return values.to(device=dev, dtype=dt).expand(lead + tuple(values.shape)).clone()

    f32 = torch.float32
    return {
        "in_z": normal((D, d_inner), D),
        "in_x": normal((D, d_inner), D),
        "in_B": normal((D, G * N), D),
        "in_C": normal((D, G * N), D),
        "in_dt": normal((D, H), D),
        "conv_x_w": normal((k, d_inner), k),
        "conv_x_b": const(torch.zeros(d_inner), dtype),
        "conv_B_w": normal((k, G * N), k),
        "conv_B_b": const(torch.zeros(G * N), dtype),
        "conv_C_w": normal((k, G * N), k),
        "conv_C_b": const(torch.zeros(G * N), dtype),
        "A_log": const(torch.log(torch.arange(1, H + 1, dtype=f32)), f32),
        "D": const(torch.ones(H), f32),
        "dt_bias": const(torch.zeros(H), f32),
        "norm_scale": const(torch.ones(d_inner), dtype),
        "out_proj": normal((d_inner, D), d_inner),
    }


def _segsum(c):
    """Running sums c (..., L) f64 -> (..., L, L) f32: segsum[i, j] = c_i − c_j
    = sum_{k=j+1..i} x_k (i >= j), -inf above the diagonal."""
    seg = (c[..., :, None] - c[..., None, :]).float()
    L = c.shape[-1]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=c.device))
    return torch.where(mask, seg, torch.full_like(seg, float("-inf")))


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, S, C), w (k, C), b (C,): each output's k
    products summed left to right in f32, plus the bias, rounded once to x's
    dtype (the decode step takes its output from this function too)."""
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).float()
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S] * wf[i]
    return (out + b.float()).to(x.dtype)


def _repeat_groups(t, G, N, H, dim):
    """(…, G·N) -> (…, H, N) with each group's N repeated over its H/G heads."""
    t = t.reshape(t.shape[:dim] + (G, N))
    return t.repeat_interleave(H // G, dim=dim)


def _decode(cfg, p, xs, Bm, Cm, dt, cache):
    """One token a row: the conv over the cached history and the state
    recurrence, both cache entries advanced in place. Returns y (B, 1,
    d_inner) f32."""
    B_ = xs.shape[0]
    d_inner, H, G, _ = ssm_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim

    def conv_step(name, new, w, b):
        h = torch.cat([cache[name], new], dim=1)  # (B, k, C)
        cache[name].copy_(h[:, 1:])
        return F.silu(_causal_conv(h, w, b)[:, -1])

    xs_c = conv_step("conv_x", xs, p["conv_x_w"], p["conv_x_b"])
    Bm_c = conv_step("conv_B", Bm, p["conv_B_w"], p["conv_B_b"])
    Cm_c = conv_step("conv_C", Cm, p["conv_C_w"], p["conv_C_b"])
    xh = xs_c.reshape(B_, H, P).float()
    Bh = _repeat_groups(Bm_c, G, N, H, 1).float()  # (B, H, N)
    Ch = _repeat_groups(Cm_c, G, N, H, 1).float()
    dt_a = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt_a * -torch.exp(p["A_log"]))
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt_a, xh, Bh)
    cache["state"].copy_(state)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + p["D"][None, :, None] * xh
    return y.reshape(B_, 1, d_inner)


def _chunked(cfg, p, xs, Bm, Cm, dt):
    """The SSD scan over S tokens from a zero state. Returns (y (B, S,
    d_inner) f32, the final state (B, H, P, N) f32)."""
    B_, S, _ = xs.shape
    d_inner, H, G, _ = ssm_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    xs_c = F.silu(_causal_conv(xs, p["conv_x_w"], p["conv_x_b"]))
    Bm_c = F.silu(_causal_conv(Bm, p["conv_B_w"], p["conv_B_b"]))
    Cm_c = F.silu(_causal_conv(Cm, p["conv_C_w"], p["conv_C_b"]))
    L = min(cfg.ssm_chunk, S)
    S_pad = -(-S // L) * L
    pad = S_pad - S
    if pad:
        # pad to a chunk multiple; padded steps are identities (dt = 0: decay
        # exp(0) = 1, zero input), so the states pass through them
        xs_c, Bm_c, Cm_c, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs_c, Bm_c, Cm_c, dt))
    nc = S_pad // L
    xh = xs_c.reshape(B_, nc, L, H, P).float()
    Bh = _repeat_groups(Bm_c.reshape(B_, nc, L, G * N), G, N, H, 3).float()
    Ch = _repeat_groups(Cm_c.reshape(B_, nc, L, G * N), G, N, H, 3).float()
    dt_a = F.softplus(dt.float() + p["dt_bias"])  # (B, S_pad, H)
    if pad:
        valid = (torch.arange(S_pad, device=xs.device) < S)[None, :, None]
        dt_a = torch.where(valid, dt_a, torch.zeros_like(dt_a))
    dt_a = dt_a.reshape(B_, nc, L, H)
    la_h = (dt_a * -torch.exp(p["A_log"])).movedim(-1, 1)  # log-decay (B, H, nc, L)
    # the running sums in f64, each difference of two cast back to f32 (see
    # the module docstring)
    cums = torch.cumsum(la_h.double(), dim=-1)
    xdt = xh * dt_a[..., None]  # (B, nc, L, H, P)

    # 1) intra-chunk, a masked attention-like product
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores * torch.exp(_segsum(cums)), xdt)
    # 2) each chunk's end state from a zero start
    decay_states = torch.exp((cums[..., -1:] - cums).float())  # (B, H, nc, L)
    states = torch.einsum("bhcl,bclhn,bclhp->bchpn", decay_states, Bh, xdt)
    # 3) the inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cums[..., -1].float())  # (B, H, nc)
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=xs.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    # 4) the carried state's contribution
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, torch.stack(h_prevs, 1),
                         torch.exp(cums.float()))
    y = (y_diag + y_off).reshape(B_, S_pad, H, P)[:, :S]
    y = y + p["D"][None, None, :, None] * xh.reshape(B_, S_pad, H, P)[:, :S]
    return y.reshape(B_, S, d_inner), h


def _keep_history(cache, name, src, k):
    """The last k − 1 pre-conv inputs of a prefill, left-padded with zeros
    when the prompt is shorter (ROADMAP C.18)."""
    hist = src[:, -(k - 1):]
    buf = cache[name]
    buf.zero_()
    buf[:, k - 1 - hist.shape[1]:] = hist


def apply_ssm(cfg, p, x, cache=None):
    """x (B, S, D) -> y (B, S, D). With a `cache` a prefill (S > 1) writes
    the final state and conv history into it, a decode step (S == 1)
    advances them; the cache is written in place."""
    S = x.shape[1]
    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    Bm = x @ p["in_B"]
    Cm = x @ p["in_C"]
    dt = x @ p["in_dt"]
    if cache is not None and S == 1:
        y = _decode(cfg, p, xs, Bm, Cm, dt, cache)
    else:
        y, h_last = _chunked(cfg, p, xs, Bm, Cm, dt)
        if cache is not None:
            cache["state"].copy_(h_last)
            for name, src in (("conv_x", xs), ("conv_B", Bm), ("conv_C", Cm)):
                _keep_history(cache, name, src, cfg.ssm_conv)
    y = y.to(x.dtype)
    # gated RMSNorm (mamba2's norm before out_proj)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
    return (y * p["norm_scale"]) @ p["out_proj"]


def init_ssm_cache(cfg, batch: int, dtype, device, lead=()):
    """{"state": lead + (batch, H, P, N) f32, "conv_x": lead + (batch, k−1,
    d_inner), "conv_B" / "conv_C": lead + (batch, k−1, G·N)}, zeroed."""
    lead = tuple(lead)
    d_inner, H, G, _ = ssm_dims(cfg)
    k, N = cfg.ssm_conv, cfg.ssm_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + (batch,) + shape, dtype=dt, device=device)

    return {
        "state": zeros(H, cfg.ssm_head_dim, N, dt=torch.float32),
        "conv_x": zeros(k - 1, d_inner),
        "conv_B": zeros(k - 1, G * N),
        "conv_C": zeros(k - 1, G * N),
    }
