"""Shared argparse helpers of the port's launchers (port of the architecture,
subspace, quantized-state and checkpoint parts of repro/launch/cli.py)."""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.base import get_config
from repro_torch.quant import QuantPolicy


def add_arch_flags(ap: argparse.ArgumentParser, default_arch: str = "llama_60m"):
    ap.add_argument("--arch", default=default_arch)
    ap.add_argument("--full", action="store_true", help="full-size config (default smoke)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: as registered; a "
                         "multiple of full_attn_every for a chunked-attention model)")
    return ap


def config_from(args):
    """The ModelConfig the add_arch_flags() dests name."""
    cfg = get_config(args.arch, smoke=not args.full)
    return dataclasses.replace(cfg, n_layers=args.layers) if args.layers else cfg


def add_galore_subspace_flags(ap: argparse.ArgumentParser):
    """Per-leaf subspace lifecycle knobs (the reference's ``--galore-*``
    spellings, with its bare aliases)."""
    ap.add_argument("--galore-rank-frac", "--rank-frac", dest="galore_rank_frac",
                    type=float, default=0.0,
                    help="proportional per-leaf rank: max(1, frac·min(m,n)); "
                         "overrides --galore-rank per leaf")
    ap.add_argument("--galore-adaptive-t", "--adaptive-t", dest="galore_adaptive_t",
                    action="store_true",
                    help="overlap-gated per-leaf refresh period (Q-GaLore-style)")
    ap.add_argument("--galore-stagger", "--stagger", dest="galore_stagger",
                    action="store_true",
                    help="stagger per-leaf projector refreshes across the window")
    return ap


def add_quant_flags(ap: argparse.ArgumentParser):
    """Quantized state storage (single definition for every CLI)."""
    ap.add_argument("--quant-moments", choices=["fp32", "int8"], default="fp32",
                    help="Adam moment storage (int8 = blockwise dynamic codes "
                         "+ per-block absmax; the paper's 8-bit GaLore)")
    ap.add_argument("--quant-proj", choices=["fp32", "bf16", "int4"], default="fp32",
                    help="persistent projector storage (int4 = packed "
                         "Q-GaLore format, dequantized on read)")
    ap.add_argument("--quant-lazy-refresh", action="store_true",
                    help="int4 projectors: skip committing refreshes that "
                         "leave the quantized codes unchanged")
    ap.add_argument("--quant-stochastic", action="store_true",
                    help="int8 moments: stochastic rounding on the requant "
                         "(Q-GaLore; counter-hash RNG seeded by the step "
                         "count, bitwise-shared between kernel and oracle)")
    return ap


def add_ckpt_flags(ap: argparse.ArgumentParser, default_dir=None, save_flags: bool = True):
    """Checkpoint location (+ save cadence and file codec when `save_flags`)."""
    ap.add_argument("--ckpt-dir", default=default_dir,
                    help="CheckpointManager root" + (
                        " (a run resumes from the newest checkpoint it finds there)"
                        if save_flags else
                        " to serve trained weights from (quantized int8/int4 "
                        "file-codec checkpoints load directly)"))
    if save_flags:
        ap.add_argument("--ckpt-every", type=int, default=50)
        ap.add_argument("--ckpt-quantize", choices=["int8", "int4"], default=None,
                        help="write quantized checkpoint files: large float params "
                             "leaves become blockwise codes + scales (~4× / ~7× "
                             "smaller, lossy); optimizer state stays verbatim and "
                             "restore is META-driven")
    return ap


def quant_policy_from(args) -> QuantPolicy:
    """QuantPolicy from the add_quant_flags() dests."""
    return QuantPolicy(moments=args.quant_moments, projectors=args.quant_proj,
                       lazy_refresh=args.quant_lazy_refresh,
                       stochastic_round=args.quant_stochastic)
