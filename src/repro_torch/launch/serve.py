"""Serving CLI + the deprecated `Server.generate` compatibility shim (port of
repro/launch/serve.py).

The engine itself lives in ``repro_torch.serve`` (continuous batching, paged
KV cache, typed Request/Completion API). This module keeps:

  * `main()` — the CLI driver: builds an Engine on ``cuda`` (or
    ``--device``), submits a demo request stream (or serves a trained or
    quantized checkpoint via ``--ckpt-dir``), drains, prints per-request
    completions. Without a GPU and without ``--device cpu`` it exits 2.
  * `Server` — the pre-engine class kept as a thin compatibility shim:
    `generate(prompts)` submits one Request per prompt and drains the
    engine. Emits DeprecationWarning; new code should use
    ``repro_torch.serve.Engine`` directly. The engine serves the paged
    families (dense, moe, vlm); the recurrent ones (ssm, hybrid), whose
    state has no blocks to page, and the encoder-decoder (audio), whose
    cross K/V have none, are served by the Server's contiguous-cache loop
    (audio prefills on zero frames, as the reference's). The CLI builds an
    Engine, which refuses them, as the reference's does.

Where the reference differs: its contiguous loop right-pads every prompt to
the longest, takes each lane's logits at the longest prompt's last position
and decodes all lanes from there, so a shorter prompt continues from its
padding (ROADMAP C.13). Here the lanes are served in groups of one prompt
length, each group prefilled to its own length.

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
      (``--arch`` any registered id of a paged family, default qwen2_7b as in
      the reference, e.g. llama_60m, llama4_scout_17b_a16e or qwen2_vl_7b;
      ``--full --layers N`` for a full-width config cut to N layers)

``--ckpt-dir`` loads trained weights from the newest valid checkpoint in a
CheckpointManager root instead of random init — including quantized (int8 /
int4 file-codec) checkpoints, which restore through META, so a train run
saved with ``--ckpt-quantize int4`` serves directly.
"""
from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.step import make_decode_step, make_prefill_step
from repro_torch.launch import cli
from repro_torch.models import model as M
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.utils import resolve_device


class Server:
    """Deprecated slot-batch facade over the paged-cache Engine, and the
    contiguous-cache loop of the families that do not page.

    Kept so existing callers (`Server(cfg, params).generate(prompts)`) run
    unchanged; greedy outputs are token-identical to a full-forward rollout.
    Prefer `repro_torch.serve.Engine`.
    """

    def __init__(self, cfg, params, max_len: int = 512, slots: int = 4):
        warnings.warn(
            "repro_torch.launch.serve.Server is deprecated; use repro_torch.serve.Engine "
            "(submit()/poll()/run_until_drained() with typed Request/"
            "Completion and per-request max_new/max_len/sampling)",
            DeprecationWarning, stacklevel=2)
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.slots = slots
        self.engine = None
        if cfg.family not in M.PAGED_FAMILIES:
            M.check_ported(cfg)
            self.prefill = make_prefill_step(cfg)
            self.decode = make_decode_step(cfg, with_logits=True)
            return
        bs = min(16, max_len)
        scfg = ServeConfig(
            block_size=bs,
            # pool sized to the old server-wide allocation (slots full
            # sequences) + scratch, so the shim can never be tighter than
            # the class it replaces
            num_blocks=1 + slots * (-(-max_len // bs)),
            slots=slots, max_len_cap=max_len,
            prefill_chunk=min(32, max_len))
        self.engine = Engine(cfg, params, scfg)

    def generate(self, prompts: list, max_new: int = 16):
        """prompts: list of 1-D int sequences (<= slots). Greedy decode."""
        assert len(prompts) <= self.slots
        if self.engine is None:
            return self._generate_contiguous(prompts, max_new)
        ids = [self.engine.submit(Request(tokens=tuple(int(t) for t in p), max_new=max_new))
               for p in prompts]
        self.engine.run_until_drained()
        return [list(self.engine.result(i).tokens) for i in ids]

    def _generate_contiguous(self, prompts: list, max_new: int):
        """Greedy decode on a contiguous cache, one batch for each prompt
        length: the group's prompts prefilled together from a zero cache,
        then max_new − 1 decode steps from the position after them."""
        if max_new <= 0:
            return [[] for _ in prompts]
        longest = max(len(p) for p in prompts)
        if longest + max_new > self.max_len:
            raise ValueError(f"a prompt of {longest} tokens and {max_new} new ones exceed "
                             f"max_len {self.max_len}")
        device = self.params["embed"]["embedding"].device
        outs = [None] * len(prompts)
        groups: dict[int, list[int]] = {}
        for i, p in enumerate(prompts):
            groups.setdefault(len(p), []).append(i)
        for plen, lanes in groups.items():
            toks = torch.tensor([[int(t) for t in prompts[i]] for i in lanes], dtype=torch.int64,
                                device=device)
            cache = M.init_cache(self.cfg, len(lanes), self.max_len, device=device)
            batch = {"tokens": toks}
            if self.cfg.family == "audio":
                # zero frames, as the reference's loop; in the model's dtype,
                # where the reference's f32 frames promote its bf16 encoder
                # to f32 (torch refuses a mixed-dtype product instead)
                batch["enc_frames"] = torch.zeros(
                    (len(lanes), self.cfg.enc_seq, self.cfg.d_model),
                    dtype=self.params["embed"]["embedding"].dtype, device=device)
            last, cache = self.prefill(self.params, cache, batch)
            nxt = last.argmax(dim=-1)
            rows = [nxt]
            for pos in range(plen, plen + max_new - 1):
                nxt, _, cache = self.decode(self.params, cache, nxt[:, None].long(), pos)
                rows.append(nxt)
            got = torch.stack(rows, 1).tolist()
            for j, i in enumerate(lanes):
                outs[i] = [int(t) for t in got[j]]
        return outs


def load_checkpoint_params(cfg, ckpt_dir: str, device=None):
    """Newest valid checkpoint in `ckpt_dir` -> (params tree for `cfg` on
    `device` (``cuda`` unless given), its step).

    Restores the "params" group only (optimizer state stays on disk);
    quantized file-codec leaves dequantize through META after their crc32s
    pass. The restore target is a parameter tree of `cfg` on the device
    (the reference's eval_shape)."""
    device = resolve_device(device)
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    step = mgr.latest_valid_step()
    if step is None:
        raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    target = M.init_params(cfg, seed=0, device=device)
    restored = mgr.restore(step, {"params": target})
    return restored["params"], step


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Continuous-batching serving engine over a paged KV cache, PyTorch "
                    "port (smoke-scale by default)")
    cli.add_arch_flags(ap, default_arch="qwen2_7b")
    cli.add_ckpt_flags(ap, default_dir=None, save_flags=False)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-len-cap", type=int, default=128,
                    help="per-request prompt+generation ceiling (block-table "
                         "width); requests may set a smaller max_len")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; there is no CPU fallback)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = cli.config_from(args)
    if args.ckpt_dir:
        params, step = load_checkpoint_params(cfg, args.ckpt_dir, device)
        print(f"[serve] restored params from {args.ckpt_dir} step {step}")
    else:
        params = M.init_params(cfg, seed=0, device=device)

    scfg = ServeConfig(block_size=args.block_size, num_blocks=args.num_blocks,
                       slots=args.slots, max_len_cap=args.max_len_cap,
                       prefill_chunk=args.prefill_chunk)
    engine = Engine(cfg, params, scfg)
    print(f"[serve] engine up on {device}: {args.slots} slots, "
          f"{args.num_blocks}×{args.block_size}-token blocks "
          f"({engine.pool_hbm_bytes / 1e6:.1f} MB KV pool)")
    reqs = [Request(tokens=tuple(int(t) for t in np.arange(n) % cfg.vocab_size),
                    max_new=args.max_new) for n in (5, 3)]
    t0 = time.time()
    ids = [engine.submit(r) for r in reqs]
    completions = engine.run_until_drained()
    dt = time.time() - t0
    total = sum(len(c.tokens) for c in completions)
    print(f"[serve] generated {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s)")
    for rid in ids:
        c = engine.result(rid)
        print(f"  req {c.request_id} [{c.finish_reason}, "
              f"ttft {c.ttft_s * 1e3:.0f}ms]: {list(c.tokens)}")


if __name__ == "__main__":
    main()
