#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each timed, none of them optional; any failed check raises:
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build the Hopper kernels from src/repro_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together; count the wgmma (HGMMA)
     instructions of the tiled projections' library and of galore_epilogue's
     (the GaLore kernel of every step form), and fail on none;
  3. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes (and r = 1024, and a ragged shape), G in bf16 and
     f32, to 1e-5·max|want| (+ 1e-5·|want|) on G̃, M' and V' — or, for the
     int8-moment kernel, on G̃ and the scales, with codes at most 1 apart,
     P both f32 and packed int4, stochastic rounding on one main shape per
     side, and the int4 launch giving the codes of the host-dequantized-P
     launch exactly; the weight-apply forms (fp32 and int8 moments)
     likewise, W bf16 and f32 (f32 W' - W within 1e-5·max + 2 ulp of W', bf16
     W' within one bf16 ulp + the same 1e-5·max), the fp32 form's W' bitwise
     ref.apply_weight of the kernel's own G̃ (read out by a launch on W = 0,
     η = 1, wd = 0), the int8 form's bitwise the plain version's wherever
     its emit form's G̃ is, and W updated in place; galore_epilogue's kernel
     also at llama_1b's leaves at the paper's 1B rank r = 512, each of its
     launches logged with its route (TMA or thread copies) and its cluster
     size, and two launches on the same inputs bitwise equal; time kernel
     and plain version with CUDA events; the int8 kernel with stochastic
     rounding on two rank blocks of the main leaves, each launched with its
     origin in the full leaf, writing exactly the full-leaf launch's slices
     of the codes and scales (ROADMAP C.27);
  4. the main path, fused: 8 GaLore-AdamW steps (rank 128, T 8, wd 0.01) of
     llama_7b at full width, 2 layers, bf16, batch 8 × 256 tokens, through
     train_loop; every loss finite, the last below the first, and each fp32
     kernel launched once per stacked leaf per step (6 left leaves, 1 right
     leaf), none by thread copies. [ckpt]: the run checkpoints at step 4 into
     a fresh directory; its final state is saved through the checkpoint
     manager (host copy and write timed apart, bytes on disk, and again with
     the int4 file codec) and restored onto the card, every leaf bit for
     bit; a second run on the directory resumes from step 4 and takes steps
     5-7: step 5's loss equal to the straight run's bit for bit, 6-7 within
     5e-2;
  5. the same run on the composable plain-torch path: no kernel launches,
     per-step losses within 5e-2 of phase 4;
  6. 8-bit GaLore, fused: phase 4's run with int8 moments and packed int4
     projectors; every loss finite and falling, only the int8-moment kernel
     launched (48 left, 8 right), none of its launches by thread copies,
     losses within 5e-2 of phase 4, and the m/v/proj state bytes measured
     from the tensors within 0.01 % of the analytic galore_state_bytes; its
     final state (int8 codes and scales, int4 P) saved and restored through
     the checkpoint manager bit for bit on the card ([ckpt]);
  7. phases 4 and 6 again with the weight update folded into the kernels
     (galore_fused_apply): only the apply kernels launched (48 left, 8
     right; never by thread copies), losses within 5e-2 of the emit phase,
     state bytes as in 6;
  8. fp32 moments with packed int4 projectors, emit and apply: only the
     fp32-moment kernels' int4-P forms launched (48 left, 8 right each;
     never by thread copies), losses
     within 5e-2 of phase 4 (and of the int4-P emit phase for apply), state
     bytes within 0.01 % of galore_state_bytes;
  8a. [guard]: phase 4 with the anomaly guard, checkpointing at step 4, and
     NaN gradients injected at steps 5-7: the three skips each a bitwise
     no-op on every leaf of params and state and launching nothing, one
     rollback to step 4, steps 5-7 replayed finite, step 5's loss equal bit
     for bit to the rejected attempt's and to phase 4's; the guarded
     non-refresh step time beside phase 4's, and the guarded step without
     fault hooks timed in turns with the unguarded one on one state (no
     refresh); and a guarded fused-apply run refused with ValueError, as in
     the reference;
  9. the paper's 7B rank, r = 1024 (T = 8: one refresh), fp32 fused and
     composable: every leaf fails the reference's fits_vmem, so the fused
     step composes the tiled projections (B4 and B5 launched 56 times each,
     B1/B2 never); losses finite, falling and within 5e-2 of the composable
     run's; state bytes within 0.01 % of galore_state_bytes; then 8-bit
     GaLore at r = 1024, fused emit and apply: every leaf takes the
     reference's plain fallback, so no GaLore kernel is launched at all;
     losses within 5e-2 of the fp32 fused r = 1024 run (and the apply run's
     of the emit run's), state bytes within 0.01 %;
  10. the paper's baselines without GaLore: 8-bit Adam (the flat 8-bit Adam
     kernel launched once per quantized leaf a step, the leaves counted
     from the state; state bytes within 0.01 % of adam8bit_state_bytes;
     finite losses) and full-rank AdamW (no kernel; its step-0 loss equal to
     8-bit Adam's within 1e-6), each with its peak memory and state bytes;
  10a. the paper's other baselines (baseline_phases), none launching a
     kernel: `adafactor` (full-rank Adafactor, β1 0.9, the 7B baseline of
     Fig. 1: step-0 loss equal to AdamW's within 1e-6, its v and m bytes
     measured equal to the analytic count), `galore-adafactor` (GaLore
     r = 128, T = 8 over Adafactor, Fig. 3, the composable path: SVDs at
     step 0 only, proj + compact m + factored v within 0.01 % of the
     analytic count), and the low-rank weight methods of Table 2 through
     the loop of benchmarks/table2_methods.py::_train_lowrank (Adam on the
     adaptors, constant −lr): `lora` (r = 128, alpha 32: step-0 loss equal
     to AdamW's within 1e-6, B = 0; the adaptors' elements counted equal
     to adaptor_param_count and to r(m + n) a matrix; adaptors + Adam state
     12 B an element), `relora` (the same, merged at step 4: the effective
     weights just before and just after relora_merge equal element for
     element, B′ = 0, a fresh Adam state) and `lowrank` (W = s·BA from
     scratch, alpha 4r: finite losses);
  10b. the refresh lifecycle at T = 8 (lifecycle_phases): `stagger` (fp32
     fused, r = 128, staggered: the SVD units per step 14, 2 × 6, 0, as the
     plan's offsets (pos·8)//7 make due), `stagger-external` (the same
     through the external refresh caller: losses and every projector bit
     for bit `stagger`'s; both without the chain's clip), `async` (8-bit
     fused, staggered, the async double buffer with moment re-projection:
     each dispatch's SVD units, the thread's time and the main thread's
     wait at the swap logged, and the swap of the step-6 refresh held
     against a synchronous refresh on the main stream: overlap > 0.999,
     codes at most one apart, scales within 1e-5) and `hetero-adaptive`
     (the MLP leaves at r = 1024 on B4/B5, attention at r = 128 on B1,
     adaptive T from T = 4: every refresh's period and next by the
     reference's rule, within t_bounds), each with its launches, state
     bytes within 0.01 % and peak memory;
  10c. serving (the engine over the paged KV cache; no kernel, the
     reference's serving path reaches no Pallas call): [serve-f32] at
     llama_7b width, 2 layers, f32 (a config copy): six greedy requests
     (prompts of 1 … 480 tokens) token-identical to the full-forward rollout
     and each emitted token's logits within 1e-4·max of the full forward's,
     with prefill chunks of 32 and 512; a padded last chunk past the block
     table (cap 500, chunk 96, a 499-token prompt: the full forward's token);
     a 39-block pool that forces recompute preemption (the uncontended
     tokens, every block back). [serve]: the full 32-layer llama_7b in bf16,
     8 lanes, eight requests of 64 … 1536 prompt tokens (two sampled), 32
     tokens each: a timed run (prefill tokens/s and decode ms a step by CUDA
     events around each step call, TTFT and latency per request, the pool's
     bytes = pool_bytes, peak memory) and a recorded run whose greedy logits
     are held against the contiguous-cache steps fed the same tokens
     (SERVE_GATE_BF16). [serve-ckpt]: the fused phase's final state, saved at
     step 8, restored through launch/serve.py::load_checkpoint_params bit
     for bit and served (bf16 logits within the gate; in f32, tokens equal
     to the contiguous steps'). The serve CLI once, in process;
  10d. the model families (family_phases): [moe-kernels] the fp32 apply
     form of galore_epilogue's kernel on one whole 64-slab Llama-4 Scout
     expert leaf a side against its plain version (apply_row's gates, a
     chunk of slabs at a time; W' bitwise ref.apply_weight of its own G̃);
     [moe] Llama-4 Scout at full width, 4 of 48 layers (one iRoPE group),
     bf16, remat full, 8 GaLore steps r = 128, T = 8, randomized projector,
     in the apply form a printed memory reckoning chooses: losses finite and
     falling, aux_loss > 0 every step, apply left 32 and right 24 launches,
     state bytes within 0.01 %, peak memory; [moe-dispatch] one Scout MoE
     layer in f32 against the all-experts computation (y 1e-5·max,
     gradients 1e-4·max); [mrope] Qwen2-VL at 2 of 28 layers: text
     positions equal rope within 1e-6·max, a forward with 256 media
     embeddings finite, 8 fp32 fused GaLore steps (left 32, right 24);
     [serve-chunk] Scout's shape served across the 8,192 chunk boundary
     against the contiguous steps (caches of 8,736 and 104 tokens): f32
     within 1e-4·max and the same greedy picks, bf16 without experts within
     SERVE_GATE_BF16 at every token, bf16 MoE at every token whose routing
     (recorded in both runs with each decision's top-1 margin) agrees, and
     a token over the gate only after a routing tie within one bf16 ulp of
     the router logits (their count printed);
     [families] qwen2, granite, internlm2, minitron and grok-1 at 2 layers,
     one forward and backward each, everything finite; [ssm] mamba2_130m
     whole (24 layers, full width, bf16, remat full): 8 fp32 fused GaLore
     steps (r = 128, T = 8; B1 at in_z and in_x, 16 launches, B2 at
     out_proj, 8), losses finite and falling, then the Server's contiguous
     loop on prompts of 2, 7, 64 and 300 tokens: in f32 greedy tokens equal
     to the full forward's and every token's logits within 1e-4·max, in
     bf16 the median token within SERVE_GATE_BF16 and every token within
     the bf16 forward's own gap to its f32 self, prefill tokens/s and decode
     ms a step by CUDA events; [hybrid] one Jamba period (8 layers) at full
     width with its experts cut from 16 to 4 (top-2 kept) after a printed
     reckoning: served in f32 at a capacity with no drops (the Server's
     tokens equal to the full forward's, logits within 1e-4·max), then
     trained with GaLore in the apply form and the randomized projector at
     the expert count the reckoning lets fit (B3-apply right at in_dt, wk
     and wv, 72 launches; every left leaf keeps 8192 rows and fails the
     reference's fits_vmem); [whisper] whisper_small whole (12 encoder and
     12 decoder layers, d_model 768, bf16, remat full; nothing cut): 8 fp32
     fused GaLore steps (r = 128, T = 8) through train_loop's data hook on
     batches of 8 × 256 tokens and 8 × 1500 × 768 frames drawn on the card
     (B1 at the 14 attention and ffn.up leaves, 112 launches, B2 at the 2
     ffn.down leaves, 16), losses finite; dec_pos and frames drawn, a
     200-token prefill and 8 decode steps through make_prefill_step /
     make_decode_step against the full forward (f32 1e-4·max, bf16
     SERVE_GATE_BF16 at every token, or, where a token misses, the bf16
     model's own gap to its f32 self measured and printed); the Server on
     zero frames (prompts of 1, 4, 64 and 200 tokens, 8 new each): in f32
     the greedy tokens equal to the full forward's, prefill tokens/s and
     decode ms a step by CUDA events;
  10e. [dryrun]: eight training phases (fused, fused-apply, 8bit-apply,
     r1024-fused, adam8bit, adamw, moe, whisper) dry-run on meta tensors
     from their own config and batch (launch/dryrun.py::dry_run_step, on
     the host), the memory resident before each phase added: each predicted
     peak within 5 % of the phase's max_memory_allocated; then, with no gate,
     the reckonings of llama_7b at 32 layers, Scout in the emit form and a
     grok-1 GaLore step at 2 layers against the card's memory;
  10f. data parallel: [dp-kernels] B1/B2 and B3-int8 (f32 and int4 P) at
     the rank blocks of 64 that GaLore-ZeRO gives them at n_dp 2, B4/B5 at
     blocks of 512, each against its plain version with check_kernels',
     check_adam8's and check_project's gates; [dp] (dp_phase) four
     configurations of `python -m torch.distributed.run --nproc-per-node 2
     -m repro_torch.launch.train --dist-backend gloo` at llama_7b width, 1
     of 32 layers (cut by depth only), batch 8 × 256, 4 steps (5 for (a) and
     (b)), T = 8, both ranks on cuda:0, each against the same command in one
     process: (a) fp32 fused r = 128 with the sharded refresh, (b) ZeRO-1
     8-bit with int4 P, (c) ZeRO-2 with GaLore-DP, (d) ZeRO-1 fp32 at
     r = 1024 — losses within 5e-2 and equal on both ranks, each rank's
     launches a step (B1 6 / B2 1, B3-int8 6 / 1 on blocks, none, B4 / B5 7
     on blocks), per-rank state bytes equal to galore_zero_state_bytes, the
     staged collectives and step times from each rank's --report; (e) (a)'s
     and (b)'s step-2 checkpoints resumed in one process for steps 3 and 4:
     step 4 within 5e-2 and the update from step 2 to step 4 off the world's
     by at most DP_UPDATE_GAP of itself in each of wq, down and the
     embedding; (f) (a) as an NCCL world of 1, losses bit for bit and every
     checkpoint array's CRC-32 equal to the one-process run's; the phase
     timed;
  10g. activation checkpointing (models/remat.py): [remat] llama_7b width,
     2 of 32 layers, bf16, batch 2 × 4096, one loss_fn forward and backward
     under each of remat none, scores, names and full: loss and every
     gradient leaf within 1e-5·max of none's (the largest difference
     printed), each policy's max_memory_allocated within 5 % of
     launch/dryrun.py::dry_run_grad's, each forward and backward timed by
     CUDA events; [remat-7b] the whole llama_7b (32 layers, no depth cut),
     batch 1 × 4096, 8-bit GaLore in the apply form (int8 moments, int4 P,
     r = 128, randomized P, T = 8), 3 steps through train_loop under remat
     scores and again under full: losses finite (full's within 5e-2 of
     scores'), B3-apply int8 launched 6 left + 1 right a step, the peak
     within 5 % of dry_run_step's for the same config and batch, the
     non-refresh step beside the dry run's FLOPs a step as TFLOP/s; B3-apply
     int8 at the L = 32 gate/up leaf against its plain version, its
     per-launch time beside its bytes bound;
  11. record: the SVD refresh time at ranks 128 and 1024, step times and
     peak memory of every phase (the paper's 7B memory comparison, 8-bit
     GaLore at r = 1024 beside 8-bit Adam, Adafactor and AdamW, on one
     line), a JSON
     line of the kernels, the card's name and power limit, and last the
     result line.
The kernel checks of phase 3 also hold the fp32-moment kernel's int4-P forms
(B1, B2 and the apply form) to the same kernel launched on the
host-dequantized P, bit for bit; the flat 8-bit Adam kernel to its plain
version, codes, scales and update bit for bit, at the embedding's, an FFN,
an attention and the norm leaves' sizes and a ragged 1000 x 520 leaf; the
tiled projections B4 and B5 (split TF32 on
the tensor cores) at the
r = 1024 leaves (the down leaf's G read, and its G̃ written, transposed) and
a ragged shape, to 1e-5·max|want|, beside torch.matmul; and RMSNorm (B6, on no path)
at the model's norm input and a ragged 1000 x 520, f32 within 1e-5 relative
and bf16 within one ulp, beside torch.nn.functional.rms_norm. These two
short kernels (and their plain versions and F.rms_norm) are timed by their
device time (device_ms of tools/kernel_times.py: calls queued back to back
between one pair of events); a single call between two events ("call")
holds the host's time in the wrapper too, and is logged beside it.
Every bound is the least time the card could take: the bytes (each input
read once, each output written once) against the operations, the
projections as split TF32 on the tensor cores (2 passes with a bf16
operand, else 3) and the elementwise work on the f32 pipes; the f32-FMA
bound (no tensor cores) is printed beside it in the log lines.
"""
import contextlib
import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.launch.train as launcher  # noqa: E402
from kernel_times import copies_for, cuda_ms, device_ms, reps_for  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core import subspace  # noqa: E402
from repro_torch.core.galore import (  # noqa: E402
    galore_state_bytes,
    refresh_projectors_pending,
    swap_pending_state,
)
from repro_torch.core.projector import (  # noqa: E402
    compute_projector,
    read_projector,
    subspace_overlap,
)
from repro_torch.data.pipeline import DataConfig, SyntheticC4  # noqa: E402
from repro_torch.distributed.step import make_refresh_grads, make_train_step  # noqa: E402
from repro_torch.kernels import adam8bit_update as a8  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import galore_fused as gf  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels.ref import apply_weight, lowrank_adam_update  # noqa: E402
from repro_torch.distributed import step as dstep  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch.dryrun import (  # noqa: E402
    allocator_bytes,
    card_bytes,
    default_train_config,
    dry_run_grad,
    dry_run_step,
    fake_world,
    run_fake_rank,
    run_mesh_cell,
)
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models.model import init_params, loss_fn  # noqa: E402
from repro_torch.optim import lowrank  # noqa: E402
from repro_torch.optim.adafactor import adafactor_state_bytes  # noqa: E402
from repro_torch.optim.adam import scale_by_adam  # noqa: E402
from repro_torch.optim.adam8bit import adam8bit_state_bytes  # noqa: E402
from repro_torch.optim.factory import galore_state_index  # noqa: E402
from repro_torch.optim.transform import apply_updates  # noqa: E402
from repro_torch.quant import QuantPolicy, codec  # noqa: E402
from repro_torch.robust import init_guard_state  # noqa: E402
from repro_torch.utils import (  # noqa: E402
    flatten_up_to,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FMA FLOP/s,
# TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
SOURCE = "src/repro_torch/csrc/galore_epilogue.cu"
SOURCE_PROJECT = "src/repro_torch/csrc/galore_project.cu"
SOURCE_RMSNORM = "src/repro_torch/csrc/rmsnorm.cu"
KERNELS = {
    "left": dict(name="galore_fused_adam_left", wrapper=gf.galore_fused_adam_step,
                 plain=gf.galore_fused_adam_step_plain, source=SOURCE,
                 replaces="src/repro/kernels/galore_fused.py:169"),
    "right": dict(name="galore_fused_adam_right", wrapper=gf.galore_fused_adam_step_right,
                  plain=gf.galore_fused_adam_step_right_plain, source=SOURCE,
                  replaces="src/repro/kernels/galore_fused.py:268"),
    "adam8_left": dict(name="galore_fused_adam8_left", wrapper=gf.galore_fused_adam8_step,
                       plain=gf.galore_fused_adam8_step_plain, source=SOURCE,
                       replaces="src/repro/kernels/galore_fused.py:685"),
    "adam8_right": dict(name="galore_fused_adam8_right", wrapper=gf.galore_fused_adam8_step_right,
                        plain=gf.galore_fused_adam8_step_right_plain, source=SOURCE,
                        replaces="src/repro/kernels/galore_fused.py:702"),
    "apply_left": dict(name="galore_fused_adam_apply_left",
                       wrapper=gf.galore_fused_adam_apply_step,
                       plain=gf.galore_fused_adam_apply_step_plain, source=SOURCE,
                       replaces="src/repro/kernels/galore_fused.py:714"),
    "apply_right": dict(name="galore_fused_adam_apply_right",
                        wrapper=gf.galore_fused_adam_apply_step_right,
                        plain=gf.galore_fused_adam_apply_step_right_plain, source=SOURCE,
                        replaces="src/repro/kernels/galore_fused.py:727"),
    "adam8_apply_left": dict(name="galore_fused_adam8_apply_left",
                             wrapper=gf.galore_fused_adam8_apply_step,
                             plain=gf.galore_fused_adam8_apply_step_plain, source=SOURCE,
                             replaces="src/repro/kernels/galore_fused.py:737"),
    "adam8_apply_right": dict(name="galore_fused_adam8_apply_right",
                              wrapper=gf.galore_fused_adam8_apply_step_right,
                              plain=gf.galore_fused_adam8_apply_step_right_plain, source=SOURCE,
                              replaces="src/repro/kernels/galore_fused.py:751"),
    # the fp32-moment kernels' int4-P forms: the same wrappers, counted apart
    "p4_left": dict(name="galore_fused_adam_left (int4 P)", wrapper=gf.galore_fused_adam_step,
                    plain=gf.galore_fused_adam_step_plain, source=SOURCE,
                    replaces="src/repro/kernels/galore_fused.py:184"),
    "p4_right": dict(name="galore_fused_adam_right (int4 P)",
                     wrapper=gf.galore_fused_adam_step_right,
                     plain=gf.galore_fused_adam_step_right_plain, source=SOURCE,
                     replaces="src/repro/kernels/galore_fused.py:284"),
    "p4_apply_left": dict(name="galore_fused_adam_apply_left (int4 P)",
                          wrapper=gf.galore_fused_adam_apply_step,
                          plain=gf.galore_fused_adam_apply_step_plain, source=SOURCE,
                          replaces="src/repro/kernels/galore_fused.py:714"),
    "p4_apply_right": dict(name="galore_fused_adam_apply_right (int4 P)",
                           wrapper=gf.galore_fused_adam_apply_step_right,
                           plain=gf.galore_fused_adam_apply_step_right_plain, source=SOURCE,
                           replaces="src/repro/kernels/galore_fused.py:727"),
    "adam8bit": dict(name="adam8bit_blocks_update", wrapper=a8.adam8bit_update,
                     plain=a8.adam8bit_update_plain, source=SOURCE,
                     replaces="src/repro/kernels/galore_fused.py:762"),
    "project": dict(name="galore_project", wrapper=tp.galore_project,
                    plain=tp.galore_project_plain, source=SOURCE_PROJECT,
                    replaces="src/repro/kernels/galore_project.py:66"),
    "project_back": dict(name="galore_project_back", wrapper=tp.galore_project_back,
                         plain=tp.galore_project_back_plain, source=SOURCE_PROJECT,
                         replaces="src/repro/kernels/galore_project.py:115"),
    "rmsnorm": dict(name="rmsnorm", wrapper=trms.rmsnorm, plain=trms.rmsnorm_plain,
                    source=SOURCE_RMSNORM, replaces="src/repro/kernels/rmsnorm.py:25"),
}
# each kernel's launch count: the wrapper's `launches`, or `launches_int4` for
# the int4-P forms of the fp32-moment kernels
COUNTERS = {key: (k["wrapper"], "launches_int4" if key.startswith("p4_") else "launches")
            for key, k in KERNELS.items()}
# (side, L, m, r, n, on the main path): the slice's leaves at llama_7b width
# with 2 layers, the paper's 7B rank, and a ragged shape
SHAPES = [
    ("left", 2, 4096, 128, 4096, True),     # wq wk wv wo
    ("left", 2, 4096, 128, 11008, True),    # gate up
    ("left", 1, 4096, 1024, 11008, False),
    ("left", 1, 1000, 96, 520, False),
    ("right", 2, 11008, 128, 4096, True),   # down
    ("right", 1, 11008, 1024, 4096, False),
    ("right", 1, 1000, 96, 520, False),
]
ALPHA, COUNT = 0.25, 7
ETA, WD = -1e-3, 0.01  # the apply checks' -lr and weight decay
# galore_epilogue's kernel (int8 moments, and the fp32-moment apply form)
# runs at the same shapes, and at the leaves of llama_1b (2 layers) at the
# paper's 1B rank, r = 512, where the reference's fits_vmem holds, so 8-bit
# GaLore and the fp32 apply step at 1B width run it with four rank chunks:
# wq wk wv wo, gate up (G rows of 5461 bf16 = 10,922 bytes, which the TMA
# cannot describe) and down; stochastic rounding at one main shape per side
SHAPES8 = [
    ("left", 2, 2048, 512, 2048, False),
    ("left", 2, 2048, 512, 5461, False),
    ("right", 2, 5461, 512, 2048, False),
]
STOCHASTIC8 = {("left", 2, 4096, 128, 11008), ("right", 2, 11008, 128, 4096)}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(side, L, m, r, n, g_dtype, seed):
    """Inputs of step COUNT: P with orthonormal columns (as a GaLore
    projector), G, and M/V left by COUNT - 1 earlier Adam steps on compact
    gradients of R's scale. Moments drawn independently of each other (a
    tiny V beside a non-zero M, which no Adam run produces) make N̂ so
    sensitive to R that two f32 summation orders differ by more than
    1e-5·max|G̃| — and either differs that much from an f64 reference."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    P = torch.linalg.qr(rnd(L, *kept))[0].contiguous()
    G = rnd(L, m, n).to(g_dtype)
    M = torch.zeros(L, *mv, device="cuda")
    V = torch.zeros(L, *mv, device="cuda")
    for t in range(1, COUNT):
        _, M, V = lowrank_adam_update(rnd(L, *mv), M, V, torch.tensor(t, device="cuda"))
    return P, G, M, V, torch.tensor(COUNT, dtype=torch.int32, device="cuda")


def p_bytes(L, kept, r, p_int4):
    """Bytes of one read of P: f32, or packed nibbles + one f32 scale a
    128-row block and column."""
    if p_int4:
        return L * -(-kept // codec.QBLOCK) * r * (codec.QBLOCK // 2 + 4)
    return 4 * L * kept * r


def out_cost(L, m, n, w_itemsize):
    """Bytes and operations of a launch's output: G̃ written in f32 (emit),
    or W read and written in its dtype and 4 operations an element (apply)."""
    if w_itemsize is None:
        return 4 * L * m * n, 0
    return 2 * w_itemsize * L * m * n, 4 * L * m * n


def step_bound(L, m, r, n, g_itemsize, nbytes, ew_ops):
    """Least time (s) of one GaLore leaf step, what bounds it, and its
    f32-FMA bound: its bytes (each input read once, each output written once)
    against its operations — the two contractions R = PᵀG and G̃ = αPN̂
    (2·L·m·r·n each) as split TF32 on the tensor cores at f32 accuracy (R in
    2 passes with a bf16 G, which is exact in TF32, else 3; G̃ in 3), as
    gemm_bound counts B4/B5, plus `ew_ops` elementwise f32 operations on the
    FMA pipes. The f32-FMA bound (both contractions at 67 TFLOP/s) is the
    least time without the tensor cores; it goes to the log lines only."""
    mac = 2 * L * m * r * n
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ((2 if g_itemsize == 2 else 3) + 3) * mac / PEAK_TF32 + ew_ops / PEAK_F32
    t_f32 = max(t_bytes, (2 * mac + ew_ops) / PEAK_F32)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_f32


def bound(side, L, m, r, n, g_itemsize, w_itemsize=None, p_int4=False):
    """step_bound of one fp32-moment launch: P, G, M and V read once, M', V'
    and G̃ (or W') written once; ~12 f32 operations a moment element (the
    elementwise Adam) and the weight apply's 4 an element."""
    kept = m if side == "left" else n
    mv = L * r * (n if side == "left" else m)
    out_bytes, out_flops = out_cost(L, m, n, w_itemsize)
    nbytes = p_bytes(L, kept, r, p_int4) + g_itemsize * L * m * n + 4 * 4 * mv + out_bytes
    return step_bound(L, m, r, n, g_itemsize, nbytes, 12 * mv + out_flops)


def check_kernels(shapes=None):
    """The fp32-moment emit form of galore_epilogue's kernel (B1, B2, and
    their int4-P forms) against its plain version at every SHAPES entry (G
    bf16 and f32) and every SHAPES8 entry (G bf16) — or at `shapes` (G
    bf16) — P f32 and packed int4:
    G̃, M' and V' within 1e-5·max|want| + 1e-5·|want|, two launches on the
    same inputs bitwise equal, and an int4-P launch bit for bit the launch on
    the host-dequantized P. Each line names the launch's route and cluster
    size; times kernel and plain version."""
    rows = []
    for i, (side, L, m, r, n, main) in enumerate(shapes or SHAPES + SHAPES8):
        two = shapes is None and i < len(SHAPES)
        dtypes = (torch.bfloat16, torch.float32) if two else (torch.bfloat16,)
        for dt in dtypes:
            P, G, M, V, count = kernel_inputs(side, L, m, r, n, dt, seed=i)
            P4 = codec.quant4_axis_state(P)
            P4_host = codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2]).contiguous()
            for p4 in (False, True):
                key = ("p4_" if p4 else "") + side
                k, Pa = KERNELS[key], (P4 if p4 else P)
                tag = (f"{k['name']} L={L} (m,r,n)=({m},{r},{n}) G "
                       f"{str(dt).removeprefix('torch.')}")
                want = k["plain"](Pa, G, M, V, count, alpha=ALPHA)
                before = thread_copies()
                got = k["wrapper"](Pa, G, M.clone(), V.clone(), count, alpha=ALPHA)
                torch.cuda.synchronize()
                tag += " " + route(before)
                errs = [close_or_raise(a, b, f"{tag} {name}")
                        for name, a, b in zip(("G̃", "M'", "V'"), got, want)]
                again = k["wrapper"](Pa, G, M.clone(), V.clone(), count, alpha=ALPHA)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{tag}: two launches on the same inputs differ")
                note = "two launches equal"
                if p4:  # in-kernel int4 dequant == launching with the host-dequantized P
                    host = k["wrapper"](P4_host, G, M.clone(), V.clone(), count, alpha=ALPHA)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, host)):
                        raise AssertionError(f"{tag}: differs from the host-dequantized-P launch")
                    note += ", equal to the host-dequantized-P launch"
                    del host
                Mw, Vw = M.clone(), V.clone()
                ms = cuda_ms(lambda: k["wrapper"](Pa, G, Mw, Vw, count, alpha=ALPHA), 3, 10)
                plain_ms = cuda_ms(lambda: k["plain"](Pa, G, M, V, count, alpha=ALPHA), 2, 5)
                b_s, b_by, b_f32 = bound(side, L, m, r, n, G.element_size(), p_int4=p4)
                rows.append(dict(kernel=key, side=side, L=L, m=m, r=r, n=n,
                                 g_dtype=str(dt).removeprefix("torch."),
                                 p="int4" if p4 else "f32", main_path=main,
                                 max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_s * 1e3, bound_by=b_by))
                log(f"[kernels] {tag} P {'int4' if p4 else 'f32'}: max|err| G̃/M'/V' "
                    f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (max|G̃| "
                    f"{float(want[0].abs().max()):.2e}); {note} ok  kernel {ms:.3f} ms  plain "
                    f"{plain_ms:.3f} ms  bound {b_s * 1e3:.3f} ms ({b_by}; {b_s / ms * 1e5:.0f} % "
                    f"of it; f32-FMA {b_f32 * 1e3:.3f})")
                del want, got, again, Mw, Vw
            del P, P4, P4_host, G, M, V
    torch.cuda.empty_cache()
    return rows


def adam8_inputs(side, L, m, r, n, seed):
    """P with orthonormal columns, the int8 moments (codes and scales) of step
    COUNT — what COUNT - 1 earlier steps of the plain 8-bit version leave on
    gradients of unit scale (the recipe of ROADMAP C.3) — and an f32 G."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    P = torch.linalg.qr(rnd(L, *kept))[0].contiguous()
    ax = -1 if side == "left" else -2
    zeros = torch.zeros(L, *mv, device="cuda")
    mom = (*codec.quantize_axis(zeros, axis=ax, signed=True),
           *codec.quantize_axis(zeros, axis=ax, signed=False))
    plain = KERNELS["adam8_" + side]["plain"]
    for t in range(1, COUNT):
        mom = plain(P, rnd(L, m, n), *mom, torch.tensor(t, dtype=torch.int32, device="cuda"))[1:]
    return P, [x.contiguous() for x in mom], rnd(L, m, n)


def bytes8(side, L, m, r, n, g_itemsize, p_int4, w_itemsize=None):
    """Bytes of one int8-moment launch: G read and G̃ written once (or W
    read and written), the codes and scales of M and V read and written
    once, P read once (packed nibbles + scales, or f32)."""
    kept, swept = (m, n) if side == "left" else (n, m)
    nb = -(-swept // codec.QBLOCK)
    return (g_itemsize * L * m * n + out_cost(L, m, n, w_itemsize)[0] + 2 * 2 * L * r * swept
            + 2 * 2 * 4 * L * r * nb + p_bytes(L, kept, r, p_int4))


def bound8(side, L, m, r, n, g_itemsize, p_int4, w_itemsize=None):
    """step_bound of one int8-moment launch: its bytes (bytes8); ~20 f32
    operations a moment element (dequant, Adam, absmax, requant), and the
    weight apply's 4 an element."""
    swept = n if side == "left" else m
    return step_bound(L, m, r, n, g_itemsize, bytes8(side, L, m, r, n, g_itemsize, p_int4,
                                                      w_itemsize),
                      20 * L * r * swept + out_cost(L, m, n, w_itemsize)[1])


def check_bound8():
    """bound8 at the main gate/up leaf (2, 4096, 128, 11008) counts the two
    contractions as split TF32 — 2 + 3 passes with a bf16 G, 3 + 3 with an
    f32 G — plus 20 f32 operations a moment element, and is bound by them."""
    L, m, r, n = 2, 4096, 128, 11008
    mac = 2 * L * m * r * n
    for g_itemsize, passes in ((2, 5), (4, 6)):
        t, by, t_f32 = bound8("left", L, m, r, n, g_itemsize, True)
        want = passes * mac / PEAK_TF32 + 20 * L * r * n / PEAK_F32
        if by != "operations" or abs(t - want) > 1e-12 * want or not t < t_f32:
            raise AssertionError(f"bound8 at the main shape, G {g_itemsize} B: {t:.6e} s "
                                 f"({by}), want {want:.6e} s (operations, below {t_f32:.6e})")


def compare8(got, want, tag, names=("update", "mq", "ms", "vq", "vs")):
    """G̃ and scales within 1e-5·max|want| + 1e-5·|want|, codes at most 1
    apart; returns (max |err| of G̃ and scales, share of codes that differ)."""
    errs, differ, total = [], 0, 0
    for name, a, b in zip(names, got, want):
        if b.dtype == torch.uint8:
            d = (a.int() - b.int()).abs()
            if int(d.max()) > 1:
                raise AssertionError(f"{tag} {name}: codes {int(d.max())} apart (limit 1)")
            differ += int((d > 0).sum())
            total += d.numel()
            continue
        diff = (a - b).abs()
        tol = 1e-5 * b.abs().max() + 1e-5 * b.abs()
        if bool((diff > tol).any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} {name}: max|err| {float(diff.max()):.3e} over tolerance "
                                 f"(1e-5·max|want| = {float(1e-5 * b.abs().max()):.3e})")
        errs.append(float(diff.max()))
    return max(errs), differ / total


def route(copied_before):
    """The route and cluster of the last launch of galore_epilogue's GaLore
    kernel, for the log: "(TMA, C=2)" or "(thread copies, C=1)"; the thread
    copies counted since `copied_before` (its eight wrappers'
    launches_thread_copy)."""
    copied = thread_copies() > copied_before
    return f"({'thread copies' if copied else 'TMA'}, C={gf.epilogue_last_cluster()})"


def thread_copies():
    return sum(fn.launches_thread_copy for fn in gf.WRAPPERS_TMA)


def check_adam8(shapes=None):
    rows = []
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    for i, (side, L, m, r, n, main) in enumerate(shapes or SHAPES + SHAPES8):
        k = KERNELS["adam8_" + side]
        P, mom, G32 = adam8_inputs(side, L, m, r, n, seed=100 + i)
        P4 = codec.quant4_axis_state(P)
        P4_host = codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2])
        variants = [(dt, p4, False) for dt in (torch.bfloat16, torch.float32)
                    for p4 in (False, True)]
        if (side, L, m, r, n) in STOCHASTIC8:
            variants.append((torch.bfloat16, True, True))
        for dt, p4, sr in variants:
            G, Pa = G32.to(dt), (P4 if p4 else P)
            tag = (f"{k['name']} L={L} (m,r,n)=({m},{r},{n}) G {str(dt).removeprefix('torch.')} "
                   f"P {'int4' if p4 else 'f32'}{' stochastic' if sr else ''}")
            run = lambda P_, mom_: k["wrapper"](P_, G, *mom_, count, alpha=ALPHA,  # noqa: E731
                                                stochastic=sr)
            want = k["plain"](Pa, G, *mom, count, alpha=ALPHA, stochastic=sr)
            before = thread_copies()
            got = run(Pa, [x.clone() for x in mom])
            torch.cuda.synchronize()
            tag += " " + route(before)
            err, share = compare8(got, want, tag)
            again = run(Pa, [x.clone() for x in mom])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: two launches on the same inputs differ")
            host = ""
            if p4:  # in-kernel int4 dequant == launching with the host-dequantized P
                ref_ = run(P4_host, [x.clone() for x in mom])
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got[1::2], ref_[1::2])):
                    raise AssertionError(f"{tag}: codes differ from the host-dequantized-P launch")
                d_host = float((got[0] - ref_[0]).abs().max())
                if d_host > 2e-5 * float(ref_[0].abs().max()):
                    raise AssertionError(f"{tag}: G̃ {d_host:.3e} from the host-dequantized-P "
                                         f"launch (limit 2e-5·max)")
                host = f"; vs host-dequantized P: codes equal, G̃ Δ {d_host:.1e}"
            mine = [x.clone() for x in mom]
            ms = cuda_ms(lambda: run(Pa, mine), 3, 10)
            plain_ms = cuda_ms(lambda: k["plain"](Pa, G, *mom, count, alpha=ALPHA,
                                                  stochastic=sr), 2, 5)
            b_s, b_by, b_f32 = bound8(side, L, m, r, n, G.element_size(), p4)
            rows.append(dict(kernel="adam8_" + side, side=side, L=L, m=m, r=r, n=n,
                             g_dtype=str(dt).removeprefix("torch."),
                             p="int4" if p4 else "f32", stochastic=sr, main_path=main,
                             max_abs_err=err, codes_differ=share, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_s * 1e3, bound_by=b_by))
            log(f"[kernels] {tag}: max|err| G̃/scales {err:.2e} (max|G̃| "
                f"{float(want[0].abs().max()):.2e}), codes differing {share:.2e}{host}; two "
                f"launches equal ok  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
                f"{b_s * 1e3:.3f} ms ({b_by}; {b_s / ms * 1e5:.0f} % of it; f32-FMA "
                f"{b_f32 * 1e3:.3f})")
            del G, want, got, mine, again
        del P, P4, P4_host, mom, G32
    torch.cuda.empty_cache()
    return rows


def int4_rows(rows):
    """B3-int4's row of record: the int8 kernel with int4 P (bf16 G, nearest
    rounding) at the main path's three leaves, its time beside the plain
    version's (the same int4 P) and its bound, from check_adam8's rows."""
    for r in rows:
        if (r["kernel"].startswith("adam8_") and r["p"] == "int4" and r["main_path"]
                and r["g_dtype"] == "bfloat16" and not r["stochastic"]):
            log(f"[kernels] {card_line()}: B3-int4 {r['side']} (L,m,r,n)=({r['L']},{r['m']},"
                f"{r['r']},{r['n']}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}; "
                f"{bytes8(r['side'], r['L'], r['m'], r['r'], r['n'], 2, True) / PEAK_BYTES * 1e3:.3f}"
                f" ms of bytes at 3.35 TB/s)")


def weight_check(got, want, w0, tag):
    """W' against the plain version's; returns (max |got - want|, a note).
    f32 W: W' - W (in f64) within 1e-5·max|want - W| + 2 f32 ulps of W'.
    bf16 W: one bf16 ulp of W' (one rounding each), plus the same 1e-5·
    max|want - W| of the applied change: where W' is near 0 (W ≈ -η G̃) the
    f32 sum cancels, and a G̃ that differs within its own tolerance moves the
    tiny W' by several of its tiny ulps. Elements beyond one ulp are counted
    and printed, with the largest |W'| among them."""
    g, w = got.double(), want.double()
    change = w - w0.double()
    slack = 1e-5 * change.abs().max()
    if w0.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
        over = (g - w).abs() > ulp
        bad = (g - w).abs() > ulp + slack
        note = f"; {int(over.sum())} of {over.numel()} more than one bf16 ulp apart"
        if bool(over.any()):
            note += f", all at |W'| ≤ {float(w[over].abs().max()):.2e}"
        limit = "one bf16 ulp + 1e-5·max|W' - W|"
    else:
        wa = want.abs()
        spacing = (torch.nextafter(wa, torch.full_like(wa, math.inf)) - wa).double()
        bad = ((g - w0.double()) - change).abs() > slack + 2 * spacing
        note, limit = "", "1e-5·max|W' - W| + 2 ulp"
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        i = int(((g - w).abs() * bad).flatten().argmax())
        w_i, want_i, got_i = (float(x.flatten()[i]) for x in (w0, w, g))
        raise AssertionError(f"{tag} W: {int(bad.sum())} elements over {limit} (max|err| "
                             f"{float((g - w).abs().max()):.3e}; worst at W {w_i:.6e}, want "
                             f"{want_i:.6e}, got {got_i:.6e})")
    return float((g - w).abs().max()), note


def own_gt(wrapper, P, G, moments, count):
    """The fp32-moment apply kernel's own G̃: a launch on an f32 W of zeros
    with η = 1 and wd = 0 writes W' = 0 + 1·(G̃ + 0·0) = G̃ exactly (the
    moments are copies)."""
    out = torch.zeros(G.shape, device="cuda")
    wrapper(P, G, out, *[x.clone() for x in moments], count, alpha=ALPHA,
            eta=torch.tensor(1.0, device="cuda"), wd=0.0)
    return out


def check_apply():
    """The weight-apply forms of galore_epilogue's kernel, fp32 and int8
    moments, against their plain versions at every SHAPES and SHAPES8 entry,
    G bf16, W bf16 and f32, P f32 and int4. Beside the tolerances: the fp32
    form's W' must equal ref.apply_weight of the kernel's own G̃ (own_gt) bit
    for bit, at every rank; the int8 form's W' must equal the plain
    version's bit for bit wherever its emit form's G̃ equals the plain G̃ (the
    two forms share every operation up to the store; with more than one rank
    chunk the apply form contracts G̃ in another order, so not there); two
    launches on the same inputs are bitwise equal; an int4-P launch equals
    the launch on the host-dequantized P; and the wrapper returns W itself,
    updated in place. Each line names the launch's route and cluster size."""
    rows = []
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    eta = torch.tensor(ETA, device="cuda")
    hp = dict(alpha=ALPHA, eta=eta, wd=WD)
    for i, (side, L, m, r, n, main) in enumerate(SHAPES + SHAPES8):
        W32 = 0.02 * torch.randn(L, m, n, generator=torch.Generator(device="cuda").manual_seed(
            200 + i), device="cuda")
        # fp32 moments
        P, G, M, V, _ = kernel_inputs(side, L, m, r, n, torch.bfloat16, seed=i)
        P4 = codec.quant4_axis_state(P)
        P4_host = codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2]).contiguous()
        for p4 in (False, True):
            key = ("p4_apply_" if p4 else "apply_") + side
            k, Pa = KERNELS[key], (P4 if p4 else P)
            gt_own = own_gt(k["wrapper"], Pa, G, (M, V), count)
            for wdt in (torch.bfloat16, torch.float32):
                W = W32.to(wdt)
                tag = (f"{k['name']} L={L} (m,r,n)=({m},{r},{n}) G bfloat16 "
                       f"W {str(wdt).removeprefix('torch.')}")
                want = k["plain"](Pa, G, W, M, V, count, **hp)
                w0, mine = W.clone(), (M.clone(), V.clone())
                before = thread_copies()
                got = k["wrapper"](Pa, G, W, *mine, count, **hp)
                torch.cuda.synchronize()
                tag += " " + route(before)
                again = k["wrapper"](Pa, G, w0.clone(), M.clone(), V.clone(), count, **hp)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{tag}: two launches on the same inputs differ")
                if p4:  # in-kernel int4 dequant == launching with the host-dequantized P
                    host = k["wrapper"](P4_host, G, w0.clone(), M.clone(), V.clone(), count, **hp)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, host)):
                        raise AssertionError(f"{tag}: differs from the host-dequantized-P launch")
                    del host
                del again
                rows.append(apply_row(key, k, side, L, m, r, n, main, wdt, "int4" if p4 else "f32",
                                      False, W, w0, mine, got, want, None, None, tag,
                                      lambda: k["wrapper"](Pa, G, W, *mine, count, **hp),
                                      lambda: k["plain"](Pa, G, w0, M, V, count, **hp),
                                      bound(side, L, m, r, n, 2, W.element_size(), p4),
                                      own=apply_weight(w0, gt_own, eta, WD)))
                del W, want, got, w0, mine
            del gt_own
        del P, P4, P4_host, G, M, V
        # int8 moments: the adam8 kernel with the apply epilogue
        k, emit = KERNELS["adam8_apply_" + side], KERNELS["adam8_" + side]
        P, mom, G32 = adam8_inputs(side, L, m, r, n, seed=100 + i)
        G = G32.to(torch.bfloat16)
        P4 = codec.quant4_axis_state(P)
        P4_host = codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2])
        variants = [(wdt, p4, False) for wdt in (torch.bfloat16, torch.float32)
                    for p4 in (False, True)]
        if (side, L, m, r, n) in STOCHASTIC8:
            variants.append((torch.bfloat16, True, True))
        for wdt, p4, sr in variants:
            W, Pa = W32.to(wdt), (P4 if p4 else P)
            tag = (f"{k['name']} L={L} (m,r,n)=({m},{r},{n}) G bfloat16 "
                   f"W {str(wdt).removeprefix('torch.')} P {'int4' if p4 else 'f32'}"
                   f"{' stochastic' if sr else ''}")
            gt_k = (emit["wrapper"](Pa, G, *[x.clone() for x in mom], count, alpha=ALPHA,
                                    stochastic=sr)[0] if r <= codec.QBLOCK else None)
            gt_p = emit["plain"](Pa, G, *mom, count, alpha=ALPHA, stochastic=sr)[0]
            want = k["plain"](Pa, G, W, *mom, count, stochastic=sr, **hp)
            w0, mine = W.clone(), [x.clone() for x in mom]
            before = thread_copies()
            got = k["wrapper"](Pa, G, W, *mine, count, stochastic=sr, **hp)
            torch.cuda.synchronize()
            tag += " " + route(before)
            W_2 = w0.clone()
            again = k["wrapper"](Pa, G, W_2, *[x.clone() for x in mom], count, stochastic=sr,
                                 **hp)
            torch.cuda.synchronize()
            if not (torch.equal(W, W_2) and all(torch.equal(a, b)
                                                for a, b in zip(got[1:], again[1:]))):
                raise AssertionError(f"{tag}: two launches on the same inputs differ")
            del W_2, again
            if p4:  # in-kernel int4 dequant == launching with the host-dequantized P
                W_h = w0.clone()
                ref_ = k["wrapper"](P4_host, G, W_h, *[x.clone() for x in mom], count,
                                    stochastic=sr, **hp)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got[1::2], ref_[1::2])):
                    raise AssertionError(f"{tag}: codes differ from the host-dequantized-P launch")
                if not torch.equal(W, W_h):
                    raise AssertionError(f"{tag}: W' differs from the host-dequantized-P launch")
                del W_h, ref_
            rows.append(apply_row("adam8_apply_" + side, k, side, L, m, r, n, main, wdt,
                                  "int4" if p4 else "f32", sr, W, w0, mine, got, want, gt_k, gt_p,
                                  tag,
                                  lambda: k["wrapper"](Pa, G, W, *mine, count, stochastic=sr,
                                                       **hp),
                                  lambda: k["plain"](Pa, G, w0, *mom, count, stochastic=sr,
                                                     **hp),
                                  bound8(side, L, m, r, n, 2, p4, W.element_size())))
            del W, want, got, w0, mine, gt_k, gt_p
        del P, P4, P4_host, mom, G32, G, W32
    torch.cuda.empty_cache()
    return rows


def apply_row(key, k, side, L, m, r, n, main, wdt, p, sr, W, w0, mine, got, want, gt_k, gt_p,
              tag, run, run_plain, bound_, own=None):
    """Check one apply launch (its outputs are `got`, W updated in place from
    `w0`; `own`, where given, the W' it must equal bit for bit), time it and
    its plain version, and return its row."""
    if got[0] is not W or got[0].data_ptr() != W.data_ptr():
        raise AssertionError(f"{tag}: the wrapper did not return W itself")
    w_err, w_note = weight_check(W, want[0], w0, tag)
    if len(want) == 3:
        errs = []
        for name, a, b in zip(("m", "v"), got[1:], want[1:]):
            tol = 1e-5 * b.abs().max() + 1e-5 * b.abs()
            if bool(((a - b).abs() > tol).any()):
                raise AssertionError(f"{tag} {name}: max|err| {float((a - b).abs().max()):.3e} "
                                     f"over tolerance")
            errs.append(float((a - b).abs().max()))
        mom_err, share = max(errs), 0.0
    else:
        mom_err, share = compare8(got[1:], want[1:], tag, names=("mq", "ms", "vq", "vs"))
    same = ""
    if gt_k is not None:  # W' bitwise wherever the emit form's G̃ is
        eq = gt_k == gt_p
        if not torch.equal(W[eq], want[0][eq]):
            raise AssertionError(f"{tag}: W' differs from the plain version's where the emit "
                                 f"kernel's G̃ equals the plain G̃")
        same = f"; G̃ bitwise at {float(eq.float().mean()):.1%}, W' bitwise there"
    if own is not None:
        if not torch.equal(W, own):
            raise AssertionError(f"{tag}: W' differs from ref.apply_weight of the kernel's own G̃")
        same = "; W' bitwise ref.apply_weight of its own G̃; two launches equal"
    ms = cuda_ms(run, 3, 10)
    plain_ms = cuda_ms(run_plain, 2, 5)
    b_s, b_by, b_f32 = bound_
    log(f"[kernels] {tag}: max|err| W' {w_err:.2e}{w_note}; moments {mom_err:.2e}"
        f"{f', codes differing {share:.2e}' if len(want) == 5 else ''}{same}; in place ok  "
        f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {b_s * 1e3:.3f} ms ({b_by}; "
        f"{b_s / ms * 1e5:.0f} % of it; f32-FMA {b_f32 * 1e3:.3f})")
    return dict(kernel=key, side=side, L=L, m=m, r=r, n=n, g_dtype="bfloat16",
                w_dtype=str(wdt).removeprefix("torch."), p=p, stochastic=sr, main_path=main,
                max_abs_err=w_err, moment_err=mom_err, codes_differ=share, ms=ms,
                plain_ms=plain_ms, bound_ms=b_s * 1e3, bound_by=b_by)


# (shape, on the main path) of the flat 8-bit Adam checks: the (tied)
# embedding, an FFN, an attention and the two norm leaf sizes of the main path
# (the stacked attention and FFN norms, the final norm), and a ragged leaf
# whose last block is partial
FLAT_SHAPES = [((32000, 4096), True), ((2, 4096, 11008), True), ((2, 4096, 4096), True),
               ((2, 4096), True), ((4096,), True), ((1000, 520), False)]
FLAT_OPS = 35  # f32 operations an element: dequant 2, moments 7, absmax 4, requant 18, update 4


def flat_inputs(shape, seed):
    """g (bf16) and the flat int8 moments of step COUNT: what COUNT - 1
    earlier steps of the plain version leave on gradients of unit scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    numel = math.prod(shape)
    zeros = torch.zeros(numel, device="cuda")
    mom = (*codec.quantize(zeros, signed=True), *codec.quantize(zeros, signed=False))
    for t in range(1, COUNT):
        g = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        mom = a8.adam8bit_update_plain(g, *mom, torch.tensor(t, dtype=torch.int32,
                                                              device="cuda"))[1:]
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16), mom


def check_adam8bit():
    """The flat 8-bit Adam kernel against its plain version at FLAT_SHAPES, g
    bf16 as the main path gives it: codes, scales and the bf16 update bit for
    bit (both run the same explicitly rounded f32 operations in one order and
    the codec's midpoint rule, then round the update once). Times kernel and
    plain version by their device time (device_ms, the inputs in copies that
    exceed the L2) and the kernel's single call (cuda_ms, host included); the
    bound is bytes: g and the update once, each code read and written once,
    each scale read and written once."""
    rows = []
    k = KERNELS["adam8bit"]
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    for i, (shape, main) in enumerate(FLAT_SHAPES):
        g, mom = flat_inputs(shape, seed=400 + i)
        numel, nb = g.numel(), mom[0].shape[0]
        want = k["plain"](g, *mom, count)
        mine = [x.clone() for x in mom]
        got = k["wrapper"](g, *mine, count)
        torch.cuda.synchronize()
        for name, a, b in zip(("update", "mq", "ms", "vq", "vs"), got, want):
            if not torch.equal(a, b):
                d = (a.float() - b.float()).abs()
                raise AssertionError(f"{k['name']} {shape} {name}: {int((d > 0).sum())} elements "
                                     f"differ from the plain version (max {float(d.max()):.3e})")
        nbytes = 2 * numel * g.element_size() + 4 * nb * codec.BLOCK + 4 * 4 * nb
        sets = [(g.clone(), [x.clone() for x in mom]) for _ in range(copies_for(nbytes))]
        call_ms = cuda_ms(lambda: k["wrapper"](g, *mine, count), 3, 10)
        ms = device_ms([lambda g=g_, m=m_: k["wrapper"](g, *m, count) for g_, m_ in sets],
                       reps_for(call_ms))
        plain_ms = device_ms([lambda g=g_, m=m_: k["plain"](g, *m, count) for g_, m_ in sets],
                             reps_for(10 * call_ms))
        t_bytes, t_ops = nbytes / PEAK_BYTES, FLAT_OPS * numel / PEAK_F32
        b_s, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        rows.append(dict(kernel="adam8bit", shape=list(shape), numel=numel, g_dtype="bfloat16",
                         main_path=main, max_abs_err=0.0, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=b_s * 1e3, bound_by=b_by, m=numel, n=1))
        log(f"[kernels] {k['name']} g {tuple(shape)} bfloat16 ({nb} blocks): update, codes and "
            f"scales equal to the plain version's ok  kernel {ms:.4f} ms (device; call "
            f"{call_ms:.4f} ms)  plain {plain_ms:.4f} ms (device)  bound {b_s * 1e3:.5f} ms "
            f"({b_by}, {nbytes / 1e9:.6f} GB; {nbytes / ms / 1e6:.0f} GB/s achieved; "
            f"{len(sets)} input copies)")
        del g, mom, want, mine, got, sets
    torch.cuda.empty_cache()
    return rows


# (leaf, L, m, r, n, G stored transposed, on the main path) of the tiled
# projection checks: the r = 1024 leaves of llama_7b with 2 layers — wq wk wv
# wo, gate up, and down, whose G (2, 11008, 4096) B4 reads transposed and
# whose G̃ B5 writes transposed — and a ragged shape
PROJECT_SHAPES = [
    ("left", 2, 4096, 1024, 4096, False, True),
    ("left", 2, 4096, 1024, 11008, False, True),
    ("down", 2, 4096, 1024, 11008, True, True),
    ("ragged", 1, 1000, 96, 520, False, False),
]


def close_or_raise(got, want, tag):
    """got within 1e-5·max|want| + 1e-5·|want| of want, and finite; returns
    max |got - want|."""
    diff = (got - want).abs()
    tol = 1e-5 * want.abs().max() + 1e-5 * want.abs()
    if bool((diff > tol).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: max|err| {float(diff.max()):.3e} over tolerance "
                             f"(1e-5·max|want| = {float(1e-5 * want.abs().max()):.3e})")
    return float(diff.max())


def gemm_bound(L, m, r, n, in_bytes, out_bytes, passes, scale_ops=0):
    """Least time (s) of one projection launch, and what bounds it: its
    inputs read once and its output written once, against its operations —
    the contraction (2·L·m·r·n) in `passes` split-TF32 passes on the tensor
    cores (3, or 2 with a bf16 G, which is exact in TF32) and any
    elementwise scale on the f32 pipes. Also returns the f32-FMA bound, the
    contraction at 67 TFLOP/s (the least time without the tensor cores)."""
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    t_ops = passes * 2 * L * m * r * n / PEAK_TF32 + scale_ops / PEAK_F32
    t_f32 = max(t_bytes, (2 * L * m * r * n + scale_ops) / PEAK_F32)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_f32


def check_project(shapes=None):
    """B4 and B5 (split TF32 on the tensor cores) against their plain
    versions (cuBLAS SGEMM) at PROJECT_SHAPES, to
    1e-5·max|want| (+ 1e-5·|want|) with TF32 off: B4 with G bf16 and f32
    (stored (L, m, n), or (L, n, m) for down), B5 on N̂-sized f32 input
    (written (L, m, n), or transposed for down). P has orthonormal columns.
    Times kernel, plain version and the library call — torch.matmul(P.mT,
    G.float()) for B4 (the cast timed in), alpha · torch.matmul(P, N) for B5
    (the scale timed in; through the transposes for down)."""
    rows = []
    for i, (leaf, L, m, r, n, trans, main) in enumerate(shapes or PROJECT_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        P = torch.linalg.qr(torch.randn(L, m, r, generator=gen, device="cuda"))[0].contiguous()
        G32 = torch.randn(L, *((n, m) if trans else (m, n)), generator=gen, device="cuda")
        shape = dict(L=L, m=m, r=r, n=n, leaf=leaf, main_path=main)
        for dt in (torch.bfloat16, torch.float32):
            G = G32.to(dt)
            tag = (f"galore_project {leaf} L={L} (m,r,n)=({m},{r},{n}) G "
                   f"{str(dt).removeprefix('torch.')}{' read transposed' if trans else ''}")
            want = tp.galore_project_plain(P, G, trans)
            copied = tp.galore_project.launches_thread_copy
            got = tp.galore_project(P, G, transpose_g=trans)
            torch.cuda.synchronize()
            err = close_or_raise(got, want, tag)
            tag += (" (thread copies)" if tp.galore_project.launches_thread_copy > copied
                    else " (TMA)")
            ms = cuda_ms(lambda: tp.galore_project(P, G, transpose_g=trans), 3, 10)
            plain_ms = cuda_ms(lambda: tp.galore_project_plain(P, G, trans), 2, 5)
            lib = ((lambda: torch.matmul(P.mT, G.float().mT)) if trans
                   else (lambda: torch.matmul(P.mT, G.float())))
            library_ms = cuda_ms(lib, 3, 10)
            b_s, b_by, b_f32 = gemm_bound(L, m, r, n,
                                          4 * L * m * r + G.element_size() * L * m * n,
                                          4 * L * r * n, 2 if dt == torch.bfloat16 else 3)
            rows.append(dict(kernel="project", g_dtype=str(dt).removeprefix("torch."),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=b_s * 1e3, bound_by=b_by,
                             **shape))
            log(f"[kernels] {tag}: max|err| {err:.2e} (max|R| {float(want.abs().max()):.2e}; "
                f"{err / float(1e-5 * want.abs().max()):.2f} of 1e-5·max) ok  kernel {ms:.3f} ms  "
                f"plain {plain_ms:.3f} ms  torch.matmul {library_ms:.3f} ms  tensor-core bound "
                f"{b_s * 1e3:.3f} ms ({b_by}; {b_s * 1e3 / ms:.0%} of it)  f32-FMA bound "
                f"{b_f32 * 1e3:.3f} ms")
            del G, want, got
        N = torch.randn(L, r, n, generator=gen, device="cuda")
        tag = (f"galore_project_back {leaf} L={L} (m,r,n)=({m},{r},{n})"
               f"{' written transposed' if trans else ''}")
        want = tp.galore_project_back_plain(P, N, ALPHA, trans)
        copied = tp.galore_project_back.launches_thread_copy
        got = tp.galore_project_back(P, N, ALPHA, transpose_out=trans)
        torch.cuda.synchronize()
        err = close_or_raise(got, want, tag)
        tag += (" (thread copies)" if tp.galore_project_back.launches_thread_copy > copied
                else " (TMA)")
        ms = cuda_ms(lambda: tp.galore_project_back(P, N, ALPHA, transpose_out=trans), 3, 10)
        plain_ms = cuda_ms(lambda: tp.galore_project_back_plain(P, N, ALPHA, trans), 2, 5)
        lib = ((lambda: ALPHA * torch.matmul(N.mT, P.mT)) if trans
               else (lambda: ALPHA * torch.matmul(P, N)))
        library_ms = cuda_ms(lib, 3, 10)
        b_s, b_by, b_f32 = gemm_bound(L, m, r, n, 4 * L * m * r + 4 * L * r * n,
                                      4 * L * m * n, 3, L * m * n)
        rows.append(dict(kernel="project_back", g_dtype=None, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_s * 1e3,
                         bound_by=b_by, **shape))
        log(f"[kernels] {tag}: max|err| {err:.2e} (max|G̃| {float(want.abs().max()):.2e}; "
            f"{err / float(1e-5 * want.abs().max()):.2f} of 1e-5·max) ok  kernel {ms:.3f} ms  "
            f"plain {plain_ms:.3f} ms  α·torch.matmul {library_ms:.3f} ms  tensor-core bound "
            f"{b_s * 1e3:.3f} ms ({b_by}; {b_s * 1e3 / ms:.0%} of it)  f32-FMA bound "
            f"{b_f32 * 1e3:.3f} ms")
        del P, G32, N, want, got
    torch.cuda.empty_cache()
    return rows


# (shape of x, on the main path): the model's norm input at the main path's
# batch (8 x 256 tokens, d_model 4096), and a ragged 1000 x 520
RMSNORM_SHAPES = [((8, 256, 4096), True), ((1000, 520), False)]


def check_rmsnorm():
    """B6 against its plain version at RMSNORM_SHAPES, x and scale both bf16
    (the model's dtype) or both f32: f32 output within 1e-5 relative (and
    1e-6 absolute), bf16 output within one bf16 ulp, the count of elements one
    ulp apart printed. Times kernel, plain version and
    torch.nn.functional.rms_norm by their device time (device_ms, x in copies
    that exceed the L2), and the kernel's single call (cuda_ms, host
    included); the bound is bytes: x read and the output written once, and
    the scale."""
    rows = []
    for i, (shape, main) in enumerate(RMSNORM_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(600 + i)
        x32 = torch.randn(shape, generator=gen, device="cuda")
        s32 = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            x, scale = x32.to(dt), s32.to(dt)
            tag = f"rmsnorm x {tuple(shape)} {str(dt).removeprefix('torch.')}"
            want = trms.rmsnorm_plain(x, scale)
            got = trms.rmsnorm(x, scale)
            torch.cuda.synchronize()
            g, w = got.double(), want.double()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{tag}: non-finite output")
            if dt == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
                beyond = int(((g - w).abs() > ulp).sum())
                note = (f"{int((g != w).sum())} of {g.numel()} one bf16 ulp apart, {beyond} "
                        f"beyond")
                if beyond:
                    raise AssertionError(f"{tag}: {note}")
            else:
                rel = float(((g - w).abs() / w.abs().clamp(min=0.1)).max())
                if bool(((g - w).abs() > 1e-5 * w.abs() + 1e-6).any()):
                    raise AssertionError(f"{tag}: beyond 1e-5 relative (max {rel:.2e})")
                note = f"max relative err {rel:.2e}"
            err = float((g - w).abs().max())
            nbytes = 2 * x.numel() * x.element_size() + scale.numel() * scale.element_size()
            xs = [x.clone() for _ in range(copies_for(nbytes))]
            call_ms = cuda_ms(lambda: trms.rmsnorm(x, scale), 5, 20)
            n = reps_for(call_ms)
            ms = device_ms([lambda x=x_: trms.rmsnorm(x, scale) for x_ in xs], n)
            plain_ms = device_ms([lambda x=x_: trms.rmsnorm_plain(x, scale) for x_ in xs], n)
            library_ms = device_ms([lambda x=x_: torch.nn.functional.rms_norm(
                x, (shape[-1],), scale, 1e-6) for x_ in xs], n)
            b_s = max(nbytes / PEAK_BYTES, 3 * x.numel() / PEAK_F32)
            rows.append(dict(kernel="rmsnorm", shape=list(shape), g_dtype=str(dt).removeprefix(
                "torch."), main_path=main, max_abs_err=err, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_s * 1e3, bound_by="bytes",
                m=x.numel() // shape[-1], n=shape[-1]))
            log(f"[kernels] {tag}: max|err| {err:.2e}; {note} ok  kernel {ms:.4f} ms (device; "
                f"call {call_ms:.4f} ms)  plain {plain_ms:.4f} ms  F.rms_norm {library_ms:.4f} ms "
                f"(device)  bound {b_s * 1e3:.4f} ms (bytes, {nbytes / 1e6:.1f} MB; "
                f"{nbytes / ms / 1e6:.0f} GB/s achieved; {len(xs)} input copies)")
            del x, xs, scale, want, got
    torch.cuda.empty_cache()
    return rows


def phase_train_config(fused=False, quant=None, apply=False, optimizer="adamw", galore=True,
                       rank=128, update_freq=8, guard=False, gkw=None, tc_kw=None):
    """A training phase's TrainConfig: AdamW (lr 1e-3, wd 0.01, 8 steps, one
    warmup step), GaLore at `rank` and `update_freq` (α 0.25, `quant`, the
    GaLoreConfig fields `gkw`) unless not `galore`, and the TrainConfig
    fields `tc_kw`."""
    gcfg = (GaLoreConfig(rank=rank, update_freq=update_freq, scale=0.25,
                         quant=quant or QuantPolicy(), **(gkw or {})) if galore else None)
    return TrainConfig(optimizer=optimizer, galore=gcfg, galore_fused_adam=fused,
                       galore_fused_apply=apply, lr=1e-3, weight_decay=WD, total_steps=8,
                       warmup_steps=1, anomaly_guard=guard, **(tc_kw or {}))


def train_phase(fused=False, quant=None, apply=False, optimizer="adamw", galore=True, rank=128,
                update_freq=8, ckpt_dir=None, ckpt_every=0, guard=False, faults=None,
                on_state=None, galore_kw=None, tc_kw=None, units=None, cfg=None, params=None,
                data=None, steps=8, rows=8, seq_len=256):
    """8 steps of the main path (AdamW, wd 0.01; GaLore at `rank`, refreshed
    every `update_freq` steps; with `apply` the weight update folded into the
    kernels; `optimizer` adafactor the reference's GaLore-Adafactor; without
    `galore` full-rank `optimizer`, AdamW, the 8-bit Adam baseline or
    Adafactor); returns the steps taken, losses, step times, the
    launches of every kernel, peak memory, and the optimizer state's bytes
    measured from the tensors (GaLore's m/v/proj, or the baselines' moments)
    beside their analytic count (galore_state_bytes, adam8bit_state_bytes,
    adafactor_state_bytes, or 8 bytes a parameter for AdamW). The run
    checkpoints into `ckpt_dir` every `ckpt_every` steps and resumes from
    what it finds there; without one it gets a fresh directory of its own,
    removed afterwards. `guard` turns on
    the anomaly guard (with the fault specs `faults`); `on_state(params,
    opt_state)` sees the final state before it is freed. `galore_kw` and
    `tc_kw` add GaLoreConfig and TrainConfig fields (the refresh lifecycle's);
    `units` (an SvdUnits) records the SVD units each step computed. `cfg`
    replaces llama_7b at 2 layers (another family's config) and `params` the
    random init and `data` the synthetic stream (train_loop's hooks); each
    step's aux_loss is kept beside its loss. `steps` steps of `rows` ×
    `seq_len` tokens (8 of 8 × 256 unless given)."""
    cfg = cfg or dataclasses.replace(get_config("llama_7b"), n_layers=2)
    tc = phase_train_config(fused, quant, apply, optimizer, galore, rank, update_freq, guard,
                            galore_kw, tc_kw)
    gcfg = tc.galore
    own_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_") if ckpt_dir is None else None
    run = RunConfig(arch=cfg.name, smoke=False, steps=steps, batch_per_host=rows, seq_len=seq_len,
                    ckpt_dir=ckpt_dir or own_dir, ckpt_every=ckpt_every, log_every=1,
                    device="cuda")
    steps, losses, aux, times, step_units = [], [], [], [], []

    def on_step(step, metrics):
        steps.append(step)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics.get("aux_loss", 0.0)))
        times.append(metrics["step_s"])
        if units is not None:
            step_units.append(units.take())

    torch.cuda.reset_peak_memory_stats()
    # what the card holds before the phase, and of it the params handed in:
    # [dryrun] predicts the phase's peak as the one less the other plus the
    # dry run of its step
    base = torch.cuda.memory_allocated()
    params_in = 0 if params is None else sum(
        allocator_bytes(t.untyped_storage().nbytes()) for t in tree_leaves(params))
    ops.reset_launch_counts()
    try:
        params, opt_state, _, _ = train_loop(run, tc, cfg=cfg, on_step=on_step, faults=faults,
                                             params=params, data=data)
    finally:
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)
    launches = {key: getattr(fn, attr) for key, (fn, attr) in COUNTERS.items()}
    thread_copy = sum(fn.launches_thread_copy for fn in (tp.galore_project,
                                                         tp.galore_project_back))
    thread_copy_epilogue = thread_copies()
    peak = torch.cuda.max_memory_allocated()
    state = opt_state[galore_state_index(tc)]
    quantized = None
    if galore and optimizer == "adafactor":
        leaves = tree_leaves([state["proj"], state["inner"]["m"], state["inner"]["v"]])
        analytic = (galore_state_bytes(params, gcfg)["projector_bytes"]
                    + adafactor_state_bytes(compact_shapes(params, gcfg)))
    elif galore:
        leaves = tree_leaves([state["proj"], state["inner"]["m"], state["inner"]["v"]])
        analytic = galore_state_bytes(params, gcfg)["optimizer_state_bytes"]
    elif optimizer == "adafactor":
        leaves = tree_leaves([state["v"], state["m"]])
        analytic = adafactor_state_bytes(params)
    elif optimizer == "adam8bit":
        leaves = tree_leaves(state["mv"])
        analytic = adam8bit_state_bytes(params)
        quantized = sum(codec.is_qstate(mv["m"]) for mv in flatten_up_to(params, state["mv"]))
    else:
        leaves = tree_leaves([state["m"], state["v"]])
        analytic = 8 * sum(p.numel() for p in tree_leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if on_state is not None:
        on_state(params, opt_state)
    del params, opt_state, state, leaves
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return dict(steps=steps, losses=losses, aux=aux, times=times, launches=launches,
                thread_copy=thread_copy, thread_copy_epilogue=thread_copy_epilogue, peak=peak,
                galore=galore, update_freq=update_freq, state_bytes=state_bytes,
                analytic_bytes=analytic, quantized_leaves=quantized, units=step_units,
                cfg=cfg, tc=tc, base=base, params_in=params_in,
                rows=run.batch_per_host, seq_len=run.seq_len)


def compact_shapes(params, gcfg):
    """What GaLore's inner transform holds statistics over: each GaLore
    leaf's compact shape (meta tensors), every other leaf as it is."""
    plans = subspace.SubspaceManager(gcfg).plans(params)
    return tree_map(lambda p, pl: torch.empty(subspace.r_shape(p, pl), device="meta")
                    if pl.galore else p, params, plans)


def npz_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs if f.endswith(".npz"))


def check_roundtrip(tag, params, opt_state, int4=False):
    """Save a phase's final state through the checkpoint manager (async: the
    host copy inside save(), then the write, timed apart), restore it onto
    the card, and require every leaf bit for bit in its dtype on its device;
    with `int4`, save it again with the int4 file codec for its bytes."""
    tree = {"params": params, "opt_state": opt_state}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    row = dict(tag=tag)
    try:
        mgr = CheckpointManager(os.path.join(root, "plain"), async_save=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(7, tree)
        row["copy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        mgr.wait()
        row["write_s"] = time.perf_counter() - t
        row["bytes"] = npz_bytes(os.path.join(root, "plain"))
        t = time.perf_counter()
        restored = mgr.restore(7, tree)
        torch.cuda.synchronize()
        row["restore_s"] = time.perf_counter() - t
        want = dict(tree_leaves_with_path(tree))
        got = dict(tree_leaves_with_path(restored))
        if sorted(got) != sorted(want):
            raise AssertionError(f"[ckpt] {tag}: restored leaves {sorted(set(got) ^ set(want))}")
        for k, w in want.items():
            g = got[k]
            same = (g == w if not isinstance(w, torch.Tensor) else
                    g.dtype == w.dtype and g.device == w.device and torch.equal(g, w))
            if not same:
                raise AssertionError(f"[ckpt] {tag}: leaf {k} did not restore bit for bit")
        row["leaves"] = len(want)
        row["device"] = str(tree_leaves(params)[0].device)
        row["int_leaves"] = sum(isinstance(w, torch.Tensor) and not w.is_floating_point()
                                for w in want.values())
        del restored, got
        if int4:
            mgr4 = CheckpointManager(os.path.join(root, "int4"), async_save=False,
                                     quantize="int4")
            t = time.perf_counter()
            mgr4.save(7, tree, block=True)
            row["int4_save_s"] = time.perf_counter() - t
            row["int4_bytes"] = npz_bytes(os.path.join(root, "int4"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[ckpt] {tag} state at step 7: save {row['copy_s']:.2f} s host copy + "
        f"{row['write_s']:.2f} s write, {row['bytes']} bytes on disk; restore "
        f"{row['restore_s']:.2f} s; {row['leaves']} leaves ({row['int_leaves']} integer: codes, "
        f"counts, key) bit for bit on {row['device']}"
        + (f"; --ckpt-quantize int4: {row['int4_bytes']} bytes "
           f"({row['bytes'] / row['int4_bytes']:.2f}x smaller), save {row['int4_save_s']:.2f} s"
           if int4 else ""))
    return row


def checked_guarded_steps(skips):
    """A make_train_step for the launcher that holds every step the guard
    rejects to a bitwise no-op: where the step's fault input is poisoned it
    clones params and state first, and after a rejected step requires every
    leaf unchanged, appending the number of leaves compared to `skips`."""
    make = launcher.make_train_step

    def make_checked(cfg, tc):
        step, opt = make(cfg, tc)

        def checked(params, opt_state, guard, batch, fault=None):
            poisoned = fault is not None and not (bool(torch.isfinite(fault["grad_scale"]))
                                                  and float(fault["loss_add"]) == 0.0)
            before = ({k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in
                       tree_leaves_with_path({"p": params, "s": opt_state})} if poisoned else None)
            out = step(params, opt_state, guard, batch, fault)
            if int(out[3]["guard_ok"]) == 0:
                if before is None:
                    raise AssertionError("the guard rejected a step with no fault")
                after = dict(tree_leaves_with_path({"p": out[0], "s": out[1]}))
                for k, w in before.items():
                    if not (torch.equal(after[k], w) if isinstance(w, torch.Tensor)
                            else after[k] == w):
                        raise AssertionError(f"[guard] a rejected step changed {k}")
                skips.append(len(before))
            return out

        return checked, opt

    return make_checked


def check_state_bytes(tag, ph):
    rel = abs(ph["state_bytes"] - ph["analytic_bytes"]) / ph["analytic_bytes"]
    log(f"[state] {tag}: optimizer state bytes measured {ph['state_bytes']}, analytic "
        f"{ph['analytic_bytes']:.0f} (Δ {rel:.2e})")
    if rel > 1e-4:
        raise AssertionError(f"{tag} state bytes {ph['state_bytes']} are not within 0.01 % of "
                             f"the analytic {ph['analytic_bytes']:.0f}")


def guard_cost(reps=5):
    """The guarded step against the unguarded one at the main path, fp32
    fused, without fault hooks and without a refresh (the galore step held
    at 1, so no leaf is due): calls in turns (unguarded, guarded, guarded,
    unguarded, …) on one state, each timed to a device sync, after two of
    each as warm-up. Returns the median ms of each."""
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    tc = TrainConfig(galore=GaLoreConfig(rank=128, update_freq=4, scale=0.25),
                     galore_fused_adam=True, lr=1e-3, weight_decay=WD, total_steps=8,
                     warmup_steps=1)
    plain, opt = make_train_step(cfg, tc)
    guarded, _ = make_train_step(cfg, dataclasses.replace(tc, anomaly_guard=True))
    params = init_params(cfg, seed=0, device="cuda")
    state = opt.init(params)
    guard = init_guard_state("cuda")
    batch = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=256, batch_per_host=8),
                        device="cuda").batch(0)
    times = {"unguarded": [], "guarded": []}
    for i in range(2 + reps):
        for name in (("unguarded", "guarded") if i % 2 == 0 else ("guarded", "unguarded")):
            state[galore_state_index(tc)]["step"] = 1  # no leaf due: no refresh
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "guarded":
                params, state, guard, _ = guarded(params, state, guard, batch)
            else:
                params, state, _ = plain(params, state, batch)
            torch.cuda.synchronize()
            if i >= 2:
                times[name].append((time.perf_counter() - t) * 1e3)
    del params, state
    torch.cuda.empty_cache()
    return {k: statistics.median(v) for k, v in times.items()}


class SvdUnits:
    """Counts the SVD units (stacked (m, n) elements) the refresh computes on
    the launching thread, by wrapping core/subspace.py's
    compute_leaf_projector while active; take() returns the count since the
    last take."""

    def __init__(self):
        self.total = self._taken = 0
        self._real = None

    def __enter__(self):
        self._real = real = subspace.compute_leaf_projector

        def counted(g, plan, cfg, key=None, step=0):
            self.total += math.prod(g.shape[:-2])
            return real(g, plan, cfg, key, step)

        subspace.compute_leaf_projector = counted
        return self

    def __exit__(self, *exc):
        subspace.compute_leaf_projector = self._real

    def take(self):
        n, self._taken = self.total - self._taken, self.total
        return n


def plan_units(params, gcfg, steps):
    """The SVD units the plan makes due at each step of the fixed (staggered)
    schedule: the stacked elements of the galore leaves due there."""
    mgr = subspace.SubspaceManager(gcfg)
    plans = mgr.plans(params)
    lead = [math.prod(p.shape[:-2]) for p in tree_leaves(params)]
    return [sum(u for u, due in zip(lead, mgr.due_mask(plans, None, s)) if due)
            for s in range(steps)]


def clone_tree(tree, grad=False):
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        c = t.detach().clone()
        return c.requires_grad_(True) if grad else c

    return tree_map(leaf, tree)


def checked_async_driver(check_step, drivers):
    """A launcher.AsyncRefreshDriver that, at the swap of the refresh it
    dispatched at `check_step`, holds the installed state against a
    synchronous refresh_projectors_pending + swap_pending_state on the main
    stream, from copies of the params, galore state and stale batch that
    the dispatch saw and of the state the swap saw: flagged leaves' P by
    subspace_overlap (> 0.999), their reprojected moments (int8 codes at
    most one apart, scales within 1e-5; fp32 within 1e-5·max), every other
    leaf bit for bit. Each driver built is appended to `drivers`, its
    verdict in `.check` (with the check's seconds). The copies and the check
    are kept out of the peak: `.peak_before` is the peak before the copies
    are made, and the peak is reset after the check."""

    class Checked(launcher.AsyncRefreshDriver):
        def __init__(self, cfg, tc, params):
            super().__init__(cfg, tc, params)
            self.cfg, self.tc, self.check, self._snap = cfg, tc, None, None
            self.peak_before = None
            drivers.append(self)

        def _dispatch(self, params, sub, batch, step):
            if step == check_step:
                self.peak_before = torch.cuda.max_memory_allocated()
                self._snap = (clone_tree(params, grad=True), clone_tree(sub), batch, step)
            super()._dispatch(params, sub, batch, step)

        def _swap_if_pending(self, opt_state, params):
            if self._snap is None or not self.in_flight:
                return super()._swap_if_pending(opt_state, params)
            before = clone_tree(opt_state[self.idx])
            out = super()._swap_if_pending(opt_state, params)
            t = time.perf_counter()
            self.check = dict(self._hold(before, out[self.idx]))
            self.check["check_s"] = time.perf_counter() - t
            self._snap = before = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return out

        def _hold(self, before, got):
            snap_params, snap_sub, batch, step = self._snap
            grads = make_refresh_grads(self.cfg, self.tc)(snap_params, batch)
            with torch.no_grad():
                pending = refresh_projectors_pending(grads, snap_sub, self.gcfg, step=step)
                want = swap_pending_state(snap_params, before, pending, self.gcfg)
            del grads
            plans = subspace.SubspaceManager(self.gcfg).plans(snap_params)
            row = dict(step=step, leaves=0, overlap=1.0, code_diff=0, scale_rel=0.0, m32_rel=0.0)
            leaves = zip(tree_leaves(snap_params), tree_leaves(plans),
                         *(flatten_up_to(snap_params, t) for t in (
                             pending["flag"], got["proj"], want["proj"], before["proj"],
                             got["inner"]["m"], want["inner"]["m"], before["inner"]["m"],
                             got["inner"]["v"], want["inner"]["v"], before["inner"]["v"])))
            for p, plan, flag, gp, wp, bp, gm, wm, bm, gv, wv, bv in leaves:
                if not plan.galore:
                    continue
                if not flag:
                    if not all(torch.equal(a, b) for a, b in zip(tree_leaves([gp, gm, gv]),
                                                                 tree_leaves([bp, bm, bv]))):
                        raise AssertionError(f"[async] the swap changed the unflagged leaf of "
                                             f"shape {tuple(p.shape)}")
                    continue
                row["leaves"] += 1
                shape = subspace.proj_shape(p, plan)
                ov = float(subspace_overlap(read_projector(gp, shape),
                                            read_projector(wp, shape)).min())
                row["overlap"] = min(row["overlap"], ov)
                for g, w in ((gm, wm), (gv, wv)):
                    if isinstance(g, dict):
                        row["code_diff"] = max(row["code_diff"], int(
                            (g["q"].int() - w["q"].int()).abs().max()))
                        row["scale_rel"] = max(row["scale_rel"], float(
                            ((g["scale"] - w["scale"]).abs() / w["scale"].abs().clamp_min(1e-30))
                            .max()))
                    else:
                        row["m32_rel"] = max(row["m32_rel"], float(
                            (g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
            if not (row["leaves"] and row["overlap"] > 0.999 and row["code_diff"] <= 1
                    and row["scale_rel"] <= 1e-5 and row["m32_rel"] <= 1e-5):
                raise AssertionError(f"[async] the swap of the step-{step} refresh is not the "
                                     f"synchronous refresh's: {row}")
            return row

    return Checked


def schedule_recorder(log):
    """A make_train_step for the launcher that records, around each train
    step, the galore step and the adaptive schedule before and after it
    (period and next host ints, overlap read to the host)."""
    make = launcher.make_train_step

    def snap(g):
        return {k: dict(tree_leaves_with_path(g["schedule"][k])) for k in ("period", "next")} | {
            "overlap": {k: float(v) for k, v in tree_leaves_with_path(g["schedule"]["overlap"])}}

    def make_recording(cfg, tc):
        step, opt = make(cfg, tc)
        idx = galore_state_index(tc)

        def recorded(params, opt_state, batch):
            gstep, before = opt_state[idx]["step"], snap(opt_state[idx])
            out = step(params, opt_state, batch)
            log.append((gstep, before, snap(out[1][idx])))
            return out

        return recorded, opt

    return make_recording


def check_schedule(log, gcfg, plans):
    """Every refresh the adaptive schedule took follows the reference's rule
    (core/subspace.py): a leaf is due iff step ≥ next; at a due step its
    period doubles at overlap ≥ hi, halves below lo (left alone at the first
    refresh), clipped to t_bounds, and next becomes the offset at step 0 and
    step + period afterwards; a leaf not due keeps its scalars. Returns the
    refresh events (step, leaf, overlap, period, next)."""
    t_min, t_max = subspace.SubspaceManager(gcfg).t_bounds()
    hi, lo = float(np.float32(gcfg.overlap_hi)), float(np.float32(gcfg.overlap_lo))
    events = []
    galore_paths = {p: pl for p, pl in tree_leaves_with_path(plans) if pl.galore}
    for step, before, after in log:
        for path, plan in galore_paths.items():
            per, nxt = before["period"][path], before["next"][path]
            if step < nxt:
                if any(after[k][path] != before[k][path] for k in ("period", "next", "overlap")):
                    raise AssertionError(f"[hetero-adaptive] {path} changed its schedule at "
                                         f"step {step}, not due (next {nxt})")
                continue
            ov = after["overlap"][path]
            want = per
            if step > 0:
                want = per * 2 if ov >= hi else (per // 2 if ov < lo else per)
                want = min(max(want, t_min), t_max)
            want_next = (plan.refresh_offset if step == 0 and plan.refresh_offset > 0
                         else step + want)
            if (after["period"][path], after["next"][path]) != (want, want_next) or not (
                    t_min <= want <= t_max):
                raise AssertionError(f"[hetero-adaptive] {path} at step {step}: period/next "
                                     f"{after['period'][path]}/{after['next'][path]}, want "
                                     f"{want}/{want_next} (overlap {ov}, bounds {t_min}-{t_max})")
            events.append((step, path, ov, want, want_next))
    return events


def svd_ms():
    """The refresh's SVD on the card at the slice's two projector shapes, for
    rank-128 and rank-1024 projectors."""
    out = {}
    for m, n in ((4096, 4096), (4096, 11008)):
        G = torch.randn(m, n, device="cuda")
        for rank in (128, 1024):
            out[f"r{rank} {m}x{n}"] = cuda_ms(lambda: compute_projector(G, rank), 1, 3)
    return out


def lifecycle_phases(phases, none):
    """The refresh lifecycle at the main path's width (T = 8, 8 steps):
    `stagger` (fp32 fused, inline stagger), `stagger-external` (the same
    through the external refresh caller: losses and projectors bit for bit
    `stagger`'s), `async` (8-bit fused, stagger, the async double buffer,
    moments re-projected; one swap held against the synchronous refresh)
    and `hetero-adaptive` (fp32 fused, MLP leaves at r = 1024 and attention
    at r = 128, adaptive T from T = 4). The two stagger phases run without
    the chain's clip: it rescales the gradient the in-step refresh sees,
    while the external refresh, as the reference's, decomposes the raw
    gradient. Adds each phase to `phases`."""
    stagger_kw = dict(refresh_stagger=True)
    finals = {}

    def keep_final(tag, want_units):
        def on_state(params, opt_state):
            finals[tag] = clone_tree(opt_state[0]["proj"])  # no clip: galore state first
            want_units.extend(plan_units(params, GaLoreConfig(rank=128, update_freq=8,
                                                              **stagger_kw), 8))
        return on_state

    for tag, tc_kw in (("stagger", {}), ("stagger-external", dict(galore_external_refresh=True))):
        t = time.perf_counter()
        want_units = []
        with SvdUnits() as units:
            ph = phases[tag] = train_phase(fused=True, update_freq=8, galore_kw=stagger_kw,
                                           tc_kw=dict(grad_clip=0.0, **tc_kw), units=units,
                                           on_state=keep_final(tag, want_units))
        ph["tag"], ph["refresh_steps"] = tag, [i for i, u in enumerate(ph["units"]) if u]
        log(f"[{tag}] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; "
            f"SVD units per step {ph['units']} (plan {want_units}); step ms "
            f"{[round(x * 1e3, 1) for x in ph['times']]}; peak memory "
            f"{ph['peak'] / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
        if ph["units"] != want_units or want_units != [14, 2, 2, 2, 2, 2, 2, 0]:
            raise AssertionError(f"{tag}: SVD units per step {ph['units']}, plan {want_units}, "
                                 f"want 14 at step 0, 2 at each of steps 1-6 (offsets "
                                 f"(pos·8)//7), 0 at step 7")
        if ph["launches"] != dict(none, left=48, right=8):
            raise AssertionError(f"{tag} launches {ph['launches']}, want left 48, right 8")
        check_state_bytes(tag, ph)
    st, ext = phases["stagger"], phases["stagger-external"]
    if ext["losses"] != st["losses"]:
        raise AssertionError(f"stagger-external losses {ext['losses']} are not stagger's "
                             f"{st['losses']} bit for bit")
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(finals["stagger-external"]),
                                              tree_leaves(finals["stagger"]))]
    if not all(same):
        raise AssertionError(f"stagger-external: {same.count(False)} projector leaves differ "
                             f"from stagger's")
    log(f"[stagger-external] losses and all {len(same)} leaves of the projector tree bit for bit "
        f"stagger's; "
        f"median due step (1-6) {statistics.median(ext['times'][1:7]) * 1e3:.1f} ms vs stagger "
        f"{statistics.median(st['times'][1:7]) * 1e3:.1f} ms")
    del finals

    async_phase(phases, none, "async", st)

    # per-leaf ranks and adaptive T: the MLP leaves at r = 1024 (B4/B5), the
    # attention leaves at r = 128 (B1)
    t = time.perf_counter()
    hetero = dict(rank_overrides=(("ffn.gate", 1024), ("ffn.up", 1024), ("ffn.down", 1024)),
                  adaptive_t=True)
    log_sched, plans = [], []
    launcher.make_train_step = schedule_recorder(log_sched)
    try:
        ph = phases["hetero-adaptive"] = train_phase(
            fused=True, update_freq=4, galore_kw=hetero,
            on_state=lambda p, s: plans.append(subspace.SubspaceManager(
                GaLoreConfig(rank=128, update_freq=4, **hetero)).plans(p)))
    finally:
        launcher.make_train_step = make_train_step
    gcfg = GaLoreConfig(rank=128, update_freq=4, scale=0.25, **hetero)
    ranks = sorted({(path, pl.rank) for path, pl in tree_leaves_with_path(plans[0]) if pl.galore})
    events = check_schedule(log_sched, gcfg, plans[0])
    ph["refresh_steps"] = sorted({e[0] for e in events})
    log(f"[hetero-adaptive] ranks {ranks}; losses {[round(x, 4) for x in ph['losses']]} launches "
        f"{ph['launches']}; step ms {[round(x * 1e3, 1) for x in ph['times']]}; peak memory "
        f"{ph['peak'] / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
    log(f"[hetero-adaptive] refreshes (step, leaf, overlap, period, next), every one by the "
        f"reference's rule, periods within t_bounds {subspace.SubspaceManager(gcfg).t_bounds()}: "
        f"{[(s, p, round(o, 4), per, n) for s, p, o, per, n in events]}")
    if ph["launches"] != dict(none, left=32, project=24, project_back=24):
        raise AssertionError(f"hetero-adaptive launches {ph['launches']}, want B1 32 (4 attention "
                             f"leaves × 8 steps), B4 and B5 24 each (gate, up, down × 8)")
    check_state_bytes("hetero-adaptive", ph)


ASYNC_Q8 = QuantPolicy(moments="int8", projectors="int4")


def async_phase(phases, none, tag, sync, gkw=None):
    """[`tag`]: 8-bit fused, stagger, T = 8, the async double buffer with the
    moments re-projected (GaLoreConfig fields `gkw` beside), 8 steps; the
    swap of the last (step-6) refresh held against the synchronous refresh
    on the main stream, so steps 1-5 run untouched by the check. Logs each
    dispatch's SVD units, gradient enqueue, refresh thread and main-thread
    wait at the swap, and their difference (the thread's time the train step
    hid), beside the synchronous phase `sync`'s due steps. Returns (the
    phase, its driver)."""
    t = time.perf_counter()
    drivers = []
    launcher.AsyncRefreshDriver, plain_driver = (checked_async_driver(6, drivers),
                                                 launcher.AsyncRefreshDriver)
    try:
        ph = phases[tag] = train_phase(
            fused=True, quant=ASYNC_Q8, update_freq=8,
            galore_kw=dict(refresh_stagger=True, reproject_moments=True, **(gkw or {})),
            tc_kw=dict(galore_refresh_async=True))
    finally:
        launcher.AsyncRefreshDriver = plain_driver
    driver = drivers[-1]
    ph["peak"] = max(ph["peak"], driver.peak_before)  # the check's copies left out
    # a step dispatches a refresh or swaps one in (waiting for its thread)
    ph["refresh_steps"] = list(range(8))
    hist = [(h["step"], h["units"], round(h["dispatch_s"] * 1e3, 1), round(h["refresh_s"] * 1e3, 1),
             round(h["wait_s"] * 1e3, 1)) for h in driver.history]
    log(f"[{tag}] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; step ms "
        f"{[round(x * 1e3, 1) for x in ph['times']]}; peak memory {ph['peak'] / 2**30:.2f} GiB "
        f"({time.perf_counter() - t:.1f} s)")
    log(f"[{tag}] dispatches (step, SVD units, gradient enqueue ms, refresh thread ms, main "
        f"thread's wait at the swap ms): {hist}; overlapped with the train step "
        f"{[round((h['refresh_s'] - h['wait_s']) * 1e3, 1) for h in driver.history]} ms")
    if [h[0] for h in hist] != [1, 2, 3, 4, 5, 6] or any(h[1] != 2 for h in hist):
        raise AssertionError(f"[{tag}] dispatches {hist}: want steps 1-6, 2 SVD units each")
    if driver.check is None:
        raise AssertionError(f"[{tag}] the swap of the step-6 refresh was not checked")
    log(f"[{tag}] swap of the step-6 refresh vs the synchronous refresh on the main stream: "
        f"{driver.check['leaves']} leaf, subspace overlap {driver.check['overlap']:.6f} (> 0.999), "
        f"int8 codes at most {driver.check['code_diff']} apart (≤ 1), scales within "
        f"{driver.check['scale_rel']:.2e} (≤ 1e-5); the check took "
        f"{driver.check['check_s']:.2f} s of step 7")
    if ph["launches"] != dict(none, adam8_left=48, adam8_right=8):
        raise AssertionError(f"{tag} launches {ph['launches']}, want adam8 left 48, right 8")
    check_state_bytes(tag, ph)
    due = [round(ph["times"][i] * 1e3, 1) for i in range(1, 6)]
    log(f"[{tag}] steps 1-5 (each dispatches a refresh and swaps the last) {due} ms, median "
        f"{statistics.median(due):.1f}, vs {sync['tag']}'s due steps "
        f"{[round(x * 1e3, 1) for x in sync['times'][1:6]]} ms, median "
        f"{statistics.median(sync['times'][1:6]) * 1e3:.1f}; peak memory "
        f"{ph['peak'] / 2**30:.2f} GiB (before the check's copies) vs {sync['tag']}'s "
        f"{sync['peak'] / 2**30:.2f} GiB")
    return ph, driver


def randomized_refresh_phases(phases, none):
    """ROADMAP C.32: the async double buffer where a refresh is short enough
    to hide. `stagger-rand` (8-bit fused, r = 128, T = 8, staggered, the
    randomized projector: 2 SVD units a due step, each a range finder, not a
    gesvd) refreshes synchronously inside each step; `async-rand` is
    `async` with the randomized projector: its losses, launches and the
    swap of the step-6 refresh checked as `async`'s are. Logs each phase's
    median due step (steps 1-5) and each dispatch's refresh, wait and
    overlap; gates on no time."""
    rand = dict(refresh_stagger=True, projector="randomized")
    t = time.perf_counter()
    want_units = []
    with SvdUnits() as units:
        ph = phases["stagger-rand"] = train_phase(
            fused=True, quant=ASYNC_Q8, update_freq=8, galore_kw=rand, units=units,
            on_state=lambda p, s: want_units.extend(plan_units(p, GaLoreConfig(
                rank=128, update_freq=8, **rand), 8)))
    ph["tag"], ph["refresh_steps"] = "stagger-rand", [i for i, u in enumerate(ph["units"]) if u]
    log(f"[stagger-rand] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; "
        f"SVD units per step {ph['units']} (plan {want_units}); step ms "
        f"{[round(x * 1e3, 1) for x in ph['times']]}; median due step (1-5) "
        f"{statistics.median(ph['times'][1:6]) * 1e3:.1f} ms; peak memory "
        f"{ph['peak'] / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
    if ph["units"] != want_units or want_units != [14, 2, 2, 2, 2, 2, 2, 0]:
        raise AssertionError(f"stagger-rand: SVD units per step {ph['units']}, plan {want_units}")
    if ph["launches"] != dict(none, adam8_left=48, adam8_right=8):
        raise AssertionError(f"stagger-rand launches {ph['launches']}, want adam8 left 48, "
                             f"right 8")
    check_state_bytes("stagger-rand", ph)
    ar, driver = async_phase(phases, none, "async-rand", ph, gkw=dict(projector="randomized"))
    step_ms = statistics.median(ph["times"][1:6])
    log(f"[async-rand] the async buffer hides at most one train step of each refresh (the swap "
        f"is at the next step boundary): median refresh thread "
        f"{statistics.median(h['refresh_s'] for h in driver.history) * 1e3:.1f} ms, median "
        f"wait at the swap {statistics.median(h['wait_s'] for h in driver.history) * 1e3:.1f} "
        f"ms; median due step async-rand {statistics.median(ar['times'][1:6]) * 1e3:.1f} ms vs "
        f"stagger-rand {step_ms * 1e3:.1f} ms")


def lowrank_phase(mode, merge_at=None):
    """8 steps of the paper's low-rank weight methods (Table 2) at the main
    path's width, batch and data, through the loop of
    benchmarks/table2_methods.py::_train_lowrank: LoRA / ReLoRA (r = 128,
    alpha 32) or low-rank (W = s·BA from scratch, alpha 4r), Adam on the
    adaptors with a constant −lr, the base frozen; with `merge_at` a
    relora_merge before that step, the merged effective weights just before
    and just after it held equal element for element, B′ = 0, and a fresh
    Adam state. Returns train_phase's record (state bytes: the adaptors
    and their Adam moments, analytic 12 B an adaptor element) and the
    adaptor counts."""
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    rank = 128
    lcfg = lowrank.LoraConfig(rank=rank, alpha=4 * rank if mode == "lowrank" else 32.0,
                              mode=mode, merge_freq=merge_at or 0)
    lr = 1e-3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # train_loop's initial params and data for seed 0: the AdamW phase's
    params = tree_map(lambda t: t.detach(), init_params(cfg, seed=0, device="cuda"))
    data = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=256, batch_per_host=8,
                                  seed=0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    adaptors = lowrank.init_adaptors(params, lcfg, gen)
    opt = scale_by_adam()
    st = opt.init(adaptors)
    losses, times, merged = [], [], None
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if lcfg.merge_freq and i > 0 and i % lcfg.merge_freq == 0:
            with torch.no_grad():
                before = lowrank.merge(params, adaptors, lcfg)
            params, adaptors = lowrank.relora_merge(params, adaptors, lcfg, gen)
            st = opt.init(adaptors)  # the ReLoRA optimizer reset
            with torch.no_grad():
                after = lowrank.merge(params, adaptors, lcfg)
            diff = [k for (k, a), b in zip(tree_leaves_with_path(after), tree_leaves(before))
                    if not torch.equal(a, b)]
            zero_b = all(not bool(t.any()) for k, t in tree_leaves_with_path(adaptors)
                         if k.endswith(".B"))
            fresh = int(st["count"]) == 0 and not any(bool(t.any()) for t in
                                                      tree_leaves([st["m"], st["v"]]))
            merged = dict(step=i, leaves=len(tree_leaves(after)), differ=diff, zero_b=zero_b,
                          fresh=fresh)
            del before, after
        loss, _ = loss_fn(cfg, lowrank.merge(params, adaptors, lcfg), data.batch(i))
        grads = lowrank.adaptor_grads(loss, adaptors)
        with torch.no_grad():
            upd, st = opt.update(grads, st, adaptors)
            apply_updates(adaptors, tree_map(lambda u: -lr * u, upd))
        del grads, upd
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del loss
    launches = {key: getattr(fn, attr) for key, (fn, attr) in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    mats = [t for t in tree_leaves([adaptors, st["m"], st["v"]]) if t.ndim >= 2]
    state_bytes = sum(t.numel() * t.element_size() for t in mats)
    counted = sum(t.numel() for t in tree_leaves(adaptors) if t.ndim >= 2)
    # r(m + n) a matrix of each adapted leaf: every ≥ 2-D leaf of the blocks
    # but the norm scales (the embedding and the norms are excluded)
    analytic = sum(math.prod(p.shape[:-2]) * rank * (p.shape[-2] + p.shape[-1])
                   for path, p in tree_leaves_with_path(params)
                   if path.startswith("blocks.") and p.ndim == 3 and ".ln" not in f".{path}")
    out = dict(steps=list(range(8)), losses=losses, times=times, launches=launches,
               thread_copy=0, thread_copy_epilogue=0, peak=peak, galore=False,
               update_freq=None, state_bytes=state_bytes, analytic_bytes=12 * counted,
               adaptors=counted, adaptor_param_count=lowrank.adaptor_param_count(adaptors),
               analytic_adaptors=analytic, merged=merged)
    del params, adaptors, st, mats
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{mode}: non-finite loss: {losses}")
    return out


def baseline_phases(phases, none):
    """The paper's other baselines at the main path's width (10a): full-rank
    Adafactor, GaLore over Adafactor, LoRA, ReLoRA and low-rank; none of
    them launches a kernel (the reference's paths for them reach no Pallas
    call). Adds each phase to `phases`."""
    adamw0 = phases["adamw"]["losses"][0]
    t = time.perf_counter()
    ph = phases["adafactor"] = train_phase(optimizer="adafactor", galore=False)
    log(f"[adafactor] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; "
        f"step ms {[round(x * 1e3, 1) for x in ph['times']]}; peak memory "
        f"{ph['peak'] / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
    if ph["launches"] != none:
        raise AssertionError(f"adafactor launched kernels: {ph['launches']}")
    if ph["state_bytes"] != ph["analytic_bytes"]:
        raise AssertionError(f"adafactor state bytes {ph['state_bytes']} are not the analytic "
                             f"{ph['analytic_bytes']} (m 4 B a parameter, v 4 B × (rows + "
                             f"columns) a ≥ 2-D leaf)")
    check_state_bytes("adafactor", ph)
    d0 = abs(ph["losses"][0] - adamw0)
    if d0 > 1e-6:
        raise AssertionError(f"step-0 losses of adafactor and adamw differ by {d0:.3e}")
    log(f"[adafactor] step-0 loss - adamw's {d0:.1e} (limit 1e-6); per-step loss - adamw's "
        f"{[f'{a - b:.4f}' for a, b in zip(ph['losses'], phases['adamw']['losses'])]}")

    t = time.perf_counter()
    with SvdUnits() as units:
        ph = phases["galore-adafactor"] = train_phase(optimizer="adafactor", units=units)
    log(f"[galore-adafactor] losses {[round(x, 4) for x in ph['losses']]} launches "
        f"{ph['launches']}; SVD units per step {ph['units']}; step ms "
        f"{[round(x * 1e3, 1) for x in ph['times']]}; peak memory {ph['peak'] / 2**30:.2f} GiB "
        f"({time.perf_counter() - t:.1f} s)")
    if ph["launches"] != none:
        raise AssertionError(f"galore-adafactor launched kernels: {ph['launches']} (the "
                             f"composable path has none)")
    if ph["units"] != [14, 0, 0, 0, 0, 0, 0, 0]:
        raise AssertionError(f"galore-adafactor SVD units per step {ph['units']}: want all 14 "
                             f"at step 0 (T = 8) and none after")
    check_state_bytes("galore-adafactor", ph)

    for tag, merge_at in (("lora", None), ("relora", 4), ("lowrank", None)):
        t = time.perf_counter()
        ph = phases[tag] = lowrank_phase(tag, merge_at)
        log(f"[{tag}] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; "
            f"step ms {[round(x * 1e3, 1) for x in ph['times']]}; peak memory "
            f"{ph['peak'] / 2**30:.2f} GiB; adaptors {ph['adaptors']} elements "
            f"(adaptor_param_count {ph['adaptor_param_count']}, r(m + n) a matrix "
            f"{ph['analytic_adaptors']}); adaptors + Adam state {ph['state_bytes']} B "
            f"({time.perf_counter() - t:.1f} s)")
        if ph["launches"] != none:
            raise AssertionError(f"{tag} launched kernels: {ph['launches']}")
        if not ph["adaptors"] == ph["adaptor_param_count"] == ph["analytic_adaptors"]:
            raise AssertionError(f"{tag}: adaptor elements {ph['adaptors']}, "
                                 f"adaptor_param_count {ph['adaptor_param_count']}, r(m + n) "
                                 f"{ph['analytic_adaptors']}")
        if ph["state_bytes"] != ph["analytic_bytes"]:
            raise AssertionError(f"{tag}: adaptors + Adam state {ph['state_bytes']} B, want 12 B "
                                 f"an adaptor element ({ph['analytic_bytes']})")
        if tag != "lowrank":
            d0 = abs(ph["losses"][0] - adamw0)
            if d0 > 1e-6:
                raise AssertionError(f"step-0 losses of {tag} and adamw differ by {d0:.3e} "
                                     f"(B = 0: the effective weights are W0)")
            log(f"[{tag}] step-0 loss - adamw's {d0:.1e} (limit 1e-6)")
    mg = phases["relora"]["merged"]
    if mg is None or mg["step"] != 4 or mg["differ"] or not mg["zero_b"] or not mg["fresh"]:
        raise AssertionError(f"[relora] the merge at step 4: {mg}; want the effective weights "
                             f"equal just before and after, B' = 0 and a fresh Adam state")
    log(f"[relora] merge before step 4: all {mg['leaves']} effective weight leaves equal "
        f"element for element just before and after relora_merge (W0' = cast(W0 + sBA), "
        f"B' = 0), Adam state fresh (count 0, moments 0)")



# ---------------------------------------------------------------------------
# serving (the engine over the paged KV cache; no kernel: the reference's
# serving path reaches no Pallas call)
# ---------------------------------------------------------------------------


# logits of the bf16 engine against the contiguous-cache steps, × max|logits|:
# the f32 engine sits 5.6e-6 from the full forward ([serve-f32]), so the paged
# arithmetic adds nothing; in bf16 the two paths' differently shaped GEMMs
# round apart, 1.84e-2–2.11e-2 through the full llama_7b's 32 layers (H100
# 80GB HBM3, PERF.md §6): 3e-2 is ≈ 16 bf16 unit roundoffs (2^-9)
SERVE_GATE_BF16 = 3e-2


class RouterTap:
    """While open, records every MoE layer call's routing: for each row and
    token the top-1 expert, the margin between the top two router logits
    (f32, as the layer computes them) and the larger of the two logits'
    magnitudes. `take()` returns the calls since the last take, each an
    (B, S, 3) numpy array, in layer order."""

    def __init__(self):
        from repro_torch.models import moe as moe_lib

        self._mod, self._calls = moe_lib, []
        self._orig = moe_lib.apply_moe

    def __enter__(self):
        orig = self._orig

        def tapped(cfg, p, x):
            with torch.no_grad():
                v, i = torch.topk(x.float() @ p["router"], 2, dim=-1)
                self._calls.append(torch.stack(
                    [i[..., 0].float(), v[..., 0] - v[..., 1], v.abs().amax(dim=-1)],
                    dim=-1).cpu().numpy())
            return orig(cfg, p, x)

        self._mod.apply_moe = tapped
        return self

    def __exit__(self, *exc):
        self._mod.apply_moe = self._orig

    def take(self):
        calls, self._calls = self._calls, []
        return calls


def routing_at(calls, row, cols):
    """(len(cols), layers, 3) of the tapped calls at `row`, positions `cols`."""
    return np.stack([c[row, cols] for c in calls], axis=1)


class EngineRecorder:
    """Wraps an Engine's two steps to keep, for every emitted token, the
    logits it was taken from — {(request_id, k): (V,) f32 on the card} for the
    k-th generated token — read from the engine's own lane state at each call
    (which lanes finish their prompt in a prefill call; which decode), and,
    with `timed`, CUDA events around every call (no host synchronisation):
    `prefill_ms` and `decode_ms` are each call's device time. With a
    RouterTap open, `routes` keeps {(request_id, position): (layers, 3)} of
    every token the engine ran (routing_at's rows)."""

    def __init__(self, engine, record=True, timed=False, tap=None):
        self.engine, self.logits, self.routes = engine, {}, {}
        self.timed = timed
        self.prefill_ms, self.decode_ms, self._events = [], [], []
        prefill, decode = engine._prefill, engine._decode
        C = engine.scfg.prefill_chunk

        def lanes(pending):
            return [(i, w) for i, w in enumerate(engine._slots) if w is not None
                    and (w.prefilled < len(w.tokens)) == pending]

        def rec_prefill(params, kv, bt, pos0, chunk):
            ev = self._start()
            logits, kv = prefill(params, kv, bt, pos0, chunk)
            self._stop(ev, "prefill")
            if not record:
                return logits, kv
            rows = bt.any(dim=1).tolist()  # the lanes in this call
            calls = tap.take() if tap is not None else None
            for i, w in lanes(True):
                c = min(C, len(w.tokens) - w.prefilled)
                if calls and rows[i]:
                    for j, r in enumerate(routing_at(calls, i, np.arange(c))):
                        self.routes[(w.req.request_id, w.prefilled + j)] = r
                if rows[i] and w.prefilled + c == len(w.tokens):
                    self.logits[(w.req.request_id, len(w.tokens) - len(w.req.tokens))] = \
                        logits[i, c - 1].float().clone()
            return logits, kv

        def rec_decode(params, kv, bt, pos, toks):
            ev = self._start()
            logits, nxt, kv = decode(params, kv, bt, pos, toks)
            self._stop(ev, "decode")
            if record:
                rows = bt.any(dim=1).tolist()
                calls = tap.take() if tap is not None else None
                at = pos.tolist()
                for i, w in lanes(False):
                    if rows[i]:
                        self.logits[(w.req.request_id, w.n_generated)] = logits[i].float().clone()
                        if calls:
                            self.routes[(w.req.request_id, at[i])] = routing_at(calls, i, [0])[0]
            return logits, nxt, kv

        self._steps = (prefill, decode)
        engine._prefill, engine._decode = rec_prefill, rec_decode

    def detach(self):
        """The engine's own steps back (the wrappers and the engine hold one
        another: without this the pool outlives the run until a collection)."""
        self.engine._prefill, self.engine._decode = self._steps

    def _start(self):
        if not self.timed:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _stop(self, start, kind):
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((kind, start, end))

    def times(self):
        torch.cuda.synchronize()
        for kind, a, b in self._events:
            (self.prefill_ms if kind == "prefill" else self.decode_ms).append(a.elapsed_time(b))
        self._events.clear()


def serve_run(cfg, params, scfg, reqs, record=True, timed=False, tap=None):
    """Drain `reqs` through a fresh Engine; returns its completions (in
    request order), the engine and its recorder. Every block comes back."""
    from repro_torch.serve import Engine

    eng = Engine(cfg, params, scfg)
    recorder = EngineRecorder(eng, record=record, timed=timed, tap=tap)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids = [eng.submit(r) for r in reqs]
    eng.run_until_drained(timeout_s=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    recorder.times()
    recorder.detach()
    eng.alloc.check_invariants()
    if eng.alloc.num_free != scfg.num_blocks - 1:
        raise AssertionError(f"[serve] {scfg.num_blocks - 1 - eng.alloc.num_free} blocks "
                             f"not returned")
    return [eng.result(i) for i in ids], eng, recorder, wall


def full_forward_rollout(cfg, params, prompt, n):
    """Greedy rollout by the full forward (no cache): tokens and the logits
    each was taken from."""
    from repro_torch.models.model import forward

    toks, rows = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            last = forward(cfg, params, {"tokens": torch.tensor([toks], device="cuda")})[0, -1]
            rows.append(last.float())
            toks.append(int(last.argmax()))
    return toks[len(prompt):], rows


def contiguous_logits(cfg, params, prompt, tokens, max_len, tap=None):
    """The contiguous-cache steps at batch 1 (make_prefill_step, then
    make_decode_step at rising positions), fed the engine's own `tokens`: the
    logits each of them was taken from, and the steps' own greedy picks;
    with a RouterTap open, also (positions, layers, 3) of their routing."""
    from repro_torch.distributed.step import make_decode_step, make_prefill_step
    from repro_torch.models.model import init_cache

    cache = init_cache(cfg, 1, max_len, device="cuda")
    last, cache = make_prefill_step(cfg)(params, cache,
                                         {"tokens": torch.tensor([prompt], device="cuda")})
    rows, picks = [last[0].float()], [int(last[0].argmax())]
    routes = [routing_at(tap.take(), 0, np.arange(len(prompt)))] if tap is not None else []
    decode = make_decode_step(cfg, with_logits=True)
    for k, tok in enumerate(tokens[:-1]):
        nxt, last, cache = decode(params, cache, torch.tensor([[tok]], device="cuda"),
                                  len(prompt) + k)
        rows.append(last[0].float())
        picks.append(int(nxt[0]))
        if tap is not None:
            routes.append(routing_at(tap.take(), 0, [0]))
    del cache
    if tap is not None:
        return rows, picks, np.concatenate(routes)
    return rows, picks


def token_gaps(recorder, comp, want_rows, vocab=None):
    """For each of a completion's tokens, max|engine logits − want| / max|want|
    over the first `vocab` columns (the pad columns' −1e30 left out)."""
    gaps = []
    for k, want in enumerate(want_rows):
        got, want = recorder.logits[(comp.request_id, k)][:vocab], want[:vocab]
        gaps.append(float((got - want).abs().max()) / float(want.abs().max()))
    return gaps


def logits_gap(recorder, comp, want_rows, vocab=None):
    """The largest of token_gaps."""
    return max(token_gaps(recorder, comp, want_rows, vocab))


def serve_prompts(rng, lengths, vocab):
    return [tuple(int(t) for t in rng.integers(0, vocab, n)) for n in lengths]


def serve_f32_phase():
    """[serve-f32]: the engine at llama_7b width, 2 layers, f32: greedy tokens
    identical to the full-forward rollout and each emitted token's logits
    within 1e-4·max|logits| of the full forward's, with prefill chunks of 32
    and of 512; the padded chunk past the block table; a tight pool forcing
    recompute preemption. Returns the largest logits gap (it sets the bf16
    phase's gate beside bf16 rounding)."""
    from repro_torch.serve import Request, ServeConfig

    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2, dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    prompts = serve_prompts(np.random.default_rng(11), (1, 17, 100, 255, 300, 480),
                            cfg.vocab_size)
    want = [full_forward_rollout(cfg, params, p, 16) for p in prompts]
    reqs = lambda: [Request(tokens=p, max_new=16) for p in prompts]  # noqa: E731
    worst = 0.0
    for chunk in (32, 512):
        scfg = ServeConfig(block_size=16, num_blocks=257, slots=4, max_len_cap=512,
                           prefill_chunk=chunk)
        comps, eng, rec, wall = serve_run(cfg, params, scfg, reqs())
        gaps = []
        for c, (toks, rows) in zip(comps, want):
            if list(c.tokens) != toks:
                raise AssertionError(f"[serve-f32] chunk {chunk}: request of {c.prompt_len} "
                                     f"tokens gave {list(c.tokens)}, the full forward {toks}")
            gaps.append(logits_gap(rec, c, rows))
        worst = max(worst, max(gaps))
        log(f"[serve-f32] chunk {chunk}: {len(comps)} requests (prompts "
            f"{[c.prompt_len for c in comps]}) token-identical to the full-forward rollout; "
            f"logits max|Δ|/max|logits| {max(gaps):.2e} (limit 1e-4); {eng.stats}; "
            f"{wall:.2f} s")
        if max(gaps) > 1e-4:
            raise AssertionError(f"[serve-f32] chunk {chunk}: logits gaps {gaps} > 1e-4")
    # a padded last chunk past the table: cap 500 → 32 blocks of 16 (512
    # slots); chunks of 96 over 499 tokens end at 480 + 96 = 576 > 512 (the
    # reference clamps 512 … 575 onto block 31, over real tokens 496 … 498)
    (prompt,) = serve_prompts(np.random.default_rng(12), (499,), cfg.vocab_size)
    toks, rows = full_forward_rollout(cfg, params, prompt, 1)
    scfg = ServeConfig(block_size=16, num_blocks=64, slots=2, max_len_cap=500, prefill_chunk=96)
    (c,), eng, rec, _ = serve_run(cfg, params, scfg, [Request(tokens=prompt, max_new=1)])
    gap = logits_gap(rec, c, rows)
    if list(c.tokens) != toks or gap > 1e-4:
        raise AssertionError(f"[serve-f32] padded chunk past the table: token {c.tokens} vs "
                             f"{toks}, logits gap {gap:.2e}")
    log(f"[serve-f32] padded chunk past the table (cap 500, chunk 96, 499-token prompt): token "
        f"{c.tokens[0]} = the full forward's, logits gap {gap:.2e}")
    # a tight pool: 39 usable blocks for requests of up to 31, four at a time
    roomy = ServeConfig(block_size=16, num_blocks=257, slots=4, max_len_cap=512,
                        prefill_chunk=32)
    tight = dataclasses.replace(roomy, num_blocks=40)
    comps, eng, _, _ = serve_run(cfg, params, tight, reqs(), record=False)
    if [list(c.tokens) for c in comps] != [w[0] for w in want]:
        raise AssertionError("[serve-f32] tight pool: tokens differ from the uncontended run's")
    if eng.stats["preemptions"] < 1:
        raise AssertionError(f"[serve-f32] tight pool: no preemption ({eng.stats})")
    log(f"[serve-f32] tight pool (39 blocks): {eng.stats['preemptions']} recompute "
        f"preemptions (per request {[c.preemptions for c in comps]}), tokens equal the "
        f"uncontended run's, invariants hold, every block back; peak blocks "
        f"{eng.alloc.peak_used}")
    del params, eng
    torch.cuda.empty_cache()
    return worst


def serve_phase(f32_gap):
    """[serve]: the full llama_7b (32 layers, bf16) behind the engine: eight
    requests (prompts of 64 … 1536 tokens, six greedy and two sampled), 32
    tokens each; a timed run (CUDA events around every step call, no host
    synchronisation added), then a recorded run whose greedy requests' logits
    are held against the contiguous-cache steps fed the same tokens."""
    from repro_torch.serve import Request, ServeConfig
    from repro_torch.serve.kv_cache import pool_bytes

    cfg = get_config("llama_7b")
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve] llama_7b: {cfg.n_layers} layers, {sum(p.numel() for p in tree_leaves(params))} "
        f"parameters, {cfg.dtype}, initialised in {time.perf_counter() - t:.1f} s")
    lengths = (64, 200, 400, 640, 900, 1100, 1300, 1536)
    prompts = serve_prompts(np.random.default_rng(13), lengths, cfg.vocab_size)
    sampled = {6: 1, 7: 2}  # request index -> seed (temperature 0.8, top_k 50)
    reqs = lambda: [Request(tokens=p, max_new=32,  # noqa: E731
                            **(dict(temperature=0.8, top_k=50, seed=sampled[i])
                               if i in sampled else {}))
                    for i, p in enumerate(prompts)]
    scfg = ServeConfig(block_size=16, num_blocks=1025, slots=8, max_len_cap=2048,
                       prefill_chunk=256)
    serve_run(cfg, params, scfg, reqs()[:2], record=False)  # warm-up
    comps, eng, rec, wall = serve_run(cfg, params, scfg, reqs(), record=False, timed=True)
    pool = sum(t.nbytes for t in eng.kv.values())
    if pool != pool_bytes(cfg, scfg.num_blocks, scfg.block_size) or pool != eng.pool_hbm_bytes:
        raise AssertionError(f"[serve] pool tensors {pool} B, pool_bytes "
                             f"{pool_bytes(cfg, scfg.num_blocks, scfg.block_size)} B")
    for c in comps:
        if c.finish_reason != "max_new" or len(c.tokens) != 32:
            raise AssertionError(f"[serve] request of {c.prompt_len} tokens: "
                                 f"{c.finish_reason}, {len(c.tokens)} tokens")
    prompt_tokens = sum(lengths)
    log(f"[serve] 8 requests × 32 tokens in {wall:.2f} s; {eng.stats}; prefill "
        f"{len(rec.prefill_ms)} calls, {sum(rec.prefill_ms):.1f} ms of device time for "
        f"{prompt_tokens} prompt tokens ({prompt_tokens / sum(rec.prefill_ms) * 1e3:.0f} "
        f"tokens/s); decode {len(rec.decode_ms)} steps, median "
        f"{statistics.median(rec.decode_ms):.2f} ms a step (min {min(rec.decode_ms):.2f}, "
        f"max {max(rec.decode_ms):.2f}); KV pool {pool / 1e6:.1f} MB; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for i, c in enumerate(comps):
        log(f"[serve]   request {c.prompt_len:5d} tokens{' (sampled)' if i in sampled else ''}: "
            f"ttft {c.ttft_s * 1e3:.1f} ms, latency {c.latency_s * 1e3:.1f} ms")
    timed_tokens = [c.tokens for c in comps]
    del eng, rec
    comps, eng, rec, _ = serve_run(cfg, params, scfg, reqs())
    if [c.tokens for c in comps] != timed_tokens:
        raise AssertionError("[serve] the recorded run's tokens differ from the timed run's")
    gaps, flips = [], 0
    for i, (c, p) in enumerate(zip(comps, prompts)):
        if i in sampled:
            continue
        rows, picks = contiguous_logits(cfg, params, p, list(c.tokens), scfg.max_len_cap)
        gaps.append(logits_gap(rec, c, rows))
        flips += sum(a != b for a, b in zip(picks, c.tokens))
    gate = SERVE_GATE_BF16
    log(f"[serve] greedy logits vs the contiguous-cache steps (batch 1, fed the engine's "
        f"tokens): max|Δ|/max|logits| per request {[f'{g:.2e}' for g in gaps]} (gate "
        f"{gate:g}; the f32 engine's gap {f32_gap:.2e}); contiguous greedy picks differing "
        f"from the engine's tokens: {flips} of {32 * len(gaps)}")
    if max(gaps) > gate:
        raise AssertionError(f"[serve] bf16 logits gaps {gaps} > {gate}")
    del params, eng, rec
    torch.cuda.empty_cache()


def save_for_serving(root, params, opt_state):
    """The fused phase's final state as train_loop writes it ({"params",
    "opt_state"}), at step 8 (the steps taken), for [serve-ckpt]; returns a
    host copy of its params."""
    CheckpointManager(root, async_save=False).save(
        8, {"params": params, "opt_state": opt_state}, block=True)
    return tree_map(lambda t: t.detach().cpu(), params)


def serve_ckpt_phase(root, host_params):
    """[serve-ckpt]: the fused phase's step-8 checkpoint through
    launch/serve.py::load_checkpoint_params (the params group only), bit for
    bit the phase's final params; two greedy requests served from it in bf16,
    logits within the bf16 gate of the contiguous steps', and from the same
    params in f32 (exactly upcast), tokens equal to the contiguous steps' and
    logits within 1e-4."""
    from repro_torch.launch.serve import load_checkpoint_params
    from repro_torch.serve import Request, ServeConfig

    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    t = time.perf_counter()
    params, step = load_checkpoint_params(cfg, root)
    torch.cuda.synchronize()
    got = dict(tree_leaves_with_path(params))
    want = dict(tree_leaves_with_path(host_params))
    if step != 8 or sorted(got) != sorted(want):
        raise AssertionError(f"[serve-ckpt] step {step}, leaves {sorted(got)}")
    for k, w in want.items():
        if got[k].dtype != w.dtype or not torch.equal(got[k].cpu(), w):
            raise AssertionError(f"[serve-ckpt] leaf {k} is not the phase's bit for bit")
    log(f"[serve-ckpt] restored step {step} ({len(got)} params leaves, bit for bit the fused "
        f"phase's final params) in {time.perf_counter() - t:.1f} s")
    prompts = serve_prompts(np.random.default_rng(14), (40, 300), cfg.vocab_size)
    scfg = ServeConfig(block_size=16, num_blocks=65, slots=2, max_len_cap=512, prefill_chunk=64)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.detach().float(), params)
    for tag, c_, p_, gate in (("bf16", cfg, params, SERVE_GATE_BF16),
                              ("f32", cfg32, params32, 1e-4)):
        comps, _, rec, _ = serve_run(c_, p_, scfg, [Request(tokens=p, max_new=16)
                                                    for p in prompts])
        gaps, flips = [], 0
        for c, p in zip(comps, prompts):
            rows, picks = contiguous_logits(c_, p_, p, list(c.tokens), scfg.max_len_cap)
            gaps.append(logits_gap(rec, c, rows))
            flips += sum(a != b for a, b in zip(picks, c.tokens))
        log(f"[serve-ckpt] {tag}: 2 greedy requests, logits max|Δ|/max|logits| vs the "
            f"contiguous steps {[f'{g:.2e}' for g in gaps]} (limit {gate:g}); contiguous picks "
            f"differing from the engine's tokens: {flips} of 32")
        if max(gaps) > gate or (tag == "f32" and flips):
            raise AssertionError(f"[serve-ckpt] {tag}: logits gaps {gaps}, {flips} tokens "
                                 f"differ from the contiguous steps'")
    del params, params32
    torch.cuda.empty_cache()


def serve_cli_phase():
    """The serving CLI in process at the smoke size, on the card."""
    from repro_torch.launch import serve as serve_cli

    t = time.perf_counter()
    serve_cli.main(["--arch", "llama_60m", "--max-new", "8"])
    log(f"[serve-cli] python -m repro_torch.launch.serve --arch llama_60m --max-new 8: done "
        f"({time.perf_counter() - t:.1f} s)")


# ---------------------------------------------------------------------------
# the attention-decoder families: MoE with chunked iRoPE attention (Llama-4
# Scout), M-RoPE (Qwen2-VL), and the dense and grok-1 configs
# ---------------------------------------------------------------------------

MOE_ARCH = "llama4_scout_17b_a16e"
# Llama-4 Scout's expert leaves at 4 of 48 layers, each 4 × 16 experts = 64
# slabs: gate (and up) projected on the left at r = 128, down on the right
EXPERT_SHAPES = [("left", 64, 5120, 128, 8192), ("right", 64, 8192, 128, 5120)]
EXPERT_CHUNK = 8  # slabs a comparison: a whole leaf's f64 comparison would not fit
FAMILY_ARCHS = ("qwen2_7b", "granite_20b", "internlm2_20b", "minitron_4b", "grok_1_314b")


def gb(nbytes):
    return f"{nbytes / 1e9:.1f} GB"


def check_expert_apply():
    """lowrank_adam_kernel's fp32 apply form (the [moe] phase's step form) on
    one whole 64-slab expert leaf a side, G and W bf16, P f32: W' and the
    moments against the plain version at apply_row's gates, EXPERT_CHUNK
    slabs at a time (each chunk's own max in the tolerances), W' bit for bit
    ref.apply_weight of the kernel's own G̃, two launches on the same inputs
    bitwise equal, W updated in place; the kernel timed on the whole leaf,
    the plain version over its chunks (summed)."""
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    eta = torch.tensor(ETA, device="cuda")
    hp = dict(alpha=ALPHA, eta=eta, wd=WD)
    rows = []
    for i, (side, L, m, r, n) in enumerate(EXPERT_SHAPES):
        key = "apply_" + side
        k = KERNELS[key]
        P, G, M, V, _ = kernel_inputs(side, L, m, r, n, torch.bfloat16, seed=300 + i)
        gen = torch.Generator(device="cuda").manual_seed(310 + i)
        W = (0.02 * torch.randn(L, m, n, generator=gen, device="cuda")).to(torch.bfloat16)
        w0, mine = W.clone(), (M.clone(), V.clone())
        before = thread_copies()
        got = k["wrapper"](P, G, W, *mine, count, **hp)
        torch.cuda.synchronize()
        tag = (f"{k['name']} expert leaf L={L} (m,r,n)=({m},{r},{n}) G bfloat16 W bfloat16 "
               f"{route(before)}")
        if got[0] is not W:
            raise AssertionError(f"{tag}: the wrapper did not return W itself")
        W2 = w0.clone()
        again = k["wrapper"](P, G, W2, M.clone(), V.clone(), count, **hp)
        torch.cuda.synchronize()
        if not (torch.equal(W, W2) and all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))):
            raise AssertionError(f"{tag}: two launches on the same inputs differ")
        del W2, again
        gt_own = own_gt(k["wrapper"], P, G, (M, V), count)
        w_err = mom_err = plain_ms = 0.0
        notes = []
        for c in range(0, L, EXPERT_CHUNK):
            sl = slice(c, c + EXPERT_CHUNK)
            if not torch.equal(W[sl], apply_weight(w0[sl], gt_own[sl], eta, WD)):
                raise AssertionError(f"{tag} slabs {c}+: W' differs from ref.apply_weight of the "
                                     f"kernel's own G̃")
            want = k["plain"](P[sl], G[sl], w0[sl], M[sl], V[sl], count, **hp)
            e, note = weight_check(W[sl], want[0], w0[sl], f"{tag} slabs {c}+")
            w_err = max(w_err, e)
            notes.append(note.removeprefix("; "))
            for name, a, b in zip(("m", "v"), got[1:], want[1:]):
                a = a[sl]
                if bool(((a - b).abs() > 1e-5 * b.abs().max() + 1e-5 * b.abs()).any()):
                    raise AssertionError(f"{tag} slabs {c}+ {name}: max|err| "
                                         f"{float((a - b).abs().max()):.3e} over tolerance")
                mom_err = max(mom_err, float((a - b).abs().max()))
            del want
            plain_ms += cuda_ms(lambda: k["plain"](P[sl], G[sl], w0[sl], M[sl], V[sl], count,
                                                   **hp), 1, 3)
        del gt_own
        ms = cuda_ms(lambda: k["wrapper"](P, G, W, *mine, count, **hp), 3, 10)
        b_s, b_by, b_f32 = bound(side, L, m, r, n, 2, 2)
        log(f"[kernels] {tag}: max|err| W' {w_err:.2e} ({'; '.join(notes)}); moments "
            f"{mom_err:.2e}; W' bitwise ref.apply_weight of its own G̃; two launches equal; in "
            f"place ok  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms ({L // EXPERT_CHUNK} calls of "
            f"{EXPERT_CHUNK} slabs)  bound {b_s * 1e3:.3f} ms ({b_by}; {b_s / ms * 1e5:.0f} % of "
            f"it; f32-FMA {b_f32 * 1e3:.3f})")
        rows.append(dict(kernel=key, side=side, L=L, m=m, r=r, n=n, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_s * 1e3, bound_by=b_by, max_abs_err=w_err))
        del P, G, M, V, W, w0, mine, got
        torch.cuda.empty_cache()
    return rows


def moe_reckoning(params, gcfg):
    """The [moe] run's peak by its parts, before the run: weights, their
    gradients and the optimizer state, and what each step form adds at its
    peak — the emit form the chain's clipped copy of the gradients and an
    f32 update of every leaf at once; the apply form (clipped in place, the
    full-shape leaves' Adam a block of rows at a time) the clip's largest
    temporary, the largest leaf's f32 copy, squared in place."""
    leaves = tree_leaves(params)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    state = galore_state_bytes(params, gcfg)["optimizer_state_bytes"]
    emit = weights + 4 * sum(t.numel() for t in leaves)
    apply = 4 * max(t.numel() for t in leaves)
    base = 2 * weights + state
    return dict(weights=weights, state=state, emit=emit, apply=apply, emit_peak=base + emit,
                apply_peak=base + apply, card=torch.cuda.get_device_properties(0).total_memory)


def moe_phase(phases, none):
    """[moe]: Llama-4 Scout at full width, 4 of 48 layers (one iRoPE group:
    three chunked layers with rope, one global rope-free), bf16, remat
    "full", trained 8 steps with GaLore-AdamW r = 128, T = 8, the randomized
    projector, in the apply form (the reckoning says why)."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=4)
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    gcfg = GaLoreConfig(rank=128, update_freq=8, scale=0.25, projector="randomized")
    rk = moe_reckoning(params, gcfg)
    log(f"[moe] {cfg.name}: {cfg.n_layers} of 48 layers (chunk {cfg.attention_chunk}, global "
        f"layer {cfg.full_attn_every - 1}), {n_params} parameters, {cfg.dtype}, remat "
        f"{cfg.remat}, initialised in {time.perf_counter() - t:.1f} s; reckoning: weights "
        f"{gb(rk['weights'])} + grads {gb(rk['weights'])} + optimizer state {gb(rk['state'])}; "
        f"the emit form adds {gb(rk['emit'])} (clipped gradients and f32 updates: peak ≥ "
        f"{gb(rk['emit_peak'])}), the apply form {gb(rk['apply'])} (the clip's f32 temporary: "
        f"≈ {gb(rk['apply_peak'])}); the card has {gb(rk['card'])}: the apply form")
    t = time.perf_counter()
    ph = phases["moe"] = train_phase(fused=True, apply=True, cfg=cfg, params=params,
                                     galore_kw=dict(projector="randomized"))
    del params
    log(f"[moe] losses {[round(x, 4) for x in ph['losses']]} aux_loss "
        f"{[round(x, 5) for x in ph['aux']]} launches {ph['launches']} (launches by thread "
        f"copies {ph['thread_copy_epilogue']}); step ms {[round(x * 1e3, 1) for x in ph['times']]}"
        f"; peak memory {ph['peak'] / 2**30:.2f} GiB ({gb(ph['peak'])}) ({time.perf_counter() - t:.1f} s)")
    if not ph["losses"][-1] < ph["losses"][0]:
        raise AssertionError(f"[moe] loss did not decrease: {ph['losses']}")
    if not all(a > 0 and math.isfinite(a) for a in ph["aux"]):
        raise AssertionError(f"[moe] aux_loss not positive at every step: {ph['aux']}")
    # left: wq wo gate up; right: wk wv (5120 × 1024) and down — one launch a
    # stacked leaf a step, the expert leaves 64 slabs each
    if ph["launches"] != dict(none, apply_left=32, apply_right=24):
        raise AssertionError(f"[moe] launches {ph['launches']}, want apply left 32 (4 leaves × 8 "
                             f"steps), right 24 (3 leaves × 8)")
    check_state_bytes("moe", ph)


def moe_dispatch_phase():
    """[moe-dispatch]: one Llama-4 Scout MoE layer in f32 (capacity factor
    E/K = 16, so no copy drops) on 256 tokens against the all-experts dense
    computation: output within 1e-5·max, the gradients of x and of every
    expert leaf within 1e-4·max."""
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_lib

    base = get_config(MOE_ARCH)
    E, K, D = base.n_experts, base.experts_per_token, base.d_model
    cfg = dataclasses.replace(base, dtype="float32", capacity_factor=float(E // K))
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    p = {k: v.requires_grad_(True) for k, v in moe_lib.init_moe(gen, cfg, torch.float32).items()}
    x = torch.randn(1, 256, D, generator=gen, device="cuda").requires_grad_(True)
    dy = torch.randn(1, 256, D, generator=gen, device="cuda")
    y, aux = moe_lib.apply_moe(cfg, p, x)
    gate, idx = torch.topk(torch.softmax(x @ p["router"], dim=-1), K, dim=-1)
    if K > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    every = torch.stack([(F.silu(x @ p["gate"][e]) * (x @ p["up"][e])) @ p["down"][e]
                         for e in range(E)], dim=2)  # (B, S, E, D)
    want = torch.einsum("bskd,bsk->bsd",
                        torch.gather(every, 2, idx[..., None].expand(-1, -1, -1, D)), gate)
    names = ["x", "gate", "up", "down", "router"]
    wrt = [x, p["gate"], p["up"], p["down"], p["router"]]
    g_got = torch.autograd.grad(y, wrt, dy)
    g_want = torch.autograd.grad(want, wrt, dy)
    y, want, aux = y.detach(), want.detach(), aux.detach()
    gaps = {"y": float((y - want).abs().max() / want.abs().max())}
    for name, a, b in zip(names, g_got, g_want):
        gaps[name] = float((a - b).abs().max() / b.abs().max())
    log(f"[moe-dispatch] {E} experts top-{K}, capacity {moe_lib.capacity_for(cfg, 256)} of 256 "
        f"tokens, f32: max|Δ|/max against the all-experts computation {gaps} (limits y 1e-5, "
        f"gradients 1e-4); aux_loss {float(aux):.5f} ({time.perf_counter() - t:.1f} s)")
    if gaps["y"] > 1e-5 or max(v for k, v in gaps.items() if k != "y") > 1e-4:
        raise AssertionError(f"[moe-dispatch] gaps {gaps}")
    del p, x, y, want, every, g_got, g_want
    torch.cuda.empty_cache()


def mrope_phase(phases, none):
    """[mrope]: Qwen2-VL-7B at full width, 2 of 28 layers, bf16: text
    positions (three equal rows) give the rope forward within 1e-6·max, a
    forward with 256 media embeddings is finite; then 8 steps of fp32 fused
    GaLore (r = 128, T = 8) through the launcher's text-only batches."""
    from repro_torch.models.model import forward

    cfg = dataclasses.replace(get_config("qwen2_vl_7b"), n_layers=2)
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(22)
    B, S, M_ = 2, 512, cfg.media_embeds
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    text = torch.arange(S, device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        V = cfg.vocab_size
        got = forward(cfg, params, {"tokens": tokens, "positions": text.expand(3, B, S)})[..., :V]
        want = forward(dataclasses.replace(cfg, rope_style="rope"), params,
                       {"tokens": tokens})[..., :V]
        gap = float((got - want).abs().max() / want.abs().max())
        # a 16 × 16 patch grid at t = 0, then text from position 16 on
        i = torch.arange(M_, device="cuda", dtype=torch.int32)
        grid = torch.stack([torch.zeros_like(i), i // 16, i % 16])
        after = (16 + torch.arange(S - M_, device="cuda", dtype=torch.int32)).expand(3, -1)
        positions = torch.cat([grid, after], dim=1)[:, None].expand(3, B, S)
        media = 0.1 * torch.randn(B, M_, cfg.d_model, generator=gen, device="cuda").to(
            torch.bfloat16)
        mixed = forward(cfg, params, {"tokens": tokens, "positions": positions, "media": media})
        finite = bool(torch.isfinite(mixed[..., :V]).all())
    log(f"[mrope] {cfg.name}: 2 of 28 layers, sections {cfg.mrope_sections}; text positions vs "
        f"rope_style rope: max|Δ|/max {gap:.2e} (limit 1e-6); a forward with {M_} media "
        f"embeddings on a 16 × 16 grid: finite {finite} ({time.perf_counter() - t:.1f} s)")
    if gap > 1e-6 or not finite:
        raise AssertionError(f"[mrope] text gap {gap}, media forward finite {finite}")
    del params, got, want, mixed
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ph = phases["mrope"] = train_phase(fused=True, cfg=cfg)
    log(f"[mrope] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; peak "
        f"memory {ph['peak'] / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
    if not ph["losses"][-1] < ph["losses"][0]:
        raise AssertionError(f"[mrope] loss did not decrease: {ph['losses']}")
    # left: wq wo gate up; right: wk wv (3584 × 512) and down
    if ph["launches"] != dict(none, left=32, right=24):
        raise AssertionError(f"[mrope] launches {ph['launches']}, want left 32 (4 leaves × 8 "
                             f"steps), right 24 (3 leaves × 8)")
    check_state_bytes("mrope", ph)


def chunk_serve(cfg, tag):
    """The [serve-chunk] traffic through a fresh engine on `cfg` (seeded
    weights): a prompt of 8,704 tokens (positions cross the chunk at 8,192)
    in prefill chunks of 512 and 32 new tokens, beside a 40-token request
    whose 64 tokens decode in the same batches; then every emitted token's
    logits against the contiguous-cache steps fed the same tokens, whose
    caches (8,736 and 104 tokens) are no multiple of the chunk. With experts
    both runs' routing is tapped (RouterTap). Returns the per-token logits
    gaps, the greedy picks that differ, and per token the routing decisions
    (position ≤ its own, layer) that differ between the two runs, each as
    (the smaller of the two runs' top-1 margins, the larger logit
    magnitude)."""
    from repro_torch.serve import Request, ServeConfig

    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    prompts = serve_prompts(np.random.default_rng(15), (8704, 40), cfg.vocab_size)
    new = (32, 64)
    cap = 8704 + 32
    scfg = ServeConfig(block_size=16, num_blocks=1 + cap // 16 + 8, slots=2, max_len_cap=cap,
                       prefill_chunk=512)
    tap = RouterTap() if cfg.n_experts > 0 else None
    torch.cuda.reset_peak_memory_stats()
    with tap or contextlib.nullcontext():
        comps, eng, rec, wall = serve_run(cfg, params, scfg, [Request(tokens=p, max_new=k)
                                                              for p, k in zip(prompts, new)],
                                          timed=True, tap=tap)
    log(f"[serve-chunk] {tag}: prompts {[c.prompt_len for c in comps]} → "
        f"{[len(c.tokens) for c in comps]} tokens in {wall:.2f} s; {eng.stats}; prefill "
        f"{len(rec.prefill_ms)} calls, {sum(rec.prefill_ms):.1f} ms of device time "
        f"({sum(map(len, prompts)) / sum(rec.prefill_ms) * 1e3:.0f} prompt tokens/s); decode "
        f"{len(rec.decode_ms)} steps, median {statistics.median(rec.decode_ms):.2f} ms; ttft "
        f"{[round(c.ttft_s * 1e3, 1) for c in comps]} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    gaps, flips, token_flips = [], 0, []
    for c, p in zip(comps, prompts):
        with tap or contextlib.nullcontext():
            got = contiguous_logits(cfg, params, p, list(c.tokens), len(p) + len(c.tokens),
                                    tap=tap)
        rows, picks = got[:2]
        gaps += token_gaps(rec, c, rows, cfg.vocab_size)
        flips += sum(a != b for a, b in zip(picks, c.tokens))
        if tap is not None:
            mine = np.stack([rec.routes[(c.request_id, q)] for q in range(len(got[2]))])
            theirs = got[2]
            q_l = np.argwhere(mine[..., 0] != theirs[..., 0])  # (position, layer) that differ
            diff = [(int(q), float(min(mine[q, l, 1], theirs[q, l, 1])),
                     float(max(mine[q, l, 2], theirs[q, l, 2]))) for q, l in q_l]
            token_flips += [[d for d in diff if d[0] <= len(p) - 1 + k]
                            for k in range(len(c.tokens))]
        del rows
    q = np.quantile(gaps, [0.5, 0.9])
    log(f"[serve-chunk] {tag}: logits vs the contiguous-cache steps, max|Δ|/max|logits| a "
        f"token: median {q[0]:.2e}, 90th percentile {q[1]:.2e}, max {max(gaps):.2e}, "
        f"{sum(g > SERVE_GATE_BF16 for g in gaps)} of {len(gaps)} over {SERVE_GATE_BF16:g}; "
        f"contiguous greedy picks differing from the engine's: {flips} of {len(gaps)}; "
        f"contiguous prefill peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({time.perf_counter() - t:.1f} s)")
    del params, eng, rec
    torch.cuda.empty_cache()
    return gaps, flips, token_flips


def bf16_ulp(x):
    """One bf16 ulp at magnitude x > 0 (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def routing_gate(tag, gaps, token_flips, positions):
    """[serve-chunk] bf16 MoE (ROADMAP C.15). A token's routing is the top-1
    expert of every MoE layer at its own position; where it agrees between
    the engine and the contiguous steps the token is held to
    SERVE_GATE_BF16; where it differs the token may exceed the gate only if
    each differing layer's top-1 margin (the smaller of the two runs') lies
    within one bf16 ulp of the larger router logit — a tie that the bf16
    rounding of the router logits decides. Logs the counts and each
    differing decision; returns the tokens that fail."""
    own = [[d for d in f if d[0] == p] for f, p in zip(token_flips, positions)]
    bad, allowed = [], 0
    for g, o in zip(gaps, own):
        if g <= SERVE_GATE_BF16:
            continue
        if o and all(m <= bf16_ulp(a) for _, m, a in o):
            allowed += 1
        else:
            bad.append(g)
    decisions = sorted({d for f in token_flips for d in f})
    agree = [g for g, o in zip(gaps, own) if not o]
    log(f"[serve-chunk] {tag} routing: {len(decisions)} top-1 decisions (position, layer) "
        f"differ between the engine and the contiguous steps, margin/ulp "
        f"{[round(m / bf16_ulp(a), 3) for _, m, a in decisions]}; tokens whose own routing "
        f"agrees {len(agree)}, max gap {max(agree, default=0.0):.2e} (limit "
        f"{SERVE_GATE_BF16:g}); tokens whose own routing differs {len(gaps) - len(agree)}, "
        f"gaps {[round(g, 4) for g, o in zip(gaps, own) if o]}, margin/ulp "
        f"{[[round(m / bf16_ulp(a), 3) for _, m, a in o] for o in own if o]}; tokens over the "
        f"limit after a tie {allowed}; failing {len(bad)} {[round(g, 4) for g in bad]}")
    return bad


def serve_chunk_phase():
    """[serve-chunk]: the [moe] model shape (capacity factor E/K, so a row's
    tokens never contend for an expert's capacity) served across the chunk
    boundary. In f32 every emitted token's logits within 1e-4·max of the
    contiguous steps' and the same greedy picks: the paged chunked mask and
    the contiguous decode window agree at the boundary and at cache lengths
    no multiple of the chunk. In bf16 the two paths' GEMMs round apart, and
    a top-1 router turns a rounding difference near a tie into another
    expert for that token: the same traffic without experts is held to
    SERVE_GATE_BF16 at every token, and the MoE model by routing_gate (the
    router's margins and routing recorded in both runs, f32 and bf16)."""
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=4,
                              capacity_factor=float(base.n_experts // base.experts_per_token))
    gaps, flips, token_flips = chunk_serve(dataclasses.replace(cfg, dtype="float32"), "f32")
    f32_decisions = {d for f in token_flips for d in f}
    log(f"[serve-chunk] f32 routing: {len(f32_decisions)} top-1 decisions differ between the "
        f"engine and the contiguous steps")
    if max(gaps) > 1e-4 or flips:
        raise AssertionError(f"[serve-chunk] f32: logits gap {max(gaps):.3e} > 1e-4 or {flips} "
                             f"greedy picks differ")
    gaps, _, _ = chunk_serve(dataclasses.replace(cfg, n_experts=0, family="dense"),
                             "bf16-dense")
    if max(gaps) > SERVE_GATE_BF16:
        raise AssertionError(f"[serve-chunk] bf16-dense: logits gap {max(gaps):.3e} > "
                             f"{SERVE_GATE_BF16}")
    gaps, _, token_flips = chunk_serve(cfg, "bf16")
    # each emitted token's logits come from the forward at its prompt's last
    # position, then at each generated token's
    positions = [n - 1 + k for n, new in ((8704, 32), (40, 64)) for k in range(new)]
    bad = routing_gate("bf16", gaps, token_flips, positions)
    if bad:
        raise AssertionError(f"[serve-chunk] bf16: {len(bad)} tokens over {SERVE_GATE_BF16} "
                             f"without a routing tie to explain them: {bad}")


def families_phase():
    """[families]: every other registered config at full width with 2 layers
    (their remat "full"), bf16: one forward and backward each, the loss and
    every gradient leaf finite; parameters and peak memory. No optimizer
    step: AdamW's moments for grok-1's 2 layers alone would be ≈ 77 GB."""
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda")
        leaves = tree_leaves(params)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                               generator=torch.Generator(device="cuda").manual_seed(23),
                               device="cuda")
        total, metrics = loss_fn(cfg, params, {"tokens": tokens})
        grads = torch.autograd.grad(total, leaves)
        bad = [path for (path, _), g in zip(tree_leaves_with_path(params), grads)
               if not bool(torch.isfinite(g).all())]
        torch.cuda.synchronize()
        log(f"[families] {cfg.name}: 2 of {get_config(arch).n_layers} layers, "
            f"{sum(p.numel() for p in leaves)} parameters, remat {cfg.remat}, kv heads "
            f"{cfg.n_kv_heads}, qkv bias {cfg.qkv_bias}, experts {cfg.n_experts}: loss "
            f"{float(metrics['loss']):.4f} aux_loss {float(metrics['aux_loss']):.5f}, "
            f"{len(grads)} gradient leaves finite {not bad}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
        if bad or not math.isfinite(float(total)):
            raise AssertionError(f"[families] {arch}: loss {float(total)}, non-finite gradients "
                                 f"{bad}")
        del params, leaves, grads, total, metrics
        torch.cuda.empty_cache()


class ServerRecorder:
    """Wraps a Server's contiguous prefill and decode steps: every emitted
    token's logits ((V,) f32 on the card, in call order: each length group's
    prefill, then its decode steps) and CUDA events around each call."""

    def __init__(self, server):
        self.rows, self.prefill_ms, self.decode_ms, self.prefill_tokens = [], [], [], 0
        self._events = []
        prefill, decode = server.prefill, server.decode

        def timed(kind, fn, *args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self._events.append((kind, a, b))
            return out

        def rec_prefill(params, cache, batch):
            last, cache = timed("prefill", prefill, params, cache, batch)
            self.prefill_tokens += batch["tokens"].numel()
            self.rows += [row.float().clone() for row in last]
            return last, cache

        def rec_decode(params, cache, tokens, pos):
            nxt, last, cache = timed("decode", decode, params, cache, tokens, pos)
            self.rows += [row.float().clone() for row in last]
            return nxt, last, cache

        server.prefill, server.decode = rec_prefill, rec_decode

    def times(self):
        torch.cuda.synchronize()
        for kind, a, b in self._events:
            (self.prefill_ms if kind == "prefill" else self.decode_ms).append(a.elapsed_time(b))
        self._events.clear()


def text_batch(cfg, rows):
    """A batch of token rows on the card; an audio model's with the zero
    frames the Server prefills on, in the model's dtype."""
    batch = {"tokens": torch.tensor(rows, device="cuda")}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.zeros((len(rows), cfg.enc_seq, cfg.d_model),
                                          dtype=getattr(torch, cfg.dtype), device="cuda")
    return batch


def served_vs_forward(cfg, params, prompts, new, max_len):
    """The Server's greedy tokens for `prompts` (each of its own length, so
    each its own lane group), and for every emitted token its logits gap
    (max|Δ|/max over the real vocab) against the full forward on the prompt
    and the served tokens, and whether its pick is the full forward's
    argmax; with the recorder's timings."""
    import warnings

    from repro_torch.launch.serve import Server
    from repro_torch.models.model import forward

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        server = Server(cfg, params, max_len=max_len, slots=len(prompts))
    rec = ServerRecorder(server)
    out = server.generate([list(p) for p in prompts], max_new=new)
    rec.times()
    V, gaps, same, k = cfg.vocab_size, [], 0, 0
    with torch.inference_mode():
        for p, toks in zip(prompts, out):
            full = forward(cfg, params, text_batch(cfg, [list(p) + toks[:-1]]))[0]
            for j, tok in enumerate(toks):
                want, got = full[len(p) - 1 + j, :V].float(), rec.rows[k][:V]
                gaps.append(float((got - want).abs().max()) / float(want.abs().max()))
                same += int(want.argmax()) == tok
                k += 1
    if k != len(rec.rows):
        raise AssertionError(f"{len(rec.rows)} recorded rows for {k} served tokens")
    return out, gaps, same, rec


SSM_ARCH, HYBRID_ARCH = "mamba2_130m", "jamba_1_5_large_398b"
SSM_PROMPTS = (2, 7, 64, 300)


def ssm_phase(phases, none):
    """[ssm]: mamba2_130m whole (24 layers, d_model 768, vocab 50280, bf16,
    remat full): 8 fp32 fused GaLore steps (r = 128, T = 8) through the
    launcher, B1 at in_z and in_x (768 × 1536, left) and B2 at out_proj
    (1536 × 768, right), in_B / in_C / in_dt on the full-shape Adam; then the
    Server's contiguous loop on prompts of 2, 7, 64 and 300 tokens, 16 new
    tokens each: in f32 the greedy tokens equal the full forward's and every
    token's logits are within 1e-4·max. In bf16 the median token within
    SERVE_GATE_BF16 and every token within the bf16 full forward's own gap
    to the f32 forward of the same weights: bf16 rounding alone moves this
    random model's logits by up to that much (bf16_own_gaps), so no bf16
    path is held closer to another at every token."""
    cfg = get_config(SSM_ARCH)
    t = time.perf_counter()
    ph = phases["ssm"] = train_phase(fused=True, cfg=cfg)
    log(f"[ssm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, remat "
        f"{cfg.remat}: losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; "
        f"step ms {[round(x * 1e3, 1) for x in ph['times']]}; peak memory "
        f"{ph['peak'] / 2**30:.2f} GiB ({time.perf_counter() - t:.1f} s)")
    if not ph["losses"][-1] < ph["losses"][0]:
        raise AssertionError(f"[ssm] loss did not decrease: {ph['losses']}")
    if ph["launches"] != dict(none, left=16, right=8):
        raise AssertionError(f"[ssm] launches {ph['launches']}, want left 16 (in_z and in_x × 8 "
                             f"steps), right 8 (out_proj × 8)")
    check_state_bytes("ssm", ph)
    rng = np.random.default_rng(26)
    prompts = serve_prompts(rng, SSM_PROMPTS, cfg.vocab_size)
    new = 16
    for dtype in ("float32", "bfloat16"):
        t = time.perf_counter()
        c = dataclasses.replace(cfg, dtype=dtype)
        params = init_params(c, seed=0, device="cuda")
        out, gaps, same, rec = served_vs_forward(c, params, prompts, new, max(SSM_PROMPTS) + new)
        own = (bf16_own_gaps(cfg, params, prompts, out) if dtype == "bfloat16" else None)
        log(f"[ssm] Server {dtype}: prompts {list(SSM_PROMPTS)} → {new} tokens each; logits vs "
            f"the full forward max|Δ|/max a token: median {statistics.median(gaps):.2e}, max "
            f"{max(gaps):.2e}" + (" (limit 1e-4)" if own is None else
                                  f" (limits: median {SERVE_GATE_BF16:g}, max the bf16 full "
                                  f"forward's own gap to the f32 forward of its weights, median "
                                  f"{statistics.median(own):.2e}, max {max(own):.2e})")
            + f"; greedy picks equal to the full forward's {same} of {len(gaps)}; prefill "
            f"{len(rec.prefill_ms)} calls, {rec.prefill_tokens / sum(rec.prefill_ms) * 1e3:.0f} "
            f"tokens/s ({[round(x, 2) for x in rec.prefill_ms]} ms); decode "
            f"{len(rec.decode_ms)} steps of one lane, median "
            f"{statistics.median(rec.decode_ms):.3f} ms; {card_line()} "
            f"({time.perf_counter() - t:.1f} s)")
        if own is None and (max(gaps) > 1e-4 or same != len(gaps)):
            raise AssertionError(f"[ssm] float32: logits gap {max(gaps):.3e} > 1e-4 or "
                                 f"{len(gaps) - same} greedy picks differ")
        if own is not None and (statistics.median(gaps) > SERVE_GATE_BF16
                                or max(gaps) > max(own)):
            raise AssertionError(f"[ssm] bfloat16: median gap {statistics.median(gaps):.3e} > "
                                 f"{SERVE_GATE_BF16} or max {max(gaps):.3e} > the bf16 forward's "
                                 f"own {max(own):.3e}")
        del params, rec
        torch.cuda.empty_cache()


def bf16_own_gaps(cfg, params, prompts, served):
    """How far bf16 rounding alone moves a bf16 model's logits: for each served
    token, the bf16 full forward's logits against the f32 full forward's of
    the same weights (bf16 values in f32) on the same tokens, max|Δ|/max over
    the real vocab."""
    from repro_torch.models.model import forward

    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.detach().float(), params)
    V, gaps = cfg.vocab_size, []
    with torch.inference_mode():
        for p, toks in zip(prompts, served):
            rows = [list(p) + toks[:-1]]
            a = forward(cfg, params, text_batch(cfg, rows))[0, len(p) - 1:, :V]
            b = forward(c32, p32, text_batch(c32, rows))[0, len(p) - 1:, :V]
            gaps += [float((x.float() - y).abs().max()) / float(y.abs().max())
                     for x, y in zip(a, b)]
    del p32
    return gaps


def shape_params(cfg):
    """init_params's tree for `cfg` with its large leaves on the meta device
    (shapes and dtypes only), for a reckoning before anything is allocated."""
    from repro_torch.models import attention, layers, model, moe, ssm

    def meta_normal(gen, shape, dtype, fan_in=None):
        return torch.empty(shape, dtype=dtype, device="meta")

    mods = (layers, attention, moe, ssm)
    saved = [m._init_normal for m in mods]
    for m in mods:
        m._init_normal = meta_normal
    try:
        return model.init_params(cfg, seed=0, device="cpu")
    finally:
        for m, f in zip(mods, saved):
            m._init_normal = f


def hybrid_config(n_experts):
    """One Jamba period at full width, its experts cut to `n_experts` (top-2
    kept), capacity E/K so that no token is dropped."""
    base = get_config(HYBRID_ARCH)
    return dataclasses.replace(base, n_layers=base.attn_every, n_experts=n_experts,
                               capacity_factor=float(n_experts // base.experts_per_token))


def hybrid_phase(phases, none):
    """[hybrid]: Jamba-1.5-Large at full width. One period holds 4 MoE layers
    of 16 experts × 3 × 8192 × 24576 ≈ 38.7 G parameters (≈ 77 GB in bf16),
    so no depth of the full config fits the card: one period (8 layers) with
    the experts cut to 4 is served in f32 (prefill and decode against the
    full forward), and trained in the apply form with the randomized
    projector at 4 experts if the reckoning's peak stays under 70 GB, else
    at 2."""
    gcfg = GaLoreConfig(rank=128, update_freq=8, scale=0.25, projector="randomized")
    rks = {}
    for E in (4, 2):
        shapes = shape_params(dataclasses.replace(hybrid_config(E), dtype="bfloat16"))
        rk = rks[E] = moe_reckoning(shapes, gcfg)
        n_params = sum(p.numel() for p in tree_leaves(shapes))
        log(f"[hybrid] reckoning, one period at full width, {E} experts top-2, bf16: "
            f"{n_params} parameters; weights {gb(rk['weights'])} + grads {gb(rk['weights'])} + "
            f"optimizer state {gb(rk['state'])}; the apply form adds {gb(rk['apply'])}: ≈ "
            f"{gb(rk['apply_peak'])}; the emit form ≥ {gb(rk['emit_peak'])}; the card has "
            f"{gb(rk['card'])}")
        del shapes
    train_e = 4 if rks[4]["apply_peak"] < 70e9 else 2

    cfg = dataclasses.replace(hybrid_config(4), dtype="float32")
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    prompts = serve_prompts(np.random.default_rng(27), (5, 48), cfg.vocab_size)
    new = 8
    out, gaps, same, rec = served_vs_forward(cfg, params, prompts, new, 48 + new)
    log(f"[hybrid] Server f32, 4 experts, capacity {cfg.capacity_factor:g} (no drops): prompts "
        f"(5, 48) → {new} tokens each; logits vs the full forward max|Δ|/max a token: median "
        f"{statistics.median(gaps):.2e}, max {max(gaps):.2e} (limit 1e-4); greedy picks equal "
        f"{same} of {len(gaps)}; prefill {rec.prefill_tokens / sum(rec.prefill_ms) * 1e3:.0f} "
        f"tokens/s, decode median {statistics.median(rec.decode_ms):.2f} ms a step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card_line()} "
        f"({time.perf_counter() - t:.1f} s)")
    if max(gaps) > 1e-4 or same != len(gaps):
        raise AssertionError(f"[hybrid] serve: logits gap {max(gaps):.3e} > 1e-4 or "
                             f"{len(gaps) - same} greedy picks differ")
    del params, rec
    torch.cuda.empty_cache()

    cfg = hybrid_config(train_e)
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    ph = phases["hybrid"] = train_phase(fused=True, apply=True, cfg=cfg, params=params,
                                        galore_kw=dict(projector="randomized"))
    del params
    log(f"[hybrid] trained at {train_e} experts (the reckoning's apply-form peak at 4: "
        f"{gb(rks[4]['apply_peak'])}, limit 70 GB): losses {[round(x, 4) for x in ph['losses']]} "
        f"aux_loss {[round(x, 5) for x in ph['aux']]} launches {ph['launches']}; step ms "
        f"{[round(x * 1e3, 1) for x in ph['times']]}; peak memory {ph['peak'] / 2**30:.2f} GiB "
        f"({time.perf_counter() - t:.1f} s)")
    if not ph["losses"][-1] < ph["losses"][0]:
        raise AssertionError(f"[hybrid] loss did not decrease: {ph['losses']}")
    if not all(a > 0 and math.isfinite(a) for a in ph["aux"]):
        raise AssertionError(f"[hybrid] aux_loss not positive at every step: {ph['aux']}")
    # a left leaf keeps its 8192 rows at r = 128 and fails fits_vmem (the
    # apply form takes the reference's plain step there); right leaves keep
    # their columns: in_dt (8192 × 256) of the 7 SSD sub-layers and the
    # attention's wk, wv (8192 × 1024) fit and run B3-apply
    if ph["launches"] != dict(none, apply_right=72):
        raise AssertionError(f"[hybrid] launches {ph['launches']}, want apply right 72 (9 "
                             f"leaves × 8 steps) and nothing else")
    check_state_bytes("hybrid", ph)


WHISPER_ARCH = "whisper_small"
WHISPER_PROMPTS = (1, 4, 64, 200)


class FrameData:
    """train_loop's data source for the audio family: the synthetic token
    stream (8 × 256 a step) and frames 0.1·N(0, 1) of (8, enc_seq, d_model)
    in the model's dtype, drawn on the card from a torch.Generator seeded by
    the step."""

    def __init__(self, cfg, batch=8, seq=256, seed=0):
        self.cfg, self.seed = cfg, seed
        self.text = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                           batch_per_host=batch, seed=seed), device="cuda")

    def batch(self, step):
        b = dict(self.text.batch(step))
        gen = torch.Generator(device="cuda").manual_seed(self.seed * 100003 + step)
        shape = (b["tokens"].shape[0], self.cfg.enc_seq, self.cfg.d_model)
        b["enc_frames"] = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(
            getattr(torch, self.cfg.dtype))
        return b


def drawn_audio(cfg, seed):
    """Whisper's random init with dec_pos drawn 0.02·N(0, 1) (the init's
    zeros would hide a position off by one), and frames 0.1·N(0, 1) for 2
    lanes (zero frames make every encoder position alike), both in the
    model's dtype."""
    params = init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        params["dec_pos"].copy_(0.02 * torch.randn(params["dec_pos"].shape, generator=gen,
                                                   device="cuda"))
    frames = (0.1 * torch.randn((2, cfg.enc_seq, cfg.d_model), generator=gen,
                                device="cuda")).to(dt)
    return params, frames


def cached_vs_forward(cfg, params, frames, tokens, n_prompt):
    """A prefill of n_prompt tokens with frames through make_prefill_step,
    then the rest of `tokens` (B, n) teacher-forced through make_decode_step
    (tokens only: the cross K/V from the cache): each step's logits gap
    max|Δ|/max over the real vocab against the full forward at its
    position, a gap per lane and step."""
    from repro_torch.distributed.step import make_decode_step, make_prefill_step
    from repro_torch.models.model import forward, init_cache

    B, n = tokens.shape
    V = cfg.vocab_size
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg, with_logits=True)
    cache = init_cache(cfg, B, n, device="cuda")
    last, cache = prefill(params, cache, {"tokens": tokens[:, :n_prompt], "enc_frames": frames})
    rows = [last]
    for pos in range(n_prompt, n):
        _, last, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        rows.append(last)
    with torch.inference_mode():
        full = forward(cfg, params, {"tokens": tokens, "enc_frames": frames})
    gaps = []
    for j, row in enumerate(rows):
        want = full[:, n_prompt - 1 + j, :V].float()
        gaps += [float((g[:V].float() - w).abs().max()) / float(w.abs().max())
                 for g, w in zip(row, want)]
    del cache, full
    return gaps


def audio_own_gaps(cfg, params, frames, tokens, n_prompt):
    """The bf16 model's own gap to its f32 self: its full forward's logits
    against the f32 forward of the same (bf16) weights and frames at every
    position the cached check compares, max|Δ|/max over the real vocab."""
    from repro_torch.models.model import forward

    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.detach().float(), params)
    V = cfg.vocab_size
    with torch.inference_mode():
        a = forward(cfg, params, {"tokens": tokens, "enc_frames": frames})[:, n_prompt - 1:, :V]
        b = forward(c32, p32, {"tokens": tokens, "enc_frames": frames.float()})[:, n_prompt - 1:,
                                                                                 :V]
    gaps = [float((x.float() - y).abs().max()) / float(y.abs().max())
            for x, y in zip(a.flatten(0, 1), b.flatten(0, 1))]
    del p32
    return gaps


def whisper_phase(phases, none):
    """[whisper]: whisper_small whole (12 + 12 layers, d_model 768, padded
    vocab 51,968, enc_seq 1500, bf16, remat full; nothing cut). 8 fp32 fused
    GaLore steps (r = 128, T = 8) through train_loop(data=FrameData): B1 at
    the 14 left leaves a step (the encoder's wq wk wv wo and ffn.up, the
    decoder's self and cross wq wk wv wo and ffn.up), B2 at the 2 ffn.down
    leaves. Then, dec_pos and frames drawn, 200 prompt tokens prefilled and 8
    decoded against the full forward: f32 within 1e-4·max, bf16 within
    SERVE_GATE_BF16 at every token — where a token misses, the bf16 model's
    own gap to its f32 self is measured and printed, and every token is held
    within it. Then the Server's contiguous loop on zero frames, prompts of
    1, 4, 64 and 200 tokens, 8 new tokens each, f32 and bf16: in f32 the
    greedy tokens equal the full forward's and every token within 1e-4·max;
    bf16 held as the cached check; prefill tokens/s and decode ms a step."""
    cfg = get_config(WHISPER_ARCH)
    n_params = sum(p.numel() for p in tree_leaves(shape_params(cfg)))
    t = time.perf_counter()
    ph = phases["whisper"] = train_phase(fused=True, cfg=cfg, data=FrameData(cfg))
    times = ph["times"]
    log(f"[whisper] {cfg.name}: {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters, {cfg.dtype}, remat {cfg.remat}, batch 8 × 256 "
        f"tokens + 8 × {cfg.enc_seq} × {cfg.d_model} frames: losses "
        f"{[round(x, 4) for x in ph['losses']]} launches {ph['launches']}; step 0 "
        f"{times[0] * 1e3:.1f} ms, non-refresh median {statistics.median(times[1:]) * 1e3:.1f} "
        f"ms ({[round(x * 1e3, 1) for x in times]}); peak memory {ph['peak'] / 2**30:.2f} GiB; "
        f"state bytes {ph['state_bytes']} (analytic {ph['analytic_bytes']}); {card_line()} "
        f"({time.perf_counter() - t:.1f} s)")
    if ph["launches"] != dict(none, left=112, right=16):
        raise AssertionError(f"[whisper] launches {ph['launches']}, want left 112 (14 leaves × 8 "
                             f"steps), right 16 (ffn.down × 2 × 8)")
    check_state_bytes("whisper", ph)

    n_prompt, n = 200, 208
    tokens = torch.from_numpy(np.random.default_rng(28).integers(0, cfg.vocab_size, (2, n))).to(
        "cuda")
    for dtype in ("float32", "bfloat16"):
        t = time.perf_counter()
        c = dataclasses.replace(cfg, dtype=dtype)
        params, frames = drawn_audio(c, seed=28)
        gaps = cached_vs_forward(c, params, frames, tokens, n_prompt)
        limit = 1e-4 if dtype == "float32" else SERVE_GATE_BF16
        msg = (f"[whisper] cached {dtype}, dec_pos and frames drawn: prefill {n_prompt} + decode "
               f"{n - n_prompt}, 2 lanes; logits vs the full forward max|Δ|/max a token: median "
               f"{statistics.median(gaps):.2e}, max {max(gaps):.2e} (limit {limit:g})")
        own = None
        if max(gaps) > limit and dtype == "bfloat16":
            own = audio_own_gaps(c, params, frames, tokens, n_prompt)
            msg += (f"; {sum(g > limit for g in gaps)} of {len(gaps)} tokens over it: the bf16 "
                    f"model's own gap to its f32 self median {statistics.median(own):.2e}, max "
                    f"{max(own):.2e}")
        log(f"{msg}; {card_line()} ({time.perf_counter() - t:.1f} s)")
        if max(gaps) > (limit if own is None else max(own)):
            raise AssertionError(f"[whisper] cached {dtype}: gap {max(gaps):.3e} over "
                                 f"{limit if own is None else max(own):.3e}")

        t = time.perf_counter()
        prompts = serve_prompts(np.random.default_rng(29), WHISPER_PROMPTS, cfg.vocab_size)
        new = 8
        out, sgaps, same, rec = served_vs_forward(c, params, prompts, new,
                                                  max(WHISPER_PROMPTS) + new)
        log(f"[whisper] Server {dtype}, zero frames: prompts {list(WHISPER_PROMPTS)} → {new} "
            f"tokens each; logits vs the full forward max|Δ|/max a token: median "
            f"{statistics.median(sgaps):.2e}, max {max(sgaps):.2e}; greedy picks equal to the "
            f"full forward's {same} of {len(sgaps)}; prefill {len(rec.prefill_ms)} calls, "
            f"{rec.prefill_tokens / sum(rec.prefill_ms) * 1e3:.0f} tokens/s "
            f"({[round(x, 2) for x in rec.prefill_ms]} ms); decode {len(rec.decode_ms)} steps of "
            f"one lane, median {statistics.median(rec.decode_ms):.3f} ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card_line()} "
            f"({time.perf_counter() - t:.1f} s)")
        if dtype == "float32" and (max(sgaps) > 1e-4 or same != len(sgaps)):
            raise AssertionError(f"[whisper] Server f32: logits gap {max(sgaps):.3e} > 1e-4 or "
                                 f"{len(sgaps) - same} greedy picks differ")
        if dtype == "bfloat16" and max(sgaps) > SERVE_GATE_BF16:
            sown = bf16_own_gaps(c, params, prompts, out)
            log(f"[whisper] Server bf16: {sum(g > SERVE_GATE_BF16 for g in sgaps)} of "
                f"{len(sgaps)} tokens over {SERVE_GATE_BF16:g}; the bf16 model's own gap to its "
                f"f32 self median {statistics.median(sown):.2e}, max {max(sown):.2e}")
            if max(sgaps) > max(sown):
                raise AssertionError(f"[whisper] Server bf16: gap {max(sgaps):.3e} over the "
                                     f"model's own {max(sown):.3e}")
        del params, frames, rec
        torch.cuda.empty_cache()


def family_phases(phases, none):
    """The families' phases in turn, each timed."""
    for tag, fn in (("moe-kernels", check_expert_apply),
                    ("moe", lambda: moe_phase(phases, none)),
                    ("moe-dispatch", moe_dispatch_phase),
                    ("mrope", lambda: mrope_phase(phases, none)),
                    ("serve-chunk", serve_chunk_phase),
                    ("families", families_phase),
                    ("ssm", lambda: ssm_phase(phases, none)),
                    ("hybrid", lambda: hybrid_phase(phases, none)),
                    ("whisper", lambda: whisper_phase(phases, none))):
        t = time.perf_counter()
        fn()
        log(f"[{tag}] ({time.perf_counter() - t:.1f} s)")

# ---------------------------------------------------------------------------
# [dryrun]: each training phase's peak predicted on the meta device
# ---------------------------------------------------------------------------

# the phases whose peak the dry run must predict within DRYRUN_GATE
DRYRUN_PHASES = ("fused", "fused-apply", "8bit-apply", "r1024-fused", "adam8bit", "adamw", "moe",
                 "whisper")
DRYRUN_GATE = 0.05


def dryrun_phase(phases):
    """[dryrun]: for each of DRYRUN_PHASES, the phase's own config and batch
    through launch/dryrun.py::dry_run_step on meta tensors (on the host,
    nothing on the card): its step and its refresh (step 0), whichever
    peaks higher, on top of what the card held before the phase (less the
    params the phase was handed, which the dry run makes itself), held
    within DRYRUN_GATE of the phase's max_memory_allocated. Then, with no
    gate, the dry run of three configurations never run on the card:
    llama_7b at all 32 layers (fp32 fused r = 128, batch 8 × 256), Scout at
    4 layers in the emit form (the [moe] phase without the apply), and
    grok-1 at 2 layers with its GaLore optimizer step (apply form, batch
    2 × 256 as [families]), each beside the card's memory."""
    card, total = card_line(), card_bytes()
    misses = []
    for tag in DRYRUN_PHASES:
        ph = phases[tag]
        t = time.perf_counter()
        rec = dry_run_step(ph["cfg"], ph["tc"], ph["rows"], ph["seq_len"], "train")
        want = ph["base"] - ph["params_in"] + rec["peak_bytes"]
        ratio = want / ph["peak"]
        parts = (f"step {rec.get('step_peak_bytes', rec['peak_bytes']) / 2**30:.3f}, refresh "
                 f"{rec['refresh']['peak_bytes'] / 2**30:.3f} GiB" if "refresh" in rec
                 else f"step {rec['peak_bytes'] / 2**30:.3f} GiB")
        log(f"[dryrun] {card}: {tag}: predicted {want / 2**30:.3f} GiB ({want} B: on the card "
            f"before the phase {(ph['base'] - ph['params_in']) / 2**30:.3f} GiB + the dry run's "
            f"peak {rec['peak_bytes'] / 2**30:.3f} GiB at {rec['peak_op']}; {parts}), measured "
            f"max_memory_allocated {ph['peak'] / 2**30:.3f} GiB ({ph['peak']} B): ratio "
            f"{ratio:.4f} (gate 1 ± {DRYRUN_GATE}); {rec['flops']:.4e} FLOPs a step "
            f"({time.perf_counter() - t:.1f} s)")
        if abs(ratio - 1) > DRYRUN_GATE:
            misses.append(f"{tag} {ratio:.4f}")
    randomized = dict(projector="randomized")
    unrun = (
        ("llama_7b, 32 layers, fp32 fused r = 128, 8 × 256", get_config("llama_7b"),
         dict(fused=True), 8),
        ("Scout, 4 layers, emit form, randomized P, 8 × 256",
         dataclasses.replace(get_config(MOE_ARCH), n_layers=4), dict(fused=True, gkw=randomized),
         8),
        ("grok-1, 2 layers, fused apply r = 128, randomized P, 2 × 256",
         dataclasses.replace(get_config("grok_1_314b"), n_layers=2),
         dict(fused=True, apply=True, gkw=randomized), 2))
    for what, cfg, kw, rows in unrun:
        t = time.perf_counter()
        rec = dry_run_step(cfg, phase_train_config(**kw), rows, 256, "train")
        gib = {k: rec[k] / 2**30 for k in ("peak_bytes", "step_peak_bytes", "argument_bytes")}
        log(f"[dryrun] {card}: never run, {what}: predicted peak {gib['peak_bytes']:.3f} GiB "
            f"(step {gib['step_peak_bytes']:.3f}, refresh "
            f"{rec['refresh']['peak_bytes'] / 2**30:.3f}; resident {gib['argument_bytes']:.3f} "
            f"GiB) against the card's {total / 2**30:.2f} GiB: "
            f"{'fits' if rec['peak_bytes'] < total else 'does not fit'}; {rec['flops']:.4e} FLOPs "
            f"a step ({time.perf_counter() - t:.1f} s)")
    if misses:
        raise AssertionError(f"[dryrun] predicted peaks off by more than {DRYRUN_GATE:.0%}: "
                             f"{', '.join(misses)}")


def check_stochastic_blocks():
    """ROADMAP C.27 on the card: the int8 kernel with stochastic rounding
    (emit form, int4 P, bf16 G) at the main gate/up and down leaves,
    launched on each of two rank blocks of P and the moments (GaLore-ZeRO
    at n_dp 2) with the block's origin, writes exactly the slice of the
    full-leaf launch's codes and scales; the same launches without the
    origin draw other coins (their differing codes counted and printed)."""
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    card = card_line()
    for i, (side, L, m, r, n) in enumerate(sorted(STOCHASTIC8)):
        k = KERNELS["adam8_" + side]
        P, mom, G32 = adam8_inputs(side, L, m, r, n, seed=200 + i)
        P4, G = codec.quant4_axis_state(P), G32.to(torch.bfloat16)
        full = [x.clone() for x in mom]
        k["wrapper"](P4, G, *full, count, alpha=ALPHA, stochastic=True)
        rb, dim = r // 2, -1 if side == "right" else -2
        local_differ = 0
        for b in range(2):
            cut = lambda x, d=dim: x.narrow(d, b * rb, rb).contiguous()  # noqa: E731
            Pb = {key: cut(v, -1) for key, v in P4.items()}
            blk = [cut(x) for x in mom]
            k["wrapper"](Pb, G, *blk, count, alpha=ALPHA, stochastic=True, origin=(b * rb, r))
            local = [cut(x) for x in mom]
            k["wrapper"](Pb, G, *local, count, alpha=ALPHA, stochastic=True)
            torch.cuda.synchronize()
            for name, a, want in zip(("mq", "ms", "vq", "vs"), blk, full):
                if not torch.equal(a, cut(want)):
                    raise AssertionError(f"[kernels] {k['name']} L={L} (m,r,n)=({m},{r},{n}) "
                                         f"rank block {b} of 2 with its origin: {name} differs "
                                         f"from the full-leaf launch's slice")
            local_differ += sum(int((a != cut(w)).sum()) for a, w in zip(local[::2], full[::2]))
        log(f"[kernels] {card}: {k['name']} L={L} (m,r,n)=({m},{r},{n}) G bfloat16 P int4 "
            f"stochastic, two rank blocks of {rb} with their origin: codes and scales equal to "
            f"the full-leaf launch's slices ok; without the origin {local_differ} of "
            f"{2 * L * r * (n if side == 'left' else m)} codes differ (ROADMAP C.27)")
        if local_differ == 0:
            raise AssertionError("[kernels] the block-local launches drew the full leaf's coins: "
                                 "the origin check sees nothing")
        del P, P4, mom, G32, G, full
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [remat] and [remat-7b]: the reference's activation-checkpointing policies
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "scores", "names", "full")
# "names" in PR 30, before its backward replayed only what it reads (ROADMAP
# C.31; H100 80GB HBM3, 700 W): max_memory_allocated, forward and backward,
# kept bytes, the dry run's FLOPs
REMAT_NAMES_PR30 = dict(peak_gib=27.839, ms=291.0, kept_gib=2.252, flops=3.5889e13)
# B3-apply int8's leaves of the whole llama_7b (32 layers, r = 128): gate/up
# (6 launches a step with the attention leaves), the attention leaves, down
REMAT_7B_LEAVES = (("gate/up", ("left", 32, 4096, 128, 11008)),
                   ("attention", ("left", 32, 4096, 128, 4096)),
                   ("down", ("right", 32, 11008, 128, 4096)))


def remat_phase():
    """[remat]: llama_7b width, 2 of 32 layers, bf16, batch 2 × 4096: one
    loss_fn forward and backward under each policy. The loss and every
    gradient leaf held within 1e-5·max of "none"'s (the largest difference
    printed: bit for bit expected, the dense path has no atomics); each
    policy's max_memory_allocated over the forward and backward (after a
    reset) within DRYRUN_GATE of the dry run's (dry_run_grad: what the card
    held before, less the params and batch the dry run makes itself, plus
    its peak); the forward and backward timed with CUDA events (the median
    of three, after the checked run). "names"' dry-run FLOPs must be below
    "full"'s (its backward replays only what it reads, ROADMAP C.31); its
    time, peak and kept bytes are logged beside PR 30's."""
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    B, S = 2, 4096
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1),
             "loss_mask": torch.ones(B, S, device="cuda")}
    leaves = tree_leaves(params)
    card, runs, misses, stats = card_line(), {}, [], {}
    for policy in REMAT_POLICIES:
        c = dataclasses.replace(cfg, remat=policy)
        rec = dry_run_grad(c, B, S)

        def fwd_bwd():
            total, _ = loss_fn(c, params, batch)
            return [total.detach()] + list(torch.autograd.grad(total, leaves))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs[policy] = fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        want = base - rec["argument_bytes"] + rec["peak_bytes"]
        ms = cuda_ms(fwd_bwd, 0, 3)
        gaps = [float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30)
                for a, b in zip(runs[policy], runs["none"])]
        log(f"[remat] {card}: {cfg.name}, 2 of 32 layers, bf16, {B} × {S}, remat {policy}: "
            f"loss {float(runs[policy][0]):.6f}; largest difference from none's (loss and "
            f"{len(leaves)} gradient leaves, of max) {max(gaps):.3e} (gate 1e-5); "
            f"max_memory_allocated {peak / 2**30:.3f} GiB, predicted {want / 2**30:.3f} GiB "
            f"(before {base / 2**30:.3f} + dry run {(rec['peak_bytes'] - rec['argument_bytes']) / 2**30:.3f}; "
            f"kept for the backward {rec['kept_bytes'] / 2**30:.3f} GiB): ratio {want / peak:.4f} "
            f"(gate 1 ± {DRYRUN_GATE}); forward and backward {ms:.1f} ms, {rec['flops']:.4e} "
            f"FLOPs ({rec['flops'] / ms / 1e9:.1f} TFLOP/s)")
        if max(gaps) > 1e-5:
            raise AssertionError(f"[remat] {policy}: the loss or a gradient differs from none's "
                                 f"by {max(gaps):.3e} of its max")
        if abs(want / peak - 1) > DRYRUN_GATE:
            misses.append(f"{policy} {want / peak:.4f}")
        if policy != "none":
            del runs[policy]
        stats[policy] = dict(peak=peak, ms=ms, kept=rec["kept_bytes"], flops=rec["flops"])
    names, full, was = stats["names"], stats["full"], REMAT_NAMES_PR30
    log(f"[remat] {card}: names {names['flops']:.4e} FLOPs vs full {full['flops']:.4e} (PR 30: "
        f"{was['flops']:.4e}, full's); names {names['ms']:.1f} ms (PR 30: {was['ms']}), peak "
        f"{names['peak'] / 2**30:.3f} GiB (PR 30: {was['peak_gib']}), kept "
        f"{names['kept'] / 2**30:.3f} GiB (PR 30: {was['kept_gib']})")
    if not names["flops"] < full["flops"]:
        raise AssertionError(f"[remat] names' FLOPs {names['flops']:.4e} are not below full's "
                             f"{full['flops']:.4e}: its backward replays what it does not read")
    if misses:
        raise AssertionError(f"[remat] predicted peaks off by more than {DRYRUN_GATE:.0%}: "
                             f"{', '.join(misses)}")
    del runs, params, batch, leaves
    torch.cuda.empty_cache()


def remat_7b_phase(phases, none, policy):
    """[remat-7b]: the whole llama_7b (32 layers, no depth cut) at batch 1 ×
    4096 under remat `policy`, 8-bit GaLore in the apply form (int8 moments,
    int4 P, r = 128, randomized P, T = 8: step 0 refreshes), 3 steps through
    train_loop: losses finite; B3-apply int8 launched 6 left + 1 right a step;
    the peak within DRYRUN_GATE of the dry run of the same config and batch
    (dry_run_step, on top of what the card held before); the non-refresh
    step time beside the dry run's FLOPs a step."""
    cfg = dataclasses.replace(get_config("llama_7b"), remat=policy)
    t = time.perf_counter()
    ph = phases[f"remat-7b-{policy}"] = train_phase(
        fused=True, quant=QuantPolicy(moments="int8", projectors="int4"), apply=True,
        galore_kw=dict(projector="randomized"), cfg=cfg, steps=3, rows=1, seq_len=4096)
    t_run, t = time.perf_counter() - t, time.perf_counter()
    rec = dry_run_step(ph["cfg"], ph["tc"], ph["rows"], ph["seq_len"], "train")
    want = ph["base"] - ph["params_in"] + rec["peak_bytes"]
    steady = statistics.median(ph["times"][1:])
    log(f"[remat-7b] {card_line()}: {cfg.name}, all {cfg.n_layers} layers, bf16, 1 × 4096, "
        f"remat {policy}, 8-bit GaLore apply r = 128, randomized P: losses "
        f"{[round(x, 4) for x in ph['losses']]}; launches {ph['launches']}; step ms "
        f"{[round(x * 1e3, 1) for x in ph['times']]}; max_memory_allocated "
        f"{ph['peak'] / 2**30:.3f} GiB, predicted {want / 2**30:.3f} GiB (before "
        f"{(ph['base'] - ph['params_in']) / 2**30:.3f} + the dry run's "
        f"{rec['peak_bytes'] / 2**30:.3f} at {rec['peak_op']}: step "
        f"{rec['step_peak_bytes'] / 2**30:.3f}, refresh {rec['refresh']['peak_bytes'] / 2**30:.3f}"
        f"; the dry run took {time.perf_counter() - t:.1f} s): ratio {want / ph['peak']:.4f} "
        f"(gate 1 ± {DRYRUN_GATE}); non-refresh step {steady * 1e3:.1f} ms at the dry run's "
        f"{rec['flops']:.4e} FLOPs a step: {rec['flops'] / steady / 1e12:.1f} TFLOP/s "
        f"({t_run:.1f} s)")
    if ph["launches"] != dict(none, adam8_apply_left=18, adam8_apply_right=3):
        raise AssertionError(f"[remat-7b] launches {ph['launches']}, want B3-apply int8 left 18 "
                             f"(6 leaves × 3 steps) and right 3, nothing else")
    if ph["thread_copy_epilogue"] != 0:
        raise AssertionError(f"[remat-7b] {ph['thread_copy_epilogue']} launches copied their "
                             f"operands by the threads instead of by the TMA")
    if abs(want / ph["peak"] - 1) > DRYRUN_GATE:
        raise AssertionError(f"[remat-7b] {policy}: predicted peak {want} B, measured "
                             f"{ph['peak']} B: off by more than {DRYRUN_GATE:.0%}")
    check_state_bytes(f"remat-7b-{policy}", ph)
    return ph


def remat_7b_kernel(what, leaf):
    """B3-apply int8 (int4 P, bf16 G and W) at one of the whole llama_7b's
    leaves, L = 32 (`what`: gate/up, attention or down): W' against its
    plain version (compared four slabs at a time), the launch and the plain
    version timed, beside the launch's bytes bound at 3.35 TB/s and its full
    bound."""
    side, L, m, r, n = leaf
    k = KERNELS["adam8_apply_" + side]
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    hp = dict(alpha=ALPHA, eta=torch.tensor(ETA, device="cuda"), wd=WD)
    P, mom, G32 = adam8_inputs(side, L, m, r, n, seed=300)
    G = G32.to(torch.bfloat16)
    del G32
    P4 = codec.quant4_axis_state(P)
    W = (0.02 * torch.randn(L, m, n, generator=torch.Generator(device="cuda").manual_seed(301),
                            device="cuda")).to(torch.bfloat16)
    w0, mine = W.clone(), [x.clone() for x in mom]
    want = k["plain"](P4, G, w0.clone(), *mom, count, **hp)[0]
    plain_ms = cuda_ms(lambda: k["plain"](P4, G, w0.clone(), *mom, count, **hp), 0, 2)
    before = thread_copies()
    k["wrapper"](P4, G, W, *mine, count, **hp)
    torch.cuda.synchronize()
    tag = (f"{k['name']} {what} L={L} (m,r,n)=({m},{r},{n}) G bfloat16 W bfloat16 P int4 "
           f"{route(before)}")
    checks = [weight_check(W[i:i + 4], want[i:i + 4], w0[i:i + 4], f"{tag} slabs {i}-{i + 3}")
              for i in range(0, L, 4)]
    del want
    ms = cuda_ms(lambda: k["wrapper"](P4, G, W, *mine, count, **hp), 2, 5)
    b_s, b_by, _ = bound8(side, L, m, r, n, 2, True, 2)
    nbytes = bytes8(side, L, m, r, n, 2, True, 2)
    log(f"[remat-7b] {card_line()}: {tag}: max|err| W' {max(e for e, _ in checks):.2e} (one "
        f"bf16 ulp + 1e-5·max|W' - W| in every 4 slabs{checks[0][1]} in slabs 0-3); kernel "
        f"{ms:.3f} ms a launch, plain {plain_ms:.3f} ms; bytes bound "
        f"{nbytes / PEAK_BYTES * 1e3:.3f} ms "
        f"({nbytes} B at 3.35 TB/s), bound {b_s * 1e3:.3f} ms ({b_by}; {b_s / ms * 1e5:.0f} % "
        f"of it)")
    del P, P4, mom, G, W, w0, mine
    torch.cuda.empty_cache()
    return ms


def remat_7b_phases(phases, none):
    """[remat-7b] under "scores" and "full" ("full"'s losses beside
    "scores'"), then B3-apply int8 at its three L = 32 leaves."""
    scores = remat_7b_phase(phases, none, "scores")
    full = remat_7b_phase(phases, none, "full")
    gaps = [a - b for a, b in zip(full["losses"], scores["losses"])]
    log(f"[remat-7b] full - scores losses {gaps} (the same numerics: bit for bit expected "
        f"where the card's kernels are deterministic); full's non-refresh step "
        f"{statistics.median(full['times'][1:]) * 1e3:.1f} ms, scores' "
        f"{statistics.median(scores['times'][1:]) * 1e3:.1f} ms")
    if max(map(abs, gaps)) > 5e-2:
        raise AssertionError(f"[remat-7b] full vs scores losses differ by more than 5e-2: {gaps}")
    for what, leaf in REMAT_7B_LEAVES:
        remat_7b_kernel(what, leaf)


# ---------------------------------------------------------------------------
# [dp]: data-parallel training through torch.distributed.run on this card
# ---------------------------------------------------------------------------

# GaLore-ZeRO's rank blocks at n_dp 2 on [dp]'s leaves (llama_7b, 1 layer):
# the fp32 and int8-moment kernels at rank 128 / 2 = 64 (B1/B2, B3-int8),
# the tiled projections at rank 1024 / 2 = 512 (B4/B5)
BLOCK_SHAPES = [
    ("left", 1, 4096, 64, 4096, False),
    ("left", 1, 4096, 64, 11008, False),
    ("right", 1, 11008, 64, 4096, False),
]
BLOCK_PROJECT_SHAPES = [
    ("left", 1, 4096, 512, 4096, False, False),
    ("left", 1, 4096, 512, 11008, False, False),
    ("down", 1, 4096, 512, 11008, True, False),
]
# llama_7b width cut to 1 of its 32 layers (by depth only: at 2 layers the
# phase took 277–299 s and chip_smoke.py 1,140 s of its 1,200), global batch
# 8 × 256, 4 steps, the refresh at step 0 only (T 8), lr 1e-3, no weight decay
DP_ARGS = ["--arch", "llama_7b", "--full", "--layers", "1", "--batch", "8", "--seq", "256",
           "--steps", "4", "--galore-t", "8", "--log-every", "1"]
# (flags, launches each rank makes a step, ZeRO)
DP_CONFIGS = {
    "a": (["--galore-rank", "128", "--galore-fused", "--galore-refresh-shard"],
          dict(left=6, right=1), False),
    "b": (["--galore-rank", "128", "--galore-fused", "--quant-moments", "int8", "--quant-proj",
           "int4", "--galore-zero", "1", "--galore-refresh-shard"],
          dict(adam8_left=6, adam8_right=1), True),
    "c": (["--galore-rank", "128", "--galore-zero", "2", "--galore-dp-compress",
           "--galore-refresh-shard"], {}, True),
    "d": (["--galore-rank", "1024", "--galore-fused", "--galore-zero", "1",
           "--galore-refresh-shard"], dict(project=7, project_back=7), True),
}
# (a) and (b) take a fifth step and checkpoint at steps 2 and 4, for (e)
DP_RESUMED = ["--ckpt-every", "2", "--steps", "5"]


# a run's checkpoint arrays whose update (e) compares: a left and a right
# galore leaf and a passthrough leaf (a norm's bf16 scale of 1.0 does not
# move in a few steps at lr 1e-3: its ulp there is 7.8e-3)
DP_LEAVES = ["params.blocks.attn.wq", "params.blocks.ffn.down", "params.embed.embedding"]
# the most that two runs' updates from one state may differ, as a share of
# the update: a world that dropped one owner's rank block of it is ~0.7 off,
# one that skipped it 1.0
DP_UPDATE_GAP = 0.25


def mesh_phase(none, steps=3):
    """[mesh]: the main path's fp32 fused configuration (llama_7b at 2 of 32
    layers, 8 × 256, r = 128, T = 8: step 0 refreshes in the step) for
    `steps` steps through make_train_step, first without rules, then with
    the pod's rules on a 1 × 1 mesh over a world of one rank (NCCL) on the
    card, from the same params and batches: every loss and every param bit
    for bit the unsharded run's; B1 and B2 launched as often in both."""
    import torch.distributed as dist

    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    tc = phase_train_config(fused=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 256), generator=gen,
                                        device="cuda")} for _ in range(steps)]
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    runs = {}
    try:
        mesh = lmesh.make_sim_mesh(1, 1, device_type="cuda")
        for tag, rules in (("unsharded", None), ("mesh", lmesh.default_rules(mesh))):
            params = init_params(cfg, seed=0, device="cuda")
            step, opt = make_train_step(cfg, tc, rules)
            state = opt.init(params)
            if rules is not None:
                state = dstep.shard_opt_state(cfg, tc, state, params, rules)
                params = dstep.shard_params(cfg, params, rules)
            ops.reset_launch_counts()
            losses, times = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(m["loss"].clone())
            launches = {key: getattr(fn, attr) for key, (fn, attr) in COUNTERS.items()}
            whole = [p.full_tensor() if hasattr(p, "full_tensor") else p
                     for p in tree_leaves(params)]
            runs[tag] = dict(losses=losses, params=whole, launches=launches, times=times)
            del params, state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    a, b = runs["unsharded"], runs["mesh"]
    same_loss = all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
    same_params = all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    log(f"[mesh] {card_line()}: llama_7b, 2 of 32 layers, fp32 fused r = 128, 8 × 256, "
        f"{steps} steps through make_train_step: unsharded losses "
        f"{[float(x) for x in a['losses']]}, on a 1 × 1 mesh {[float(x) for x in b['losses']]}; "
        f"bit for bit: losses {same_loss}, params {same_params}; launches {a['launches']} / "
        f"{b['launches']}; step ms {[round(x * 1e3, 1) for x in a['times']]} / "
        f"{[round(x * 1e3, 1) for x in b['times']]}")
    if not (same_loss and same_params):
        raise AssertionError("[mesh] the 1 × 1 mesh step is not the unsharded step bit for bit")
    want = dict(none, left=6 * steps, right=steps)
    if a["launches"] != want or b["launches"] != want:
        raise AssertionError(f"[mesh] launches {a['launches']} / {b['launches']}, want B1 "
                             f"{6 * steps} and B2 {steps} in each run")


# what rank 0 of the 16 × 16 pod needs to fit the card: remat "full" and the
# reference's gradient accumulation over 2 microbatches (the dry run, on the
# host: 368.3 GiB as configured, 79.3 with remat "full" alone, 46.9 with both)
MESH_7B, MESH_7B_MB = dict(remat="full"), 2


def mesh_7b_phase():
    """[mesh-7b]: the whole llama_7b train_4k cell (256 × 4096, the
    reference's default_train_config: GaLore-AdamW r = 1024, Newton–Schulz,
    the external refresh) under the baseline rules as rank 0 of a fake
    16 × 16 world, on this rank's shards at full size, remat "full" and 2
    microbatches (MESH_7B, MESH_7B_MB). First the sharded
    dry run of the cell (meta tensors, on the host); then one train step on
    the card: max_memory_allocated within DRYRUN_GATE of the dry run's
    peak_bytes_per_device, and the collectives DTensor issues, by kind, as
    many as the dry run counted. The collectives are fake, so the values
    mean nothing and the time is compute only."""
    t = time.perf_counter()
    rec = run_mesh_cell("llama_7b", "train_4k", microbatch=MESH_7B_MB, overrides=MESH_7B)
    t_dry = time.perf_counter() - t
    if rec["status"] != "ok":
        raise AssertionError(f"[mesh-7b] the dry run failed: {rec.get('error')}")
    want = rec["memory"]["peak_bytes_per_device"]
    want_counts = rec["collective_schedule"]["count_by_kind"]
    cfg = dataclasses.replace(get_config("llama_7b"), **MESH_7B)
    t = time.perf_counter()
    with fake_world(256):
        rules = lmesh.rules_variant(lmesh.make_production_mesh(device_type="cuda"), "baseline")
        tc = default_train_config(cfg, microbatch=MESH_7B_MB)
        run = run_fake_rank(cfg, tc, "train_4k", rules)
    torch.cuda.empty_cache()
    got_counts = run["collectives"].stats().count_by_kind
    ratio = want / run["peak_bytes"]
    log(f"[mesh-7b] {card_line()}: llama_7b train_4k (256 × 4096, all 32 layers, remat full, "
        f"{MESH_7B_MB} microbatches, GaLore-AdamW r = {tc.galore.rank}) as rank 0 of a fake "
        f"16 × 16 "
        f"world, baseline rules: max_memory_allocated {run['peak_bytes'] / 2**30:.3f} GiB "
        f"({run['peak_bytes']} B), the sharded dry run's peak {want / 2**30:.3f} GiB ({want} B, "
        f"at {rec['peak_op']}; {t_dry:.1f} s): ratio {ratio:.4f} (gate 1 ± {DRYRUN_GATE}); "
        f"collectives by kind {got_counts}, the dry run's {want_counts}; one step "
        f"{run['seconds'] * 1e3:.1f} ms, compute only, collectives fake; the dry run's "
        f"{rec['raw_cost']['flops']:.4e} FLOPs, {rec['collective_schedule']['total_bytes']} "
        f"collective bytes a rank, roofline {rec['roofline']['dominant']} "
        f"({time.perf_counter() - t:.1f} s)")
    if abs(ratio - 1) > DRYRUN_GATE:
        raise AssertionError(f"[mesh-7b] predicted {want} B, measured {run['peak_bytes']} B: off "
                             f"by more than {DRYRUN_GATE:.0%}")
    if got_counts != want_counts:
        raise AssertionError(f"[mesh-7b] collectives {got_counts}, the dry run's {want_counts}")


def check_rank_blocks():
    """The kernels at the rank-block shapes the ZeRO phases give them, each
    against its plain version (the gates of check_kernels, check_adam8 and
    check_project): B1/B2 and B3-int8 at rank 64, B4/B5 at rank 512."""
    return (check_kernels(BLOCK_SHAPES) + check_adam8(BLOCK_SHAPES)
            + check_project(BLOCK_PROJECT_SHAPES))


def read_report(path, n):
    out = []
    for k in range(n):
        with open(f"{path}.rank{k}.json") as f:
            out.append(json.load(f))
    return out


def report_launches(rep_):
    """A rank's launches by COUNTERS key (ops.launch_counts' names)."""
    counts = rep_["launches"]
    return {key: counts[fn.__name__ + (".int4" if attr == "launches_int4" else "")]
            for key, (fn, attr) in COUNTERS.items()}


def report_losses(rep_):
    return [rep_["steps"][str(i)]["loss"] for i in range(len(rep_["steps"]))]


def start_world(argv, root, tag, nproc=2, backend="gloo"):
    """Start `python -m torch.distributed.run --nproc-per-node nproc -m
    repro_torch.launch.train argv …` on this card (every rank on cuda:0), in
    a process group of its own; finish_world waits for it and reads each
    rank's report, stop_world ends it and its ranks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    report = os.path.join(root, f"{tag}-report")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), "-m", "repro_torch.launch.train", *argv, "--ckpt-dir",
           os.path.join(root, tag), "--report", report]
    if backend is not None:
        cmd += ["--dist-backend", backend]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)
    return dict(proc=proc, tag=tag, report=report, nproc=nproc, t=time.perf_counter())


def stop_world(w):
    """Kill a world that is still running, its ranks with it, and reap it."""
    if w["proc"].poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(w["proc"].pid, signal.SIGKILL)
        w["proc"].wait()


def finish_world(w):
    out, err = w["proc"].communicate(timeout=600)
    if w["proc"].returncode != 0:
        raise AssertionError(f"[dp] {w['tag']}: torch.distributed.run exited "
                             f"{w['proc'].returncode}: {err[-3000:]}")
    return read_report(w["report"], w["nproc"]), time.perf_counter() - w["t"]


def dp_one(argv, root, tag):
    """The same configuration in this process, with no world (the launcher's
    main, as a user runs it): its report."""
    report = os.path.join(root, f"{tag}-report")
    launcher.main([*argv, "--device", "cuda", "--ckpt-dir", os.path.join(root, tag),
                   "--report", report])
    torch.cuda.empty_cache()
    return read_report(report, 1)[0]


def ckpt_leaves(root, tag, step, keys=DP_LEAVES):
    """Some arrays of a run's step-`step` checkpoint (read one by one), f64."""
    with np.load(os.path.join(root, tag, f"step_{step:08d}", "host_0.npz")) as z:
        return {k: z[k].astype(np.float64) for k in keys}


def update_gap(tag, start, got, want):
    """{leaf: ‖got − want‖ / ‖want − start‖} over DP_LEAVES: two runs'
    updates from one state against each other; raises past DP_UPDATE_GAP,
    or where `want` did not move from `start` or lies far from it (a start
    that is not these runs' own)."""
    gaps, moved = {}, {}
    for k in DP_LEAVES:
        step = float(np.linalg.norm(want[k] - start[k]))
        moved[k] = step / float(np.linalg.norm(start[k]))
        gaps[k] = float(np.linalg.norm(got[k] - want[k])) / step if step else math.inf
    if not all(0 < m < 0.5 for m in moved.values()):
        raise AssertionError(f"[dp] {tag}: moved {moved} of the start's norm")
    if max(gaps.values()) > DP_UPDATE_GAP:
        raise AssertionError(f"[dp] {tag}: updates {gaps} apart, as a share of the update "
                             f"(limit {DP_UPDATE_GAP})")
    return gaps


def ckpt_crcs(root, tag, step=2):
    """{array name: (CRC-32, bytes)} of a run's checkpoint, from its zip
    directory (no array read)."""
    import zipfile

    with zipfile.ZipFile(os.path.join(root, tag, f"step_{step:08d}", "host_0.npz")) as z:
        return {i.filename: (i.CRC, i.file_size) for i in z.infolist()}


def fmt_gaps(gaps):
    return ", ".join(f"{k.rsplit('.', 1)[-1]} {v:.2e}" for k, v in gaps.items())


def dp_check(tag, flags, want, zero, one, reps, t_world):
    """[dp] gates of one configuration's world of 2 against its one-process
    run (`want`: the launches a rank makes a step); logs the line."""
    want_l = report_losses(one)
    got = [report_losses(r) for r in reps]
    if got[0] != got[1]:
        raise AssertionError(f"[dp] {tag}: the ranks' losses differ: {got}")
    gap = max(abs(a - b) for a, b in zip(got[0], want_l))
    if not all(map(math.isfinite, got[0])) or gap > 5e-2:
        raise AssertionError(f"[dp] {tag}: world-of-2 losses {got[0]} vs one process "
                             f"{want_l}: max |Δ| {gap:.3e} (limit 5e-2)")
    none = {key: 0 for key in COUNTERS}
    for r in reps + [one]:
        if report_launches(r) != dict(none, **{k: v * len(r["steps"]) for k, v in want.items()}):
            raise AssertionError(f"[dp] {tag} rank {r['rank']} of {r['n_dp']}: launches "
                                 f"{report_launches(r)}, want {want}")
    later = statistics.median(r["steps"][str(i)]["step_s"] for r in reps for i in (1, 2, 3))
    later_one = statistics.median(one["steps"][str(i)]["step_s"] for i in (1, 2, 3))
    line = (f"[dp] {tag} {' '.join(flags)}: losses {got[0]} vs one process {want_l} (max "
            f"|Δ| {gap:.2e}); launches a rank a step {want or 'none'}; step 0 "
            f"{reps[0]['steps']['0']['step_s']:.2f} / {reps[1]['steps']['0']['step_s']:.2f} s "
            f"on ranks 0 / 1 vs {one['steps']['0']['step_s']:.2f} s in one process; median "
            f"later step {later * 1e3:.0f} ms vs {later_one * 1e3:.0f} ms; SVD units a rank "
            f"{[(r['refresh'] or {}).get('units') for r in reps]}; staged collectives a rank "
            f"{[r['staged'] for r in reps]}; peak {[round(r['peak_bytes'] / 2**30, 2) for r in reps]}"
            f" GiB a rank vs {one['peak_bytes'] / 2**30:.2f}; world {t_world:.1f} s")
    if zero:
        want_b = reps[0]["zero_bytes"]["opt_state_bytes_per_replica"]
        got_b = [r["state_bytes"]["total"] for r in reps]
        if any(x != want_b for x in got_b):
            raise AssertionError(f"[dp] {tag}: per-rank state bytes {got_b}, "
                                 f"galore_zero_state_bytes {want_b}")
        line += (f"; state bytes a rank {got_b} = galore_zero_state_bytes {want_b:.0f} vs one "
                 f"process {one['state_bytes']['total']}")
    log(line)


def dp_resumed_check(tag, one, rank0, root):
    """(e) of `tag`: its world's step-2 checkpoint resumed in one process
    (`one`'s report) against the world's own steps 3 and 4 (`rank0`'s);
    logs the line."""
    straight = report_losses(rank0)
    if sorted(one["steps"]) != ["3", "4"]:
        raise AssertionError(f"[dp] e-{tag}: the resumed run took steps {sorted(one['steps'])}")
    gap = abs(one["steps"]["4"]["loss"] - straight[4])
    if gap > 5e-2:
        raise AssertionError(f"[dp] e-{tag}: resumed step 4 {one['steps']['4']['loss']} vs "
                             f"the world's {straight[4]} (limit 5e-2)")
    upd = update_gap(f"e-{tag}", ckpt_leaves(root, tag + "-two", 2),
                     ckpt_leaves(root, "e-" + tag, 4), ckpt_leaves(root, tag + "-two", 4))
    log(f"[dp] e-{tag} ({tag})'s step-2 checkpoint of a world of 2 resumed in one process for "
        f"steps 3 and 4: step 4 loss {one['steps']['4']['loss']} vs the world's {straight[4]} "
        f"(|Δ| {gap:.2e}); the update from the step-2 to the step-4 checkpoint off the world's "
        f"by {fmt_gaps(upd)} of itself (limit {DP_UPDATE_GAP})")


def dp_phase():
    """[dp]: each DP_CONFIGS configuration as a world of 2 ranks sharing
    cuda:0 over gloo (NCCL refuses two ranks on one device) against one run
    of it in one process (the launcher's main here): (a) fp32 fused r = 128
    with the sharded refresh, (b) ZeRO-1 8-bit with int4 P (B3-int8 on rank
    blocks of 64), (c) ZeRO-2 with GaLore-DP, fp32, (d) ZeRO-1 fp32 at
    r = 1024 (B4/B5 on blocks of 512): losses within 5e-2, both ranks'
    losses equal, each rank's launches (every rank updates every leaf, or
    its block of it), ZeRO's per-rank state bytes equal to
    galore_zero_state_bytes at n_dp 2, the collectives staged through host
    memory, and the sharded step 0 beside the one-process step 0. (a) runs
    alone; (b) and (c) run side by side, then (d) beside (f), each pair
    beside the one-process runs, so their times are under contention. (e)
    (a)'s and (b)'s step-2 checkpoints resumed in one process for steps 3
    and 4 ((a) and (b) run 5 steps): step 4 within 5e-2 of the world's own,
    and the update from the step-2 to the step-4 checkpoint within
    DP_UPDATE_GAP of the world's from the same state (the runs from step 0
    take their own SVDs, whose rank-128 subspaces differ: 0.11–0.20 of the
    update apart), so a world's update is held to one process's and the
    re-sliced ZeRO state drives two updates. (f) (a) as an NCCL world of 1: losses bit for bit
    and every checkpoint array's CRC-32 the one-process run's. Nothing
    across cards is measured: every rank shares the one card."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    argv = {tag: DP_ARGS + flags + (DP_RESUMED if tag in "ab" else [])
            for tag, (flags, _, _) in DP_CONFIGS.items()}
    started = []

    def start(*a, **kw):
        started.append(start_world(*a, **kw))
        return started[-1]

    try:
        ones, worlds, resumed = {}, {}, {}
        # (a) alone: its step 0 is the one compared with one process
        ones["a"] = dp_one(argv["a"], root, "a-one")
        worlds["a"] = finish_world(start(argv["a"], root, "a-two"))
        # (b) and (c) side by side, then (d) beside (f), each pair beside the
        # one-process runs (and (e), which needs (a)'s and (b)'s worlds'
        # checkpoints)
        b, c = (start(argv[t], root, t + "-two") for t in "bc")
        for t in "bc":
            ones[t] = dp_one(argv[t], root, t + "-one")
        worlds["b"], worlds["c"] = finish_world(b), finish_world(c)
        d = start(argv["d"], root, "d-two")
        f = start(argv["a"], root, "f", nproc=1, backend=None)
        ones["d"] = dp_one(argv["d"], root, "d-one")
        for t in "ab":
            shutil.copytree(os.path.join(root, t + "-two"), os.path.join(root, "e-" + t),
                            ignore=shutil.ignore_patterns("step_00000004"))
            resumed[t] = dp_one(argv[t], root, "e-" + t)
        worlds["d"] = finish_world(d)
        for tag, (flags, want, zero) in DP_CONFIGS.items():
            dp_check(tag, argv[tag][len(DP_ARGS):], want, zero, ones[tag], *worlds[tag])
        for t, one in resumed.items():
            dp_resumed_check(t, one, worlds[t][0][0], root)

        (rep_f,), t_f = finish_world(f)
        if rep_f["backend"] != "nccl" or rep_f["n_dp"] != 1:
            raise AssertionError(f"[dp] f: backend {rep_f['backend']}, n_dp {rep_f['n_dp']}")
        if report_losses(rep_f) != report_losses(ones["a"]):
            raise AssertionError(f"[dp] f: NCCL world of 1 losses {report_losses(rep_f)} vs "
                                 f"one process {report_losses(ones['a'])}")
        crcs = ckpt_crcs(root, "f")
        if crcs != ckpt_crcs(root, "a-one"):
            raise AssertionError("[dp] f: the NCCL world of 1's step-2 checkpoint differs from "
                                 "the one-process run's")
        log(f"[dp] f NCCL world of 1: losses bit for bit and the step-2 checkpoint's {len(crcs)} "
            f"arrays of equal CRC-32 and size to the one-process run's ({t_f:.1f} s)")
    finally:
        for w in started:
            stop_world(w)
        shutil.rmtree(root, ignore_errors=True)
    log(f"[dp] phase {time.perf_counter() - t_phase:.1f} s")


def main():
    t_all = time.perf_counter()
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s) ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    libs = build.build(["galore_epilogue", "galore_project", "rmsnorm"])
    log(f"[build] nvcc sm_90a: {', '.join(p.name for p in libs.values())} "
        f"({time.perf_counter() - t:.1f} s)")
    for path in libs.values():
        report = path.with_name(path.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {path.name.split('-')[0]}: {line.strip()}")
    # the tiled projections and galore_epilogue's GaLore kernel run on the
    # tensor cores: count their wgmma (HGMMA) instructions in each library's
    # SASS
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    for name, what in (("galore_project", "B4/B5"),
                       ("galore_epilogue", "the GaLore kernel (every step form)")):
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        hgmma = sum(" HGMMA." in line for line in sass.splitlines())
        log(f"[build] {name}: {hgmma} HGMMA instructions in its SASS "
            f"({sum(' FFMA ' in line for line in sass.splitlines())} FFMA)")
        if hgmma == 0:
            raise AssertionError(f"{name}'s SASS has no HGMMA: {what} do not use the tensor "
                                 f"cores")

    t = time.perf_counter()
    check_bound8()
    rows = check_kernels()
    rows += check_adam8()
    int4_rows(rows)
    check_stochastic_blocks()
    rows += check_apply()
    rows += check_adam8bit()
    rows += check_project()
    rows += check_rmsnorm()
    log(f"[kernels] {len(rows)} checks passed ({time.perf_counter() - t:.1f} s)")

    none = {name: 0 for name in COUNTERS}
    # the fused phase checkpoints at step 4 into a directory of its own, which
    # the [ckpt] resume below reads; its final state goes through the manager
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # and its final state is written for [serve-ckpt] to serve from
    serve_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    ckpt_rows, served = [], []

    def fused_state(p, s):
        ckpt_rows.append(check_roundtrip("fused", p, s, int4=True))
        served.append(save_for_serving(serve_dir, p, s))

    t = time.perf_counter()
    fused = train_phase(fused=True, ckpt_dir=ckpt_dir, ckpt_every=4, on_state=fused_state)
    log(f"[fused] losses {[round(x, 4) for x in fused['losses']]} launches {fused['launches']} "
        f"({time.perf_counter() - t:.1f} s)")
    if not fused["losses"][-1] < fused["losses"][0]:
        raise AssertionError(f"loss did not decrease: {fused['losses']}")
    if fused["launches"] != dict(none, left=48, right=8):
        raise AssertionError(f"main path launches {fused['launches']}, want left 48 (6 leaves × "
                             f"8 steps), right 8 (1 leaf × 8 steps), no adam8")
    if fused["thread_copy_epilogue"] != 0:
        raise AssertionError(f"main path: {fused['thread_copy_epilogue']} launches of "
                             f"galore_epilogue's kernel copied their operands by the threads "
                             f"instead of by the TMA")

    # [ckpt] resume: a second run on the fused phase's directory restores its
    # step-4 checkpoint and takes steps 5-7; step 5 sees the params and batch
    # of the straight run's step 5, so its loss is the same bit for bit
    t = time.perf_counter()
    try:
        resumed = train_phase(fused=True, ckpt_dir=ckpt_dir, ckpt_every=4)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if resumed["steps"] != [5, 6, 7]:
        raise AssertionError(f"[ckpt] the resumed run took steps {resumed['steps']}, want 5-7 "
                             f"after the step-4 checkpoint")
    if resumed["launches"] != dict(none, left=18, right=3):
        raise AssertionError(f"[ckpt] resumed launches {resumed['launches']}, want left 18, "
                             f"right 3 (3 steps)")
    resume_gaps = [a - b for a, b in zip(resumed["losses"], fused["losses"][5:])]
    log(f"[ckpt] resume from step 4: steps 5-7 losses {resumed['losses']} vs straight "
        f"{fused['losses'][5:]}; Δ {resume_gaps} ({time.perf_counter() - t:.1f} s)")
    if resume_gaps[0] != 0.0:
        raise AssertionError(f"[ckpt] the resumed step-5 loss {resumed['losses'][0]!r} is not "
                             f"the straight run's {fused['losses'][5]!r} bit for bit")
    if max(map(abs, resume_gaps)) > 5e-2:
        raise AssertionError(f"[ckpt] resumed steps 6-7 differ by more than 5e-2: {resume_gaps}")

    t = time.perf_counter()
    comp = train_phase(fused=False)
    log(f"[composable] losses {[round(x, 4) for x in comp['losses']]} launches "
        f"{comp['launches']} ({time.perf_counter() - t:.1f} s)")
    if comp["launches"] != none:
        raise AssertionError(f"the composable path launched kernels: {comp['launches']}")
    gap = max(abs(a - b) for a, b in zip(fused["losses"], comp["losses"]))
    if gap > 5e-2:
        raise AssertionError(f"fused vs composable losses differ by {gap:.3e} > 5e-2")
    log(f"[parity] fused vs composable max |Δloss| {gap:.3e} (limit 5e-2)")

    t = time.perf_counter()
    q8 = train_phase(fused=True, quant=QuantPolicy(moments="int8", projectors="int4"),
                     on_state=lambda p, s: ckpt_rows.append(check_roundtrip("8bit", p, s)))
    log(f"[8bit] losses {[round(x, 4) for x in q8['losses']]} launches {q8['launches']} "
        f"({time.perf_counter() - t:.1f} s)")
    if not q8["losses"][-1] < q8["losses"][0]:
        raise AssertionError(f"8-bit loss did not decrease: {q8['losses']}")
    if q8["launches"] != dict(none, adam8_left=48, adam8_right=8):
        raise AssertionError(f"8-bit path launches {q8['launches']}, want adam8 left 48, "
                             f"right 8, no fp32 kernel")
    if q8["thread_copy_epilogue"] != 0:
        raise AssertionError(f"8-bit path: {q8['thread_copy_epilogue']} int8-kernel launches "
                             f"copied their operands by the threads instead of by the TMA")
    gap8 = max(abs(a - b) for a, b in zip(fused["losses"], q8["losses"]))
    if gap8 > 5e-2:
        raise AssertionError(f"8-bit vs fp32 fused losses differ by {gap8:.3e} > 5e-2")
    log(f"[parity] 8-bit vs fp32 fused max |Δloss| {gap8:.3e} (limit 5e-2)")
    for tag, ph in (("fp32", fused), ("8bit", q8)):
        check_state_bytes(tag, ph)
    log(f"[state] 8-bit / fp32 state bytes {q8['state_bytes'] / fused['state_bytes']:.4f} "
        f"({1 - q8['state_bytes'] / fused['state_bytes']:.1%} smaller)")

    phases = {"fused": fused, "composable": comp, "8bit": q8}
    int4p = QuantPolicy(projectors="int4")
    for tag, quant, emit_tag, want in (
            ("fused-apply", None, "fused", dict(none, apply_left=48, apply_right=8)),
            ("8bit-apply", QuantPolicy(moments="int8", projectors="int4"), "8bit",
             dict(none, adam8_apply_left=48, adam8_apply_right=8)),
            ("int4p", int4p, "fused", dict(none, p4_left=48, p4_right=8)),
            ("int4p-apply", int4p, "int4p", dict(none, p4_apply_left=48, p4_apply_right=8))):
        t = time.perf_counter()
        ph = phases[tag] = train_phase(fused=True, quant=quant, apply=tag.endswith("apply"))
        log(f"[{tag}] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']} "
            f"({time.perf_counter() - t:.1f} s)")
        if not ph["losses"][-1] < ph["losses"][0]:
            raise AssertionError(f"{tag} loss did not decrease: {ph['losses']}")
        if ph["launches"] != want:
            raise AssertionError(f"{tag} launches {ph['launches']}, want only "
                                 f"{[k for k, v in want.items() if v]}, left 48 (6 leaves × 8 "
                                 f"steps) and right 8")
        # every leaf's operands have 16-byte rows: galore_epilogue's kernel
        # copies them by the TMA
        if ph["thread_copy_epilogue"] != 0:
            raise AssertionError(f"{tag}: {ph['thread_copy_epilogue']} launches of "
                                 f"galore_epilogue's kernel copied their operands by the threads "
                                 f"instead of by the TMA")
        gap = max(abs(a - b) for a, b in zip(ph["losses"], phases[emit_tag]["losses"]))
        if gap > 5e-2:
            raise AssertionError(f"{tag} vs {emit_tag} losses differ by {gap:.3e} > 5e-2")
        log(f"[parity] {tag} vs {emit_tag} max |Δloss| {gap:.3e} (limit 5e-2)")
        check_state_bytes(tag, ph)

    # [guard] the fused phase guarded, checkpointing at step 4, with NaN
    # gradients at steps 5-7: three skips (each a bitwise no-op, checked by
    # checked_guarded_steps), a rollback to step 4, and steps 5-7 replayed
    # clean (a traced fault fires once)
    t = time.perf_counter()
    skips = []
    launcher.make_train_step = checked_guarded_steps(skips)
    try:
        guarded = train_phase(fused=True, guard=True, ckpt_every=4, faults=["nan_grad@5*3"])
    finally:
        launcher.make_train_step = make_train_step
    log(f"[guard] steps {guarded['steps']} losses {[round(x, 4) for x in guarded['losses']]} "
        f"launches {guarded['launches']} ({time.perf_counter() - t:.1f} s)")
    if guarded["steps"] != [0, 1, 2, 3, 4, 5, 6, 5, 6, 7] or len(skips) != 3:
        raise AssertionError(f"[guard] steps {guarded['steps']} with {len(skips)} checked skips, "
                             f"want 0-6 with 5-7 skipped, a rollback, then 5-7 replayed")
    if guarded["launches"] != dict(none, left=48, right=8):
        raise AssertionError(f"[guard] launches {guarded['launches']}: a skipped step must "
                             f"launch nothing (8 accepted steps: left 48, right 8)")
    replay = guarded["losses"][7:]
    if replay[0] != guarded["losses"][5]:
        raise AssertionError(f"[guard] the replayed step-5 loss {replay[0]!r} is not the "
                             f"rejected attempt's {guarded['losses'][5]!r} (the same params "
                             f"from the step-4 checkpoint, the same batch)")
    if replay[0] != fused["losses"][5]:
        raise AssertionError(f"[guard] the replayed step-5 loss {replay[0]!r} is not the "
                             f"[ckpt] straight run's {fused['losses'][5]!r} bit for bit")
    guard_steady = statistics.median(guarded["times"][i] for i in (1, 2, 3, 7, 8, 9))
    fused_steady = statistics.median(fused["times"][i] for i in (1, 2, 3, 5, 6, 7))
    log(f"[guard] {len(skips)} skips, each a bitwise no-op on all {skips[0]} leaves of params "
        f"and state; replayed steps 5-7 losses {replay} (step 5 = the straight run's bit for "
        f"bit; 6-7 Δ {[a - b for a, b in zip(replay[1:], fused['losses'][6:])]}); median "
        f"non-refresh step {guard_steady * 1e3:.1f} ms guarded vs {fused_steady * 1e3:.1f} ms "
        f"unguarded ({(guard_steady / fused_steady - 1) * 100:+.1f} %)")
    cost = guard_cost()
    log(f"[guard] guarded step without fault hooks or refresh, in turns with the unguarded "
        f"one on one state: {cost['guarded']:.1f} ms vs {cost['unguarded']:.1f} ms "
        f"({cost['guarded'] - cost['unguarded']:+.1f} ms: the global norm and the host's read "
        f"of the verdict between the backward and the optimizer)")
    try:
        train_phase(fused=True, apply=True, guard=True)
    except ValueError as e:
        log(f"[guard] guarded --galore-fused-apply refused, as in the reference: {e}")
    else:
        raise AssertionError("[guard] a guarded fused-apply run did not raise ValueError")

    # the paper's 7B rank: every GaLore leaf fails the reference's fits_vmem
    # at r = 1024, so the fp32 fused step composes B4 → Adam → B5 (7 leaves ×
    # 8 steps) and launches no B1/B2; T = 8, so only step 0 refreshes
    for tag, fused_ in (("r1024-fused", True), ("r1024-composable", False)):
        t = time.perf_counter()
        ph = phases[tag] = train_phase(fused=fused_, rank=1024, update_freq=8)
        log(f"[{tag}] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']} "
            f"({time.perf_counter() - t:.1f} s)")
        if not ph["losses"][-1] < ph["losses"][0]:
            raise AssertionError(f"{tag} loss did not decrease: {ph['losses']}")
        want = dict(none, project=56, project_back=56) if fused_ else none
        if ph["launches"] != want:
            what = "B4 and B5 56 each (7 leaves × 8 steps), no B1/B2" if fused_ else "none"
            raise AssertionError(f"{tag} launches {ph['launches']}, want {what}")
        # every leaf's operands have 16-byte rows: B4/B5 copy them by the TMA
        if ph["thread_copy"] != 0:
            raise AssertionError(f"{tag}: {ph['thread_copy']} B4/B5 launches copied their "
                                 f"operands by the threads instead of by the TMA")
        check_state_bytes(tag, ph)
    gap = max(abs(a - b) for a, b in zip(phases["r1024-fused"]["losses"],
                                         phases["r1024-composable"]["losses"]))
    if gap > 5e-2:
        raise AssertionError(f"r1024 fused vs composable losses differ by {gap:.3e} > 5e-2")
    log(f"[parity] r1024-fused vs r1024-composable max |Δloss| {gap:.3e} (limit 5e-2)")

    # 8-bit GaLore at the paper's 7B rank: the int8-moment emit and apply
    # steps fail fits_vmem at every leaf too, and the reference runs its
    # plain step there, so no GaLore kernel is launched at all
    q8 = QuantPolicy(moments="int8", projectors="int4")
    for tag, apply, ref_tag in (("r1024-8bit", False, "r1024-fused"),
                                ("r1024-8bit-apply", True, "r1024-8bit")):
        t = time.perf_counter()
        ph = phases[tag] = train_phase(fused=True, quant=q8, apply=apply, rank=1024,
                                       update_freq=8)
        log(f"[{tag}] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']} "
            f"({time.perf_counter() - t:.1f} s)")
        if not ph["losses"][-1] < ph["losses"][0]:
            raise AssertionError(f"{tag} loss did not decrease: {ph['losses']}")
        if ph["launches"] != none:
            raise AssertionError(f"{tag} launches {ph['launches']}, want none: every leaf "
                                 f"fails fits_vmem and takes the plain step")
        gap = max(abs(a - b) for a, b in zip(ph["losses"], phases[ref_tag]["losses"]))
        if gap > 5e-2:
            raise AssertionError(f"{tag} vs {ref_tag} losses differ by {gap:.3e} > 5e-2")
        log(f"[parity] {tag} vs {ref_tag} max |Δloss| {gap:.3e} (limit 5e-2)")
        check_state_bytes(tag, ph)

    # the paper's baselines without GaLore: 8-bit Adam (the flat kernel) and
    # full-rank AdamW (no kernel), same lr, schedule, batch and data
    t = time.perf_counter()
    ph = phases["adam8bit"] = train_phase(optimizer="adam8bit", galore=False)
    log(f"[adam8bit] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']} "
        f"({time.perf_counter() - t:.1f} s)")
    want = dict(none, adam8bit=8 * ph["quantized_leaves"])
    if ph["quantized_leaves"] == 0 or ph["launches"] != want:
        raise AssertionError(f"adam8bit launches {ph['launches']}, want only adam8bit, once per "
                             f"quantized leaf ({ph['quantized_leaves']}) and step")
    check_state_bytes("adam8bit", ph)
    t = time.perf_counter()
    ph = phases["adamw"] = train_phase(optimizer="adamw", galore=False)
    log(f"[adamw] losses {[round(x, 4) for x in ph['losses']]} launches {ph['launches']} "
        f"({time.perf_counter() - t:.1f} s)")
    if ph["launches"] != none:
        raise AssertionError(f"full-rank AdamW launched kernels: {ph['launches']}")
    check_state_bytes("adamw", ph)
    d0 = abs(phases["adam8bit"]["losses"][0] - ph["losses"][0])
    if d0 > 1e-6:
        raise AssertionError(f"step-0 losses of adam8bit and adamw differ by {d0:.3e} (the same "
                             f"params and batch, before any update)")
    gaps = [a - b for a, b in zip(phases["adam8bit"]["losses"], ph["losses"])]
    log(f"[baselines] step-0 loss adam8bit - adamw {d0:.1e} (limit 1e-6); per-step loss "
        f"adam8bit - adamw {[f'{x:.4f}' for x in gaps]}; peak memory adam8bit "
        f"{phases['adam8bit']['peak'] / 2**30:.2f} GiB, adamw {ph['peak'] / 2**30:.2f} GiB; "
        f"state bytes adam8bit {phases['adam8bit']['state_bytes']}, adamw {ph['state_bytes']} "
        f"({phases['adam8bit']['state_bytes'] / ph['state_bytes']:.4f})")

    baseline_phases(phases, none)
    lifecycle_phases(phases, none)
    randomized_refresh_phases(phases, none)

    log("[memory] the paper's 7B comparison (Fig. 1) at 2 layers, peak device memory: 8-bit "
        f"GaLore r = 1024 {phases['r1024-8bit']['peak'] / 2**30:.2f} GiB (apply "
        f"{phases['r1024-8bit-apply']['peak'] / 2**30:.2f} GiB), 8-bit Adam "
        f"{phases['adam8bit']['peak'] / 2**30:.2f} GiB, Adafactor "
        f"{phases['adafactor']['peak'] / 2**30:.2f} GiB, AdamW "
        f"{phases['adamw']['peak'] / 2**30:.2f} GiB; optimizer state "
        f"{phases['r1024-8bit']['state_bytes']} / {phases['adam8bit']['state_bytes']} / "
        f"{phases['adafactor']['state_bytes']} / {phases['adamw']['state_bytes']} B")

    # serving: the engine at llama_7b width in f32, the full llama_7b in bf16,
    # the fused phase's checkpoint served, and the CLI
    t = time.perf_counter()
    try:
        f32_gap = serve_f32_phase()
        log(f"[serve-f32] ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        serve_phase(f32_gap)
        log(f"[serve] ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        serve_ckpt_phase(serve_dir, served[0])
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    serve_cli_phase()
    log(f"[serve-ckpt] and the CLI ({time.perf_counter() - t:.1f} s)")

    family_phases(phases, none)

    t = time.perf_counter()
    dryrun_phase(phases)
    log(f"[dryrun] ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    block_rows = check_rank_blocks()
    log(f"[dp-kernels] {len(block_rows)} rank-block checks passed "
        f"({time.perf_counter() - t:.1f} s)")
    dp_phase()

    for tag, fn in (("remat", remat_phase), ("remat-7b", lambda: remat_7b_phases(phases, none)),
                    ("mesh", lambda: mesh_phase(none)), ("mesh-7b", mesh_7b_phase)):
        t = time.perf_counter()
        fn()
        log(f"[{tag}] ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    svd = svd_ms()
    shapes = ", ".join(f"{k} {v:.1f} ms" for k, v in svd.items())
    log(f"[svd] torch.linalg.svd f32, rank-128 and rank-1024 projectors: {shapes} "
        f"({time.perf_counter() - t:.1f} s)")
    for tag, ph in phases.items():
        times = ph["times"]
        if ph["galore"]:
            T = ph["update_freq"]
            refresh = ph.get("refresh_steps", range(0, len(times), T))
            rest = [times[i] for i in range(len(times)) if i not in refresh]
            steady = (f"median non-refresh {statistics.median(rest) * 1e3:.1f} ms" if rest
                      else "every step refreshes or swaps")
            first = (f"{steady}; refresh steps "
                     f"{'/'.join(map(str, refresh))} "
                     f"{'/'.join(f'{times[i] * 1e3:.1f}' for i in refresh)} ms")
        else:
            first = (f"median of steps 1-7 {statistics.median(times[1:]) * 1e3:.1f} ms; step 0 "
                     f"{times[0] * 1e3:.1f} ms")
        log(f"[steps] {tag}: step ms {[round(x * 1e3, 1) for x in times]}; {first}; peak memory "
            f"{ph['peak'] / 2**30:.2f} GiB")

    # each kernel's launches in the phase of the main path that runs it
    runs_in = {"left": "fused", "right": "fused", "adam8_left": "8bit", "adam8_right": "8bit",
               "apply_left": "fused-apply", "apply_right": "fused-apply",
               "adam8_apply_left": "8bit-apply", "adam8_apply_right": "8bit-apply",
               "p4_left": "int4p", "p4_right": "int4p", "p4_apply_left": "int4p-apply",
               "p4_apply_right": "int4p-apply", "adam8bit": "adam8bit",
               "project": "r1024-fused", "project_back": "r1024-fused"}
    # B6 lies on no path (the models call the plain apply_norm, as the
    # reference's do): it runs in its check only, and its launches are 0
    launches = {key: phases[tag]["launches"][key] for key, tag in runs_in.items()}
    launches["rmsnorm"] = 0
    kernels = []
    for key, k in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == key]
        # the row of record: the largest main-path shape with bf16 G (and bf16
        # W), as the main path runs it (int4 P, nearest rounding, for the int8
        # kernel; B5 has no G, B6 its bf16 x)
        top = max((r for r in mine if r["main_path"] and r["g_dtype"] in ("bfloat16", None)
                   and (r.get("w_dtype") or "bfloat16") == "bfloat16" and not r.get("stochastic")
                   and (not key.startswith("adam8_") or r["p"] == "int4")),
                  key=lambda r: r["m"] * r["n"])
        if key == "adam8bit":
            shape = dict(numel=top["numel"], g_dtype="bfloat16")
        elif key == "rmsnorm":
            shape = dict(x=top["shape"], x_dtype="bfloat16", scale_dtype="bfloat16")
        else:
            shape = dict(L=top["L"], m=top["m"], r=top["r"], n=top["n"], g_dtype=top["g_dtype"],
                         w_dtype=top.get("w_dtype"), p=top.get("p", "f32"))
        if key in runs_in and launches[key] == 0:
            raise AssertionError(f"{k['name']} was not launched in the {runs_in[key]} phase")
        kernels.append(dict(
            name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
            p=None if key in ("adam8bit", "rmsnorm") else top.get("p", "f32"),
            launches=launches[key], on_path=runs_in.get(key),
            max_abs_err=max(r["max_abs_err"] for r in mine if r["main_path"]),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"],
            library_ms=top.get("library_ms"), shape=shape))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
