"""Gloo worlds of CPU processes for the port's data-parallel tests, and the
runs each rank of such a world makes (torch and the port only: a spawned
process imports this module, never JAX).

    from torch_world import run_world
    results = run_world(train_run, 2, tmp_path, spec)   # one result a rank

``run_world`` starts n processes with ``torch.multiprocessing.spawn``; each
joins a gloo world (on the CPU, or sharing one card) through a ``FileStore``
under `tmp_path` (no TCP port, so
parallel test workers cannot collide), runs ``fn(*args)`` with torch at one
thread, and hands its result back through a file. Called with n = 0 it runs
``fn`` in this process with no world.

A run's spec is a dict of numpy arrays and plain values: "params" (a numpy
parameter tree), "tokens" (the global batch), "tc" and "galore" (the
TrainConfig and GaLoreConfig keyword arguments, "quant" a QuantPolicy's),
"steps", and optionally "jstate" (a chain state in numpy form, the JAX
package's, to start from), "arch", "ckpt_dir" / "ckpt_every" (train_loop
checkpoints).
"""
import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, n, store, out, fn, args, device):
    torch.set_num_threads(1)
    from repro_torch.distributed import world

    world.init_world(device, "gloo", rank=rank, world_size=n, store=dist.FileStore(store, n))
    try:
        torch.save(fn(*args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        world.close_world()


def run_world(fn, n: int, tmp_path, *args, device="cpu") -> list:
    """fn(*args) on every rank of a gloo world of n processes on `device`
    (n = 0: here, with no world); each rank's result, in rank order."""
    if n == 0:
        return [fn(*args)]
    out = tmp_path / f"world{n}_{fn.__name__}_{len(list(tmp_path.iterdir()))}"
    out.mkdir()
    mp.spawn(_entry, args=(n, str(out / "store"), str(out), fn, args, device), nprocs=n,
             join=True)
    return [torch.load(out / f"rank{k}.pt", weights_only=False) for k in range(n)]


# ---------------------------------------------------------------------------
# the runs a rank makes
# ---------------------------------------------------------------------------


def configs(spec):
    from repro_torch.configs.base import GaLoreConfig, TrainConfig
    from repro_torch.quant import QuantPolicy

    g = dict(spec["galore"])
    if "quant" in g:
        g["quant"] = QuantPolicy(**g["quant"])
    return TrainConfig(galore=GaLoreConfig(**g), **spec["tc"])


def chain_state_from_numpy(jstate, opt, params, tc, axes):
    """The port's chain state holding a JAX chain state's galore state (this
    rank's ZeRO blocks of it, under ZeRO) and schedule count."""
    from repro_torch.bridge import galore_blocks_from_numpy, galore_state_from_numpy
    from repro_torch.distributed import world
    from repro_torch.optim.factory import effective_galore_config, galore_state_index

    idx, gcfg = galore_state_index(tc), effective_galore_config(tc)
    state = list(opt.init(params))
    state[idx] = (galore_blocks_from_numpy(jstate[idx], params, gcfg, world.rank(), world.n_dp(),
                                           "cpu", axes) if gcfg.zero
                  else galore_state_from_numpy(jstate[idx], "cpu"))
    state[-1] = {"count": torch.tensor(int(np.asarray(jstate[-1]["count"])), dtype=torch.int32)}
    return tuple(state)


class FixedBatches:
    """The same global batch at every step (a train_loop data source)."""

    def __init__(self, tokens):
        self.tokens = torch.from_numpy(np.array(tokens)).long()

    def batch(self, step):
        return {"tokens": self.tokens}


def train_run(spec):
    """`steps` train steps (the refresh step of its own first, where the
    config refreshes externally) from spec["params"], or from spec["jstate"]
    when given. Returns the losses, this rank's galore-state tensor bytes,
    and on rank 0 the params and the full (gathered) galore state in numpy
    form after the first step (after every step with spec["keep_all"])."""
    from repro_torch.bridge import galore_state_to_numpy, params_from_numpy, params_to_numpy
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import world
    from repro_torch.distributed.state_sharding import ZeroLayout, galore_state_tensor_bytes
    from repro_torch.distributed.step import make_refresh_step, make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.factory import (
        effective_galore_config,
        external_refresh,
        galore_state_index,
    )

    cfg = get_config(spec.get("arch", "llama_60m"), smoke=True)
    tc = configs(spec)
    step_fn, opt = make_train_step(cfg, tc)
    refresh = make_refresh_step(cfg, tc) if external_refresh(tc) else None
    params = params_from_numpy(spec["params"], "cpu")
    idx, gcfg = galore_state_index(tc), effective_galore_config(tc)
    layout = ZeroLayout(params, gcfg, param_axes=M.param_axes(cfg)) if gcfg.zero else None
    if "jstate" in spec:
        state = chain_state_from_numpy(spec["jstate"], opt, params, tc, M.param_axes(cfg))
    else:
        state = opt.init(params)
    batch = {"tokens": torch.from_numpy(np.array(spec["tokens"])).long()}
    start = int(spec.get("start", 0))
    losses, kept = [], []
    for i in range(start, start + spec["steps"]):
        if refresh is not None:
            state = refresh(params, state, batch, i)
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
        if i == start or spec.get("keep_all"):
            g = layout.gather(state[idx]) if layout is not None else state[idx]
            rec = {"bytes": galore_state_tensor_bytes(state[idx])}
            if world.rank() == 0:
                rec.update(params=params_to_numpy(params), galore=galore_state_to_numpy(g))
            kept.append(rec)
    return {"losses": losses, "first": kept[0], "kept": kept}


def train_losses(spec):
    return train_run(spec)["losses"]


def train_cases(cases: dict) -> dict:
    """train_run (loop_run where the spec has "loop") of every spec of
    {name: spec}, in one world."""
    return {name: (loop_run if spec.get("loop") else train_run)(spec)
            for name, spec in cases.items()}


def loop_run(spec):
    """launch/train.py::train_loop over FixedBatches from spec["params"]:
    {"losses": {step: loss}, "log": the printed lines, "recalibrations":
    the async drivers' SVD-cost recalibrations}."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as T

    cfg = get_config(spec.get("arch", "llama_60m"), smoke=True)
    losses = {}
    buf = io.StringIO()
    made = []
    build = T.AsyncRefreshDriver.__init__

    def spy(self, *a, **kw):  # every async driver the loop builds
        build(self, *a, **kw)
        made.append(self)

    T.AsyncRefreshDriver.__init__ = spy
    try:
        with contextlib.redirect_stdout(buf):
            T.train_loop(T.RunConfig(steps=spec["steps"], batch_per_host=8, seq_len=32,
                                     log_every=1, ckpt_dir=spec["ckpt_dir"],
                                     ckpt_every=spec.get("ckpt_every", 0), device="cpu"),
                         configs(spec), cfg=cfg, params=params_from_numpy(spec["params"], "cpu"),
                         data=FixedBatches(spec["tokens"]),
                         on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])))
    finally:
        T.AsyncRefreshDriver.__init__ = build
    return {"losses": losses, "log": buf.getvalue().splitlines(),
            "recalibrations": sum(d.recalibrations for d in made)}


def refresh_parity(spec):
    """The sharded refresh against the unsharded one on the same reduced
    gradient, for each GaLoreConfig of spec["cases"] ({name: kwargs}), at
    each of spec["refresh_steps"] (None: force-all) in turn; the gradient
    made non-finite at call spec["poison_at"][name], where given. Per case
    and call: whether every projector and schedule scalar is bit for bit
    equal, and this rank's SVD units, every rank's load and the guard's
    verdict as shard_units reports them and as counted here."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.base import get_config
    from repro_torch.core.galore import refresh_projectors
    from repro_torch.core.subspace import SubspaceManager, sum_units
    from repro_torch.distributed import world
    from repro_torch.distributed.step import make_refresh_grads, shard_units
    from repro_torch.models import model as M
    from repro_torch.optim.factory import (
        build_optimizer,
        effective_galore_config,
        galore_state_index,
    )
    from repro_torch.utils import tree_leaves

    cfg = get_config(spec.get("arch", "llama_60m"), smoke=True)
    axes = M.param_axes(cfg)
    params = params_from_numpy(spec["params"], "cpu")
    batch = {"tokens": torch.from_numpy(np.array(spec["tokens"])).long()}
    out = {}
    for name, kw in spec["cases"].items():
        tc = configs(dict(spec, galore=kw))
        gcfg = effective_galore_config(tc)
        gstate = build_optimizer(tc, param_axes=axes).init(params)[galore_state_index(tc)]
        refresh_grads = make_refresh_grads(cfg, tc)
        mgr = SubspaceManager(gcfg, param_axes=axes)
        calls = out[name] = []
        for k, step in enumerate(spec["refresh_steps"]):
            grads = refresh_grads(params, batch)
            if spec.get("poison_at", {}).get(name) == k:
                tree_leaves(grads)[0].view(-1)[0] = float("nan")
            with torch.no_grad():
                want = refresh_projectors(grads, gstate, gcfg, step=step, param_axes=axes)
                pre, got_valid, last = shard_units(mgr, grads, gstate, step)
                got = refresh_projectors(grads, gstate, gcfg, step=step, param_axes=axes,
                                         precomputed=sum_units(pre), valid=got_valid)
                assignment, loads = mgr.partition_refresh(grads, step, world.n_dp())
            due = mgr.due_mask(mgr.plans(grads), gstate.get("schedule"),
                               gstate["step"] if step is None else step, step is None)
            valid = mgr._snapshot_valid(grads, due)
            mine = sum(int((a == world.rank()).sum()) * (d and valid)
                       for a, d in zip(tree_leaves(assignment), due))
            same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                       for a, b in zip(tree_leaves(got), tree_leaves(want)))
            calls.append({"equal": same, "units": last["units"], "units_counted": mine,
                          "loads": last["loads"], "loads_counted": loads.tolist(),
                          "valid": bool(got_valid), "valid_counted": bool(valid)})
            # the next call starts from the refreshed state, as a run would
            gstate = dict(want, step=want["step"] + 1)
    return out


def collectives_check(device):
    """Every collective of distributed/world.py on this rank's tensors on
    `device`: {"results": {name: (got on the host, the host computation)},
    "devices": the results' device types, "staged": the calls staged through
    host memory}."""
    from repro_torch.distributed import world

    k, n = world.rank(), world.n_dp()
    dev = torch.device(device)
    rows = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(n)]
    x = rows[k].to(dev)
    res = {
        "sum": (world.all_reduce_sum_many([x])[0], sum(rows)),
        "mean_bf16": (world.all_reduce_mean_many([x.to(torch.bfloat16)])[0],
                      (sum(rows) / n).to(torch.bfloat16)),
        "gather": (world.all_gather(x, 1), torch.cat(rows, dim=1)),
        "scatter": (world.reduce_scatter_mean(torch.cat([x, x], dim=0), 0),
                    (sum(rows) / n).reshape(2, 3) if n == 2 else None),
        "broadcast": (world.broadcast(x, 1), rows[1]),
    }
    devices = {v[0].device.type for v in res.values()}
    return {"results": {name: (got.cpu(), want) for name, (got, want) in res.items()},
            "devices": devices, "staged": world.STAGED["calls"]}


def mesh_run(spec):
    """The reference's multi-device setting on a (data, model) mesh over this
    world (spec["mesh"], e.g. (2, 2); None: no mesh): the external refresh
    every spec["every"] steps (every projector), then the train step,
    spec["steps"] times, from spec["params"]. With spec["galore0"] (a galore
    state in numpy form) and spec["count0"] (the schedule's count) the run
    starts from that state and skips the first refresh. Returns the losses,
    the whole params after the first step (gathered from the shards) and
    the placements of blocks.ffn.gate."""
    from repro_torch.bridge import galore_state_from_numpy, params_from_numpy, params_to_numpy
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.step import (
        make_refresh_step,
        make_train_step,
        shard_opt_state,
        shard_params,
    )
    from repro_torch.launch.mesh import default_rules, make_sim_mesh
    from repro_torch.optim.factory import galore_state_index
    from repro_torch.utils import is_dtensor, tree_map

    cfg = get_config(spec.get("arch", "llama_60m"), smoke=True)
    tc = configs(spec)
    rules = None
    if spec.get("mesh") is not None:
        rules = default_rules(make_sim_mesh(*spec["mesh"], device_type="cpu"))
    step_fn, opt = make_train_step(cfg, tc, rules)
    refresh = make_refresh_step(cfg, tc, rules)
    params = params_from_numpy(spec["params"], "cpu")
    state = opt.init(params)
    if "galore0" in spec:
        idx = galore_state_index(tc)
        count = {"count": torch.tensor(int(spec.get("count0", 0)), dtype=torch.int32)}
        state = (state[:idx] + (galore_state_from_numpy(spec["galore0"], "cpu"),)
                 + state[idx + 1:-1] + (count,))
    if rules is not None:
        state = shard_opt_state(cfg, tc, state, params, rules)
        params = shard_params(cfg, params, rules)
    batch = {"tokens": torch.from_numpy(np.array(spec["tokens"])).long()}
    losses, first = [], None
    for i in range(spec["steps"]):
        if i % spec["every"] == 0 and not (i == 0 and "galore0" in spec):
            state = refresh(params, state, batch)
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
        if i == 0:  # every rank takes part in the gathers
            whole = tree_map(lambda p: p.full_tensor() if is_dtensor(p) else p, params)
            first = params_to_numpy(whole)
    gate = params["blocks"]["ffn"]["gate"]
    return {"losses": losses, "first": first,
            "gate": [str(p) for p in gate.placements] if is_dtensor(gate) else None}


def mesh_cases(cases: dict) -> dict:
    """mesh_run of every spec of {name: spec}, in one world."""
    return {name: mesh_run(spec) for name, spec in cases.items()}
