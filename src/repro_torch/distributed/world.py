"""The data-parallel world: ranks, the batch split and the collectives of the
data-parallel train and refresh steps (the port's counterpart of the
reference's ``launch/mesh.py::data_parallel_axes`` / ``data_parallel_size``
and ``distributed/step.py::_dp_shard_index``). The pod's 2-D mesh, whose
rules place the parameters too, is launch/mesh.py's, on DTensor.

A world is a ``torch.distributed`` process group of n_dp ranks. Every rank
holds the whole model and reads the same global batch; ``shard_batch`` hands
it rows [rank·B/n, (rank+1)·B/n), the reference's split of the batch dim over
its ``data`` mesh axes. ``init_world`` joins the group that ``python -m
torch.distributed.run`` describes in the environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or one the caller names (rank, world
size and a store: the tests' ``FileStore``). The backend is NCCL on CUDA and
gloo on the CPU; ``backend="gloo"`` on CUDA lets two ranks share one card,
which NCCL refuses.

With no world every helper is what a world of 1 computes: rank 0, n_dp 1,
the whole batch, each collective its input, and no process group is touched.

gloo has no CUDA form of all-gather-into-tensor or reduce-scatter, and only
some builds carry its CUDA all-reduce. So every collective of a gloo world
on a CUDA tensor goes through host memory: a copy to the CPU, the
collective there, a copy back. The choice is made by the backend and the
tensor's device, before the call; ``STAGED`` counts such calls.

A step's many tensors (a gradient tree, the owners' partial updates) are
reduced together: ``all_reduce_mean_many`` / ``all_reduce_sum_many`` pack
them, in f32, into buckets of up to ``BUCKET`` elements (a larger tensor is
a bucket of its own), one collective a bucket, staged through a pinned host
buffer kept for the next step.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

STAGED = {"calls": 0}  # collectives of a gloo world staged through host memory
BUCKET = 1 << 26  # elements a bucket of the *_many reductions (256 MiB in f32)
_PINNED: dict = {}  # the pinned host buffer of the staged buckets, by device

_WORLD: dict | None = None  # {"rank", "n", "backend", "device"} once joined


def init_world(device, backend: str | None = None, *, rank: int | None = None,
               world_size: int | None = None, store=None) -> torch.device:
    """Join the data-parallel world and return this rank's device.

    `rank`, `world_size` and `store` default to the environment that
    ``torch.distributed.run`` sets; with no WORLD_SIZE there (and none
    given) no world is made, and `device` comes back as it is. A CUDA
    device is this rank's own card, ``cuda:{LOCAL_RANK % device_count}``.
    `backend` None is NCCL for CUDA and gloo for the CPU."""
    global _WORLD
    device = torch.device(device)
    if world_size is None:
        env = os.environ.get("WORLD_SIZE")
        if env is None:
            return device
        world_size = int(env)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(minutes=30))
    if store is not None:
        kw["store"] = store
    dist.init_process_group(**kw)
    _WORLD = {"rank": rank, "n": world_size, "backend": backend, "device": device}
    return device


def close_world() -> None:
    """Leave the world (destroys the process group); a no-op without one."""
    global _WORLD
    if _WORLD is not None:
        dist.destroy_process_group()
        _WORLD = None


def in_world() -> bool:
    return _WORLD is not None


def rank() -> int:
    """This process's index in the world (the reference's data-parallel
    shard index); 0 with no world."""
    return _WORLD["rank"] if _WORLD is not None else 0


def n_dp() -> int:
    """The world's size, the data-parallel replica count; 1 with no world."""
    return _WORLD["n"] if _WORLD is not None else 1


def backend() -> str | None:
    return _WORLD["backend"] if _WORLD is not None else None


def _batch_dim(key: str) -> int:
    """M-RoPE "positions" (3, B, S) carry the batch on dim 1, every other
    batch leaf on dim 0 (the reference's ``_batch_dim_index``)."""
    return 1 if key == "positions" else 0


def shard_rows(x: torch.Tensor, dim: int = 0, *, k: int | None = None,
               n: int | None = None) -> torch.Tensor:
    """Rank k's rows [k·B/n, (k+1)·B/n) of `x` along `dim` (this rank's by
    default); raises where n does not divide B."""
    k = rank() if k is None else k
    n = n_dp() if n is None else n
    B = x.shape[dim]
    if B % n:
        raise ValueError(f"the batch ({B}) must be divisible by n_dp ({n}) to split it over "
                         f"the data-parallel ranks")
    return x.narrow(dim, k * (B // n), B // n)


def shard_batch(batch: dict, *, k: int | None = None, n: int | None = None) -> dict:
    """This rank's rows of every leaf of a global batch dict; the batch
    itself with no world."""
    n = n_dp() if n is None else n
    if n == 1:
        return batch
    return {key: shard_rows(v, _batch_dim(key), k=k, n=n) for key, v in batch.items()}


def microbatch(batch: dict, i: int, nm: int) -> dict:
    """Microbatch i of nm of a batch dict: each leaf's i-th chunk along its
    batch dim (``_batch_dim``)."""
    return {key: v.chunk(nm, dim=_batch_dim(key))[i] for key, v in batch.items()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor) -> bool:
    return _WORLD["backend"] == "gloo" and t.device.type == "cuda"


def _host(t: torch.Tensor) -> torch.Tensor:
    if _staged(t):
        STAGED["calls"] += 1
        return t.to("cpu")
    return t


# torch 2.13 names these collectives all_gather_single / reduce_scatter_single
# and warns on the old names; torch 2.11 (the H100 machine's) has only the old
# ones. Chosen once, here.
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def _buckets(ts):
    """Consecutive runs of `ts` whose sizes add up to at most BUCKET
    elements (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(ts):
        if cur and size + t.numel() > BUCKET:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    if cur:
        out.append(cur)
    return out


def _reduce_many(ts, mean: bool) -> list:
    ts = list(ts)
    if _WORLD is None:
        return ts
    out = [None] * len(ts)
    for idx in _buckets(ts):
        flat = torch.cat([ts[i].reshape(-1).float() for i in idx])
        if _staged(flat):
            STAGED["calls"] += 1
            buf = _PINNED.get(flat.device)
            if buf is None or buf.numel() < flat.numel():
                buf = _PINNED[flat.device] = torch.empty(flat.numel(), dtype=torch.float32,
                                                         pin_memory=True)
            host = buf[:flat.numel()]
            host.copy_(flat)
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            flat.copy_(host)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if mean:
            flat /= _WORLD["n"]
        for i, part in zip(idx, flat.split([ts[i].numel() for i in idx])):
            out[i] = part.view(ts[i].shape).to(ts[i].dtype)
    return out


def all_reduce_mean_many(ts) -> list:
    """The world's mean of every tensor of `ts`, packed in buckets (each mean
    summed in f32 and cast back to its tensor's dtype); `ts` itself with no
    world."""
    return _reduce_many(ts, mean=True)


def all_reduce_sum_many(ts) -> list:
    """The world's f32 sum of every tensor of `ts` (cast back to its dtype),
    packed in buckets."""
    return _reduce_many(ts, mean=False)


def all_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in rank order."""
    if _WORLD is None:
        return t
    n = _WORLD["n"]
    x = _host(t).movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_single(out, x)
    return out.movedim(0, dim).to(t.device)


def reduce_scatter_mean(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank k's block k of the world's f32 mean of `t` along `dim` (n_dp must
    divide the dim): the all-reduce's result, each rank receiving only its
    own slice."""
    if _WORLD is None:
        return t
    n = _WORLD["n"]
    x = _host(t.float()).movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter of a dim of {x.shape[0]} over {n} ranks")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter_single(out, x, op=dist.ReduceOp.SUM)
    return (out / n).movedim(0, dim).to(t.device)


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank `src`'s `t` on every rank (a new tensor on the others)."""
    if _WORLD is None:
        return t
    x = _host(t).contiguous().clone()
    dist.broadcast(x, src=src)
    return x.to(t.device)


def all_true(flag: bool) -> bool:
    """True iff `flag` holds on every rank (one host round trip)."""
    if _WORLD is None:
        return bool(flag)
    x = torch.tensor([0 if flag else 1], dtype=torch.int32)
    if _WORLD["backend"] == "nccl":
        x = x.to(_WORLD["device"])
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return int(x.item()) == 0


def barrier() -> None:
    if _WORLD is not None:
        dist.barrier()
