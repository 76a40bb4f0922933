"""The train step (port of the default branch of repro/distributed/step.py::
make_train_step and its ``_grads_and_loss``), on a single device."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.optim.factory import build_optimizer
from repro_torch.optim.transform import apply_updates
from repro_torch.utils import tree_leaves, tree_unflatten_like


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns (train_step(params, opt_state, batch) -> (params, opt_state, metrics), opt).

    train_step updates `params` in place and returns them."""
    opt = build_optimizer(tc)

    def loss_of(params, batch):
        return M.loss_fn(cfg, params, batch, z_loss=tc.z_loss)

    def train_step(params, opt_state, batch):
        _, metrics, grads = _grads_and_loss(tc, loss_of, params, batch)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step, opt


def _grads_and_loss(tc, loss_of, params, batch):
    """(loss, metrics, grads); with tc.microbatch > 1 the batch is split and
    the f32 gradients averaged, as the reference's scan does."""
    leaves = tree_leaves(params)
    if tc.microbatch and tc.microbatch > 1:
        nm = tc.microbatch
        chunks = [{k: v.chunk(nm, dim=0)[i] for k, v in batch.items()} for i in range(nm)]
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_acc = 0.0
        for b in chunks:
            loss, _ = loss_of(params, b)
            gs = torch.autograd.grad(loss, leaves)
            g_acc = [a + g.float() / nm for a, g in zip(g_acc, gs)]
            loss_acc = loss_acc + loss.detach() / nm
        return loss_acc, {"loss": loss_acc}, tree_unflatten_like(params, g_acc)
    loss, metrics = loss_of(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten_like(params, list(grads))
