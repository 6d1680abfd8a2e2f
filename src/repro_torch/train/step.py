"""Train step: next-token cross-entropy (+ the MoE aux loss) with AdamW,
as the JAX package's ``train/step.py``; the gradient of every
attention call comes from the flash backward kernel on the card
(``kernels/ops.py: FlashAttention``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_map
from repro_torch.train.optimizer import AdamWConfig, adamw_update, leaves


def loss_fn(cfg: ModelConfig, params, inputs, labels, remat=True):
    """(loss, {"ce", "aux"}): the mean NLL of the f32 log-softmax plus aux."""
    logits, aux = T.forward_full(cfg, params, inputs, remat=remat)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = nll.mean()
    return ce + aux, {"ce": ce, "aux": aux}


def loss_and_grads(cfg: ModelConfig, params, inputs, labels, remat=True):
    """(loss, parts, grads): grads a tree like ``params`` (zeros for a leaf
    the loss does not reach, as JAX gives)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = loss_fn(cfg, live, inputs, labels, remat=remat)
        flat = list(leaves(live))
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(flat, got)}
    grads = tree_map(lambda p: by_id[id(p)], live)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat=True):
    """train_step(params, opt_state, inputs, labels) -> (params, opt_state,
    metrics {"loss", "ce", "aux", "grad_norm", "lr"}); params and moments
    are updated in place (see ``adamw_update``)."""
    def train_step(params, opt_state, inputs, labels):
        loss, parts, grads = loss_and_grads(cfg, params, inputs, labels, remat=remat)
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}
    return train_step
