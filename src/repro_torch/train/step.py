"""Training step factory, ported from ``repro.train.step``: loss, grads,
clip and update, with microbatch gradient accumulation.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the params'
leaves with ``materialize_grads=True``, so a leaf the loss does not
reach gets a zero gradient, as ``jax.grad`` gives it (and AdamW still
decays it).  Microbatches are a loop: float32 zeros, plus each
microbatch's gradients in order, divided by their number; the metrics
are the mean over microbatches, as the reference's ``lax.scan`` and
``.mean()`` give them.

Training runs the plain attention and scans only (``attn_impl =
"reference"``): no kernel of either package has a backward pass, and the
reference cannot differentiate its ``pallas_call``s.  ``make_train_step``
refuses any other ``attn_impl`` on every device, before it runs.

With ``rules`` (``sharding.logical.AxisRules``) and a state and batch of
DTensors on a mesh, the forward pins its activations as the reference's
does; on a mesh, microbatch ``i`` is every rank's ``i``-th slice of its
own batch rows (the same rows in all, summed in another order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import _device
from repro_torch._tree import tree_flatten, tree_unflatten
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import logical as L


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    microbatches: int = 1          # grad accumulation steps
    aux_weight: float = 0.01


def loss_and_metrics(params, batch, cfg: ModelConfig, aux_weight: float,
                     rules=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    logits, aux = registry.forward(params, batch, cfg, rules)
    loss = registry.loss_fn(logits, batch["labels"], aux,
                            aux_weight=aux_weight)
    return loss, {"loss": loss, "aux_loss": aux}


def _microbatch(batch: Dict[str, Any], n: int, i: int) -> Dict[str, Any]:
    def take(x):
        loc = x.to_local() if L.is_dtensor(x) else x
        b = loc.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} "
                             f"microbatches")
        part = loc.reshape(n, b // n, *loc.shape[1:])[i]
        if loc is x:
            return part
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(part, x.device_mesh, x.placements,
                                  run_check=False)
    return {k: take(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, rules=None):
    """Returns train_step(state, batch) -> (state, metrics), where
    state = {"params": ..., "opt": ...}."""
    if cfg.attn_impl != "reference":
        raise ValueError(
            f"training needs attn_impl='reference', not "
            f"{cfg.attn_impl!r}: no kernel of either package has a "
            f"backward pass, and the reference cannot differentiate its "
            f"pallas_call kernels")

    def grads_of(flat_p, treedef, mb):
        live = [p.detach().requires_grad_() for p in flat_p]
        with torch.enable_grad():
            loss, metrics = loss_and_metrics(tree_unflatten(treedef, live),
                                             mb, cfg, tcfg.aux_weight, rules)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        flat_p, treedef = tree_flatten(params)
        n = tcfg.microbatches
        if n > 1:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat_p]
            per_mb = []
            for i in range(n):
                grads, metrics = grads_of(flat_p, treedef,
                                          _microbatch(batch, n, i))
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
                per_mb.append(metrics)
            grads = [a / n for a in acc]
            del acc
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
        else:
            grads, metrics = grads_of(flat_p, treedef, batch)
        grads, gnorm = adamw.clip_by_global_norm(
            tree_unflatten(treedef, grads), tcfg.optimizer.grad_clip_norm)
        new_params, new_opt = adamw.apply_updates(
            tcfg.optimizer, params, grads, opt)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = adamw.lr_at(tcfg.optimizer, new_opt["step"])
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator = None,
                     device=None) -> Dict[str, Any]:
    """Params drawn from ``generator`` (seed 0 on the target device when
    None) and a zero optimizer state, on ``device``: the GPU unless the
    caller names one."""
    device = _device.resolve(device, "init_train_state")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = L.init_params(generator, registry.param_specs(cfg), device)
    return {"params": params, "opt": adamw.init_state(params)}
