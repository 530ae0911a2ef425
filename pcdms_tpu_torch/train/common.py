"""Shared training harness (counterpart of ``pcdms_tpu/train/common.py``):
AdamW after global-norm clipping, gradient accumulation, the learning-rate
schedules, an EMA of the trainable parameters, and data parallelism over a
``parallel/mesh.py::Mesh`` with ZeRO-1.

The update follows optax's (``optax.chain(clip_by_global_norm, adamw)``,
wrapped in ``optax.MultiSteps`` when accumulating) where torch's stock
pieces differ:

* the schedule is evaluated at the count of updates made *before* this
  one, so with warmup the first update has lr = schedule(0) = 0;
* clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6`` always);
* accumulated gradients are the running mean of the micro-batch gradients
  (Welford, as ``MultiSteps``), clipped as a whole on the update step;
* parameters that got no gradient count as zero gradients (weight decay and
  the moments still move), as every leaf of a JAX gradient tree does.

``torch.optim.AdamW`` gives optax's update otherwise (decoupled decay,
eps outside the square root, bias correction). The EMA blends only on real
updates, with the diffusers ramp min(decay, (1 + t) / (10 + t)) over t
completed updates.

Over a mesh, every micro-step's gradients (and the loss and metrics) are
averaged over the whole world before anything reads them, so each rank sees
the global batch's gradient as the JAX step does; parameters that got no
gradient count as zeros there too. With ``TrainConfig.zero1`` each rank of a
slice keeps the AdamW moments of about ``1 / slice size`` of the parameters
(``ZeroRedundancyOptimizer`` over the slice's group), updates those and
broadcasts them; clipping, the schedule and the EMA act on the full,
replicated tensors as before.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from pcdms_tpu_torch.parallel.mesh import Mesh, all_reduce_mean

Models = Dict[str, torch.nn.Module]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_warmup_steps: int = 5000
    max_train_steps: int = 1_000_000
    lr_scheduler: str = "constant_with_warmup"   # reference default
    gradient_accumulation_steps: int = 1
    noise_offset: float = 0.1
    zero1: bool = False                           # shard optimizer state
    use_ema: bool = False
    ema_decay: float = 0.9999


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda n: init
    return lambda n: (init - end) * (1 - min(max(n, 0), steps) / steps) + end


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Update count -> learning rate, as the JAX package's optax
    schedules."""
    lr, warm = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant":
        return lambda n: lr
    if cfg.lr_scheduler == "constant_with_warmup":
        ramp = _linear(0.0, lr, max(warm, 1))
        return lambda n: ramp(n) if n < warm else lr
    if cfg.lr_scheduler == "cosine":
        ramp = _linear(0.0, lr, warm)
        decay = cfg.max_train_steps - warm
        if decay <= 0:
            raise ValueError("cosine schedule needs max_train_steps > "
                             "lr_warmup_steps")

        def cosine(n):
            n = min(n, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * n / decay))
        return lambda n: ramp(n) if n < warm else cosine(n - warm)
    raise ValueError(cfg.lr_scheduler)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``global_norm``), f32,
    from one norm per tensor in a few fused launches (``_foreach_norm``):
    the UNet has 690 parameter tensors, and one reduction each would cost
    more host time than device time."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class TrainState:
    """The trainable modules, AdamW over their parameters, the micro-step
    count, the accumulated gradient and the EMA shadow.

    ``models`` maps a name to a module (stage 2: ``unet``, ``image_proj``,
    ``pose_proj``); every parameter that requires grad is trained. The
    modules are updated in place. With ``cfg.zero1`` on a mesh with a group,
    the optimizer is a ``ZeroRedundancyOptimizer`` over the slice's ranks.
    """

    def __init__(self, models: Models, cfg: TrainConfig,
                 mesh: Optional[Mesh] = None):
        self.models = models
        self.named = [(f"{m}.{n}", p) for m, mod in models.items()
                      for n, p in mod.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named]
        kw = dict(lr=0.0, betas=(cfg.adam_beta1, cfg.adam_beta2),
                  eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)
        self.zero1 = bool(cfg.zero1 and mesh is not None
                          and mesh.slice_group is not None)
        if self.zero1:
            from torch.distributed.optim import ZeroRedundancyOptimizer
            self.optimizer = ZeroRedundancyOptimizer(
                self.params, optimizer_class=torch.optim.AdamW,
                process_group=mesh.slice_group, **kw)
        else:
            self.optimizer = torch.optim.AdamW(self.params, **kw)
        self.step = 0          # micro-steps taken
        self.acc = None        # running-mean gradient under accumulation
        self.ema = ({n: p.detach().clone() for n, p in self.named}
                    if cfg.use_ema else None)

    def optimizer_state(self) -> dict:
        """The whole optimizer state, as ``torch.optim.AdamW`` keeps it. Under
        ZeRO-1 every rank of the slice must call this (it gathers the shards
        on the slice's first rank); the other ranks get None."""
        if not self.zero1:
            return self.optimizer.state_dict()
        self.optimizer.consolidate_state_dict(to=0)
        return (self.optimizer.state_dict()
                if self.optimizer.rank == 0 else None)

    def state_dict(self) -> dict:
        return {
            "models": {k: m.state_dict() for k, m in self.models.items()},
            "optimizer": self.optimizer_state(),
            "step": self.step,
            "acc": self.acc,
            "ema": self.ema,
        }

    def load_state_dict(self, sd: dict) -> None:
        for k, m in self.models.items():
            m.load_state_dict(sd["models"][k])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        self.acc = sd["acc"]
        self.ema = sd["ema"]


def init_train_state(models: Models, cfg: TrainConfig,
                     mesh: Optional[Mesh] = None) -> TrainState:
    return TrainState(models, cfg, mesh)


def by_model(flat: Dict[str, torch.Tensor]
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"model.param": t} -> {model: {param: t}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in flat.items():
        model, _, pname = name.partition(".")
        out.setdefault(model, {})[pname] = t
    return out


def ema_params(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters to export for inference, {model: {name: tensor}}: the
    EMA shadow if the run tracked one, the raw parameters otherwise."""
    return by_model(state.ema if state.ema is not None else {
        n: p.detach() for n, p in state.named})


def make_train_step(loss_fn: Callable, cfg: TrainConfig,
                    mesh: Optional[Mesh] = None):
    """loss_fn(models, batch, generator) -> (loss, metrics). Returns
    step_fn(state, batch, generator) -> metrics, which takes one micro-step
    and updates ``state`` in place; ``metrics`` holds the loss and the
    global norm of this micro-batch's gradient before clipping. Over a
    ``mesh`` the gradients, the loss and the metrics are the world's mean."""
    schedule = make_lr_schedule(cfg)
    k = cfg.gradient_accumulation_steps

    def step_fn(state: TrainState, batch, generator):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.models, batch, generator)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.params]
        metrics = dict(metrics, loss=loss.detach())
        if mesh is not None and mesh.group is not None:
            names = sorted(metrics)
            scalars = torch.stack([torch.as_tensor(
                metrics[k], dtype=torch.float32, device=grads[0].device)
                for k in names])
            all_reduce_mean(grads + [scalars], mesh)
            metrics.update(zip(names, scalars.unbind()))
        metrics["grad_norm"] = global_norm(grads)

        mini = state.step % k
        if k > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(p) for p in state.params]
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (mini + 1))
            grads = state.acc
        if mini == k - 1:
            norm = global_norm(grads) if k > 1 else metrics["grad_norm"]
            if norm >= cfg.max_grad_norm:   # in place: no second copy
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, cfg.max_grad_norm)
            for p, g in zip(state.params, grads):
                p.grad = g
            for group in opt.param_groups:
                group["lr"] = schedule(state.step // k)
            opt.step()
            opt.zero_grad(set_to_none=True)
            state.acc = None
            if state.ema is not None:
                t = state.step // k          # completed updates before
                d = min(cfg.ema_decay, (1.0 + t) / (10.0 + t))
                ema = [state.ema[name] for name, _ in state.named]
                with torch.no_grad():
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, state.params, alpha=1.0 - d)
        state.step += 1
        return metrics

    return step_fn
