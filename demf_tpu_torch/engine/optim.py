"""AdamW, Adam and SGD, the step LR schedule and the global-norm gradient
clip (port of ``demf_tpu/engine/optim.py``).

The JAX package builds one optax chain a type, after clip_by_global_norm:

* AdamW: scale_by_adam -> add_decayed_weights -> per-leaf lr_mult ->
  scale_by_learning_rate.  Here ``torch.optim.AdamW`` with one param group
  per lr_mult: a group's learning rate is ``lr * lr_mult``, and AdamW's
  decoupled decay is scaled by the group's learning rate, so lr_mult scales
  both the Adam step and the decay, as the chain does.
* Adam: scale_by_adam -> lr_mult -> scale_by_learning_rate, with no decay
  whatever ``weight_decay`` says (the chain has none).  Here
  ``torch.optim.Adam`` with the same groups and ``weight_decay=0``.
* SGD: optax.trace (momentum, no dampening, no Nesterov) ->
  add_decayed_weights -> scale_by_learning_rate: the decay is added to the
  update outside the momentum trace, where ``torch.optim.SGD(
  weight_decay=)`` puts it inside; hence ``OptaxSGD``.  The chain has no
  lr_mult: ``custom_keys`` and the frozen patterns do not reach it, so every
  parameter takes the same rate, and a frozen one (its gradient zero in the
  JAX package, None here) still moves by its decay, ``-lr * wd * p``, as it
  does there.

``custom_keys`` match by substring on the dotted torch parameter name
(mmcv's rule; the JAX side matches the '/' flax path), the first matching
key in config order winning, as on the JAX side.
"""
from __future__ import annotations

import torch


def step_lr_schedule(base_lr, steps_per_epoch, milestones, gamma=0.1,
                     warmup=None, warmup_iters=500, warmup_ratio=1.0 / 3):
    """mmcv ``StepLrUpdaterHook`` as a function of the update count: the
    rate drops by ``gamma`` at each milestone epoch (at counts >= the
    boundary), with an optional linear warmup over ``warmup_iters``."""
    if warmup not in (None, 'linear'):
        raise NotImplementedError(warmup)
    boundaries = sorted(int(m * steps_per_epoch) for m in milestones)

    def schedule(count):
        lr = base_lr
        for boundary in boundaries:
            if count >= boundary:
                lr = lr * gamma
        if warmup and count < warmup_iters:
            frac = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
            lr = lr * (warmup_ratio + (1.0 - warmup_ratio) * frac)
        return lr

    return schedule


def param_lr_mult(name, custom_keys):
    """The lr multiplier of parameter ``name``: the first key of
    ``custom_keys`` that is a substring of it, else 1."""
    for key, spec in (custom_keys or {}).items():
        if key in name:
            return spec.get('lr_mult', 1.0)
    return 1.0


class OptaxSGD(torch.optim.Optimizer):
    """optax's ``chain(trace(momentum), add_decayed_weights(wd),
    scale_by_learning_rate(lr))``: ``buf = g + momentum * buf``, then
    ``p -= lr * (buf + wd * p)``.  A parameter without a gradient counts
    as a zero gradient (optax updates every leaf)."""

    def __init__(self, params, lr, momentum=0.9, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                state = self.state[p]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                buf = state.get('momentum_buffer')
                buf = g.clone() if buf is None else \
                    g + group['momentum'] * buf
                state['momentum_buffer'] = buf
                update = buf + group['weight_decay'] * p \
                    if group['weight_decay'] else buf
                p.sub_(group['lr'] * update)


def build_optimizer(model, optimizer_cfg, frozen_patterns=()):
    """The optimizer of an mmcv-style config: dict(type='AdamW' | 'Adam' |
    'SGD', lr, weight_decay, betas, eps, momentum,
    paramwise_cfg=dict(custom_keys={...})), as the JAX package's chain of
    that type (see the module's doc).

    ``frozen_patterns`` join the custom keys at lr_mult 0 (AdamW and Adam;
    SGD has no lr_mult).  Every group carries its ``lr_mult``; ``set_lr``
    applies a scheduled rate to all.
    """
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'AdamW')
    if opt_type not in ('AdamW', 'Adam', 'SGD'):
        raise NotImplementedError(
            f'the port has AdamW, Adam and SGD, not {opt_type}')
    lr = cfg.pop('lr', 1e-3)
    if opt_type == 'SGD':
        return OptaxSGD([dict(params=list(model.parameters()), lr=lr,
                              lr_mult=1.0)], lr,
                        momentum=cfg.pop('momentum', 0.9),
                        weight_decay=cfg.pop('weight_decay', 0.0))
    custom_keys = dict((cfg.pop('paramwise_cfg', None) or {}).get(
        'custom_keys', {}))
    for pat in frozen_patterns:
        custom_keys[pat] = dict(lr_mult=0.0, decay_mult=0.0)
    groups = {}
    for name, p in model.named_parameters():
        mult = param_lr_mult(name, custom_keys)
        groups.setdefault(mult, []).append(p)
    param_groups = [dict(params=ps, lr=lr * m, lr_mult=m)
                    for m, ps in groups.items()]
    kind, wd = ((torch.optim.AdamW, cfg.pop('weight_decay', 0.0))
                if opt_type == 'AdamW' else (torch.optim.Adam, 0.0))
    return kind(param_groups, lr=lr,
                betas=tuple(cfg.pop('betas', (0.9, 0.999))),
                eps=cfg.pop('eps', 1e-8), weight_decay=wd)


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group['lr'] = lr * group['lr_mult']


def global_norm(tensors):
    """sqrt of the sum of squares over all ``tensors`` (optax.global_norm),
    a 0-dim tensor; no host sync."""
    return torch.stack([(t * t).sum() for t in tensors]).sum().sqrt()


def clip_grad_global_norm(params, max_norm):
    """Clip the gradients of ``params`` in place by their global norm with
    optax's rule: scaled to ``g / norm * max_norm`` only when
    ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (norm + 1e-6)`` whenever that is < 1).  Returns the norm
    before clipping, as a 0-dim tensor; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm
