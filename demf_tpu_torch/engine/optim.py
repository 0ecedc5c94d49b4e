"""AdamW, the step LR schedule and the global-norm gradient clip (port of
``demf_tpu/engine/optim.py``).

The JAX package builds one optax chain: clip_by_global_norm -> scale_by_adam
-> add_decayed_weights -> per-leaf lr_mult -> scale_by_learning_rate.  Here
that is ``torch.optim.AdamW`` with one param group per lr_mult: a group's
learning rate is ``lr * lr_mult``, and AdamW's decoupled decay is scaled by
the group's learning rate, so lr_mult scales both the Adam step and the
decay, as the chain does.  ``custom_keys`` match by substring on the dotted
torch parameter name (mmcv's rule; the JAX side matches the '/' flax path),
the first matching key in config order winning, as on the JAX side.
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


def build_optimizer(model, optimizer_cfg, frozen_patterns=()):
    """``torch.optim.AdamW`` from an mmcv-style config, dict(type='AdamW',
    lr, weight_decay, betas, eps, paramwise_cfg=dict(custom_keys={...})).

    ``frozen_patterns`` join the custom keys at lr_mult 0.  Every group
    carries its ``lr_mult``; ``set_lr`` applies a scheduled rate to all.
    """
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'AdamW')
    if opt_type != 'AdamW':
        raise NotImplementedError(f'the port has AdamW, not {opt_type}')
    lr = cfg.pop('lr', 1e-3)
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
    return torch.optim.AdamW(
        param_groups, lr=lr, betas=tuple(cfg.pop('betas', (0.9, 0.999))),
        eps=cfg.pop('eps', 1e-8), weight_decay=cfg.pop('weight_decay', 0.0))


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
