"""The bf16 mixed-precision policy (port of ``demf_tpu/utils/precision.py``).

The same four decisions as the JAX package:

* master weights stay float32 in the optimizer; the train and eval steps
  run the model on bfloat16 *copies* of its floating parameters
  (``policy_call``), so gradients flow through the copies and arrive in
  float32.  Only a parameter that takes a gradient is copied on every
  call; the copy of any other (a frozen image branch, every weight of a
  served request) is kept until the parameter changes
  (``policy_weights``).  BatchNorm running statistics are buffers, not
  parameters: they are never copied and stay float32;
* of a batch, only the network inputs ``img`` / ``img_features`` are cast
  (``cast_batch``); ``points``, ground truth and calibration stay float32,
  because one bfloat16 step is ~2 cm at 5 m and would move FPS, the ball
  query and every projection.  The point branch casts *derived* features
  after the coordinate math (``cast_compute``, read from the one scope
  object that the steps set);
* the model's results go to float32 before ``model.loss`` and
  ``get_bboxes`` (``cast_floating``): losses, targets, the NMS and the box
  count run in float32;
* every layer computes in the promoted dtype of its input and its
  parameters, as flax's ``promote_dtype`` does (``promote``, ``dense``,
  ``conv``): a float32 coordinate that meets a bfloat16 weight is computed
  in float32, as in the JAX package; every norm reduces in float32 and
  returns the dtype its call site names (``norm_as``).

No ``torch.autocast``: autocast would run every matmul in bfloat16
whatever its inputs, the float32 geometry included.  bfloat16 has
float32's exponent range, so there is no loss scaling; the reference's
``fp16 = dict(loss_scale=...)`` selects the same policy.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn.functional as F

# batch keys the network consumes (cast under the policy); everything else
# stays float32 for coordinate, target-assignment and projection math
CASTABLE_BATCH_KEYS = ('img', 'img_features')

# the policy's dtype while a step runs the model under it, else None
_ACTIVE_COMPUTE_DTYPE = None


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    """Mark ``dtype`` as the active compute dtype inside the block."""
    global _ACTIVE_COMPUTE_DTYPE
    prev = _ACTIVE_COMPUTE_DTYPE
    _ACTIVE_COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _ACTIVE_COMPUTE_DTYPE = prev


def cast_compute(x):
    """``x`` in the active compute dtype (unchanged outside a scope): for
    features whose coordinate math is done."""
    if _ACTIVE_COMPUTE_DTYPE is None:
        return x
    return x.to(_ACTIVE_COMPUTE_DTYPE)


def cast_floating(tree, dtype):
    """Every floating tensor of a nested dict / list / tuple in ``dtype``
    (a ``dtype`` of None leaves the tree as it is)."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_batch(batch, dtype):
    """Only the network-input keys of a batch dict in ``dtype`` (a
    ``dtype`` of None leaves the batch as it is)."""
    if dtype is None:
        return batch
    out = dict(batch)
    for k in CASTABLE_BATCH_KEYS:
        if k in out:
            out[k] = cast_floating(out[k], dtype)
    return out


def resolve_compute_dtype(cfg):
    """``bf16 = True`` or the reference's ``fp16 = dict(...)`` in a config
    select ``torch.bfloat16``; anything else float32 (None)."""
    if cfg is None:
        return None
    if cfg.get('bf16') or cfg.get('fp16') is not None:
        return torch.bfloat16
    return None


# model -> {parameter name: (parameter, (storage, version, dtype), copy)}
_KEPT_COPIES = weakref.WeakKeyDictionary()


def policy_weights(model, dtype):
    """The floating parameters of ``model`` as copies in ``dtype``.  A
    parameter that takes a gradient in this call (``requires_grad`` with
    autograd on) is cast anew, so that its gradient reaches the float32
    master through the copy.  The copy of any other parameter is kept with
    the model and made again only when the parameter changes: an optimizer
    step, ``load_state_dict`` or a move to another device changes its
    version counter or its storage."""
    kept = _KEPT_COPIES.setdefault(model, {})
    grad = torch.is_grad_enabled()
    out = {}
    for name, p in model.named_parameters():
        if not p.is_floating_point():
            continue
        if grad and p.requires_grad:
            out[name] = p.to(dtype)
            continue
        key = (p.data_ptr(), p._version, dtype)
        entry = kept.get(name)
        if entry is None or entry[0] is not p or entry[1] != key:
            # a plain tensor even under inference_mode, so that a later
            # train step may save it for its backward
            with torch.inference_mode(False), torch.no_grad():
                entry = (p, key, p.detach().to(dtype))
            kept[name] = entry
        out[name] = entry[2]
    return out


def policy_call(model, dtype, *args, **kwargs):
    """``model(*args, **kwargs)``, under the policy when ``dtype`` is set:
    the floating parameters replaced by their copies in ``dtype``
    (``policy_weights``) and the scope active.  Buffers, BatchNorm's
    running statistics among them, are the model's own and stay
    float32."""
    if dtype is None:
        return model(*args, **kwargs)
    with compute_dtype_scope(dtype):
        return torch.func.functional_call(
            model, policy_weights(model, dtype), args, kwargs)


def promote(*tensors):
    """The tensors in their promoted dtype (None passes through), as flax's
    ``promote_dtype`` gives a layer its input and parameters."""
    dtype = None
    for t in tensors:
        if t is not None:
            dtype = t.dtype if dtype is None else torch.promote_types(
                dtype, t.dtype)
    return [t if t is None else t.to(dtype) for t in tensors]


def dense(x, layer):
    """``x @ W.T + b`` over the last axis, for an ``nn.Linear`` or a 1x1
    ``nn.Conv1d`` / ``nn.Conv2d`` (mmdet3d's layouts of a flax Dense), in
    the promoted dtype of ``x`` and the layer's parameters."""
    return F.linear(*promote(x, layer.weight.flatten(1), layer.bias))


def conv(layer, x):
    """An ``nn.Conv2d`` on NCHW ``x`` in the promoted dtype."""
    x, w, b = promote(x, layer.weight, layer.bias)
    return layer._conv_forward(x, w, b)


def norm_as(dtype, fn, x, *params):
    """A norm computed in float32 on ``x`` and its float32 ``params`` and
    returned in ``dtype``: flax reduces in float32, and every call site of
    the JAX package casts the result back to the dtype it names."""
    return fn(x.float(), *[p if p is None else p.float()
                           for p in params]).to(dtype)
