"""Weights from the JAX package into the port (DeMF-VoteNet, the stage-1
DETR pretrain model, VoteNet, ImVoteNet and its Faster R-CNN branch, FCAF3D
and DeMF-FCAF3D).

``state_dict_from_jax`` is the exact inverse of
``demf_tpu.engine.torch_port.port_demf_checkpoint`` and, for the FCAF3D
family's MinkResNet and FCAF3DHead, of ``port_fcaf3d_checkpoint``: it takes
the flax variables as flat ``{'a/b/c': ndarray}`` dicts (the form of
``torch_port.flatten_params``) and returns the port's state_dict under the
mmdet3d key names.  A sparse kernel goes from the JAX package's tap order
(the last axis fastest) to MinkowskiEngine's (the first axis fastest, the
inverse of ``torch_port._me_tap_perm``), the order in which mmdet3d stores
it and the port's models use it (``ops/sparse.py``).  DeMF-FCAF3D's fusion
head (``query_proj``, ``fuse_proj{i}``, ``conv_center{i}`` /
``conv_reg{i}`` / ``conv_cls{i}``: Linear layers under the port's names,
and the decoder layers under DeMF-VoteNet's rules) and its image branch
take the rules of the other detectors.  It reads no jax; callers flatten on
the JAX side.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# (flax module path pattern, torch module path template, weight kind).
# Kinds: 'c2' Dense kernel as a 1x1 Conv2d, 'c1' Dense kernel as a Conv1d,
# 'lin' Linear, 'hwio' Conv2d kernel, 'norm' BN / GN / LN.  Templates use
# str.format on the match groups ({1}, {2}, ...); {p} is the leading path
# with '/' -> '.'.
_RULES = [
    (r'(?P<p>.*)/SA_modules_(\d+)/mlps/Dense_(\d+)',
     '{p}.SA_modules.{1}.mlps.0.layer{2}.conv', 'c2'),
    (r'(?P<p>.*)/SA_modules_(\d+)/mlps/BatchNorm_(\d+)',
     '{p}.SA_modules.{1}.mlps.0.layer{2}.bn', 'norm'),
    (r'(?P<p>.*)/FP_modules_(\d+)/mlps/Dense_(\d+)',
     '{p}.FP_modules.{1}.mlps.layer{2}.conv', 'c2'),
    (r'(?P<p>.*)/FP_modules_(\d+)/mlps/BatchNorm_(\d+)',
     '{p}.FP_modules.{1}.mlps.layer{2}.bn', 'norm'),
    (r'(?P<p>.*)/vote_aggregation/mlps/Dense_(\d+)',
     '{p}.vote_aggregation.mlps.0.layer{1}.conv', 'c2'),
    (r'(?P<p>.*)/vote_aggregation/mlps/BatchNorm_(\d+)',
     '{p}.vote_aggregation.mlps.0.layer{1}.bn', 'norm'),
    (r'(?P<p>.*)/vote_conv/Dense_(\d+)', '{p}.vote_conv.{1}.conv', 'c1'),
    (r'(?P<p>.*)/vote_conv/BatchNorm_(\d+)', '{p}.vote_conv.{1}.bn', 'norm'),
    (r'(?P<p>.*)/vote_module/conv_out', '{p}.vote_module.conv_out', 'c1'),
    (r'(?P<p>.*)/shared_convs/Dense_(\d+)', '{p}.shared_convs.layer{1}.conv',
     'c1'),
    (r'(?P<p>.*)/shared_convs/BatchNorm_(\d+)',
     '{p}.shared_convs.layer{1}.bn', 'norm'),
    (r'(?P<p>.*)/conv_pred(\d+)/conv_(cls|reg)', '{p}.conv_pred{1}.conv_{2}',
     'c1'),
    # a vote head's single prediction layer (VoteNet's CAVoteHead, VoteHead)
    (r'(?P<p>.*)/conv_pred/conv_(cls|reg)', '{p}.conv_pred.conv_{1}', 'c1'),
    (r'(?P<p>.*)/decoder_(\d+)/layer/cross_attn/(\w+)',
     '{p}.decoder.{1}.layer.attentions.1.{2}', 'lin'),
    (r'(?P<p>.*)/decoder_(\d+)/layer/ffn/fc1',
     '{p}.decoder.{1}.layer.ffns.0.layers.0.0', 'lin'),
    (r'(?P<p>.*)/decoder_(\d+)/layer/ffn/fc2',
     '{p}.decoder.{1}.layer.ffns.0.layers.1', 'lin'),
    (r'(?P<p>.*)/decoder_(\d+)/layer/norm(\d)',
     '{p}.decoder.{1}.layer.norms.{n2}', 'norm'),
    (r'(?P<p>.*)/decoder_(\d+)/posembed/fc1',
     '{p}.decoder.{1}.posembed.position_embedding_head.0', 'c1'),
    (r'(?P<p>.*)/decoder_(\d+)/posembed/bn',
     '{p}.decoder.{1}.posembed.position_embedding_head.1', 'norm'),
    (r'(?P<p>.*)/decoder_(\d+)/posembed/fc2',
     '{p}.decoder.{1}.posembed.position_embedding_head.3', 'c1'),
    # DeformableDETRHead: its layers sit under mmdet's ``transformer``
    (r'(?P<p>.*)/encoder_(\d+)/self_attn/(\w+)',
     '{p}.transformer.encoder.layers.{1}.attentions.0.{2}', 'lin'),
    (r'(?P<p>.*)/encoder_(\d+)/ffn/fc1',
     '{p}.transformer.encoder.layers.{1}.ffns.0.layers.0.0', 'lin'),
    (r'(?P<p>.*)/encoder_(\d+)/ffn/fc2',
     '{p}.transformer.encoder.layers.{1}.ffns.0.layers.1', 'lin'),
    (r'(?P<p>.*)/encoder_(\d+)/norm(\d)',
     '{p}.transformer.encoder.layers.{1}.norms.{n2}', 'norm'),
    (r'(?P<p>.*)/decoder_(\d+)/cross_attn/(\w+)',
     '{p}.transformer.decoder.layers.{1}.attentions.1.{2}', 'lin'),
    (r'(?P<p>.*)/decoder_(\d+)/ffn/fc1',
     '{p}.transformer.decoder.layers.{1}.ffns.0.layers.0.0', 'lin'),
    (r'(?P<p>.*)/decoder_(\d+)/ffn/fc2',
     '{p}.transformer.decoder.layers.{1}.ffns.0.layers.1', 'lin'),
    (r'(?P<p>.*)/decoder_(\d+)/norm(\d)',
     '{p}.transformer.decoder.layers.{1}.norms.{n2}', 'norm'),
    (r'(?P<p>.*)/(reference_points_fc)', '{p}.transformer.reference_points',
     'lin'),
    # ImVoteNet's Faster R-CNN branch: FPN, RPN, Shared2FC (mmdet's names)
    (r'(?P<p>.*)/lateral_(\d+)', '{p}.lateral_convs.{1}.conv', 'hwio'),
    (r'(?P<p>.*)/fpn_conv_(\d+)', '{p}.fpn_convs.{1}.conv', 'hwio'),
    (r'(?P<p>.*)/(rpn_conv|rpn_cls|rpn_reg)', '{p}.{1}', 'hwio'),
    (r'(?P<p>.*)/shared_fc(\d)', '{p}.bbox_head.shared_fcs.{n2}', 'lin'),
    (r'(?P<p>.*img_roi_head)/(fc_cls|fc_reg)', '{p}.bbox_head.{1}', 'lin'),
    # ImVoteNet's image-vote MLP (mmdet3d ``MLP``: Conv1d layers)
    (r'(?P<p>.*)/mlp/Dense_(\d+)', '{p}.mlp.layer{1}.conv', 'c1'),
    (r'(?P<p>.*)/mlp/BatchNorm_(\d+)', '{p}.mlp.layer{1}.bn', 'norm'),
    (r'(?P<p>.*)/(fc_cls)', '{p}.fc_cls', 'lin'),
    (r'(?P<p>.*)/fc_reg/l(\d)', '{p}.fc_reg.{x2}', 'lin'),
    (r'(?P<p>.*)/layers_(\d+)/self_attn/(\w+)',
     '{p}.encoder.layers.{1}.attentions.0.{2}', 'lin'),
    (r'(?P<p>.*)/layers_(\d+)/ffn/fc1',
     '{p}.encoder.layers.{1}.ffns.0.layers.0.0', 'lin'),
    (r'(?P<p>.*)/layers_(\d+)/ffn/fc2',
     '{p}.encoder.layers.{1}.ffns.0.layers.1', 'lin'),
    (r'(?P<p>.*)/layers_(\d+)/norm(\d)', '{p}.encoder.layers.{1}.norms.{n2}',
     'norm'),
    (r'(?P<p>.*)/layer(\d)_(\d+)/conv(\d)', '{p}.layer{1}.{2}.conv{3}',
     'hwio'),
    (r'(?P<p>.*)/layer(\d)_(\d+)/bn(\d)', '{p}.layer{1}.{2}.bn{3}', 'norm'),
    (r'(?P<p>.*)/layer(\d)_(\d+)/downsample_conv',
     '{p}.layer{1}.{2}.downsample.0', 'hwio'),
    (r'(?P<p>.*)/layer(\d)_(\d+)/downsample_bn',
     '{p}.layer{1}.{2}.downsample.1', 'norm'),
    (r'(?P<p>.*)/(conv1)', '{p}.conv1', 'hwio'),
    (r'(?P<p>.*)/(bn1)', '{p}.bn1', 'norm'),
    (r'(?P<p>.*)/convs_(\d+)', '{p}.convs.{1}.conv', 'hwio'),
    (r'(?P<p>.*)/gn_(\d+)', '{p}.convs.{1}.gn', 'norm'),
    (r'(?P<p>.*)/extra_convs_(\d+)', '{p}.extra_convs.{1}.conv', 'hwio'),
    (r'(?P<p>.*)/extra_gn_(\d+)', '{p}.extra_convs.{1}.gn', 'norm'),
    # DeMF-FCAF3D's fusion head
    (r'(?P<p>.*)/(query_proj|fuse_proj\d+|conv_(?:center|reg|cls)\d+)',
     '{p}.{1}', 'lin'),
]
_RULES = [(re.compile(pat + '$'), tmpl, kind) for pat, tmpl, kind in _RULES]
# the decoder's self-attention: the DeMF head's layer, the DETR head's layers
_MHA = re.compile(r'(?P<p>.*)/decoder_(\d+)(?P<demf>/layer)?/self_attn/attn$')
_LEAF = dict(kernel='weight', bias='bias', scale='weight',
             mean='running_mean', var='running_var')
# MinkResNet and FCAF3DHead (the JAX package's flat names -> mmdet3d's);
# a sparse kernel is a leaf of its own, a BN a module with the usual leaves
_MINK_KERNELS = [
    (r'(?P<p>.*)/stem_conv', '{p}.conv1.kernel'),
    (r'(?P<p>(?:.*/)?backbone)/layer(\d)_(\d+)/conv(\d)',
     '{p}.layer{1}.{2}.conv{3}.kernel'),
    (r'(?P<p>(?:.*/)?backbone)/layer(\d)_(\d+)/down',
     '{p}.layer{1}.{2}.downsample.0.kernel'),
    (r'(?P<p>.*)/up_block_(\d+)_tconv', '{p}.up_block_{1}.0.kernel'),
    (r'(?P<p>.*)/up_block_(\d+)_conv', '{p}.up_block_{1}.3.kernel'),
    (r'(?P<p>.*)/out_block_(\d+)_conv', '{p}.out_block_{1}.0.kernel'),
]
_MINK_NORMS = [
    (r'(?P<p>.*)/stem_bn', '{p}.norm1.bn'),
    (r'(?P<p>(?:.*/)?backbone)/layer(\d)_(\d+)/bn(\d)',
     '{p}.layer{1}.{2}.norm{3}.bn'),
    (r'(?P<p>(?:.*/)?backbone)/layer(\d)_(\d+)/bn_down',
     '{p}.layer{1}.{2}.downsample.1.bn'),
    (r'(?P<p>.*)/up_block_(\d+)_tbn', '{p}.up_block_{1}.1.bn'),
    (r'(?P<p>.*)/up_block_(\d+)_bn', '{p}.up_block_{1}.4.bn'),
    (r'(?P<p>.*)/out_block_(\d+)_bn', '{p}.out_block_{1}.1.bn'),
]
_MINK_KERNELS = [(re.compile(p + '$'), t) for p, t in _MINK_KERNELS]
_MINK_NORMS = [(re.compile(p + '$'), t) for p, t in _MINK_NORMS]
# FCAF3DHead's shared 1x1x1 convs: flax Dense name -> MinkowskiConvolution
_MINK_DENSE = {'conv_center': 'centerness_conv', 'conv_reg': 'reg_conv',
               'conv_cls': 'cls_conv'}


def _torch_module(path):
    for pat, tmpl, kind in _RULES:
        m = pat.match(path)
        if m:
            g = m.groups()
            # {n2}: flax norm{k} counts from 1, mmcv norms.{k-1} from 0
            # {x2}: DetrMLP's l{k} is index 2k of the port's Sequential
            last = int(g[-1]) if g[-1].isdigit() else None
            return tmpl.format(
                *g, p=g[0].replace('/', '.'),
                n2=None if last is None else last - 1,
                x2=None if last is None else 2 * last), kind
    raise KeyError(f'no port rule for flax module {path!r}')


def _convert(kind, leaf, v):
    if leaf != 'kernel':
        return v
    if kind == 'hwio':
        return v.transpose(3, 2, 0, 1)
    if kind == 'c2':
        return v.T[:, :, None, None]
    if kind == 'c1':
        return v.T[:, :, None]
    return v.T   # Linear


def me_tap_order(kernel):
    """A (k^3, C_in, C_out) kernel from the JAX package's tap order (the
    last axis fastest) to MinkowskiEngine's (the first axis fastest)."""
    k = round(kernel.shape[0] ** (1 / 3))
    return kernel.reshape(k, k, k, *kernel.shape[1:]).transpose(
        2, 1, 0, 3, 4).reshape(kernel.shape)


def _sub(match, template):
    g = match.groups()
    return template.format(*g, p=g[0].replace('/', '.'))


def _mink_entry(key, v):
    """(torch key, value) of a MinkResNet / FCAF3DHead leaf, or None."""
    for pat, tmpl in _MINK_KERNELS:
        m = pat.match(key)
        if m:
            if v.shape[0] == 1:           # a 1x1x1 kernel: (C_in, C_out)
                return _sub(m, tmpl), v[0]
            return _sub(m, tmpl), me_tap_order(v)
    path, leaf = key.rsplit('/', 1)
    for pat, tmpl in _MINK_NORMS:
        m = pat.match(path)
        if m:
            return f'{_sub(m, tmpl)}.{_LEAF[leaf]}', v
    prefix, name = path.rsplit('/', 1) if '/' in path else ('', path)
    if name in _MINK_DENSE and leaf in ('kernel', 'bias'):
        module = '.'.join(filter(None, (prefix.replace('/', '.'),
                                        _MINK_DENSE[name])))
        # MinkowskiConvolution keeps its kernel (C_in, C_out), a bias (1, C)
        return f'{module}.{leaf}', v if leaf == 'kernel' else v[None]
    return None


def state_dict_from_jax(params, batch_stats):
    """Flat flax ``params`` / ``batch_stats`` -> the port's state_dict.

    Raises ``KeyError`` on a flax leaf no rule covers.  Every BatchNorm
    gets ``num_batches_tracked = 0``.
    """
    sd = {}
    mha = {}
    mink = any(k.endswith('/stem_conv') for k in params)
    for key, v in list(params.items()) + list(batch_stats.items()):
        v = np.asarray(v)
        entry = _mink_entry(key, v) if mink else None
        if entry is not None:
            sd[entry[0]] = entry[1]
            if entry[0].endswith('.running_mean'):
                sd[entry[0][:-len('running_mean')] + 'num_batches_tracked'] \
                    = np.asarray(0)
            continue
        path, leaf = key.rsplit('/', 1)
        if leaf == 'level_embeds':
            # a DETR head keeps them under ``transformer``, beside its
            # queries; the DeMF image encoder on itself
            head = f'{path}/query_embedding' in params
            sd[path.replace('/', '.') + ('.transformer.' if head else '.') +
               leaf] = v
            continue
        if leaf == 'query_embedding':
            sd[key.replace('/', '.') + '.weight'] = v
            continue
        attn_path, proj = path.rsplit('/', 1)
        if _MHA.match(attn_path):
            mha.setdefault(attn_path, {})[(proj, leaf)] = v
            continue
        module, kind = _torch_module(path)
        sd[f'{module}.{_LEAF[leaf]}'] = _convert(kind, leaf, v)
        if leaf == 'mean':
            sd[f'{module}.num_batches_tracked'] = np.asarray(0)
    for attn_path, parts in mha.items():
        m = _MHA.match(attn_path)
        prefix = ('{}.decoder.{}.layer.attentions.0.attn' if m.group('demf')
                  else '{}.transformer.decoder.layers.{}.attentions.0.attn'
                  ).format(m.group('p').replace('/', '.'), m.group(2))
        names = ('query', 'key', 'value')
        e = parts[('query', 'kernel')].shape[0]
        sd[f'{prefix}.in_proj_weight'] = np.concatenate(
            [parts[(n, 'kernel')].reshape(e, e).T for n in names])
        sd[f'{prefix}.in_proj_bias'] = np.concatenate(
            [parts[(n, 'bias')].reshape(e) for n in names])
        sd[f'{prefix}.out_proj.weight'] = parts[('out', 'kernel')].reshape(
            e, e).T
        sd[f'{prefix}.out_proj.bias'] = parts[('out', 'bias')]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            sd.items()}
