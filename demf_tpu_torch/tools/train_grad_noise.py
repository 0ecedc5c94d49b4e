"""How far the FCAF3D family's train step on the kernel path strays from
the plain path where float32 cannot resolve a gradient, and whether the
step's end-to-end check (``chip_smoke.compare_train_paths``) reports a
fault planted in the kernel path.  On one card, from the repo root:

    python -m demf_tpu_torch.tools.train_grad_noise [--seeds 4] [--faults]
        [--out build/train_grad_noise.json]

* For FCAF3D and DeMF-FCAF3D at full width (``chip_smoke.fcaf3d_trainer``
  and ``demf_fcaf3d_trainer``: 8 scenes of 100,000 points) and each seed
  (the weights and the scenes), the first step's gradients on the kernel
  path and on the plain path, each against the plain path in float64
  (``chip_smoke.train_grad_errors``).  Each tensor's ratio of the two
  errors where float32 does not resolve it (the plain error above
  ``UNRESOLVED`` of the tensor's largest): the largest and smallest by
  model and seed.  ``chip_smoke.TRAIN_GRAD_NOISE`` must lie above the
  largest.
* ``--faults``: FCAF3D at seed 0 with one fault at a time planted in the
  kernel path (the plain path, which patches the same wrappers, runs as it
  is), held by ``compare_train_paths``:
  ``reverse_taps``: taps 0 and 1 swapped in layer 4's reverse table (the
  d_feats of its five 27-tap convs, C_out 512, K14 on the flipped table);
  ``dweights_slice_64`` / ``_512``: the plan's first (scene, row tile)s,
  as many as a K16 block takes (``dweights_chunk``), dropped in every call
  at 27 taps and C = C_out = 64 (layer 1's five convs, 6 tiles of 512)
  / 512 (layer 4's five, 64 of 64: their whole weight gradients).  Each
  row gives
  the factor below which the check reports the fault (``caught_below``:
  the largest kernel-to-plain ratio among the tensors past
  ``TRAIN_GRAD_BOUND``), and for K16's faults whether
  ``check_sparse_dweights`` reports it on the step's own calls.

Prints a line a run and writes the rows as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

UNRESOLVED = 1e-4


def ratios(errors):
    """{parameter: (kernel error, plain error)} -> the kernel-to-plain
    ratios of the unresolved tensors, sorted: [(ratio, name)]."""
    return sorted((k / p, n) for n, (k, p) in errors.items()
                  if p > UNRESOLVED)


def noise_row(smoke, model, batch, label):
    got_l, want_l, errors, whole, finite, _ = smoke.train_grad_errors(
        model, batch, label)
    found = ratios(errors)
    loss_err = max((got_l[k] - w).abs().item() / max(w.abs().item(), 1e-30)
                   for k, w in want_l.items())
    row = dict(label=label, tensors=len(errors), unresolved=len(found),
               finite=bool(finite), loss_err=loss_err,
               largest=found[-3:][::-1], smallest=found[:3],
               largest_plain=max(p for _, p in errors.values()),
               whole=whole)
    if not found:
        print(f'{label}: every gradient resolved in float32', flush=True)
        return row
    print(f'{label}: {len(found)} of {len(errors)} gradients unresolved in '
          f'float32 (plain error > {UNRESOLVED:g}, the largest '
          f'{row["largest_plain"]:.3e}); kernel / plain error ratio largest '
          + ', '.join(f'{n} {r:.3f}' for r, n in row['largest']) +
          '; smallest ' + ', '.join(f'{n} {r:.3f}' for r, n in
                                    row['smallest']) +
          f'; whole gradient {whole[0]:.3e} / {whole[1]:.3e}; loss max rel '
          f'err {loss_err:.3e}', flush=True)
    return row


def reverse_taps_fault(smoke):
    """Taps 0 and 1 swapped in the reverse table of every d_feats call on
    layer 4's level (27 taps, an output gradient 512 wide), its plan made
    for the swapped table."""
    from demf_tpu_torch.ops import sparse
    real = sparse.sparse_conv_backward_cuda

    def faulty(g, rev, wt, plan):
        if rev.shape[2] == 27 and g.shape[2] == 512:
            rev = rev[..., [1, 0] + list(range(2, 27))].contiguous()
            plan = sparse.conv_plan(rev)
        return real(g, rev, wt, plan)
    return smoke.patched((sparse, 'sparse_conv_backward_cuda', faulty))


def dweights_slice_fault(smoke, width, dropped):
    """The first (scene, row tile)s of the plan, as many as a K16 block
    takes (its chunk), dropped in every call at 27 taps and C = C_out =
    ``width``: their entries list no tap in the plan the kernel walks.
    ``dropped`` gets each call's chunk and share of the table's (row, tap)
    pairs left out."""
    from demf_tpu_torch.ops import sparse
    real = sparse.sparse_conv_dweights_cuda

    def faulty(feats, nbr, g, plan, chunk=None):
        if nbr.shape[2] == 27 and feats.shape[2] == g.shape[2] == width:
            b, mo, k = nbr.shape
            per = chunk or sparse.dweights_chunk(b, mo, feats.shape[2],
                                                 g.shape[2], k, feats.dtype)
            tiles = plan.tile_taps.shape[1]
            taps = plan.tile_taps.clone().reshape(-1)
            taps[:per] = 0
            rows = torch.zeros(b * tiles * sparse.CONV_TILE_ROWS,
                               dtype=torch.bool, device=nbr.device)
            rows[:per * sparse.CONV_TILE_ROWS] = True
            order = plan.order.long()
            hit = (nbr.gather(1, order[..., None].expand(-1, -1, k)) >= 0)
            pad = tiles * sparse.CONV_TILE_ROWS - mo
            hit = torch.cat([hit, hit.new_zeros((b, pad, k))], 1)
            left_out = hit.reshape(-1, k)[rows].sum().item()
            dropped[tuple(nbr.shape)] = (per, left_out / max(
                1, int(hit.sum().item())))
            plan = plan._replace(tile_taps=taps.reshape(b, tiles))
        return real(feats, nbr, g, plan, chunk)
    return smoke.patched((sparse, 'sparse_conv_dweights_cuda', faulty))


def fault_row(smoke, model, batch, name, fault, dropped=None):
    """``fault()`` planted in ``train_grad_errors``, ``compare_train_paths``
    and, with ``dropped`` (a K16 fault's record), ``check_sparse_dweights``
    on the step's calls."""
    label = f'FCAF3D seed 0, fault {name}'
    per_call = None
    with fault():
        _, _, errors, _, _, calls = smoke.train_grad_errors(model, batch,
                                                            label)
        if dropped is not None:
            try:
                smoke.check_sparse_dweights(calls['sparse_conv_dweights'])
                per_call = False
            except AssertionError as e:
                per_call = True
                print(f'{label}: check_sparse_dweights reported: '
                      f'{str(e)[:200]}', flush=True)
        del calls
    moved = [k / p for k, p in errors.values()
             if k > smoke.TRAIN_GRAD_BOUND]
    caught_below = max(moved, default=0.0)
    worst = sorted(((k / smoke.grad_bound(p), k, p, n)
                    for n, (k, p) in errors.items()), reverse=True)[:3]
    with fault():
        try:
            smoke.compare_train_paths(model, batch, label)
            reported = False
        except AssertionError as e:
            reported = True
            print(f'{label}: reported: {str(e)[:300]}', flush=True)
    extra = {} if dropped is None else dict(
        per_call_reported=per_call,
        dropped={str(k): v for k, v in dropped.items()})
    row = dict(fault=name, reported=reported, caught_below=caught_below,
               tensors_past_bound=sum(k > smoke.grad_bound(p)
                                      for k, p in errors.values()),
               worst=worst, **extra)
    print(f'{label}: reported {reported} at factor '
          f'{smoke.TRAIN_GRAD_NOISE:g}; {row["tensors_past_bound"]} tensors '
          f'past their bound; reported for any factor below '
          f'{caught_below:.3f}; the worst (error over bound, kernel, plain) '
          + ', '.join(f'{n} {r:.3g} {k:.2e} {p:.2e}' for r, k, p, n in worst)
          + (f'; {extra}' if extra else ''), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seeds', type=int, default=4)
    ap.add_argument('--faults', action='store_true')
    ap.add_argument('--out', default=os.path.join('build',
                                                  'train_grad_noise.json'))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('train_grad_noise: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    dev = torch.device('cuda', 0)
    rows = dict(noise=[], faults=[])
    if args.faults:
        model, _, _, batch = smoke.fcaf3d_trainer(dev, 0)
        rows['faults'].append(fault_row(
            smoke, model, batch, 'reverse_taps',
            lambda: reverse_taps_fault(smoke)))
        for width in (64, 512):
            dropped = {}
            rows['faults'].append(fault_row(
                smoke, model, batch, f'dweights_slice_{width}',
                lambda: dweights_slice_fault(smoke, width, dropped),
                dropped))
        del model, batch
        torch.cuda.empty_cache()
    for name, make in (('FCAF3D', smoke.fcaf3d_trainer),
                       ('DeMF-FCAF3D', smoke.demf_fcaf3d_trainer)):
        for seed in range(args.seeds):
            model, _, _, batch = make(dev, seed)
            rows['noise'].append(dict(model=name, seed=seed, **noise_row(
                smoke, model, batch, f'{name} seed {seed}')))
            del model, batch
            torch.cuda.empty_cache()
    runs = [r for r in rows['noise'] if r['unresolved']]
    if not runs:
        return write(args.out, rows)
    largest = max(runs, key=lambda r: r['largest'][0][0])
    smallest = min(runs, key=lambda r: r['smallest'][0][0])
    print(f'kernel / plain error ratio over {len(rows["noise"])} runs: '
          f'largest {largest["largest"][0][0]:.3f} ({largest["label"]}, '
          f'{largest["largest"][0][1]}), smallest '
          f'{smallest["smallest"][0][0]:.3f} ({smallest["label"]}, '
          f'{smallest["smallest"][0][1]}); TRAIN_GRAD_NOISE '
          f'{smoke.TRAIN_GRAD_NOISE:g}', flush=True)
    return write(args.out, rows)


def write(path, rows):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
