"""Where K12 (the RoIAlign's backward) spends its time at the image-only
step's shape:

    python -m demf_tpu_torch.tools.k12_phases

Where no kernel profiler is at hand: this builds ``csrc/roi_align.cu``
with one phase of its tiles kernel after another taken out
(``-DK12_SKIP=n``: a loop bound that is never true at run time, so the
compiler keeps the rest as it is) and times each through the wrapper on
the same inputs, with its kernels' device ms: 512 RoIs a scene spread and
piled onto one box at batch 16, spread at batch 2
(``tools/roi_cases.py``).  The differences between neighbouring lines are
the phases' times.  Only the first line computes the right result; the
copies go to ``build/kernels/k12_phases`` and are used nowhere else.  Each
case's tile lists are described first (``ops/roi_align.py::k12_lists``).
Prints its lines and returns the rows.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

from ..ops import _cuda, roi_align
from . import cuda_device, device_kernels, time_ms
from .roi_cases import ROI_STRIDES, SAMPLED_ROIS, k12_case

# what is left with -DK12_SKIP=n (csrc/roi_align.cu)
LEFT = (
    'the whole kernel',
    'without the sums (the scan of the RoIs and the writes)',
    'and without the scan (the writes of the tiles alone)',
)
CASES = ((16, 'spread'), (16, 'piled'), (2, 'spread'))


def build_variants():
    """-> [(what is left, path of its shared library)]"""
    out_dir = os.path.join(_cuda.BUILD_DIR, 'k12_phases')
    os.makedirs(out_dir, exist_ok=True)
    source = os.path.join(_cuda.CSRC_DIR, 'roi_align.cu')
    built, procs = [], []
    for skip, what in enumerate(LEFT):
        path = os.path.join(out_dir, f'skip{skip}.so')
        procs.append(subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f'-DK12_SKIP={skip}',
             '-shared', '-o', path, source], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        built.append((what, path))
    for (what, _), proc in zip(built, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on "{what}":\n{err[-3000:]}')
    return built


def main(argv=None):
    dev = cuda_device()
    kernel = roi_align.ROI_ALIGN_BACKWARD_KERNEL
    kept = kernel._fn  # the library's entry, put back at the end
    rows = []
    try:
        variants = build_variants()
        for b, kind in CASES:
            d_out, shapes, rois, lvl = k12_case(dev, b, kind, seed=b)
            n = roi_align.k12_lists(shapes, rois, lvl, ROI_STRIDES)['tile_n']
            _, chunks = roi_align.k12_chunks(
                n, roi_align.K12_CHUNK, roi_align.k12_slots(
                    b, SAMPLED_ROIS, shapes, shapes[0][-1], 7,
                    roi_align.K12_CHUNK))
            bins = b * SAMPLED_ROIS * 49
            print(f'K12 {kind} RoIs (B {b}, {SAMPLED_ROIS} RoIs): '
                  f'{n.numel()} tiles, {int((n > 0).sum())} with entries, '
                  f'{int(n.sum())} entries ({int(n.sum()) / bins:.2f} a '
                  f'bin), the longest list {int(n.max())}, '
                  f'{int(chunks.sum())} work items, '
                  f'{int((chunks > 1).sum())} tiles cut into chunks',
                  flush=True)
            for what, path in variants:
                fn = ctypes.CDLL(path).demf_roi_align_backward
                fn.argtypes = kernel.argtypes + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                kernel._fn = fn

                def run():
                    return roi_align.pyramid_roi_align_backward_cuda(
                        d_out, shapes, rois, lvl, ROI_STRIDES)

                ms = time_ms(run, 20)
                tiles_ms = sum(t for k, (_, t) in device_kernels(run).items()
                               if k.startswith('roi_align_backward_tiles'))
                rows.append(dict(b=b, kind=kind, left=what, ms=ms,
                                 tiles_ms=tiles_ms))
                print(f'  {what}: {ms:.4f} ms through the wrapper, the '
                      f'tiles kernel {tiles_ms:.4f} ms on the device',
                      flush=True)
    finally:
        kernel._fn = kept
    return rows


if __name__ == '__main__':
    main()
