"""Multi-scalar multiplication (MSM) at tensor level, single device and
sharded over the ranks of a process group.

No counterpart in the reference crate; the port of the reference package's
``parallel/msm.py``, whose values it reproduces limb for limb.  Windowed
Horner with per-chunk multiples tables ("Pippenger without scatter"): for
each chunk of C points build the 16-entry table [0..15]P_i (15 additions),
select every 4-bit window's entry for all 63 windows at once and reduce over
the chunk; only the final 252 Horner doublings run on one accumulator.

This is the reference package's second algorithm, beside the fused kernel
path of ``ops/msm.py`` (which ``msm_fused`` takes and which is the one a
caller on the card should use: here every step is a handful of launches).

``msm_sharded`` is the reference's mesh-sharded MSM over
``torch.distributed`` instead of ``shard_map``: each rank holds a shard of
the points and scalars, computes its window sums, and one ``all_gather`` of
the (nwin,) window-sum planes (5 x 20 x nwin int32 words a rank, whatever
the shard's size) crosses between ranks; the reduction over the ranks and
the spine then run on every rank, so every rank returns the same point.
The process group carries the axis name the reference's mesh had.
"""

from __future__ import annotations

import torch

from .. import config, stages
from ..curve.points import (ExtendedNielsPoint, ExtendedPoint, map_point,
                            reduce_sum)
from ..curve.scalar_mul import (NWINDOWS, _stack_points, _take_entry,
                                window_digits)
from ..fields import Fq, Fr
from ..fields.spec import NLIMBS
from ..ops.msm import fold_window_sums, window_sums_fused

_COORDS = ("u", "v", "z", "t1", "t2")
ALGORITHMS = ("fused", "sorted", "torch")


def _multiples_table(p: ExtendedPoint) -> ExtendedPoint:
    """[0]P..[15]P stacked as extended points (leading axis 16)."""
    pn = p.to_niels()
    mults = [ExtendedPoint.identity(p.shape, p.device)]
    acc = p
    for _ in range(15):
        mults.append(acc)
        acc = acc.add_extended_niels(pn)
    return _stack_points(mults)


def window_sums(points: ExtendedPoint, scalars: Fr, chunk: int | None = None,
                sequential: bool = False) -> ExtendedPoint:
    """Per-window digit-weighted sums W_w = sum_i digit_w(k_i) * P_i over
    unsigned 4-bit windows: an ExtendedPoint batch of shape (63,).  Points
    go in chunks of ``chunk`` (``config.MSM_CHUNK``); a ragged last chunk is
    padded with identity points and zero scalars, each pad built with its
    own explicit shape."""
    chunk = config.MSM_CHUNK if chunk is None else chunk
    (n,) = points.shape
    dev = points.device
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        ident = ExtendedPoint.identity((pad,), dev)
        points = map_point(lambda a, i: torch.cat([a, i], dim=1), points, ident)
        scalars = Fr(torch.cat([scalars.limbs, torch.zeros(
            (NLIMBS, pad), dtype=scalars.limbs.dtype, device=dev)], dim=1))
        n += pad
    digits = window_digits(scalars)  # (63, n)

    acc = ExtendedPoint.identity((NWINDOWS,), dev)
    for c0 in range(0, n, chunk):
        pts = map_point(lambda a: a[:, c0:c0 + chunk], points)
        table = _multiples_table(pts)  # planes (16, NLIMBS, chunk)
        # all 63 windows' selections in one select tree: (NLIMBS, 63, chunk)
        table_b = map_point(lambda a: a[:, :, None, :], table)
        sel = _take_entry(table_b, digits[:, c0:c0 + chunk])
        s = reduce_sum(sel, axis=1, sequential=sequential)  # (63,) points
        acc = acc.add_extended_niels(s.to_niels())
    return acc


def horner_spine(wsums: ExtendedPoint, wbits: int = 4) -> ExtendedPoint:
    """Fold the window sums, S = sum_w 2^(w*wbits) W_w, MSB first: wbits*nwin
    steps of (double, add), where all but every wbits-th operand is the
    Niels identity (the reference package's schedule)."""
    (nwin,) = wsums.shape
    niels = wsums.to_niels()
    ident = ExtendedNielsPoint.identity((), wsums.device)
    acc = ExtendedPoint.identity((), wsums.device)
    for step in range(wbits * nwin):
        if step % wbits == wbits - 1:
            w = nwin - 1 - step // wbits
            x = map_point(lambda a: a[:, w], niels)
        else:
            x = ident
        acc = acc.double().add_extended_niels(x)
    return acc


def msm(points: ExtendedPoint, scalars: Fr, chunk: int | None = None,
        sequential: bool = False) -> ExtendedPoint:
    """Single-device MSM: sum_i scalars_i * points_i."""
    return horner_spine(window_sums(points, scalars, chunk=chunk,
                                    sequential=sequential))


# ---------------------------------------------------------------------------
# Sharded over the ranks of a process group
# ---------------------------------------------------------------------------

def msm_sharded(points: ExtendedPoint, scalars: Fr, group=None,
                chunk: int | None = None, sequential: bool = False,
                algorithm: str | None = None) -> ExtendedPoint:
    """``sum_i scalars_i * points_i`` over the shards of every rank of
    ``group`` (default: the default process group): ``points`` and
    ``scalars`` are this rank's shard, batches of shape (N,).  Returns the
    same point on every rank.

    ``algorithm`` selects the rank's window sums:
      - "fused": ``ops/msm.py:window_sums_fused``, the window-sums kernel on
        a CUDA tensor, ``config.MSM_WBITS``;
      - "sorted": ``parallel/pippenger.py:window_sums_sorted``, the prefix-scan
        kernel, ``config.PIPPENGER_WBITS``;
      - "torch": ``window_sums`` (the reference's "xla"), 4-bit, with
        ``chunk`` and ``sequential``.
    The default follows the tensors' device, as the reference's follows its
    mesh's platform: "fused" on the card, "torch" on the CPU.  Then one
    ``all_gather`` of the window sums in rank order (NCCL on the card; gloo
    takes CPU tensors and CUDA ones, which it moves through host memory
    itself), ``reduce_sum`` over the ranks (the reference's ``axis=0``), and
    the spine: on the CPU the reference's ``horner_spine``, limb for limb
    its result; on the card ``ops/msm.py:fold_window_sums`` (one
    ``msm_fold`` launch), the same group element, as ``msm_pippenger``
    does.  Stage marks
    (``stages``): the window sums' own, then "window_sums", "all_gather",
    "reduce_sum", "spine"."""
    import torch.distributed as dist
    if algorithm is None:
        algorithm = "fused" if points.device.type == "cuda" else "torch"
    if algorithm not in ALGORITHMS:
        raise ValueError(f"msm_sharded: algorithm must be one of "
                         f"{ALGORITHMS}, got {algorithm!r}")
    if algorithm == "fused":
        wbits = config.MSM_WBITS
        ws = window_sums_fused(points, scalars, wbits)
    elif algorithm == "sorted":
        from .pippenger import window_sums_sorted
        wbits = config.PIPPENGER_WBITS
        ws = window_sums_sorted(points, scalars, wbits)
    else:
        wbits = 4
        ws = window_sums(points, scalars, chunk=chunk, sequential=sequential)
    stages.mark("window_sums")
    planes = torch.stack([getattr(ws, c).limbs for c in _COORDS])
    parts = [torch.empty_like(planes)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, planes, group=group)
    gathered = torch.stack(parts, dim=2)         # (5, NLIMBS, ranks, nwin)
    stages.mark("all_gather")
    total = reduce_sum(ExtendedPoint(*[Fq(gathered[c]) for c in range(5)]),
                       axis=0, sequential=sequential)
    stages.mark("reduce_sum")
    if total.device.type == "cuda":
        out = fold_window_sums(total, wbits)
    else:
        out = horner_spine(total, wbits=wbits)
    stages.mark("spine")
    return out
