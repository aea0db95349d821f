"""Sorted-scan Pippenger MSM: bucket accumulation without scatter.

The port of the reference package's ``parallel/pippenger.py``.  Pippenger's
bucket accumulation is a scatter-add of points; this formulation replaces it
by a sort, a per-lane prefix scan and prefix differences.  For each
``c``-bit window w (digits d_i in [0, 2^c)):

  1. sort the points by digit (``torch.sort``) and gather their Niels
     records into sorted order, lane ``l`` owning the sorted positions
     ``[l*run, (l+1)*run)``;
  2. the prefix-scan kernel (``ops/scan.py``):
     ``stream[s, l] = sum of lane l's first s+1 sorted points``, n group
     additions, the bucket-accumulation cost;
  3. the window sum from the suffix-sum identity

         W_w = sum_i d_i P_i = sum_{t=1}^{2^c-1} S_t,
         S_t = sum_{d_i >= t} P_i = total - prefix(pos_t),
         pos_t = #{i : d_i < t}  (``torch.searchsorted`` on the sorted digits),

     ``prefix(pos) = lane_prefix_excl[pos // run] + stream[pos % run - 1,
     pos // run]``: (2^c - 1) gathered prefix points, one batched addition,
     one reduction tree, and ``2^c * total`` by c doublings.

The window sums are then folded into the result: on the card by
``ops/msm.py:fold_window_sums`` (one ``msm_fold`` launch over the
``ceil(252/c)`` sums), on the CPU by the reference's
``parallel.msm.horner_spine``; the same group element either way.

Where the port differs from the reference, and why:
  - the reference walks the windows in a ``lax.scan`` to bound TPU memory.
    Here the sort, the gather, the scan kernel and all the point arithmetic
    after it are batched over the window axis: each batched group addition
    is some 800 small launches on the card, so 16 windows in turn would be
    hundreds of thousands of launches.  At 2^20 points and 16-bit windows
    the sorted records take 5.5 GB and the stream 6.9 GB of the card's
    80 GB;
  - the lane prefixes (``lax.associative_scan`` there) are a log-depth
    doubling scan of batched group additions, as ``fields/mont.py`` scans
    products for ``batch_invert``;
  - the lane count is one wave of the card (``ops/scan.py:n_lanes``), not
    ``PIPPENGER_ROWS * 128``; a caller may pass ``lanes``;
  - the order of points among equal digits after the sort is not the
    reference's (``lax.sort_key_val(is_stable=False)`` leaves it open), so
    streams and window sums agree with the reference as group elements, after
    ``batch_normalize``, not limb for limb.

The reference's sorted-scan MSM failed on TPU hardware (its
``TPUTESTS_r05.json``), so the port holds this path to the oracle.
"""

from __future__ import annotations

import torch

from .. import config, stages
from ..curve.points import (ExtendedPoint, map_point, reduce_sum,
                            select_point)
from ..curve.scalar_mul import window_digits_wide
from ..fields import Fq, Fr
from ..fields.spec import NLIMBS
from ..ops.msm import fold_window_sums
from ..ops.scan import n_lanes, prefix_scan
from .msm import horner_spine

_NCOORDS = ("v_plus_u", "v_minus_u", "z", "t2d")


def _niels_records(points: ExtendedPoint) -> torch.Tensor:
    """(n,) extended points -> (n, 4*NLIMBS) int32 records, one row a point
    (v+u, v-u, z, 2dT), so that the per-window permutation is a gather of
    contiguous rows."""
    niels = points.to_niels()
    return torch.cat([getattr(niels, c).limbs.T for c in _NCOORDS], dim=1)


def _inclusive_scan(p: ExtendedPoint, axis: int) -> ExtendedPoint:
    """Inclusive running sums along a batch ``axis`` by recursive doubling:
    ceil(log2 n) batched group additions of (nearly) the whole batch."""
    larr = axis + 1  # limb axis is 0 on the raw planes
    n = p.shape[axis]
    d = 1
    while d < n:
        lo = map_point(lambda a: a.narrow(larr, 0, n - d), p)
        hi = map_point(lambda a: a.narrow(larr, d, n - d), p)
        s = lo.add_extended_niels(hi.to_niels())
        p = map_point(lambda a, b: torch.cat([a.narrow(larr, 0, d), b],
                                             dim=larr), p, s)
        d *= 2
    return p


def sorted_niels(points: ExtendedPoint, scalars: Fr, wbits: int,
                 lanes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps before the scan: pad the batch with identities (digit 0, which
    no threshold t >= 1 counts) to a multiple of ``lanes``, recode the
    scalars into unsigned ``wbits``-bit windows, sort each window's digits
    and gather the points' Niels records into that order.  Returns the scan
    kernel's input, int32 ``(4, NLIMBS, nwin, run, lanes)`` with lane ``l``
    holding the sorted positions ``[l*run, (l+1)*run)``, and the sorted
    digits ``(nwin, n_padded)``.  Stage marks "digits", "sort_gather"."""
    (n,) = points.shape
    dev = points.device
    pad = (-n) % lanes
    if pad:
        ident = ExtendedPoint.identity((pad,), dev)
        points = map_point(lambda a, i: torch.cat([a, i], dim=1), points,
                           ident)
        scalars = Fr(torch.cat([scalars.limbs, torch.zeros(
            (NLIMBS, pad), dtype=scalars.limbs.dtype, device=dev)], dim=1))
        n += pad
    run = n // lanes
    recs = _niels_records(points)                      # (n, 80)
    digits = window_digits_wide(scalars, wbits)        # (nwin, n)
    nwin = digits.shape[0]
    stages.mark("digits")
    sd, si = torch.sort(digits, dim=1)
    g = si.reshape(nwin, lanes, run).transpose(1, 2)   # (nwin, run, lanes)
    niels = (recs[g].permute(3, 0, 1, 2)
             .reshape(4, NLIMBS, nwin, run, lanes).contiguous())
    stages.mark("sort_gather")
    return niels, sd


def window_sums_sorted(points: ExtendedPoint, scalars: Fr,
                       wbits: int | None = None,
                       lanes: int | None = None) -> ExtendedPoint:
    """Per-window digit-weighted sums ``W_w = sum_i digit_w(k_i) * P_i``
    over unsigned ``wbits``-bit windows (default
    ``config.PIPPENGER_WBITS``) via sorted-scan bucket accumulation: an
    ExtendedPoint batch of shape (ceil(252/wbits),).  ``lanes`` (default:
    one wave of the card) lanes scan ``ceil(n/lanes)`` sorted points each.
    Stage marks (``stages``): "digits", "sort_gather", "scan_kernel",
    "lane_prefixes", "suffix_sums"."""
    wbits = config.PIPPENGER_WBITS if wbits is None else wbits
    if len(points.shape) != 1 or scalars.shape != points.shape:
        raise ValueError(f"window_sums_sorted: points and scalars must be "
                         f"batches of shape (N,), got {points.shape} and "
                         f"{scalars.shape}")
    if not 1 <= wbits <= 16:
        raise ValueError(f"window_sums_sorted: wbits must lie in [1, 16], "
                         f"got {wbits}")
    dev = points.device
    lanes = n_lanes(points.shape[0], dev) if lanes is None else lanes
    if lanes < 1:
        raise ValueError("window_sums_sorted: lanes must be positive")
    niels, sd = sorted_niels(points, scalars, wbits, lanes)
    nwin, n = sd.shape
    run = n // lanes
    nthr = (1 << wbits) - 1

    stream = prefix_scan(niels)                        # (5, NLIMBS, nwin, run, lanes)
    del niels
    stages.mark("scan_kernel")

    # lane totals -> inclusive / exclusive lane prefixes, (nwin, lanes)
    lane_tot = ExtendedPoint(*[Fq(stream[c, :, :, run - 1]) for c in range(5)])
    incl = _inclusive_scan(lane_tot, axis=1)
    excl = map_point(lambda i, a: torch.cat([i, a[:, :, :-1]], dim=2),
                     ExtendedPoint.identity((nwin, 1), dev), incl)
    total = map_point(lambda a: a[:, :, -1], incl)      # (nwin,)
    stages.mark("lane_prefixes")

    # pos_t = #{digits < t}; prefix(pos_t) from the stream, total where
    # pos_t == n (no digit >= t)
    thresholds = torch.arange(1, nthr + 1, dtype=sd.dtype, device=dev)
    pos = torch.searchsorted(sd, thresholds.expand(nwin, nthr).contiguous(),
                             side="left")               # (nwin, nthr)
    full = pos == n
    posc = pos.clamp(max=n - 1)
    lq, s_in = posc // run, posc % run
    ws = (s_in - 1).clamp(min=0)
    win = torch.arange(nwin, device=dev)[:, None]
    within = ExtendedPoint(*[Fq(stream[c][:, win, ws, lq]) for c in range(5)])
    within = select_point(s_in == 0,
                          ExtendedPoint.identity((nwin, nthr), dev), within)
    excl_at = map_point(lambda a: a[:, win, lq], excl)
    prefix_t = excl_at.add_extended_niels(within.to_niels())
    prefix_t = select_point(
        full, map_point(lambda a: a[:, :, None].expand(NLIMBS, nwin, nthr),
                        total), prefix_t)
    del stream

    # W = 2^c * total - total - sum_t prefix_t
    sum_prefix = reduce_sum(prefix_t, axis=1)
    tot2c = total
    for _ in range(wbits):
        tot2c = tot2c.double()
    w = tot2c.sub_extended_niels(total.to_niels())
    w = w.sub_extended_niels(sum_prefix.to_niels())
    stages.mark("suffix_sums")
    return w


def msm_pippenger(points: ExtendedPoint, scalars: Fr,
                  wbits: int | None = None,
                  lanes: int | None = None) -> ExtendedPoint:
    """Single-device MSM ``sum_i scalars_i * points_i`` via sorted-scan
    bucket accumulation, then the spine (stage mark "spine"): on the card
    ``fold_window_sums``, on the CPU the reference's ``horner_spine``."""
    wbits = config.PIPPENGER_WBITS if wbits is None else wbits
    ws = window_sums_sorted(points, scalars, wbits=wbits, lanes=lanes)
    if ws.device.type == "cuda":
        out = fold_window_sums(ws, wbits)
    else:
        out = horner_spine(ws, wbits=wbits)
    stages.mark("spine")
    return out
