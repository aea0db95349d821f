"""``msm_window_sums``: the window sums of a multi-scalar multiplication.

Replaces the reference package's ``ops/pallas_msm.py`` kernel
(``_window_sums_kernel``), signed and unsigned, and ports the functions
around it (``window_sums_fused``, ``msm_fused``).  Source: ``csrc/msm.cu``
over ``csrc/point.cuh`` and ``csrc/field.cuh``.

``W_w = sum_i digit_w(k_i) * P_i`` for every window ``w``.  Signed (the
default): 5-bit digits in [-15, 16], 51 windows, a per-point table of the
magnitudes [1..16]P.  Unsigned: 4-bit digits, 63 windows, a table [0..15]P.

Decomposition.  A block of two groups (``MSM_GROUPS``) of 64 threads owns a
contiguous range of ``P = ceil(N / blocks)`` points; thread ``w`` of group
``g`` keeps a partial sum of window ``w`` in registers for the whole launch,
over the block's points whose index in the range is ``g`` modulo 2.  The
block walks its range in chunks of ``CHUNK`` points: the chunk's digit rows
go to shared memory, each of ``CHUNK`` threads builds one point's multiples
table into shared memory (packed two limbs a word), and then every window
thread adds, point by point in order, the entry its digit selects.  At the
end group 0 adds group 1's partial (as a Niels point), so the output is one
partial a window a block, ``(5, 20, nwin, blocks)``: 264 a window at 2^20
points on an H100 instead of the 33792 of a per-thread design, which
``msm_reduce`` sums.  Nothing needs padding: a batch of any size, 1
included, splits into blocks as it is, and a block without points gives the
identity.

``CHUNK`` and ``BLOCKS_PER_SM`` are constants of this module, chosen by
``chip_smoke.py --sweep`` on an H100: see their notes.  Of the reference's
knobs, ``MSM_WGROUP``, ``MSM_GROUPS_INNER`` and ``MSM_BLOCK_ROWS`` are not
carried over: the window groups, the two grid orders and the block rows
exist to fit the TPU kernel into 16 MB of scoped VMEM and its sequential
grid (``config.py:58-68`` there).

What bounds it on an H100, signed 5-bit windows: a point costs 560 field
multiplications (``to_niels`` of the point, 15 table additions with their
``to_niels``, 51 window additions), about 0.43 M int32 multiply-adds, or
about 27 ms for 2^20 points at the int32 rate ``chip_smoke.py`` uses.  The
device traffic is the input, 400 B a point (0.4 GB at 2^20 points), and the
partials: operations bound it.  The select is still a scan of every entry
of the table with masked selects, so no address depends on a digit; since
all window threads of a block read the same point's table at once, each
word of the scan is one broadcast read from shared memory for the block.

The tail (``csrc/msm_tail.cu``).  ``msm_reduce`` sums the partials of
each window, one block of threads a window, in ``reduce_sum``'s tree order;
``msm_fold`` folds the window sums as ``sum_w [2^(wbits*w)] W_w`` by Horner
from the most significant window, on one thread.  Each is one launch where
the plain PyTorch trees took some 5,800 and 4,300 a call, paced by the
host.  The fold gives the group element of the reference's spine
(``parallel.msm.horner_spine``), not its limbs: that spine starts from the
identity and adds it between the windows.

Plain versions: ``window_sums_plain``, the same tables, selects and
additions in the kernel's order, in plain PyTorch; ``reduce_sum`` for
``msm_reduce``; ``fold_plain`` for ``msm_fold``.  A CPU tensor takes them; a
CUDA tensor launches the kernel or raises.  Each kernel's result is its
plain version's limb for limb.
"""

from __future__ import annotations

import torch

from .. import config, stages
from ..device import sm_count
from ..curve.points import (ExtendedNielsPoint, ExtendedPoint, map_point,
                            reduce_sum)
from ..curve.scalar_mul import (_stack_points, _take_entry,
                                signed_digit_windows,
                                signed_window_digits_wide, take_signed,
                                window_digits_wide)
from ..fields import Fq, Fr, mont
from ..fields.spec import NLIMBS
from . import _build

_COORDS = ("u", "v", "z", "t1", "t2")
MAX_ENTRIES = 32   # csrc/msm.cu: MSM_MAX_ENTRIES
MSM_WINDOWS = 64   # csrc/msm.cu: threads a group, one a window (nwin <= 64)
MSM_GROUPS = 2     # csrc/msm.cu: groups a block
REDUCE_MAX_BLOCKS = 512  # csrc/msm_tail.cu: partials a window (shared memory)
# Points a chunk: the points whose tables a block holds in shared memory at
# once (2.5 KB a point at 16 entries), a multiple of MSM_GROUPS.  The table
# build runs on CHUNK threads while the others wait, so a larger chunk
# spreads that phase over more points, but takes more shared memory and so
# leaves fewer blocks on an SM.  Blocks an SM: the grid is this many blocks
# on each SM of the card (231 registers a thread allow two blocks of 128).
# Both chosen by chip_smoke.py --sweep on an H100 80GB HBM3 (PERF.md).
CHUNK = 32
BLOCKS_PER_SM = 2
# points whose tables and selects the plain version computes at once
PLAIN_POINTS = 16384


def n_entries(wbits: int, signed: bool) -> int:
    """Entries of the kernel's per-point table: the magnitudes
    1..2^(w-1) (signed) or 1..2^w - 1 (unsigned; digit 0 is the identity,
    taken from constants)."""
    return 1 << (wbits - 1) if signed else (1 << wbits) - 1


def n_windows(wbits: int, signed: bool) -> int:
    return signed_digit_windows(wbits) if signed else -(-252 // wbits)


def n_blocks(n: int, device) -> int:
    """Blocks of the kernel for a batch of ``n`` points on ``device``:
    ``BLOCKS_PER_SM`` on each SM of the card, and no more than there are
    chunks of points.  The CPU's plain version splits the points as an H100
    SXM would."""
    return max(1, min(-(-n // CHUNK), sm_count(device) * BLOCKS_PER_SM))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _multiples_niels(base: ExtendedPoint, wbits: int, signed: bool):
    """The per-point table as stacked ExtendedNielsPoints (leading axis the
    entries): unsigned [0..2^w - 1]P (entry 0 the identity, which the kernel
    takes from constants), signed [1..2^(w-1)]P."""
    base_n = base.to_niels()
    if signed:
        entries, size = [base_n], n_entries(wbits, signed)
    else:
        entries = [ExtendedNielsPoint.identity(base.shape, base.device), base_n]
        size = 1 << wbits
    acc = base
    while len(entries) < size:
        acc = acc.add_extended_niels(base_n)
        entries.append(acc.to_niels())
    return _stack_points(entries)


def _select(table, digits: torch.Tensor, signed: bool) -> ExtendedNielsPoint:
    """Entries for digits ``(nwin, n)`` from a table of planes
    ``(T, NLIMBS, n)``: a select tree over all entries, then (signed) the
    masked Niels negation and the identity override of digit 0."""
    table_b = map_point(lambda a: a[:, :, None, :], table)
    if not signed:
        return _take_entry(table_b, digits)
    return take_signed(table_b, digits)


def window_sums_plain(planes, digits: torch.Tensor, wbits: int, signed: bool,
                      blocks: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: points ``(u, v, z, t1*t2)``, each
    (NLIMBS, N), digits (nwin, N) -> partial sums (5, NLIMBS, nwin, blocks).
    Block ``b`` owns the points ``[b*P, min(N, (b+1)*P))``, ``P = ceil(N /
    blocks)``; its group ``g`` adds, in order, those whose index in the range
    is ``g`` modulo ``MSM_GROUPS``, all windows at once (step ``r`` adds the
    ``r``-th point of every group that has one); group 0's sum then takes in
    each other group's as a Niels point.  Computes in plain PyTorch wherever
    the tensors lie."""
    u, v, z, t = planes
    nwin, n = digits.shape
    dev = digits.device
    per = -(-n // blocks)
    parts = blocks * MSM_GROUPS
    q = torch.arange(parts, device=dev)
    first = q // MSM_GROUPS * per + q % MSM_GROUPS  # partial q's first point
    end = torch.clamp((q // MSM_GROUPS + 1) * per, max=n)
    steps = -(-per // MSM_GROUPS)
    ranks = max(1, PLAIN_POINTS // parts)  # steps whose entries go together
    with mont.plain_only():
        acc = ExtendedPoint.identity((nwin, parts), dev)
        for r0 in range(0, steps, ranks):
            rs = torch.arange(r0, min(steps, r0 + ranks), device=dev)
            idx = first[None, :] + MSM_GROUPS * rs[:, None]   # (R, parts)
            valid = idx < end[None, :]
            cols = idx[valid]                                 # step-major
            base = ExtendedPoint(u=Fq(u[:, cols]), v=Fq(v[:, cols]),
                                 z=Fq(z[:, cols]), t1=Fq(t[:, cols]),
                                 t2=Fq.one((len(cols),), dev))
            sel = _select(_multiples_niels(base, wbits, signed),
                          digits[:, cols], signed)
            off = 0
            for row in valid:
                pos = row.nonzero().squeeze(1)
                cnt = len(pos)
                step = map_point(lambda a: a[:, :, off:off + cnt], sel)
                new = map_point(lambda a: a[:, :, pos], acc) \
                    .add_extended_niels(step)
                acc = map_point(lambda a, b: a.index_copy(2, pos, b),
                                acc, new)
                off += cnt
        grouped = map_point(
            lambda a: a.reshape(NLIMBS, nwin, blocks, MSM_GROUPS), acc)
        out = map_point(lambda a: a[..., 0], grouped)
        for g in range(1, MSM_GROUPS):
            out = out.add_extended_niels(
                map_point(lambda a: a[..., g], grouped).to_niels())
    return torch.stack([getattr(out, c).limbs for c in _COORDS])


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def msm_window_sums(planes, digits: torch.Tensor, wbits: int, signed: bool,
                    blocks: int) -> torch.Tensor:
    """Per-block partial window sums.  ``planes``: (u, v, z, t1*t2), each
    int32 (NLIMBS, N); ``digits``: int32 (nwin, N), least significant window
    first.  Returns int32 (5, NLIMBS, nwin, blocks): the extended
    coordinates of block ``b``'s sum over the points ``[b*P, (b+1)*P)``,
    ``P = ceil(N / blocks)`` (the identity where that range is empty), in
    the kernel's order (``window_sums_plain``)."""
    planes = tuple(planes)
    if len(planes) != 4:
        raise ValueError("msm_window_sums: expected the planes u, v, z, t1*t2")
    nwin = n_windows(wbits, signed)
    if digits.dtype != torch.int32 or digits.ndim != 2 or digits.shape[0] != nwin:
        raise ValueError(f"msm_window_sums: digits must be int32 ({nwin}, N), "
                         f"got {digits.dtype} {tuple(digits.shape)}")
    n = digits.shape[1]
    for x in planes:
        if x.dtype != torch.int32 or tuple(x.shape) != (NLIMBS, n):
            raise ValueError(f"msm_window_sums: each coordinate must be int32 "
                             f"({NLIMBS}, {n}), got {x.dtype} {tuple(x.shape)}")
        if x.device != digits.device:
            raise ValueError("msm_window_sums: points and digits on different "
                             "devices")
    if blocks < 1:
        raise ValueError(f"msm_window_sums: blocks must be positive, got "
                         f"{blocks}")
    if nwin > MSM_WINDOWS:
        raise ValueError(f"msm_window_sums: at most {MSM_WINDOWS} windows (one "
                         f"thread each), got {nwin}")
    nentries = n_entries(wbits, signed)
    if nentries > MAX_ENTRIES:
        raise ValueError(f"msm_window_sums: at most {MAX_ENTRIES} table "
                         f"entries (the kernel's limit), got {nentries}")
    if not digits.is_cuda:
        return window_sums_plain(planes, digits, wbits, signed, blocks)
    planes = [x.contiguous() for x in planes]
    digits = digits.contiguous()
    dev = digits.device
    out = torch.empty((5, NLIMBS, nwin, blocks), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library("msm").jj_msm_window_sums(
            *[x.data_ptr() for x in planes], digits.data_ptr(), nwin, n,
            int(signed), nentries, out.data_ptr(), blocks, CHUNK,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "msm_window_sums")
    msm_window_sums.launches += 1
    return out


msm_window_sums.launches = 0


# ---------------------------------------------------------------------------
# The tail: the partials' reduction and the fold
# ---------------------------------------------------------------------------

def _point(planes: torch.Tensor) -> ExtendedPoint:
    return ExtendedPoint(*[Fq(planes[c]) for c in range(5)])


def _planes(p: ExtendedPoint) -> torch.Tensor:
    return torch.stack([getattr(p, c).limbs for c in _COORDS])


def msm_reduce_plain(partials: torch.Tensor) -> torch.Tensor:
    """``msm_reduce``'s plain version: ``reduce_sum`` over the blocks, in
    plain PyTorch wherever the tensors lie."""
    with mont.plain_only():
        return _planes(reduce_sum(_point(partials), axis=1))


def fold_plain(wsums: torch.Tensor, wbits: int) -> torch.Tensor:
    """``msm_fold``'s plain version: ``sum_w [2^(wbits*w)] W_w`` of window
    sums (5, NLIMBS, nwin) by Horner from the most significant window (acc
    = W_{nwin-1}; then, for each lower window, ``wbits`` doublings and the
    addition of W_w as an extended Niels point), in plain PyTorch wherever
    the tensors lie."""
    ws = _point(wsums)
    with mont.plain_only():
        acc = map_point(lambda a: a[:, -1], ws)
        for w in range(wsums.shape[2] - 2, -1, -1):
            for _ in range(wbits):
                acc = acc.double()
            acc = acc.add_extended_niels(
                map_point(lambda a: a[:, w], ws).to_niels())
    return _planes(acc)


def msm_reduce(partials: torch.Tensor) -> torch.Tensor:
    """Window sums from the window-sums kernel's partials: int32 (5, NLIMBS,
    nwin, blocks) -> (5, NLIMBS, nwin), each window's partials summed in
    ``reduce_sum``'s order (``msm_reduce_plain``)."""
    if (partials.dtype != torch.int32 or partials.ndim != 4
            or tuple(partials.shape[:2]) != (5, NLIMBS)):
        raise ValueError(f"msm_reduce: partials must be int32 (5, {NLIMBS}, "
                         f"nwin, blocks), got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    _, _, nwin, blocks = partials.shape
    if nwin < 1 or not 1 <= blocks <= REDUCE_MAX_BLOCKS:
        raise ValueError(f"msm_reduce: at least one window and 1 to "
                         f"{REDUCE_MAX_BLOCKS} blocks, got {nwin} and "
                         f"{blocks}")
    if not partials.is_cuda:
        return msm_reduce_plain(partials)
    partials = partials.contiguous()
    out = torch.empty((5, NLIMBS, nwin), dtype=torch.int32,
                      device=partials.device)
    with torch.cuda.device(partials.device):
        rc = _build.library("msm_tail").jj_msm_reduce(
            partials.data_ptr(), nwin, blocks, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "msm_reduce")
    msm_reduce.launches += 1
    return out


msm_reduce.launches = 0


def msm_fold(wsums: torch.Tensor, wbits: int) -> torch.Tensor:
    """``sum_w [2^(wbits*w)] W_w`` of window sums int32 (5, NLIMBS, nwin):
    one point, (5, NLIMBS), by ``fold_plain``'s steps."""
    if (wsums.dtype != torch.int32 or wsums.ndim != 3
            or tuple(wsums.shape[:2]) != (5, NLIMBS) or wsums.shape[2] < 1):
        raise ValueError(f"msm_fold: window sums must be int32 (5, {NLIMBS}, "
                         f"nwin >= 1), got {wsums.dtype} "
                         f"{tuple(wsums.shape)}")
    if wbits < 1:
        raise ValueError(f"msm_fold: wbits must be positive, got {wbits}")
    if not wsums.is_cuda:
        return fold_plain(wsums, wbits)
    wsums = wsums.contiguous()
    out = torch.empty((5, NLIMBS), dtype=torch.int32, device=wsums.device)
    with torch.cuda.device(wsums.device):
        rc = _build.library("msm_tail").jj_msm_fold(
            wsums.data_ptr(), wsums.shape[2], wbits, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "msm_fold")
    msm_fold.launches += 1
    return out


msm_fold.launches = 0


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def window_sums_fused(points: ExtendedPoint, scalars: Fr,
                      wbits: int | None = None, signed: bool | None = None
                      ) -> ExtendedPoint:
    """Per-window digit-weighted sums ``W_w = sum_i digit_w(k_i) * P_i`` of a
    batch of shape (N,): an ExtendedPoint batch of shape (nwin,).  Defaults
    come from ``jubjub_tpu_torch.config``.  Stage marks (``stages``):
    "digits", "window_sums_kernel", "partial_reduction"."""
    wbits = config.MSM_WBITS if wbits is None else wbits
    signed = config.MSM_SIGNED if signed is None else signed
    if len(points.shape) != 1 or scalars.shape != points.shape:
        raise ValueError(f"window_sums_fused: points and scalars must be "
                         f"batches of shape (N,), got {points.shape} and "
                         f"{scalars.shape}")
    (n,) = points.shape
    nwin = n_windows(wbits, signed)
    t = points.t1 * points.t2
    recode = signed_window_digits_wide if signed else window_digits_wide
    digits = recode(scalars, wbits).reshape(nwin, n)
    stages.mark("digits")
    acc = msm_window_sums((points.u.limbs, points.v.limbs, points.z.limbs,
                           t.limbs), digits, wbits, signed,
                          n_blocks(n, digits.device))
    stages.mark("window_sums_kernel")
    out = _point(msm_reduce(acc))
    stages.mark("partial_reduction")
    return out


def fold_window_sums(wsums: ExtendedPoint, wbits: int) -> ExtendedPoint:
    """``sum_w [2^(wbits*w)] W_w`` for window sums of shape (nwin,):
    ``msm_fold``, one launch on the card.  The same group element as
    ``parallel.msm.horner_spine``."""
    if len(wsums.shape) != 1:
        raise ValueError(f"fold_window_sums: expected window sums of shape "
                         f"(nwin,), got {wsums.shape}")
    return _point(msm_fold(_planes(wsums), wbits))


def msm_fused(points: ExtendedPoint, scalars: Fr, wbits: int | None = None,
              signed: bool | None = None) -> ExtendedPoint:
    """``sum_i scalars_i * points_i`` through the window-sums kernel, the
    partials' reduction and the fold (stage mark "spine")."""
    wbits = config.MSM_WBITS if wbits is None else wbits
    out = fold_window_sums(
        window_sums_fused(points, scalars, wbits, signed), wbits)
    stages.mark("spine")
    return out
