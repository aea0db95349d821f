"""Sapling bundle validation: the Jubjub work a Zcash node does for every
Sapling transaction of a batch.

Sources: the Zcash Protocol Spec, 4.4 (Spend descriptions), 4.5 (Output
descriptions), 4.13 (balance and binding signature), 5.4.7 (RedDSA) and B.1
(RedDSA batch validation); the consensus rules that cv, rk and epk are
canonical encodings (ZIP 216) of points not of small order; the
zcash/redjubjub crate's ``batch::Verifier``, which takes spend-authorisation
and binding items in one batch, each kind with its own basepoint.

For the transactions t of a batch, ``verify_bundles``

1. decodes every spend's cv, rk and signature R, every output's cv and epk
   and every binding signature's R, in one ``affine_from_bytes``;
2. applies the small-order rule, [8]P != O, to cv, rk and epk: a
   transaction with an encoding that names no point, a cv, rk or epk of
   small order, or a scalar that is not canonical is invalid (``ok`` false)
   and stays out of the batch equation;
3. forms bvk_t = sum cv_spend - sum cv_output - [valueBalance_t] V, one
   segment a transaction (``segment_sum``), and encodes it: the binding
   signature's challenge hashes repr(bvk);
4. checks every kept signature in one equation over two basepoints, G for
   spend authorisation and R for the value commitments' randomness:

       [8] (sum_j [z_j] R_j + [z_j c_j] rk_j
            + sum_t [z_t] R_t + [z_t c_t] bvk_t
            - [sum_j z_j S_j] G - [sum_t z_t S_t] R)

   whose encoding is that of the identity when every kept signature is
   valid.  The caller forms the products z c and z S (the crate forms them on
   the CPU); the card drops those of invalid transactions and sums the z S of
   each kind mod r, and the two basepoints join the multiscalar
   multiplication as two more points, negated.  Those two sums come back
   too: every kept signature's z S is in them, so they show which
   signatures the equation held, which its point cannot show where the
   signatures are valid (their terms sum to the identity whether they are
   in or out).

Nothing is read back from the card before the answers: the transactions'
offsets are copied to the host at the start, while the card's queue holds
only the caller's uploads, and the segmented sum takes its step plan from
that copy.

Stage marks (``stages``): those of ``affine_from_bytes`` ("from_bytes",
"batch_invert", "sqrt"), then "checks", "fixed_base" ([valueBalance] V by
the fixed-base kernel), "segment_sum", "bvk", and those of ``msm_fused``
("digits" to "spine").
"""

from __future__ import annotations

import functools

import torch

from . import oracle, stages
from .curve.encoding import affine_from_bytes
from .curve.points import (AffinePoint, batch_normalize, map_point,
                           segment_sum, select_point)
from .curve.scalar_mul import FixedBaseTable
from .fields import Fq, Fr, mont
from .fields.element import FR_SPEC
from .fields.spec import LIMB_BITS, MASK, NLIMBS
from .ops.msm import msm_fused


@functools.lru_cache(maxsize=8)
def _neg_bases(g_base: tuple[int, int], r_base: tuple[int, int],
               device: str) -> AffinePoint:
    """-G and -R on ``device``, made once: a copy to the card waits for its
    queue."""
    q = oracle.Q
    return AffinePoint(
        u=Fq.from_int([(-g_base[0]) % q, (-r_base[0]) % q], device=device),
        v=Fq.from_int([g_base[1], r_base[1]], device=device))


@functools.lru_cache(maxsize=8)
def _value_base_table(base: tuple[int, int]) -> FixedBaseTable:
    return FixedBaseTable(base)


def _cat(points: list):
    """Batches of points of one type, one after the other."""
    return map_point(lambda *xs: torch.cat(xs, dim=1), *points)


def _owner(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """The transaction of each of ``n`` items laid out by ``offsets``."""
    lane = torch.arange(n, device=offsets.device)
    return torch.searchsorted(offsets[1:], lane, right=True)


def _neg_value_scalars(value_balance: torch.Tensor) -> Fr:
    """-valueBalance mod r for signed 64-bit values above -2^63: the
    magnitude's limbs times R^2 (from the standard form) or -R^2."""
    mag = value_balance.abs()
    limbs = torch.zeros((NLIMBS,) + tuple(mag.shape), dtype=torch.int32,
                        device=mag.device)
    for i in range(-(-64 // LIMB_BITS)):
        limbs[i] = (mag >> (LIMB_BITS * i)) & MASK
    shape, dev = tuple(mag.shape), mag.device
    sign = torch.where(value_balance < 0,
                       mont.const_mont(FR_SPEC, FR_SPEC.R, shape, dev),
                       mont.const_mont(FR_SPEC, -FR_SPEC.R, shape, dev))
    return Fr(mont.mul(FR_SPEC, limbs, sign))


def verify_bundles(spends: torch.Tensor, outputs: torch.Tensor,
                   binding_r: torch.Tensor, spend_offsets: torch.Tensor,
                   output_offsets: torch.Tensor, value_balance: torch.Tensor,
                   spend_scalars: torch.Tensor, binding_scalars: torch.Tensor,
                   bases) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Validates the Jubjub part of a batch of T Sapling transactions.

    - ``spends``: uint8 (32, 3, NS), each spend's cv, rk and R;
      ``outputs``: uint8 (32, 2, NO), each output's cv and epk;
      ``binding_r``: uint8 (32, T), each binding signature's R.
    - ``spend_offsets``, ``output_offsets``: int64 (T + 1,), nondecreasing
      from 0: transaction t holds the spends ``[spend_offsets[t],
      spend_offsets[t + 1])`` and likewise the outputs.
    - ``value_balance``: int64 (T,), each transaction's valueBalance.
    - ``spend_scalars``: uint8 (32, 3, NS), each spend-authorisation
      signature's z_j, z_j c_j and z_j S_j as canonical scalar bytes;
      ``binding_scalars``: uint8 (32, 3, T), the same of each binding
      signature.
    - ``bases``: the affine points (u, v), as integers, of G (spend
      authorisation), R (value commitment randomness) and V (value).

    Returns ``ok``, bool (T,); repr(bvk), uint8 (32, T), exact for every
    transaction whose ``ok`` is true; the encoding of the batch equation's
    point, uint8 (32,); and the basepoints' coefficients, uint8 (32, 2):
    sum z_j S_j over the kept spend-authorisation signatures and sum z_t
    S_t over the kept binding signatures, mod r, as canonical scalar bytes.
    Runs where the tensors lie."""
    ns, no, nt = spends.shape[-1], outputs.shape[-1], binding_r.shape[-1]
    for name, x, shape in (
            ("spends", spends, (32, 3, ns)), ("outputs", outputs, (32, 2, no)),
            ("binding_r", binding_r, (32, nt)),
            ("spend_scalars", spend_scalars, (32, 3, ns)),
            ("binding_scalars", binding_scalars, (32, 3, nt))):
        if x.dtype != torch.uint8 or tuple(x.shape) != shape:
            raise ValueError(f"verify_bundles: {name} must be uint8 {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
    for name, x, size in (("spend_offsets", spend_offsets, nt + 1),
                          ("output_offsets", output_offsets, nt + 1),
                          ("value_balance", value_balance, nt)):
        if x.dtype != torch.int64 or tuple(x.shape) != (size,):
            raise ValueError(f"verify_bundles: {name} must be int64 "
                             f"({size},), got {x.dtype} {tuple(x.shape)}")
    dev = spends.device
    # bvk's segments, one a transaction: its spends' cv, its outputs' -cv
    # and -[valueBalance] V, in that order
    bvk_offsets = ((spend_offsets + output_offsets).cpu()
                   + torch.arange(nt + 1))

    # 1. decode: cv and rk of the spends, cv and epk of the outputs (the
    # points the small-order rule reads), then every R
    enc = torch.cat([spends[:, 0], spends[:, 1], outputs[:, 0], outputs[:, 1],
                     spends[:, 2], binding_r], dim=1)
    pts, lane_ok = affine_from_bytes(enc)

    def role(i, n):
        return map_point(lambda x: x[:, i:i + n], pts)
    ruled = 2 * ns + 2 * no
    cv_s, rk, cv_o = role(0, ns), role(ns, ns), role(2 * ns, no)
    r_s, r_t = role(ruled, ns), role(ruled + ns, nt)

    # 2. the consensus checks, per transaction
    lane_ok = lane_ok & torch.cat([~role(0, ruled).is_small_order(),
                                   torch.ones(ns + nt, dtype=torch.bool,
                                              device=dev)])
    scal, scal_ok = Fr.from_bytes(torch.cat(
        [spend_scalars.reshape(32, 3 * ns),
         binding_scalars.reshape(32, 3 * nt)], dim=1))
    per_spend = (lane_ok[:ns] & lane_ok[ns:2 * ns] & lane_ok[ruled:ruled + ns]
                 & scal_ok[:ns] & scal_ok[ns:2 * ns] & scal_ok[2 * ns:3 * ns])
    per_output = lane_ok[2 * ns:2 * ns + no] & lane_ok[2 * ns + no:ruled]
    b = 3 * ns
    per_tx = (lane_ok[ruled + ns:] & scal_ok[b:b + nt]
              & scal_ok[b + nt:b + 2 * nt] & scal_ok[b + 2 * nt:])
    spend_tx, output_tx = _owner(spend_offsets, ns), _owner(output_offsets, no)
    bad = (~per_tx).to(torch.int32)
    bad.index_add_(0, spend_tx, (~per_spend).to(torch.int32))
    bad.index_add_(0, output_tx, (~per_output).to(torch.int32))
    ok = bad == 0
    stages.mark("checks")

    # 3. bvk
    g_base, r_base, v_base = (tuple(int(c) for c in p) for p in bases)
    vv = _value_base_table(v_base).mul_fused(_neg_value_scalars(value_balance))
    stages.mark("fixed_base")
    src = _cat([cv_s.to_extended(), (-cv_o).to_extended(), vv])
    tx = torch.arange(nt + 1, device=dev)
    dest = torch.cat([
        torch.arange(ns, device=dev) + output_offsets[spend_tx] + spend_tx,
        torch.arange(no, device=dev) + spend_offsets[output_tx + 1]
        + output_tx,
        spend_offsets[1:] + output_offsets[1:] + tx[:-1]])
    lanes = map_point(lambda x: torch.empty_like(x).index_copy_(1, dest, x),
                      src)
    bvk = batch_normalize(segment_sum(lanes, bvk_offsets))
    bvk_bytes = bvk.to_bytes()
    stages.mark("bvk")

    # 4. the batch equation over the kept transactions
    keep_s = ok[spend_tx]
    points = _cat([r_s, rk, r_t, bvk, _neg_bases(g_base, r_base, str(dev))])
    keep = torch.cat([keep_s, keep_s, ok, ok,
                      torch.ones(2, dtype=torch.bool, device=dev)])
    points = select_point(keep, points,
                          AffinePoint.identity((len(keep),), dev))
    zs = torch.cat([scal.limbs[:, 2 * ns:3 * ns], scal.limbs[:, b + 2 * nt:]],
                   dim=1)
    zs = torch.where(torch.cat([keep_s, ok]), zs, 0)
    kind = torch.cat([torch.zeros(ns, dtype=torch.int64, device=dev),
                      torch.ones(nt, dtype=torch.int64, device=dev)])
    k = torch.cat([scal.limbs[:, :2 * ns], scal.limbs[:, b:b + 2 * nt]], dim=1)
    coeffs = mont.sum_by_index(FR_SPEC, zs, kind, 2)
    k = torch.cat([torch.where(keep[:-2], k, 0), coeffs], dim=1)
    acc = msm_fused(points.to_extended(), Fr(k))
    result = batch_normalize(acc.mul_by_cofactor()).to_bytes()
    return ok, bvk_bytes, result, Fr(coeffs).to_bytes()
