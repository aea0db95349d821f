"""Square roots, constant-pattern for both field shapes.

Two strategies, selected by the 2-adicity ``s`` of the field (the reference
crate gets Fr's from src/fr.rs:384-399 and Fq's from the bls12_381 crate):

  - s == 1 (Fr): p == 3 (mod 4) -> single exponentiation a^((p+1)/4).
  - s large (Fq, s = 32): Tonelli-Shanks recast as a Pohlig-Hellman discrete
    log in the 2-Sylow subgroup.  Writing b = a^t = c^e (c = root of unity of
    order 2^s), each bit of e is extracted with a fixed squaring ladder and
    the root is a^((t+1)/2) * c^(-e/2).

The schedule is the reference package's: for each of the s bits a ladder of
s - 1 squarings, of which those past the bit's depth are computed and
discarded (the mask depends on the loop indices only), so every lane and
every call runs the same s*(s-1) squarings; the bits of e only choose
between computed values.  Values agree with the reference package limb for
limb.
"""

from __future__ import annotations

import torch

from . import mont
from .spec import FieldSpec


def _sqrt_p34(F: FieldSpec, a: torch.Tensor):
    """s == 1 case (src/fr.rs:384-399)."""
    res = mont.pow_const(F, a, (F.p + 1) // 4)
    return res, mont.eq(F, mont.square(F, res), a)


def _sylow_consts(F: FieldSpec, device):
    """Constant planes for the 2-Sylow discrete log: cinv^(2^i) for
    i = 0..s-1, and the root corrections cinv^(2^(i-1)) (a dummy 1 at i=0),
    each an (NLIMBS, s) int32 tensor in Montgomery form."""
    cinv_pows = []
    x = F.root_of_unity_inv
    for _ in range(F.s):
        cinv_pows.append(x)
        x = x * x % F.p
    half_pows = [1] + cinv_pows[:F.s - 1]

    def stack(vals):
        return torch.stack([mont._limb_const(F.np_mont(v).tolist(), device)
                            for v in vals], dim=1)
    return stack(cinv_pows), stack(half_pows)


def _sqrt_tonelli_shanks(F: FieldSpec, a: torch.Tensor):
    s = F.s
    batch = a.shape[1:]
    w = mont.pow_const(F, a, (F.t - 1) // 2)
    x = mont.mul(F, a, w)        # a^((t+1)/2): root candidate modulo the 2-Sylow part
    b = mont.mul(F, x, w)        # a^t = c^e in the 2-Sylow subgroup
    minus_one = mont.const_mont(F, F.p - 1, batch, a.device)
    cinv_pows, half_pows = _sylow_consts(F, a.device)

    def col(plane, i):
        return mont._col(plane[:, i], a.ndim)

    d, corr = b, mont.one(F, batch, a.device)
    odd = torch.zeros(batch, dtype=torch.bool, device=a.device)
    for i in range(s):
        # sgn = d^(2^(s-1-i)) in {+1, -1}: a fixed ladder of s-1 squarings
        sgn = d
        for j in range(s - 1):
            sq = mont.square(F, sgn)
            sgn = sq if j < s - 1 - i else sgn
        ei = mont.eq(F, sgn, minus_one)  # bit i of e
        d = mont.select(ei, mont.mul(F, d, col(cinv_pows, i)), d)
        if i > 0:
            corr = mont.select(ei, mont.mul(F, corr, col(half_pows, i)), corr)
        else:
            odd = odd | ei

    res = mont.mul(F, x, corr)   # a^((t+1)/2) * c^(-e/2)
    zero_in = mont.is_zero(F, a)
    ok = (~odd) | zero_in        # QR iff e is even; sqrt(0) = 0
    return mont.select(zero_in, torch.zeros_like(res), res), ok


def sqrt(F: FieldSpec, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sqrt(a), is_square).  Non-residues yield ok=False (value undefined).
    A tensor of a field with s > 1 (Fq) that the kernels take
    (``mont._to_kernel``: on the card, outside ``mont.plain_only``) goes
    through the ``fq_sqrt`` kernel, one launch; the root is then the same
    field element, its lazy limbs not always these."""
    if F.s == 1:
        return _sqrt_p34(F, a)
    if mont._to_kernel(a):
        from ..ops.sqrt import fq_sqrt
        return fq_sqrt(F, a)
    return _sqrt_tonelli_shanks(F, a)


def sqrt_ratio(F: FieldSpec, num: torch.Tensor, div: torch.Tensor):
    """ff::Field::sqrt_ratio semantics (src/fr.rs:704-706): returns
    (is_square, x) with x = sqrt(num/div) if num/div is a square, else
    sqrt(ROOT_OF_UNITY * num/div); div == 0 gives (False, 0), num == 0 gives
    (True, 0)."""
    div_inv, div_ok = mont.invert(F, div)
    ratio = mont.mul(F, num, div_inv)
    root, is_sq = sqrt(F, ratio)
    alt_root, _ = sqrt(F, mont.mul_const(F, ratio, F.root_of_unity))
    num_zero = mont.is_zero(F, num)
    x = mont.select(is_sq, root, alt_root)
    x = mont.select(num_zero | ~div_ok, torch.zeros_like(x), x)
    return (is_sq | num_zero) & div_ok, x
