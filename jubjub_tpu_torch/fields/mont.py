"""Montgomery arithmetic on 20x13-bit limb planes, in PyTorch.

Every function operates on int32 tensors of shape ``(NLIMBS, *batch)`` — limb
axis leading, arbitrary batch shape trailing — holding Montgomery residues
with each limb in ``[0, 2^13)``.  All control flow is static; the same
sequence of operations runs for every input ("constant pattern"), the batch
analogue of the reference crate's constant-time contract (src/lib.rs:12-17).

This module is the port's tensor-level code and, at the same time, the plain
PyTorch version of the ``mont_mul`` / ``mont_square`` CUDA kernels
(``ops/mont.py``): ``mul`` and ``square`` send a CUDA tensor to the kernel
and compute a CPU tensor here.  Values agree limb for limb with the
reference package's ``fields/mont.py``.

Column arithmetic.  A product accumulates up to 40 terms of (2^13-1)^2 in one
carry-save column, which exceeds 2^31 (fields/spec.py has the bound).  The
kernels keep the columns in ``uint32_t``.  PyTorch has no usable uint32
arithmetic and ``>>`` on int32 is an arithmetic shift, so the plain version
carries the columns in **int64** (the same integers, no wrap-around anywhere)
and returns int32.  ``sub`` and ``cond_sub_kp`` on the other hand *rely* on
the arithmetic shift of a signed int32 for their transient borrow.

Algorithm parity with the reference crate:
  - ``mul``/``_mont_reduce_rows``: schoolbook product + HAC 14.32 Montgomery
    reduction (src/fr.rs:544-616), radix 2^13 instead of 2^64.  The product
    phase may instead be one level of subtractive Karatsuba
    (``config.MUL_KARATSUBA``), with the same column values.
  - ``add``/``sub``/``neg``: src/fr.rs:620-665.
  - ``square``: upper-triangle doubling (src/fr.rs:353-381).
  - ``pow_const``: fixed-window exponentiation with a constant exponent.
  - ``batch_invert``: ff::BatchInverter (src/lib.rs:1084-1107) re-shaped as
    log-depth prefix/suffix product scans.

Lazy reduction contract: values are REDUNDANT residues, 13-bit-normalized
planes whose integer value is < c*p for a small per-site bound c, not
necessarily < p.  ``mul``/``square`` emit c=2; ``add`` emits c_a+c_b;
``sub(a,b,k)`` (requires k >= c_b) emits c_a+k.  The mul/square precondition
is c_a*c_b <= 32 (so the column value stays < p*2^260; 2^260/p ~ 35.3), and
any value must stay < 2^260.  ``to_canonical``/``eq``/``is_zero``/byte
encoding are the boundaries where exact representatives are restored.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch

from .. import config
from ..device import resolve
from .spec import LIMB_BITS, MASK, NLIMBS, FieldSpec, int_to_limbs

_I32 = torch.int32
_I64 = torch.int64
NACC = 2 * NLIMBS + 1  # 41 carry-save columns for a full product


# ---------------------------------------------------------------------------
# Kernel dispatch
# ---------------------------------------------------------------------------

_PLAIN_ONLY: contextvars.ContextVar = contextvars.ContextVar(
    "jubjub_torch_plain_only", default=False)


@contextlib.contextmanager
def plain_only():
    """Scope in which ``mul``/``square`` compute in plain PyTorch even on a
    CUDA tensor.  Only the kernels' plain versions use it, so that what a
    kernel is compared with on the card shares no CUDA code with it."""
    token = _PLAIN_ONLY.set(True)
    try:
        yield
    finally:
        _PLAIN_ONLY.reset(token)


def _to_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda and not _PLAIN_ONLY.get()


# ---------------------------------------------------------------------------
# Constants / constructors
# ---------------------------------------------------------------------------

_CONSTS: dict = {}


def _limb_const(limbs, device, dtype=_I32) -> torch.Tensor:
    """(NLIMBS,) constant tensor of a limb tuple, cached per device."""
    key = (tuple(limbs), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(list(limbs), dtype=dtype, device=device)
        _CONSTS[key] = t
    return t


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(NLIMBS,) -> (NLIMBS, 1, ..., 1) to broadcast over an ndim-d plane."""
    return t.reshape((t.shape[0],) + (1,) * (ndim - 1))


def zero(F: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=_I32,
                       device=resolve(device))


def const_mont(F: FieldSpec, x: int, batch_shape=(), device=None) -> torch.Tensor:
    """Montgomery form of the integer ``x`` broadcast over a batch."""
    device = resolve(device)
    limbs = _limb_const(int_to_limbs(x % F.p * F.R % F.p), device)
    shape = tuple(batch_shape)
    return _col(limbs, 1 + len(shape)).expand((NLIMBS,) + shape).contiguous()


def one(F: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return const_mont(F, 1, batch_shape, device)


# ---------------------------------------------------------------------------
# Carry machinery
# ---------------------------------------------------------------------------

def _carry_norm(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact carry propagation of column sums along axis 0 (int32 or int64;
    a negative intermediate borrows through the arithmetic shift).

    Returns (LIMB_BITS-bit int32 limbs, final carry).  Sequential in the limb
    axis, vectorized over the batch."""
    out = torch.empty(rows.shape, dtype=_I32, device=rows.device)
    carry = torch.zeros_like(rows[0])
    for i in range(rows.shape[0]):
        t = rows[i] + carry
        out[i] = t & MASK
        carry = t >> LIMB_BITS
    return out, carry


def _borrow_chain(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Limb differences ``d`` (int32, possibly negative) -> (13-bit limbs of
    the difference mod 2^260, final borrow in {0, 1})."""
    diff = torch.empty_like(d)
    borrow = torch.zeros_like(d[0])
    for i in range(NLIMBS):
        t = d[i] - borrow
        diff[i] = t & MASK
        borrow = (t >> LIMB_BITS) & 1
    return diff, borrow


def _cond_sub_p(F: FieldSpec, limbs: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Given a normalized value ``v = limbs + top*2^260 < 2p``, return v mod p
    (the trailing conditional subtraction of the reference crate's reduction,
    src/fr.rs:587, :645-647)."""
    p = _col(_limb_const(F.p_limbs, limbs.device), limbs.ndim)
    diff, borrow = _borrow_chain(limbs - p)
    geq = top >= borrow  # v >= p
    return torch.where(geq, diff, limbs)


# ---------------------------------------------------------------------------
# Add / sub / neg
# ---------------------------------------------------------------------------

def add(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy add: carry-normalize only (no mod reduction; bound c_a + c_b).
    Valid while the running value stays < 2^260."""
    limbs, _ = _carry_norm(a + b)  # limbs <= 2*(2^13-1), exact in int32
    return limbs  # value < 2^260: top carry is always 0


def sub(F: FieldSpec, a: torch.Tensor, b: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Lazy subtract: a + k*p - b in one fused carry chain.

    ``k`` is a static headroom bound with k*p >= b.  Result bound:
    < (c_a + k)*p.  Replaces the reference crate's
    borrow-then-conditional-add-p (src/fr.rs:620-634)."""
    assert k * F.p < (1 << (LIMB_BITS * NLIMBS))
    ndim = max(a.ndim, b.ndim)
    kp = _col(_limb_const(int_to_limbs(k * F.p), a.device), ndim)
    # the arithmetic shift inside _carry_norm handles the transient borrow
    limbs, _ = _carry_norm(a + kp - b)
    return limbs  # a + k*p - b >= 0 and < 2^260: carry is 0


def neg(F: FieldSpec, a: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k*p - a: congruent to -a mod p (cf. src/fr.rs:651-665; the canonical
    boundary maps the redundant zero back to 0)."""
    return sub(F, torch.zeros_like(a), a, k=k)


def cond_sub_kp(F: FieldSpec, x: torch.Tensor, k: int) -> torch.Tensor:
    """One conditional reduction step: x - k*p if x >= k*p, else x.

    Brings a value < 2k*p back under k*p (used at the few spots in the point
    formulas where lazy bounds would overflow the mul precondition)."""
    kp = _col(_limb_const(int_to_limbs(k * F.p), x.device), x.ndim)
    diff, borrow = _borrow_chain(x - kp)
    return torch.where(borrow == 0, diff, x)  # borrow == 0: x >= k*p


def double_el(F: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(F, a, a)


# ---------------------------------------------------------------------------
# Multiplication / squaring / Montgomery reduction
# ---------------------------------------------------------------------------

def _mont_reduce_rows(F: FieldSpec, cols: torch.Tensor,
                      canonical: bool = False) -> torch.Tensor:
    """Reduce 41 int64 carry-save columns: returns (v / 2^260) mod p.

    By default the result is *lazily* reduced: a 13-bit-normalized value in
    ``[0, 2p)`` (the final conditional subtraction is skipped).  Pass
    ``canonical=True`` for the exact representative in ``[0, p)``.

    Radix-2^13 analogue of HAC Algorithm 14.32 (src/fr.rs:544-588): 20 rounds
    of ``k = cols[i] * (-p^-1) mod 2^13; cols += k*p << 13i; carry``, then a
    final normalization.  ``cols`` is consumed (updated in place).  For Fq,
    ``inv_limb == MASK`` so ``k`` is ``-cols[i] mod 2^13`` and several limbs
    of p are 0 or 1; the kernels resolve those cases at compile time, here
    the general formula yields the same integers."""
    assert cols.shape[0] == NACC and cols.dtype == _I64
    p = _col(_limb_const(F.p_limbs, cols.device, _I64), cols.ndim)
    inv = int(F.inv_limb)
    for rnd in range(NLIMBS):
        k = (cols[rnd] * inv) & MASK
        cols[rnd:rnd + NLIMBS] += k * p
        # low 13 bits of cols[rnd] are now 0 mod 2^13; fold the carry up
        cols[rnd + 1] += cols[rnd] >> LIMB_BITS
    limbs, top = _carry_norm(cols[NLIMBS:NACC])
    # value < 2p < 2^260: the last of the NLIMBS+1 limbs (bits >= 260) is 0
    if not canonical:
        return limbs[:NLIMBS]  # redundant form, < 2p
    top_col = limbs[NLIMBS] + (top << LIMB_BITS).to(_I32)
    return _cond_sub_p(F, limbs[:NLIMBS], top_col)


def _limb_products(x: torch.Tensor, y: torch.Tensor, ncols: int) -> torch.Tensor:
    """Columns of the product of two limb vectors ``(n, *batch)`` (int64,
    signed where the limbs are): ``(ncols, *batch)``, column c the sum of
    x_i * y_(c-i); ncols >= 2n - 1."""
    n = x.shape[0]
    shape = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
    cols = torch.zeros((ncols,) + shape, dtype=_I64, device=x.device)
    for i in range(n):
        cols[i:i + n] += x[i] * y
    return cols


def _limb_squares(x: torch.Tensor, ncols: int) -> torch.Tensor:
    """The same columns for y = x: the diagonal plus the doubled upper
    triangle (src/fr.rs:353-381), n(n+1)/2 limb products."""
    n = x.shape[0]
    cols = torch.zeros((ncols,) + x.shape[1:], dtype=_I64, device=x.device)
    for i in range(n):
        cols[2 * i] += x[i] * x[i]
        if i + 1 < n:
            cols[2 * i + 1:i + n] += (x[i] * x[i + 1:]) * 2
    return cols


def _product_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns: 400 limb products into 41 int64 columns
    (each product < 2^26, exact)."""
    return _limb_products(a.to(_I64), b.to(_I64), NACC)


def _square_cols(a: torch.Tensor) -> torch.Tensor:
    """Schoolbook square columns (210 products); the same values as
    ``_product_cols(a, a)``."""
    return _limb_squares(a.to(_I64), NACC)


def _use_karatsuba() -> bool:
    """The plain versions' product phase, read at call time:
    ``config.MUL_KARATSUBA`` where it is set.  None (the default) leaves
    them schoolbook, as the reference package leaves it off its TPU: the
    kernels take ``config.kernels_karatsuba()``, and in PyTorch the
    Karatsuba columns take more tensor operations."""
    return bool(config.MUL_KARATSUBA)


_H = NLIMBS // 2  # limbs of a Karatsuba half


def _recombine(z0: torch.Tensor, z2: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Three (2H-1, *batch) half-product column sets -> the 41 columns of the
    whole product: z0 at 0, z0 + z2 - m at H, z2 at 2H."""
    cols = torch.zeros((NACC,) + z0.shape[1:], dtype=_I64, device=z0.device)
    cols[:2 * _H - 1] += z0
    cols[_H:3 * _H - 1] += z0 + z2 - m
    cols[2 * _H:4 * _H - 1] += z2
    return cols


def _product_cols_karatsuba(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook-identical product columns by subtractive Karatsuba.

    Split a = a0 + a1*2^(13*H), b likewise (H = 10 limbs).  With
        z0 = a0*b0,  z2 = a1*b1,  m = (a0-a1)*(b0-b1)
    the cross columns z0 + z2 - m are the columns of a0*b1 + a1*b0, so every
    column EQUALS the schoolbook column as an integer and the reduction and
    its result are unchanged.  The intermediates are signed (int64 here;
    ``csrc/field.cuh`` keeps them in int32_t): a0_i - a1_i lies in
    (-2^13, 2^13), a half column below 10*2^26 in magnitude, and a cross
    column in [0, 20*2^26].  300 limb products instead of 400."""
    a64, b64 = a.to(_I64), b.to(_I64)
    a0, a1, b0, b1 = a64[:_H], a64[_H:], b64[:_H], b64[_H:]
    ncols = 2 * _H - 1
    return _recombine(_limb_products(a0, b0, ncols),
                      _limb_products(a1, b1, ncols),
                      _limb_products(a0 - a1, b0 - b1, ncols))


def _square_cols_karatsuba(a: torch.Tensor) -> torch.Tensor:
    """Schoolbook-identical square columns by subtractive Karatsuba:
    z0 = a0^2, z2 = a1^2, m = (a0-a1)^2, cross = z0 + z2 - m, the columns
    of 2*a0*a1.  Three half squares of 55 limb products: 165 instead of
    210."""
    a64 = a.to(_I64)
    a0, a1 = a64[:_H], a64[_H:]
    ncols = 2 * _H - 1
    return _recombine(_limb_squares(a0, ncols), _limb_squares(a1, ncols),
                      _limb_squares(a0 - a1, ncols))


def product_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 41 int64 columns of a*b in the plain versions' product phase."""
    if _use_karatsuba():
        return _product_cols_karatsuba(a, b)
    return _product_cols(a, b)


def square_cols(a: torch.Tensor) -> torch.Tensor:
    """The 41 int64 columns of a^2 in the plain versions' product phase."""
    if _use_karatsuba():
        return _square_cols_karatsuba(a)
    return _square_cols(a)


def mul_plain(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product in plain PyTorch: the product's int64 columns
    (schoolbook or Karatsuba, ``product_cols``), then the row reduction."""
    return _mont_reduce_rows(F, product_cols(a, b))


def square_plain(F: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Squaring in plain PyTorch: ``square_cols``, then the row reduction;
    the same limbs as ``mul_plain(a, a)``."""
    return _mont_reduce_rows(F, square_cols(a))


# ---------------------------------------------------------------------------
# Matmul-form Montgomery reduction: the k*p work as constant-matrix products
# ---------------------------------------------------------------------------
#
# The HAC 14.32 rounds interleave the quotient digits with the fold of k*p.
# Both operands-against-constants are matrix products with constant
# matrices:
#
#     k  = (V mod R) * p'  mod R        p' = -p^-1 mod 2^260   (Toeplitz)
#     T  = V + k * p                    p  Toeplitz, T = 0 mod R
#     out = T / R  (top 20 limbs)       out < 2p (the row form's lazy bound)
#
# so the per-lane products of the row reduction become two int8 matrix
# products against (3*20, 40) / (3*41, 40) constant matrices: each 13-bit
# limb splits into a 7-bit and a 6-bit int8 chunk, and the three shift
# blocks (2^0, 2^7, 2^14) of the product are recombined afterwards.  Every
# column stays below 2^31 (20 terms of 127*127 / 127*63 / 63*63 a block).
# The result is BIT-IDENTICAL to the row reduction.
#
# ``use_mxu_reduce(F)`` installs F's matrices for a scope; inside it ``mul``
# and ``square`` of F build their columns and reduce through the matrix
# products, on the CPU and on a CUDA tensor alike (the scope takes
# precedence over the ``mont_mul`` / ``mont_square`` kernels for F; the
# other field's products still reach them).  The reference package uses it
# at the XLA level, outside its Pallas kernels; the int8 product here is one
# ``torch._int_mm`` call, outside any kernel of the port.

_MM_TABLES: contextvars.ContextVar = contextvars.ContextVar(
    "jubjub_torch_mm_tables", default=None)


def _toeplitz(vals, nrows: int, ncols: int) -> np.ndarray:
    M = np.zeros((nrows, ncols), np.int64)
    for n in range(nrows):
        for i in range(ncols):
            j = n - i
            if 0 <= j < len(vals):
                M[n, i] = vals[j]
    return M


def _shift_blocks(M: np.ndarray) -> np.ndarray:
    """13-bit matrix (nrows, 20) -> int8 shift-block matrix (3*nrows, 40).

    Row blocks are the 2^0 / 2^7 / 2^14 partial products of the 7/6-bit
    chunk decomposition; columns pair with [x & 0x7f, x >> 7] chunks."""
    lo = (M & 0x7F).astype(np.int8)
    hi = (M >> 7).astype(np.int8)
    nrows = M.shape[0]
    W = np.zeros((3 * nrows, 2 * NLIMBS), np.int8)
    W[0 * nrows:1 * nrows, :NLIMBS] = lo
    W[1 * nrows:2 * nrows, :NLIMBS] = hi
    W[1 * nrows:2 * nrows, NLIMBS:] = lo
    W[2 * nrows:3 * nrows, NLIMBS:] = hi
    return W


@functools.lru_cache(maxsize=4)
def mont_matrices(F: FieldSpec) -> tuple[np.ndarray, np.ndarray]:
    """(WK8, WP8) int8 constant matrices of the matmul-form reduction."""
    R_mod = 1 << (LIMB_BITS * NLIMBS)
    pprime = (-pow(F.p, -1, R_mod)) % R_mod
    MK = _toeplitz(int_to_limbs(pprime), NLIMBS, NLIMBS)
    MP = _toeplitz(F.p_limbs, NACC, NLIMBS)
    return _shift_blocks(MK), _shift_blocks(MP)


@functools.lru_cache(maxsize=8)
def _device_matrices(F: FieldSpec, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    wk, wp = mont_matrices(F)
    return (torch.from_numpy(wk).to(device), torch.from_numpy(wp).to(device))


@contextlib.contextmanager
def matmul_tables(wk, wp):
    """Install (WK8, WP8) int8 tensors so that ``mul``/``square`` inside the
    scope use the matmul-form reduction, whatever their field."""
    token = _MM_TABLES.set((None, wk, wp))
    try:
        yield
    finally:
        _MM_TABLES.reset(token)


@contextlib.contextmanager
def use_mxu_reduce(F: FieldSpec):
    """Scope in which ``mul``/``square`` of field ``F`` reduce through F's
    constant matrices (``mont_matrices``), moved to each operand's device.
    A product of another field inside the scope goes where it goes outside
    it: to the kernel on a CUDA tensor, to the row form on the CPU."""
    token = _MM_TABLES.set((F, None, None))
    try:
        yield
    finally:
        _MM_TABLES.reset(token)


def _carry_norm_exact(rows: torch.Tensor) -> torch.Tensor:
    """Exact carry propagation of nonnegative column sums along axis 0 ->
    13-bit int32 limbs (the final carry is 0 where it is used)."""
    out = torch.empty(rows.shape, dtype=_I32, device=rows.device)
    carry = torch.zeros_like(rows[0], dtype=_I64)
    for i in range(rows.shape[0]):
        t = rows[i].to(_I64) + carry
        out[i] = t & MASK
        carry = t >> LIMB_BITS
    return out


def _mm_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """(20, *batch) 13-bit limbs -> (n8, 40) int8 chunks, one row a lane,
    padded with zero lanes to n8.  On a card ``torch._int_mm`` (cuBLASLt)
    takes an int8 product (m, k) @ (k, n) with m > 16 and k, n multiples of
    8, and refused (40, n) lanes on the right at 131072 lanes, so the lanes
    are the rows: n8 is a multiple of 8 and at least 24."""
    x8 = torch.cat([x & 0x7F, x >> 7]).reshape(2 * NLIMBS, n).to(torch.int8)
    n8 = max(-(-n // 8) * 8, 24)
    return torch.nn.functional.pad(x8, (0, n8 - n)).T.contiguous()


def _mm_apply(w: torch.Tensor, x8: torch.Tensor, nrows: int, shape) -> torch.Tensor:
    """x8 (n8, 40) int8 @ w^T, w (3*nrows, 40) int8 -> recombined
    (nrows, *shape) int32: the three shift blocks summed, the padding lanes
    dropped.  w^T is padded with zero columns to a multiple of 8."""
    n = 1
    for d in shape:
        n *= d
    wt = torch.nn.functional.pad(w.T, (0, -w.shape[0] % 8))
    out = torch._int_mm(x8, wt)[:n, :w.shape[0]].T
    out = out.reshape((3, nrows) + tuple(shape))
    return out[0] + (out[1] << 7) + (out[2] << 14)


def _mont_reduce_matmul(F: FieldSpec, cols: torch.Tensor, wk: torch.Tensor,
                        wp: torch.Tensor) -> torch.Tensor:
    """Matmul-form Montgomery reduction of 41 columns; lazy result < 2p.

    Bit-identical to ``_mont_reduce_rows(..., canonical=False)``."""
    assert cols.shape[0] == NACC
    shape = tuple(cols.shape[1:])
    n = cols[0].numel()
    V = _carry_norm_exact(cols)                          # 41 exact 13-bit limbs
    kcols = _mm_apply(wk, _mm_chunks(V[:NLIMBS], n), NLIMBS, shape)
    k = _carry_norm_exact(kcols)                         # k = V * p' mod R
    kp = _mm_apply(wp, _mm_chunks(k, n), NACC, shape)
    T = _carry_norm_exact(kp.to(_I64) + V)               # V + k*p, 0 mod R
    return T[NLIMBS:NACC - 1]                            # (V + k*p) / R < 2p


def _in_scope(F: FieldSpec) -> bool:
    """Whether a ``use_mxu_reduce`` / ``matmul_tables`` scope applies to a
    product of field ``F``: ``matmul_tables``' applies to every field,
    ``use_mxu_reduce``'s to its own."""
    tables = _MM_TABLES.get()
    return tables is not None and (tables[0] is None or tables[0] is F)


def _reduce_dispatch(F: FieldSpec, cols: torch.Tensor,
                     canonical: bool = False) -> torch.Tensor:
    """The matmul form inside a ``use_mxu_reduce`` / ``matmul_tables`` scope
    (lazy results only), the row form elsewhere and for ``canonical``."""
    if _in_scope(F) and not canonical:
        _, wk, wp = _MM_TABLES.get()
        if wk is None:
            wk, wp = _device_matrices(F, str(cols.device))
        return _mont_reduce_matmul(F, cols, wk.to(cols.device),
                                   wp.to(cols.device))
    return _mont_reduce_rows(F, cols, canonical=canonical)


def mul(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*2^-260 mod p (src/fr.rs:592-616), lazy (< 2p).

    Valid for any 13-bit-normalized inputs with a*b < p * 2^260.  Inside a
    scope that applies to ``F`` (``use_mxu_reduce(F)``, ``matmul_tables``):
    the columns here and the matmul-form reduction, on any device.
    Elsewhere, a product of another field inside the scope included, a CUDA
    tensor goes through the ``mont_mul`` kernel, a CPU tensor through
    ``mul_plain``; all give the same limbs."""
    if _in_scope(F):
        return _reduce_dispatch(F, product_cols(a, b))
    if _to_kernel(a):
        from ..ops.mont import mont_mul
        return mont_mul(F, a, b)
    return mul_plain(F, a, b)


def square(F: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^2 * 2^-260 mod p, lazy (< 2p); the matmul-form reduction inside a
    scope that applies to ``F``, else the kernel on CUDA and plain on the
    CPU."""
    if _in_scope(F):
        return _reduce_dispatch(F, square_cols(a))
    if _to_kernel(a):
        from ..ops.mont import mont_square
        return mont_square(F, a)
    return square_plain(F, a)


def mul_const(F: FieldSpec, a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c for a small constant c (via Montgomery mul by c*R mod p)."""
    return mul(F, a, const_mont(F, c, a.shape[1:], a.device))


# ---------------------------------------------------------------------------
# Montgomery domain conversion
# ---------------------------------------------------------------------------

def to_canonical(F: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard representative (cf. to_bytes' reduction,
    src/fr.rs:296-308)."""
    cols = torch.zeros((NACC,) + a.shape[1:], dtype=_I64, device=a.device)
    cols[:NLIMBS] = a
    return _mont_reduce_rows(F, cols, canonical=True)


def from_canonical(F: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Standard representative (< p) -> Montgomery form: mont_mul(x, R^2)."""
    return mul(F, x, const_mont(F, F.R, x.shape[1:], x.device))


def sum_by_index(F: FieldSpec, a: torch.Tensor, index: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sums of elements by index: ``a`` (NLIMBS, m), ``index`` (m,) in
    [0, n); element i of the result, (NLIMBS, n), is the sum mod p of the
    elements whose index is i (0 where there is none), below 2p.

    The limbs are added up as int64 in one pass over the lanes (each limb is
    below 2^13: exact for fewer than 2^40 lanes).  Read as the columns of
    one value V below m 2^260 < p 2^260, the limb sums take one Montgomery
    reduction, V / R mod p, which is the sum in standard form (the lanes
    are in Montgomery form), and one product by R^2 brings it back."""
    if a.ndim != 2 or a.shape[0] != NLIMBS or index.shape != a.shape[1:]:
        raise ValueError(f"sum_by_index: expected limbs (NLIMBS, m) and an "
                         f"index (m,), got {tuple(a.shape)} and "
                         f"{tuple(index.shape)}")
    cols = torch.zeros((NACC, n), dtype=_I64, device=a.device)
    cols[:NLIMBS].index_add_(1, index.to(device=a.device, dtype=_I64),
                             a.to(_I64))
    return from_canonical(F, _mont_reduce_rows(F, cols))


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

def eq(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a == b mod p: (a - b) == 0 after one canonical reduction.

    PRECONDITION: ``b``'s lazy bound must be <= 8p (the fixed ``k=8``
    headroom).  Public operator values are < 2p and point coordinates stay
    <= 6p; a caller holding a wider lazy value must ``reduce_once`` first."""
    return is_zero(F, sub(F, a, b, k=8))


def is_zero(F: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a == 0 mod p (canonicalizes: the redundant forms of 0 are 0, p, 2p...)."""
    return torch.all(to_canonical(F, a) == 0, dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b, with mask shaped like the batch (broadcast across limbs)."""
    return torch.where(mask, a, b)


# ---------------------------------------------------------------------------
# Fixed-exponent exponentiation / inversion
# ---------------------------------------------------------------------------

def pow_const(F: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a constant exponent, 4-bit fixed windows.

    Replaces the reference crate's bit-serial ``pow`` (src/fr.rs:403-414) and
    its addition-chain ``invert``: with a static exponent the window schedule
    is data-independent.  Same schedule as the reference package (table of
    a^0..a^15, leading zero windows skipped, a multiplication per window even
    for digit 0), so the lazy representatives agree."""
    assert e >= 0
    if e == 0:
        return one(F, a.shape[1:], a.device)
    table = [one(F, a.shape[1:], a.device), a]
    for _ in range(14):
        table.append(mul(F, table[-1], a))
    ndigits = 64
    digits = [(e >> (4 * (ndigits - 1 - i))) & 0xF for i in range(ndigits)]
    first = next(i for i, d in enumerate(digits) if d)
    acc = table[digits[first]]
    for i in range(first + 1, ndigits):
        for _ in range(4):
            acc = square(F, acc)
        acc = mul(F, acc, table[digits[i]])
    return acc


def pow_traced(F: FieldSpec, a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """a^e for an exponent known only at run time, possibly batched: ``e`` a
    standard-form limb plane (NLIMBS, *batch) holding an integer below
    2^256, not reduced mod p-1 (the reference crate's ``pow`` over a raw
    [u64; 4], src/fr.rs:403-414).  256 fixed steps of one square and one
    masked multiplication, most significant bit first: the sequence of
    operations does not depend on the exponent's bits.  On the card each
    step is a ``mont_square`` and a ``mont_mul`` launch."""
    shape = tuple(torch.broadcast_shapes(a.shape[1:], e.shape[1:]))
    lead = (1,) * (len(shape) - (a.dim() - 1))  # the limb axis stays first
    a = a.reshape((NLIMBS,) + lead + tuple(a.shape[1:])).expand(
        (NLIMBS,) + shape)
    acc = one(F, shape, a.device)
    for i in range(256):
        acc = square(F, acc)
        j = 255 - i
        bit = (e[j // LIMB_BITS] >> (j % LIMB_BITS)) & 1
        acc = select(bit == 1, mul(F, acc, a), acc)
    return acc


def invert(F: FieldSpec, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a^-1, is_invertible). a == 0 maps to (0, False)
    (cf. src/fr.rs:438-540)."""
    return pow_const(F, a, F.p - 2), ~is_zero(F, a)


# ---------------------------------------------------------------------------
# Byte I/O (little-endian 32-byte encodings)
# ---------------------------------------------------------------------------

def limbs_from_le_bytes(b: torch.Tensor) -> torch.Tensor:
    """uint8 (32, *batch) -> int32 (NLIMBS, *batch) standard-form limbs:
    limb i holds bits [13i, 13i+13) of the little-endian 256-bit value."""
    bi = b.to(_I32)
    limbs = []
    for i in range(NLIMBS):
        bitpos = LIMB_BITS * i
        j, off = bitpos // 8, bitpos % 8
        v = bi[j] >> off
        if j + 1 < 32:
            v = v | (bi[j + 1] << (8 - off))
        if off + LIMB_BITS > 16 and j + 2 < 32:
            v = v | (bi[j + 2] << (16 - off))
        limbs.append(v & MASK)
    return torch.stack(limbs)


def limbs_to_le_bytes(x: torch.Tensor) -> torch.Tensor:
    """int32 (NLIMBS, *batch) 13-bit limbs -> uint8 (32, *batch)."""
    out = []
    for j in range(32):
        bitpos = 8 * j
        k, off = bitpos // LIMB_BITS, bitpos % LIMB_BITS
        v = x[k] >> off
        if off + 8 > LIMB_BITS and k + 1 < NLIMBS:
            v = v | (x[k + 1] << (LIMB_BITS - off))
        out.append((v & 0xFF).to(torch.uint8))
    return torch.stack(out)


def to_bytes(F: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return limbs_to_le_bytes(to_canonical(F, a))


def lt_p(F: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Canonicity check: standard-form limb value < p (src/fr.rs:268-292)."""
    p = _col(_limb_const(F.p_limbs, x.device), x.ndim)
    _, borrow = _borrow_chain(x - p)
    return borrow == 1


def from_bytes(F: FieldSpec, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical LE bytes (32, *batch) -> (Montgomery limbs, ok).
    Non-canonical inputs yield ok=False (limbs then carry garbage; callers
    must mask)."""
    x = limbs_from_le_bytes(b)
    return from_canonical(F, x), lt_p(F, x)


def from_bytes_wide(F: FieldSpec, b: torch.Tensor) -> torch.Tensor:
    """512-bit LE bytes (64, *batch) reduced mod p: d0*R^2 + d1*R^3 in the
    Montgomery domain (src/fr.rs:312-343), brought below 2p."""
    batch = b.shape[1:]
    lo = mul(F, limbs_from_le_bytes(b[:32]), const_mont(F, F.R, batch, b.device))
    hi = mul(F, limbs_from_le_bytes(b[32:]),
             const_mont(F, (1 << 256) * F.R, batch, b.device))
    return cond_sub_kp(F, add(F, lo, hi), 2)


# ---------------------------------------------------------------------------
# Batch inversion (prefix/suffix product scans)
# ---------------------------------------------------------------------------

def from_u64(F: FieldSpec, v: int, batch_shape=(), device=None) -> torch.Tensor:
    """Constant small integer -> Montgomery form (src/fr.rs:42-46)."""
    return const_mont(F, v, batch_shape, device)


def _product_scan(F: FieldSpec, a: torch.Tensor, axis: int,
                  reverse: bool) -> torch.Tensor:
    """Inclusive running product along ``axis`` by recursive doubling:
    ceil(log2 n) multiplications of (nearly) the whole plane."""
    n = a.shape[axis]
    x = a
    d = 1
    while d < n:
        prod = mul(F, x.narrow(axis, 0, n - d), x.narrow(axis, d, n - d))
        if reverse:
            x = torch.cat([prod, x.narrow(axis, n - d, d)], dim=axis)
        else:
            x = torch.cat([x.narrow(axis, 0, d), prod], dim=axis)
        d *= 2
    return x


def batch_invert(F: FieldSpec, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Invert every element along a batch axis with ONE field inversion.

    Replacement for ff::BatchInverter (src/lib.rs:1084-1107): inclusive
    prefix and suffix products by log-depth doubling scans (PyTorch has no
    associative scan), then
    ``a_i^-1 = prefix_{i-1} * suffix_{i+1} * (prod all)^-1``.
    All elements must be nonzero (same contract as the reference crate).
    The lazy representative depends on the order of combination, so results
    agree with the reference package after ``to_canonical``."""
    if axis < 0:
        axis = a.ndim + axis
    assert axis != 0, "axis 0 is the limb axis"

    prefix = _product_scan(F, a, axis, reverse=False)
    suffix = _product_scan(F, a, axis, reverse=True)

    n = a.shape[axis]
    total = prefix.select(axis, n - 1)
    total_inv, _ = invert(F, total)

    ones = one(F, a.shape[1:axis] + (1,) + a.shape[axis + 1:], a.device)
    prefix_shift = torch.cat([ones, prefix.narrow(axis, 0, n - 1)], dim=axis)
    suffix_shift = torch.cat([suffix.narrow(axis, 1, n - 1), ones], dim=axis)

    return mul(F, mul(F, prefix_shift, suffix_shift),
               total_inv.unsqueeze(axis))

