"""Reference of the ``bundle_verify`` path, and the comparison that decides
``correct`` for its cells.

The curve's group is cyclic, of order 8r, generated by the full generator
P0 (``curve_int.GENERATOR``), so every point the generator made is [x] P0
for an x it records modulo 8r: a subgroup point [e] G8 is x = 8e, an
8-torsion point T_k is x = k r, and a point with a torsion part is their
sum.  From those integers:

- a lane names a point of small order ([8] P = O) exactly when x = 0 mod r;
  a transaction is valid when each of its encodings names a point and no cv,
  rk or epk is of small order (Zcash Protocol Spec 4.4, 4.5; ZIP 216);
- bvk_t = sum cv_spend - sum cv_output - [v_t] V is [x_bvk] P0, x_bvk in
  Python integers, encoded by ``encode_multiples``: a comb over a table of
  [d 256^w] P0 made in Python integers, the entries that x's 32 bytes
  select summed in extended coordinates over ``field.PlainField``, one
  inversion, in plain PyTorch;
- the batch equation's point is [8 s] P0, s = the sum of each kept term's
  coefficient times its point's x, mod r, one multiplication in
  ``curve_int``.  A batch whose kept signatures are all valid sums to 0;
  one with a spend-authorisation S off by one does not;
- the basepoints' coefficients are the sums of z S over the kept
  signatures of each kind, mod r.  The point cannot show which valid
  signatures the equation held (their terms sum to 0 either way); these
  sums hold each kept signature's z S, so a transaction left out of the
  equation with its coefficients moves them, and one left out without them
  moves the point.

A sample of the lanes and every lane the generator changed after making it
are encoded again from their x in Python integers, and every encoding that
must name no point is decoded there: a check of the generator.  repr(bvk) is compared on the valid
transactions.  Nothing of the program is imported here.

``READINGS`` are the control and the faults that ``portbench/control.py``
puts in the program's place: the control leaves the small-order rule out
(the transactions it drops stay in the equation with their random
signatures); the faults are a state left unchanged (every bvk and the
result the identity, the coefficients 0), half of the batch equation's
terms left out (in the program's order: every R_j and rk_j, every R_t and
bvk_t, the two basepoints), the second half of the transactions left out of
the equation with their coefficients, the same transactions' points left
out but their z S kept in the coefficients (``ok`` and bvk right in both),
and byte 0 of the first valid transaction's bvk altered.
"""

from __future__ import annotations

import functools
from itertools import accumulate, chain

import numpy as np
import torch

from .. import generate
from . import curve_int as ci
from . import lanes

FQ = lanes.FQ
ORDER = 8 * ci.R     # the full group's order
LIMITS = {"ok_mismatch": 0, "bvk_mismatch": 0, "result_mismatch": 0,
          "coeff_mismatch": 0}
SAMPLE = 8           # unchanged lanes decoded again in Python integers


# -- [x] P0 on many lanes ---------------------------------------------------

@functools.lru_cache(maxsize=1)
def _comb_table() -> list[tuple[int, int]]:
    """[d 256^w] P0 for w < 32 and d < 256, entry 256 w + d."""
    out = []
    base = ci.GENERATOR
    for _ in range(32):
        acc = ci.IDENTITY
        for _ in range(256):
            out.append(acc)
            acc = ci.add(acc, base)
        base = acc
    return out


def encode_multiples(xs: list[int], device) -> torch.Tensor:
    """uint8 (32, n): the encodings of [x] P0 for each x of ``xs`` (taken
    modulo 8r).  Extended coordinates (X : Y : Z : T), T = XY/Z, plus an
    affine entry (u, v) with a = -1: E = X v + Y u, F = Z - d T u v,
    G = Z + d T u v, H = Y v + X u; then (E F : G H : F G : E H)."""
    table = _comb_table()
    n = len(xs)
    u = FQ.from_ints([p[0] for p in table], device)
    v = FQ.from_ints([p[1] for p in table], device)
    duv = FQ.from_ints([ci.EDWARDS_D * p[0] * p[1] for p in table], device)
    upv = FQ.add(u, v)
    digits = torch.from_numpy(generate.to_le_rows(
        [x % ORDER for x in xs])).to(device=device, dtype=torch.int64)
    X, Y = FQ.const(0, n, device), FQ.const(1, n, device)
    Z, T = FQ.const(1, n, device), FQ.const(0, n, device)
    for w in range(32):
        i = 256 * w + digits[w]
        eu, ev = u[:, i], v[:, i]
        A, B = FQ.mul(X, eu), FQ.mul(Y, ev)
        C = FQ.mul(T, duv[:, i])
        E = FQ.sub(FQ.sub(FQ.mul(FQ.add(X, Y), upv[:, i]), A), B)
        F, G, H = FQ.sub(Z, C), FQ.add(Z, C), FQ.add(B, A)
        X, Y, Z, T = FQ.mul(E, F), FQ.mul(G, H), FQ.mul(F, G), FQ.mul(E, H)
    zinv = FQ.invert(Z)
    return lanes.encode(FQ.mul(X, zinv), FQ.mul(Y, zinv)).cpu()


@functools.lru_cache(maxsize=1)
def _torsion() -> list[tuple[int, int]]:
    """[k r] P0 for k < 8: the points of small order."""
    return [ci.mul(ci.GENERATOR, k * ci.R) for k in range(8)]


def _encoded(x: int) -> torch.Tensor:
    return torch.frombuffer(bytearray(ci.to_bytes(ci.mul(ci.GENERATOR,
                                                         x % ORDER))),
                            dtype=torch.uint8)


# -- the batch in integers --------------------------------------------------

class Batch:
    """A pool batch as the reference reads it: the layout of its lanes and
    each lane's x, as the generator recorded it."""

    def __init__(self, pool: dict, b: int):
        batch = pool["batches"][b]
        self.batch = batch
        txs = batch["txs"]
        self.nt = len(txs)
        self.so = list(accumulate((s for s, _ in txs), initial=0))
        self.oo = list(accumulate((o for _, o in txs), initial=0))
        self.ns, self.no = self.so[-1], self.oo[-1]
        ns, no = self.ns, self.no
        # the first lane of each role: cv, rk, R of the spends, cv, epk of
        # the outputs, the binding signatures' R
        self.cv_s, self.rk, self.r_s = 0, ns, 2 * ns
        self.cv_o, self.epk, self.r_t = 3 * ns, 3 * ns + no, 3 * ns + 2 * no
        self.x = batch["x"]
        self.base_x = pool["base_x"]

    def _tx_of(self, lanes: list[int]) -> set[int]:
        """The transactions that hold ``lanes``."""
        ns, no = self.ns, self.no
        so, oo = np.array(self.so), np.array(self.oo)
        out = set()
        for i in lanes:
            if i < self.cv_o:
                t = np.searchsorted(so, i % ns if ns else 0, side="right") - 1
            elif i < self.r_t:
                t = np.searchsorted(oo, (i - self.cv_o) % no, side="right") - 1
            else:
                t = i - self.r_t
            out.add(int(t))
        return out

    def ok(self, small_order: bool) -> list[bool]:
        bad = list(self.batch["undecodable"])
        if small_order:
            x, r = self.x, ci.R
            ruled = chain(range(self.cv_s, self.r_s),    # cv, rk
                          range(self.cv_o, self.r_t))    # cv, epk
            bad += [i for i in ruled if x[i] % r == 0]
        dropped = self._tx_of(bad)
        return [t not in dropped for t in range(self.nt)]

    def bvk_x(self) -> list[int]:
        xv, v, x = self.base_x[2], self.batch["v"], self.x
        ps = list(accumulate(x[self.cv_s:self.cv_s + self.ns], initial=0))
        po = list(accumulate(x[self.cv_o:self.cv_o + self.no], initial=0))
        so, oo = self.so, self.oo
        return [(ps[so[t + 1]] - ps[so[t]] - po[oo[t + 1]] + po[oo[t]]
                 - v[t] * xv) % ORDER for t in range(self.nt)]

    def terms(self, ok: list[bool], bvk: list[int]):
        """(coefficients, x) of the batch equation's terms, in the
        program's order: z_j R_j, z_j c_j rk_j, z_t R_t, z_t c_t bvk_t, and
        the two basepoints' -sum z S; a dropped transaction's terms 0."""
        z, c, S = self.batch["z"], self.batch["c"], self.batch["S"]
        ns, nt, x = self.ns, self.nt, self.x
        kept = [ok[t] for t in range(nt)
                for _ in range(self.so[t + 1] - self.so[t])] + ok
        zz = [zi if k else 0 for zi, k in zip(z, kept)]
        coef = (zz[:ns] + [a * b for a, b in zip(zz[:ns], c)] + zz[ns:]
                + [a * b for a, b in zip(zz[ns:], c[ns:])]
                + [-sum(a * b for a, b in zip(zz[:ns], S)),
                   -sum(a * b for a, b in zip(zz[ns:], S[ns:]))])
        xs = (x[self.r_s:self.r_s + ns] + x[self.rk:self.rk + ns]
              + x[self.r_t:self.r_t + nt] + bvk + list(self.base_x[:2]))
        return coef, xs

    def self_check(self, g) -> None:
        enc = self.encodings()
        for i in self.batch["undecodable"]:
            if ci.from_bytes(enc(i)) is not None:
                raise RuntimeError(f"generator fault: lane {i} decodes")
        changed = set(self.batch["over"])
        rest = np.setdiff1d(np.arange(len(self.x)),
                            np.array(sorted(changed | set(
                                self.batch["undecodable"])), dtype=np.int64))
        sample = g.choice(rest, size=min(SAMPLE, len(rest)), replace=False)
        for i in sorted(changed) + [int(i) for i in sample]:
            x = self.x[i] % ORDER
            want = (_torsion()[x // ci.R] if x % ci.R == 0
                    else ci.mul(ci.GENERATOR, x))
            # an encoding names one point, and a point has one encoding
            if enc(i) != ci.to_bytes(want):
                raise RuntimeError(f"generator fault: lane {i} is not [x]P0")

    def encodings(self):
        """Lane -> its 32 bytes, as the timed path uploads them."""
        b = self.batch
        sp, out, rt = (np.asarray(b[k]) for k in ("spends", "outputs",
                                                  "binding_r"))

        def enc(i: int) -> bytes:
            if i < self.cv_o:
                col = sp[:, i // self.ns, i % self.ns]
            elif i < self.r_t:
                k = i - self.cv_o
                col = out[:, k // self.no, k % self.no]
            else:
                col = rt[:, i - self.r_t]
            return bytes(col)
        return enc


def _equation(terms, count: int | None = None) -> int:
    """The sum of the first ``count`` (all) terms' coefficient times x,
    mod r."""
    coef, xs = terms
    n = len(coef) if count is None else count
    return sum(k * x for k, x in zip(coef[:n], xs[:n])) % ci.R


def _coeffs(terms) -> torch.Tensor:
    """uint8 (32, 2): the basepoints' coefficients sum z S of each kind, the
    negated last two terms, as canonical scalar bytes."""
    return torch.from_numpy(generate.to_le_rows(
        [-k % ci.R for k in terms[0][-2:]]).astype(np.uint8))


def expected(pool: dict, b: int, device, small_order: bool = True) -> dict:
    """The answers for pool batch ``b``: ``ok`` (T,), repr(bvk) uint8
    (32, T), the equation's encoding uint8 (32,) and its basepoints'
    coefficients uint8 (32, 2), on the host; ``sigs``, the signatures of
    the batch.  ``small_order=False`` computes the
    control: the same reference with the small-order rule left out."""
    ref = Batch(pool, b)
    ref.self_check(generate.rng(pool["seed"], 6, b))
    ok = ref.ok(small_order)
    bvk = ref.bvk_x()
    terms = ref.terms(ok, bvk)
    s = _equation(terms)
    if small_order and (s == 0) != (ref.batch["off"] is None):
        raise RuntimeError(f"generator fault: batch {b} sums to {s}")
    return {"ok": torch.tensor(ok, dtype=torch.bool),
            "bvk": encode_multiples(bvk, device),
            "result": _encoded(8 * s), "coeffs": _coeffs(terms),
            "sigs": ref.ns + ref.nt}


def compare(outputs: list[tuple[int, dict]], want: dict) -> dict:
    """``outputs``: (pool index, the path's outputs) for every batch of the
    window; ``want``: pool index -> ``expected``.  Returns the numbers
    compared (transactions whose ``ok`` differs, valid transactions whose
    repr(bvk) differs, batches whose result differs, batches whose
    coefficients differ) and the signatures that failed: those of a batch
    with any difference."""
    ok_off = bvk_off = res_off = coeff_off = failed = 0
    for b, out in outputs:
        w = want[b]
        nt = w["ok"].numel()
        got_ok, got_bvk, got = out["ok"], out["bvk"], out["result"]
        if got_ok.shape != w["ok"].shape or got_ok.dtype != torch.bool:
            lanes_off = nt
        else:
            lanes_off = int((got_ok != w["ok"]).sum())
        if got_bvk.shape != w["bvk"].shape or got_bvk.dtype != torch.uint8:
            bvks = int(w["ok"].sum())
        else:
            bvks = int(((got_bvk != w["bvk"]).any(0) & w["ok"]).sum())
        res = int(got.shape != w["result"].shape or got.dtype != torch.uint8
                  or not torch.equal(got, w["result"]))
        got_k = out["coeffs"]
        coeff = int(got_k.shape != w["coeffs"].shape
                    or got_k.dtype != torch.uint8
                    or not torch.equal(got_k, w["coeffs"]))
        ok_off, bvk_off = ok_off + lanes_off, bvk_off + bvks
        res_off, coeff_off = res_off + res, coeff_off + coeff
        failed += w["sigs"] if lanes_off or bvks or res or coeff else 0
    return {"ok_mismatch": ok_off, "bvk_mismatch": bvk_off,
            "result_mismatch": res_off, "coeff_mismatch": coeff_off}, failed


# -- the control and the faults (``portbench/control.py``) ------------------

def _unchanged(pool, b, want, device):
    ident = torch.frombuffer(bytearray(ci.to_bytes(ci.IDENTITY)),
                             dtype=torch.uint8)
    return dict(want, bvk=ident[:, None].expand_as(want["bvk"]).clone(),
                result=ident.clone(), coeffs=torch.zeros_like(want["coeffs"]))


def _half(pool, b, want, device):
    ref = Batch(pool, b)
    bvk = ref.bvk_x()
    terms = ref.terms(want["ok"].tolist(), bvk)
    half = len(terms[0]) // 2
    return dict(want, result=_encoded(8 * _equation(terms, half)))


def _second_half_cut(pool, b, want):
    """The batch, its terms with ``ok``, and its terms with the second half
    of the transactions dropped as well."""
    ref = Batch(pool, b)
    bvk, ok = ref.bvk_x(), want["ok"].tolist()
    cut = [k and t < ref.nt // 2 for t, k in enumerate(ok)]
    return ref.terms(ok, bvk), ref.terms(cut, bvk)


def _second_half_out(pool, b, want, device):
    _, cut = _second_half_cut(pool, b, want)
    return dict(want, result=_encoded(8 * _equation(cut)),
                coeffs=_coeffs(cut))


def _second_half_points_out(pool, b, want, device):
    full, cut = _second_half_cut(pool, b, want)
    return dict(want, result=_encoded(8 * _equation(
        (cut[0][:-2] + full[0][-2:], cut[1]))))


def _altered(pool, b, want, device):
    bvk = want["bvk"].clone()
    t = int(want["ok"].nonzero()[0])
    bvk[0, t] ^= 1
    return dict(want, bvk=bvk)


# reading -> (how ``expected`` is called, what is broken in its answer)
READINGS = {
    "control: small-order rule left out": ({"small_order": False}, None),
    "fault: state unchanged": ({}, _unchanged),
    "fault: half the batch equation left out": ({}, _half),
    "fault: the second half of the transactions left out":
        ({}, _second_half_out),
    "fault: the second half's points left out, their z S kept":
        ({}, _second_half_points_out),
    "fault: an answer altered": ({}, _altered),
}
