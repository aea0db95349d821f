"""Generator of the ``bundle_verify`` traffic mixes: ``traffic/<mix>.json``
with ``"kind": "bundle_verify"``.  ``make(mix, config, seed, device)``
gives the pool."""

from __future__ import annotations

import functools
import hashlib
from itertools import accumulate, repeat

import numpy as np

from portbench.generate import invalid_encoding, points, rng
from portbench.reference import curve_int as ci

# the keys of a mix of this kind, besides ``kind``
PARAMS = ("pool", "transactions", "shapes", "torsion_valid", "invalid_every",
          "invalid_txs", "invalid_kinds")
KINDS = ("non_canonical_cv", "small_order_spend_cv", "small_order_rk",
         "small_order_output_cv", "small_order_epk")
MAX_MONEY = 21_000_000 * 100_000_000
# G (spend authorisation), R (value commitment randomness) and V (value):
# [k] G8 for three fixed k, in place of the spec's FindGroupHash points
BASE_LOGS = tuple(
    int.from_bytes(hashlib.sha256(tag).digest(), "little") % ci.R
    for tag in (b"Zcash_G_", b"Zcash_cv r", b"Zcash_cv v"))


@functools.lru_cache(maxsize=1)
def torsion() -> list[tuple[int, int]]:
    """The 8-torsion points T_k = [k r] P0, k < 8 (T_0 the identity)."""
    return [ci.mul(ci.GENERATOR, k * ci.R) for k in range(8)]


def _shapes(mix: dict) -> list[tuple[int, int]]:
    """Each transaction's (spends, outputs): ``transactions`` split over
    ``shapes`` [spends, outputs, weight] in proportion to the weights."""
    total = sum(w for _, _, w in mix["shapes"])
    out = []
    for ns, no, w in mix["shapes"]:
        if mix["transactions"] * w % total:
            raise ValueError(f"bundle_verify: {mix['transactions']} "
                             f"transactions do not split by {w}/{total}")
        out += [(ns, no)] * (mix["transactions"] * w // total)
    return out


def _xs(prog, n: int) -> list[int]:
    """x = 8e mod 8r of the first ``n`` lanes of ``generate.points``, e
    the lane's discrete log (``generate.dlogs``)."""
    a0, a1, b0, b1, K = prog
    r8 = 8 * ci.R
    betas = [8 * ((b0 + k * b1) % ci.R) for k in range(K)]
    out = []
    for j in range(-(-n // K)):
        alpha = 8 * ((a0 + j * a1) % ci.R)
        out += [(alpha + beta) % r8 for beta in betas]
    del out[n:]
    return out


def _scalars(g, n: int) -> list[int]:
    """``n`` seeded scalars below r, from 32 uniform bytes each."""
    raw = g.bytes(32 * n)
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % ci.R
            for i in range(n)]


def _le_rows(values, n: int) -> np.ndarray:
    """Python ints below 2^256 -> uint8 (32, len(values) // n, n)."""
    raw = b"".join(map(int.to_bytes, values, repeat(32), repeat("little")))
    return np.ascontiguousarray(
        np.frombuffer(raw, np.uint8).reshape(-1, 32).T.reshape(32, -1, n))


def make(mix: dict, config: dict, seed: int, device) -> dict:
    """Sapling bundle validation: a batch is ``transactions`` transactions,
    the multiset of shapes the same in every batch and its order seeded.
    Every point is [e] G8 from one seeded progression (``generate.points``;
    an odd-numbered batch takes the previous batch's progression negated),
    its x = 8e recorded modulo 8r (``reference/bundle_verify.py``);
    signatures are made from those logs with seeded challenges c and 128-bit
    z, and valueBalance is seeded below MAX_MONEY.  ``torsion_valid``
    transactions of each batch take an 8-torsion point T_k (k > 0) into an
    rk (the even ones) or an output's cv (the odd ones), which the rules
    accept.  In every batch whose index in the pool is ``invalid_every - 1``
    modulo ``invalid_every``, ``invalid_txs`` transactions fail a check,
    taking ``invalid_kinds`` in turn (a v of q or more on a spend's cv, then
    on an output's, in turn; a small-order point, T_k with k < 8, in the
    field the kind names), with random signatures; and one valid
    transaction has a spend-authorisation S off by one."""
    bad_kinds = [k for k in mix["invalid_kinds"] if k not in KINDS]
    if bad_kinds:
        raise ValueError(f"bundle_verify: unknown invalid kinds {bad_kinds}")
    shapes = _shapes(mix)
    zbits = config["sizes"]["z_bits"]
    base_x = tuple(8 * k for k in BASE_LOGS)
    inv_g, inv_r = (pow(x, -1, ci.R) for x in base_x[:2])
    batches = []
    for b in range(mix["pool"]):
        g = rng(seed, 5, b)
        txs = [shapes[i] for i in g.permutation(len(shapes))]
        nt = len(txs)
        so = np.concatenate([[0], np.cumsum([s for s, _ in txs])])
        oo = np.concatenate([[0], np.cumsum([o for _, o in txs])])
        ns, no = int(so[-1]), int(oo[-1])
        cv_s, rk, cv_o, epk, r_t = 0, ns, 3 * ns, 3 * ns + no, 3 * ns + 2 * no
        if b % 2 == 0:
            fresh, prog = points(g, 3 * ns + 2 * no + nt, device)
            enc = fresh.copy()
        else:
            # the previous batch's progression negated: -P flips the sign
            # bit of P's encoding (no lane is the identity), so the card
            # encodes half the pool's points
            prog = tuple((-a) % ci.R for a in prog[:4]) + prog[4:]
            enc = fresh.copy()
            enc[31] ^= 0x80
        x = _xs(prog, enc.shape[1])
        over, undecodable, used = {}, [], set()

        def pick(need_spend: bool) -> int:
            """A transaction not picked before, with a spend if asked."""
            def fits(t):
                return t not in used and (txs[t][0] or not need_spend)
            t = int(g.integers(nt))
            if not fits(t):
                free = [t for t in range(nt) if fits(t)]
                if not free:
                    raise ValueError("bundle_verify: too few transactions for "
                                     "the mix's torsion, invalid and bad "
                                     "signatures")
                t = free[int(g.integers(len(free)))]
            used.add(t)
            return t

        def patch(lane: int, point, xl: int) -> None:
            enc[:, lane] = np.frombuffer(ci.to_bytes(point), np.uint8)
            over[lane] = xl % (8 * ci.R)

        # what each picked transaction carries, and whether it needs a
        # spend; those that do are placed first, so a mix that fits is met
        plan = [("torsion_rk", True) if i % 2 == 0 else ("torsion_cv", False)
                for i in range(mix["torsion_valid"])]
        if b % mix["invalid_every"] == mix["invalid_every"] - 1:
            kinds = [mix["invalid_kinds"][i % len(mix["invalid_kinds"])]
                     for i in range(mix["invalid_txs"])]
            noncanon = 0
            for kind in kinds:
                if kind == "non_canonical_cv":
                    plan.append(("non_canonical_cv",
                                 "spend" if noncanon % 2 == 0 else "output"))
                    noncanon += 1
                else:
                    plan.append((kind, kind in ("small_order_spend_cv",
                                                "small_order_rk")))
            plan.append(("bad_s", True))
        invalid, off = {}, None
        for what, where in sorted(plan, key=lambda p: p[1] not in (True,
                                                                     "spend")):
            t = pick(where in (True, "spend"))
            s0, o0 = int(so[t]), int(oo[t])
            if what == "bad_s":
                off = s0
            elif what.startswith("torsion"):
                lane = rk + s0 if what == "torsion_rk" else cv_o + o0
                k = 1 + int(g.integers(7))
                patch(lane, ci.add(ci.from_bytes(bytes(enc[:, lane])),
                                   torsion()[k]), x[lane] + k * ci.R)
            elif what == "non_canonical_cv":
                invalid[t] = what
                lane = cv_s + s0 if where == "spend" else cv_o + o0
                enc[:, lane] = np.frombuffer(
                    invalid_encoding(g, "non_canonical_v"), np.uint8)
                undecodable.append(lane)
            else:
                invalid[t] = what
                lane = {"small_order_spend_cv": cv_s + s0,
                        "small_order_rk": rk + s0,
                        "small_order_output_cv": cv_o + o0,
                        "small_order_epk": epk + o0}[what]
                k = int(g.integers(8))
                patch(lane, torsion()[k], k * ci.R)

        for lane, xl in over.items():
            x[lane] = xl
        c = _scalars(g, ns + nt)
        w = zbits // 8
        zraw = g.bytes(w * (ns + nt))
        z = [int.from_bytes(zraw[w * j:w * j + w], "little")
             for j in range(ns + nt)]
        v = [int(a) for a in g.integers(1 - MAX_MONEY, MAX_MONEY, size=nt)]
        S = [(xr + cj * xk) * inv_g % ci.R for xr, cj, xk in
             zip(x[2 * ns:3 * ns], c, x[rk:rk + ns])]
        sol, ool = so.tolist(), oo.tolist()
        ps = list(accumulate(x[cv_s:cv_s + ns], initial=0))
        po = list(accumulate(x[cv_o:cv_o + no], initial=0))
        S += [(x[r_t + t] + c[ns + t] * (ps[sol[t + 1]] - ps[sol[t]]
                                         - po[ool[t + 1]] + po[ool[t]]
                                         - v[t] * base_x[2])) * inv_r % ci.R
              for t in range(nt)]
        for t in invalid:   # random signatures
            for j in list(range(sol[t], sol[t + 1])) + [ns + t]:
                S[j] = _scalars(g, 1)[0]
        if off is not None:
            S[off] = (S[off] + 1) % ci.R

        def scalars(lo: int, n: int) -> np.ndarray:
            zs, cs, ss = z[lo:lo + n], c[lo:lo + n], S[lo:lo + n]
            return _le_rows(zs + [a * b % ci.R for a, b in zip(zs, cs)]
                            + [a * b % ci.R for a, b in zip(zs, ss)], n)

        batches.append({
            "spends": enc[:, :3 * ns].reshape(32, 3, ns).copy(),
            "outputs": enc[:, cv_o:r_t].reshape(32, 2, no).copy(),
            "binding_r": enc[:, r_t:].copy(),
            "spend_offsets": so.astype(np.int64),
            "output_offsets": oo.astype(np.int64),
            "value_balance": np.array(v, dtype=np.int64),
            "spend_scalars": scalars(0, ns),
            "binding_scalars": scalars(ns, nt),
            "txs": txs, "prog": prog, "over": over, "x": x,
            "undecodable": undecodable, "z": z, "c": c, "S": S, "v": v,
            "invalid": invalid, "off": off})
    nsig = sum(s for s, _ in shapes) + len(shapes)
    return {"kind": "bundle_verify", "batches": batches, "work": nsig,
            "bases": [ci.mul(ci.SUBGROUP_GENERATOR, k) for k in BASE_LOGS],
            "base_x": base_x,
            "shape": {"transactions": len(shapes),
                      "spends": sum(s for s, _ in shapes),
                      "outputs": sum(o for _, o in shapes),
                      "signatures": nsig}}
