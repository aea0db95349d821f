"""``segment_sum`` and ``verify_bundles`` on the CPU, exactly, against the
benchmark's plain reference: sums in Python integers
(``portbench/reference/curve_int.py``) and the bundle reference
(``portbench/reference/bundle_verify.py``), which works its answers out from
the points' discrete logs and imports nothing of the port."""

import random
from itertools import accumulate

import numpy as np
import pytest
import torch

import jubjub_tpu_torch as jj
from jubjub_tpu_torch.curve.points import AffinePoint
from portbench import generate, harness
from portbench.reference import curve_int as ci

SEED = (1 << 31) + 14014
# every shape of the benchmark's mix, the long one once
SHAPES = [[1, 2, 2], [0, 2, 2], [2, 2, 2], [4, 2, 2], [1, 5, 2], [64, 2, 1]]
INPUTS = ("spends", "outputs", "binding_r", "spend_offsets", "output_offsets",
          "value_balance", "spend_scalars", "binding_scalars")
TORSION = [ci.mul(ci.GENERATOR, k * ci.R) for k in range(8)]


def _affine(points) -> AffinePoint:
    return AffinePoint.from_raw_unchecked([p[0] for p in points],
                                          [p[1] for p in points], device="cpu")


@pytest.mark.parametrize("lens", [
    [1, 1, 1, 1],            # segments of one lane
    [3, 5, 7, 1],            # odd lengths
    [2, 0, 3, 0, 4, 0],      # empty segments, one last
    [1, 2, 19, 3, 2],        # one longer than the others put together
    [0, 0],                  # no lane at all
])
def test_segment_sum_against_python_integers(lens):
    rnd = random.Random(len(lens) * 1000 + sum(lens))
    pts = [ci.add(ci.mul(ci.SUBGROUP_GENERATOR, rnd.randrange(ci.R)),
                  TORSION[rnd.randrange(8)]) for _ in range(sum(lens))]
    offsets = torch.tensor(list(accumulate(lens, initial=0)),
                           dtype=torch.int64)
    # doubled, so that no input has z = 1
    doubled = _affine(pts or [ci.IDENTITY]).to_extended().double()
    if not pts:
        doubled = jj.ExtendedPoint(*[jj.Fq(getattr(doubled, c).limbs[:, :0])
                                     for c in ("u", "v", "z", "t1", "t2")])
    out = jj.batch_normalize(jj.segment_sum(doubled, offsets))
    got = list(zip(out.u.to_ints(), out.v.to_ints()))
    want = []
    for s in range(len(lens)):
        acc = ci.IDENTITY
        for p in pts[offsets[s]:offsets[s + 1]]:
            acc = ci.add(acc, ci.add(p, p))
        want.append(acc)
    assert got == want


def test_segment_sum_rejects_a_batch_of_two_axes():
    p = jj.ExtendedPoint.identity((2, 3), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        jj.segment_sum(p, torch.tensor([0, 6]))


@pytest.fixture(scope="module")
def bundles():
    """The bundle cell's second batch at a small size (every invalid kind,
    two torsion-carrying valid transactions, one S off by one), through
    ``verify_bundles`` on the CPU, and the reference's answers."""
    cell = harness.load_cell("bundle-256k-tx")
    mix = dict(cell.mix, transactions=11, shapes=SHAPES, torsion_valid=2,
               invalid_txs=5)
    pool = generate.pin(generate.pool(mix, cell.config, SEED, "cpu"), "cpu")
    batch = pool["batches"][1]
    got = jj.verify_bundles(*[batch[k] for k in INPUTS], pool["bases"])
    ref = harness.load_module("reference", "bundle_verify")
    return pool, batch, got, ref.expected(pool, 1, "cpu")


def test_the_batch_covers_every_shape_kind_and_fault(bundles):
    pool, batch, _, want = bundles
    assert {tuple(s[:2]) for s in SHAPES} == set(batch["txs"])
    assert set(batch["invalid"].values()) == {
        "non_canonical_cv", "small_order_spend_cv", "small_order_rk",
        "small_order_output_cv", "small_order_epk"}
    assert batch["off"] is not None
    assert int((~want["ok"]).sum()) == 5


def test_verify_bundles_ok_bvk_and_result_exactly(bundles):
    _, _, (ok, bvk, result, coeffs), want = bundles
    assert ok.dtype == torch.bool and torch.equal(ok, want["ok"])
    assert bvk.shape == want["bvk"].shape and bvk.dtype == torch.uint8
    assert torch.equal(bvk[:, ok], want["bvk"][:, ok])
    assert torch.equal(result, want["result"])
    assert coeffs.dtype == torch.uint8 and torch.equal(coeffs, want["coeffs"])
    # one S off by one: the equation is not the identity
    assert bytes(result.numpy()) != ci.to_bytes(ci.IDENTITY)


def _torsion_rk(pool, batch):
    """(transaction, encoding) of the valid rk that carries torsion."""
    ns = batch["spend_offsets"][-1].item()
    so = batch["spend_offsets"].tolist()
    for lane, x in batch["over"].items():
        if ns <= lane < 2 * ns and x % ci.R:
            j = lane - ns
            t = int(np.searchsorted(so, j, side="right")) - 1
            return t, batch["spends"][:, 1, j]
    raise AssertionError("no torsion-carrying rk in the batch")


def test_the_small_order_rule_is_not_the_subgroup_check(bundles):
    """A valid rk with a torsion part fails ``is_torsion_free`` but passes
    the consensus rule, [8] rk != O: its transaction is kept."""
    pool, batch, (ok, *_), _ = bundles
    t, enc = _torsion_rk(pool, batch)
    point, dec_ok = jj.affine_from_bytes(enc[:, None])
    assert bool(dec_ok.all())
    assert not bool(point.is_torsion_free().any())
    assert not bool(point.is_small_order().any())
    assert bool(ok[t])


def test_verify_bundles_refuses_a_misshapen_input(bundles):
    pool, batch, _, _ = bundles
    args = [batch[k] for k in INPUTS]
    args[0] = args[0][:, :2]
    with pytest.raises(ValueError, match="spends"):
        jj.verify_bundles(*args, pool["bases"])
