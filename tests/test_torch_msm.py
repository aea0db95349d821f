"""Multi-scalar multiplication in the port: the window-sums kernel's plain
version, the tensor-level ``parallel.msm`` path, the Horner spine and its
folded form, and ``msm_fused`` / ``msm`` end to end.  Against one JAX trace
of the reference package's interpreted ``window_sums_fused`` and one of its
``horner_spine`` (shared through ``jax_results``), and against the Python-int
oracle.  All exact: window sums agree with the reference package as group
elements (after normalisation, since the order of the commutative partial
sums differs), the spine limb for limb.  The reference results are
computed once per session (``jax_results``), each by the reference package's
own calls at the shapes of its own MSM tests."""

import pytest
import torch

import jubjub_tpu_torch as jj
from jubjub_tpu_torch import convert, oracle, stages
from jubjub_tpu_torch.curve import reduce_sum
from jubjub_tpu_torch.curve.scalar_mul import (generator_table,
                                               signed_window_digits_wide)
from jubjub_tpu_torch.fields import Fr
from jubjub_tpu_torch.ops import msm as msm_ops
from jubjub_tpu_torch.parallel.msm import horner_spine, window_sums

from helpers_torch import (CPU, EXT, MSM_POINTS, affine_ints_to_extended,
                           assert_points_equal, jax_results,  # a fixture
                           msm_inputs, rand_ints, spine_inputs)


def points_and_scalars(s: list[int], k: list[int]):
    """P_i = [s_i]G8 from the fixed-base path, and the scalars k_i."""
    pts = generator_table().mul_fused(Fr.from_int(s, device=CPU))
    return pts, Fr.from_int(k, device=CPU)


def expected(s: list[int], k: list[int]) -> tuple[int, int]:
    """sum_i k_i [s_i]G8 = [sum_i k_i s_i mod r]G8, on the host."""
    return oracle.mul(oracle.SUBGROUP_GENERATOR,
                      sum(a * b for a, b in zip(s, k)) % oracle.R)


def affine(p) -> list[tuple[int, int]]:
    aff = jj.batch_normalize(p)
    u, v = aff.u.to_ints(), aff.v.to_ints()
    return list(zip(u, v)) if isinstance(u, list) else [(u, v)]


def ws_from(ref: dict):
    return convert.extended_from_numpy(*[ref[c] for c in EXT], device=CPU)


@pytest.fixture(scope="module")
def fixture_points():
    s, k = msm_inputs()
    return s, k, *points_and_scalars(s, k)


def partial_sums(acc):
    """Per-block partials (5, 20, nwin, blocks) -> window sums (nwin,)."""
    return reduce_sum(jj.ExtendedPoint(*[jj.Fq(acc[c]) for c in range(5)]),
                      axis=1)


def test_window_sums_equal_reference_package(jax_results, fixture_points):
    """Signed 5-bit window sums: the kernel's plain version (through
    ``window_sums_fused`` on the CPU, as an H100 would split the points, and
    directly at 100 blocks) and, unsigned 4-bit, the tensor-level ``window_sums`` are the
    reference package's window sums as points, and the unsigned ones
    recombine to the oracle's MSM."""
    s, k, pts, ks = fixture_points
    want = affine(ws_from(jax_results.window_sums()))
    assert len(want) == 51
    assert affine(msm_ops.window_sums_fused(pts, ks, wbits=5,
                                            signed=True)) == want
    t = pts.t1 * pts.t2
    acc = msm_ops.msm_window_sums(
        (pts.u.limbs, pts.v.limbs, pts.z.limbs, t.limbs),
        signed_window_digits_wide(ks, 5), 5, True, 100)  # 86 blocks of 3, 1
    assert affine(partial_sums(acc)) == want
    unsigned = msm_ops.window_sums_fused(pts, ks, wbits=4, signed=False)
    tensor_level = window_sums(pts, ks, chunk=16)
    assert affine(unsigned) == affine(tensor_level)
    acc = oracle.IDENTITY
    for w, pt in enumerate(affine(tensor_level)):
        acc = oracle.add(acc, oracle.mul(pt, 1 << (4 * w)))
    assert acc == expected(s, k)


def test_horner_spine_limb_for_limb(jax_results):
    ws = affine_ints_to_extended(jj, spine_inputs(), device=CPU)
    got = horner_spine(ws, wbits=5)
    assert_points_equal(got, jax_results.horner_spine(), EXT)
    acc = oracle.IDENTITY
    for w, pt in enumerate(spine_inputs()):
        acc = oracle.add(acc, oracle.mul(pt, 1 << (5 * w)))
    assert affine(got) == [acc]
    # the folded spine of msm_fused: the same group element
    assert affine(msm_ops.fold_window_sums(ws, 5)) == affine(got)


@pytest.mark.parametrize("nwin,wbits", [(51, 5), (16, 16)])
def test_fold_window_sums_against_horner_spine_and_oracle(nwin, wbits):
    """The fold on the CPU (``fold_plain``, the steps of the card's
    ``msm_fold``) over window sums of the full group: torsion-carrying
    points, a point of small order and the identity among them.  Its
    encoding is the reference's spine's and the oracle's, at ``msm_fused``'s
    51 windows of 5 bits and ``msm_pippenger``'s 16 of 16."""
    ms = rand_ints(500 + nwin, nwin, 8 * oracle.R)
    ms[1], ms[2] = 0, 3 * oracle.R  # the identity; a point of order 8
    pts = [oracle.mul(oracle.GENERATOR, m) for m in ms]
    ws = affine_ints_to_extended(jj, pts, device=CPU)
    want = oracle.IDENTITY
    for w, pt in enumerate(pts):
        want = oracle.add(want, oracle.mul(pt, 1 << (wbits * w)))
    assert oracle.mul(want, oracle.R) != oracle.IDENTITY  # torsion remains
    for got in (msm_ops.fold_window_sums(ws, wbits),
                horner_spine(ws, wbits=wbits)):
        assert got.shape == ()
        enc = jj.batch_normalize(got).to_bytes()
        assert bytes(enc.numpy()) == oracle.to_bytes(want)


def test_plain_partials_lane_order():
    """The plain version's block split: block b sums the points
    [b*P, (b+1)*P), P = ceil(N / blocks), in the kernel's order, so a
    block's partial is limb for limb the one-block sum of its points, a
    block without points holds the identity, and summing the partials of
    every window gives the same points for any block count."""
    s = rand_ints(41, 9, oracle.R)
    k = [0] + rand_ints(42, 8, oracle.R)
    pts, ks = points_and_scalars(s, k)
    t = pts.t1 * pts.t2
    planes = (pts.u.limbs, pts.v.limbs, pts.z.limbs, t.limbs)
    digits = signed_window_digits_wide(ks, 5)
    sums = []
    for blocks in (1, 4, 9, 12):
        acc = msm_ops.msm_window_sums(planes, digits, 5, True, blocks)
        assert tuple(acc.shape) == (5, 20, 51, blocks)
        sums.append(affine(partial_sums(acc)))
    assert sums[0] == sums[1] == sums[2] == sums[3]
    # 4 blocks of P = 3: points 3..5 are block 1's, block 3 has none
    acc = msm_ops.msm_window_sums(planes, digits, 5, True, 4)
    one = msm_ops.msm_window_sums([x[:, 3:6] for x in planes], digits[:, 3:6],
                                  5, True, 1)
    assert torch.equal(acc[..., 1], one[..., 0])
    empty = jj.ExtendedPoint(*[jj.Fq(acc[c, :, :, 3]) for c in range(5)])
    assert bool(empty.is_identity().all())
    # an H100 SXM's split on the CPU, at most one block a chunk of points
    sms = 132 * msm_ops.BLOCKS_PER_SM
    assert msm_ops.n_blocks(1 << 20, CPU) == sms
    assert msm_ops.n_blocks(5 * msm_ops.CHUNK + 1, CPU) == min(6, sms)
    assert msm_ops.n_blocks(9, CPU) == 1 and msm_ops.n_blocks(0, CPU) == 1
    with pytest.raises(ValueError, match="blocks"):
        msm_ops.msm_window_sums(planes, digits, 5, True, 0)
    with pytest.raises(ValueError, match="digits"):
        msm_ops.msm_window_sums(planes, digits, 4, False, 1)
    with pytest.raises(ValueError, match="table entries"):
        msm_ops.msm_window_sums(planes, torch.zeros((42, 9), dtype=torch.int32),
                                6, False, 1)
    with pytest.raises(ValueError, match="windows"):
        msm_ops.msm_window_sums(planes, torch.zeros((84, 9), dtype=torch.int32),
                                3, False, 1)


@pytest.mark.parametrize("n", [1, 16, 48, 200, 4099])
def test_msm_fused_against_oracle(n):
    """Batches no block or lane count divides, a single point, and zero
    scalars among the inputs."""
    s = rand_ints(100 + n, n, oracle.R)
    k = rand_ints(200 + n, n, oracle.R)
    k[::5] = [0] * len(k[::5])
    k[-1] = oracle.R - 1
    pts, ks = points_and_scalars(s, k)
    names = []
    with stages.recording(names.append):
        out = jj.msm_fused(pts, ks)
    assert out.shape == ()
    assert affine(out) == [expected(s, k)]
    assert names == ["digits", "window_sums_kernel", "partial_reduction",
                     "spine"]


@pytest.mark.parametrize("n,chunk,sequential",
                         [(16, 16, False), (48, 10, True)])
def test_msm_tensor_level_against_oracle(n, chunk, sequential):
    """One chunk, and a ragged last chunk with the chunk sums folded in
    order (``reduce_sum(sequential=True)``)."""
    s = rand_ints(300 + n, n, oracle.R)
    k = rand_ints(400 + n, n, oracle.R)
    k[0] = 0
    pts, ks = points_and_scalars(s, k)
    out = jj.msm(pts, ks, chunk=chunk, sequential=sequential)
    assert affine(out) == [expected(s, k)]


def test_msm_all_zero_scalars_is_identity(fixture_points):
    _, _, pts, _ = fixture_points
    zero = Fr.from_int([0] * MSM_POINTS, device=CPU)
    assert bool(jj.msm_fused(pts, zero).is_identity())
    assert bool(jj.msm_fused(pts, zero, wbits=4, signed=False).is_identity())


def test_msm_fused_decoded_points(fixture_points):
    """The slice: encodings -> affine_from_bytes -> to_extended -> msm_fused
    -> batch_normalize -> to_bytes."""
    s, k, pts, ks = fixture_points
    enc = jj.batch_normalize(pts).to_bytes()
    names = []
    with stages.recording(names.append):
        dec, ok = jj.affine_from_bytes(enc)
    assert names == ["from_bytes", "batch_invert", "sqrt"]
    assert bool(ok.all())
    out = jj.batch_normalize(jj.msm_fused(dec.to_extended(), ks)).to_bytes()
    assert bytes(out.numpy()) == oracle.to_bytes(expected(s, k))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (32,)
