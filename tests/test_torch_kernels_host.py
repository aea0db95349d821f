"""The CUDA sources, compiled as plain C++ for the host.

``csrc/*.cu`` also build without ``nvcc``: each entry point then runs its
lane function in a loop on the CPU.  That holds the arithmetic the GPU
kernels are made of (limb products, Montgomery rounds, borrow chains, the
group law, table lookup, window loops) against the plain PyTorch versions
where there is no GPU.  Launch, indexing by thread and memory behaviour are
checked on the card by ``chip_smoke.py``.

The tests that take ``phase_libs`` run once for each product phase of the
field core (``csrc/field.cuh``): the sources built as they are
(schoolbook) and with ``-DJJ_MUL_KARATSUBA``; the others take the package's
own phase (``config.kernels_karatsuba``)."""

import ctypes
import os
import shutil

import filelock
import numpy as np
import pytest
import torch

from jubjub_tpu_torch import oracle
from jubjub_tpu_torch.curve import ExtendedPoint
from jubjub_tpu_torch.curve import scalar_mul as sm
from jubjub_tpu_torch.fields import Fq, Fr, mont
from jubjub_tpu_torch.fields.element import FQ_SPEC, FR_SPEC
from jubjub_tpu_torch.ops import _build
from jubjub_tpu_torch.ops.fixed_base import fixed_base_plain
from jubjub_tpu_torch.curve.points import batch_normalize, reduce_sum
from jubjub_tpu_torch.ops.ladder import (ladder, ladder_affine_plain,
                                         ladder_plain, ladder_signed,
                                         ladder_signed_plain)
from jubjub_tpu_torch.ops import msm as msm_ops
from jubjub_tpu_torch.ops import roofline as ro
from jubjub_tpu_torch.ops.scan import prefix_scan_plain
from jubjub_tpu_torch.ops.sqrt import fq_sqrt
from jubjub_tpu_torch.fields.sqrt import _sqrt_tonelli_shanks
from jubjub_tpu_torch.parallel.pippenger import _niels_records

from helpers_torch import CPU, EXT, limb_plane, rand_ints, t

N = 67  # lanes (no power of two)


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """builds(karatsuba) -> the host build of every source in that product
    phase (None: the package's own).  Each phase is compiled once a test
    session, also across the workers of pytest-xdist: the first worker to
    take the file lock compiles, the others load its libraries."""
    if shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the directory all workers of this run share
    done = {}

    def builds(karatsuba):
        key = "karatsuba" if _build.phase_flags(karatsuba) else "schoolbook"
        if key not in done:
            out = root / f"jj_host_{key}"
            with filelock.FileLock(str(out) + ".lock"):
                if not (out / "built").exists():
                    _build.build_host(str(out), karatsuba=karatsuba)
                    (out / "built").touch()
            done[key] = {name: _build._bind(ctypes.CDLL(
                str(out / f"libjj_{name}_host.so")), name)
                for name in _build.KERNEL_SOURCES}
        return done[key]
    return builds


@pytest.fixture(scope="module")
def libs(host_builds):
    return host_builds(None)


@pytest.fixture(scope="module", params=[False, True],
                ids=["schoolbook", "karatsuba"])
def phase_libs(request, host_builds):
    """The host build in each product phase of the field core."""
    return host_builds(request.param)


def plane(F, seed, c):
    edges = [0, 1, F.p - 1, F.p, min(c, 2) * F.p - 1]
    return t(limb_plane(rand_ints(seed, N - len(edges), c * F.p) + edges))


@pytest.mark.parametrize("F,fid", [(FQ_SPEC, 0), (FR_SPEC, 1)],
                         ids=["Fq", "Fr"])
@pytest.mark.parametrize("ca,cb", [(1, 1), (2, 2), (5, 6)])
def test_mont_mul_and_square_lanes(phase_libs, F, fid, ca, cb):
    a, b = plane(F, 1, ca), plane(F, 2, cb)
    out = torch.empty_like(a)
    rc = phase_libs["mont"].jj_mont_mul(fid, a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), N, 128, None)
    assert rc == 0 and torch.equal(out, mont.mul_plain(F, a, b))
    rc = phase_libs["mont"].jj_mont_square(fid, a.data_ptr(),
                                           out.data_ptr(), N, 128, None)
    assert rc == 0 and torch.equal(out, mont.square_plain(F, a))


def scalars():
    return Fr.from_int([0, 1, 2, 127, 128, 129, 255, 256, oracle.R - 1]
                       + rand_ints(3, N - 9, oracle.R), device=CPU)


def run_fixed_base(libs, table, digits, signed, threads=128, stages=2):
    """The host build of the fixed-base entry point; returns (5, 20, n)."""
    n = digits.shape[1]
    out = torch.empty((5, 20, n), dtype=torch.int32)
    rc = libs["fixed_base"].jj_fixed_base(
        int(signed), digits.data_ptr(), table.data_ptr(), table.shape[0],
        table.shape[3], *[out[c].data_ptr() for c in range(5)], n, threads,
        stages, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_fixed_base_lanes(phase_libs, signed):
    table = sm.generator_table().device_table(8, signed, CPU)
    recode = sm.signed_window_digits_wide if signed else sm.window_digits_wide
    digits = recode(scalars(), 8).contiguous()
    want = fixed_base_plain(table, digits, signed)
    out = run_fixed_base(phase_libs, table, digits, signed)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


@pytest.mark.parametrize("threads,stages", [(32, 1), (32, 2), (64, 3)])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_fixed_base_edge_digits_and_stages(libs, signed, threads, stages):
    """Digits at the table's edges (0, +-1, +-tsize and tsize - 1 signed;
    0, 1 and tsize - 1 unsigned) in every window, on 67 lanes (no multiple
    of the block), through a ring of one to three table slices."""
    table = sm.generator_table().device_table(8, signed, CPU)
    nwin, tsize = table.shape[0], table.shape[3]
    edges = ([0, 1, -1, tsize, -tsize, tsize - 1, 1 - tsize] if signed
             else [0, 1, tsize - 1])
    lo, hi = (-tsize, tsize + 1) if signed else (0, tsize)
    rng = np.random.default_rng(11)
    digits = rng.integers(lo, hi, (nwin, N), dtype=np.int32)
    for w in range(nwin):  # every edge digit in every window, on moving lanes
        digits[w, [(w + 5 * e) % N for e in range(len(edges))]] = edges
    digits = torch.from_numpy(digits)
    want = fixed_base_plain(table, digits, signed)
    out = run_fixed_base(libs, table, digits, signed, threads, stages)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_fixed_base_one_digit_on_every_lane(libs, signed):
    """Every lane of a window holds the same digit, the digits running over
    the table's edges (0, +-1, the largest magnitude) window by window: the
    scan over the whole slice keeps the entry of that digit on every lane."""
    table = sm.generator_table().device_table(8, signed, CPU)
    nwin, tsize = table.shape[0], table.shape[3]
    edges = ([0, 1, -1, tsize, -tsize, tsize - 1, 2] if signed
             else [0, 1, tsize - 1, 2])
    row = np.array([edges[w % len(edges)] for w in range(nwin)], np.int32)
    digits = torch.from_numpy(np.repeat(row[:, None], N, axis=1))
    want = fixed_base_plain(table, digits, signed)
    out = run_fixed_base(libs, table, digits, signed, 64, 2)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


def test_fixed_base_refuses_bad_shapes(libs):
    """Block sizes past 256 or off a warp, stage counts outside 1-3, and a
    table off a 16-byte boundary are refused (-1) before any launch."""
    table = sm.generator_table().device_table(8, True, CPU)
    digits = torch.zeros((table.shape[0], 4), dtype=torch.int32)
    out = torch.empty((5, 20, 4), dtype=torch.int32)
    flat = torch.zeros(table.numel() + 1, dtype=torch.int32)
    for tbl, threads, stages in ((table, 512, 2), (table, 48, 2),
                                 (table, 128, 0), (table, 128, 4),
                                 (flat[1:], 128, 2)):
        rc = libs["fixed_base"].jj_fixed_base(
            1, digits.data_ptr(), tbl.data_ptr(), table.shape[0],
            table.shape[3], *[out[c].data_ptr() for c in range(5)], 4,
            threads, stages, None)
        assert rc == -1, (threads, stages)
    # the scan reads four entries at a time: tsize a multiple of 4
    rc = libs["fixed_base"].jj_fixed_base(
        1, digits.data_ptr(), table.data_ptr(), table.shape[0],
        table.shape[3] - 2, *[out[c].data_ptr() for c in range(5)], 4, 128,
        2, None)
    assert rc == -1


def ladder_points():
    p = sm.full_generator_table().mul_fused(
        Fr.from_int([i % 97 + 1 for i in range(N)], device=CPU))
    return [getattr(p, c).limbs.contiguous() for c in EXT]


def run_ladder(libs, fn, planes, digits, entries):
    """The host build of a ladder entry point over the lanes of ``digits``;
    returns the outputs and the scratch tensor that holds the tables."""
    n = digits.shape[1]
    out = torch.empty((5, 20, n), dtype=torch.int32)
    scratch = torch.empty((entries, 40, n), dtype=torch.int32)
    rc = getattr(libs["ladder"], fn)(
        *[x.data_ptr() for x in planes], digits.data_ptr(), sm.NWINDOWS,
        scratch.data_ptr(), *[out[c].data_ptr() for c in range(5)], n, 32,
        None)
    assert rc == 0
    return out, scratch


def first_lanes(n, *tensors):
    return [x[:, :n].contiguous() for x in tensors]


# all N lanes, and a single lane (table words one apart, as in a spine)
LADDER_BATCHES = pytest.mark.parametrize("lanes", [N, 1],
                                         ids=["batch", "one_lane"])


@LADDER_BATCHES
def test_ladder_lanes(phase_libs, lanes):
    planes = first_lanes(lanes, *ladder_points())
    [digits] = first_lanes(lanes, sm.window_digits(scalars()))
    want = ladder_plain(planes, digits)
    out, _ = run_ladder(phase_libs, "jj_ladder", planes, digits, 15)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


@LADDER_BATCHES
def test_ladder_signed_lanes(phase_libs, lanes):
    planes = first_lanes(lanes, *ladder_points())
    [digits] = first_lanes(lanes, sm.signed_window_digits(scalars()))
    want = ladder_signed_plain(planes, digits)
    out, _ = run_ladder(phase_libs, "jj_ladder_signed", planes, digits, 8)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


def _scan_digits(kind, pattern):
    """Digits for a ladder's masked scan: "edges" plants 0, +-1 and the
    largest magnitude in every window on moving lanes among seeded ones;
    "one_digit" gives every lane one seeded digit sequence (the signed
    ladder's carry row included)."""
    lo, hi, edges = {"unsigned": (0, 16, [0, 1, 15]),
                     "affine": (0, 16, [0, 1, 15]),
                     "signed": (-8, 9, [0, 1, -1, 8, -8])}[kind]
    rows = 64 if kind == "signed" else sm.NWINDOWS
    rng = np.random.default_rng(13)
    if pattern == "one_digit":
        d = np.repeat(rng.integers(lo, hi, (rows, 1), dtype=np.int32), N, 1)
    else:
        d = rng.integers(lo, hi, (rows, N), dtype=np.int32)
        for w in range(sm.NWINDOWS):
            d[w, [(w + 7 * e) % N for e in range(len(edges))]] = edges
    if kind == "signed":
        d[63] = rng.integers(0, 2, d.shape[1]) if pattern == "edges" else 1
    return torch.from_numpy(np.ascontiguousarray(d))


@pytest.mark.parametrize("pattern", ["edges", "one_digit"])
@pytest.mark.parametrize("kind", ["unsigned", "signed", "affine"])
def test_ladder_scans_edge_digits_and_one_digit_on_every_lane(libs, kind,
                                                              pattern):
    """The masked scans (ScannedNiels, unsigned and signed, and
    ScannedAffineNiels) keep the entry the digit names for digits 0, +-1
    and the largest magnitude, and with one digit sequence on every lane:
    limb for limb the plain versions."""
    digits = _scan_digits(kind, pattern)
    if kind == "affine":
        p = sm.full_generator_table().mul_fused(
            Fr.from_int([i % 97 + 1 for i in range(N)], device=CPU))
        table = sm._affine_niels_table(batch_normalize(p))
        planes = [getattr(table, c).limbs.contiguous()
                  for c in ("v_plus_u", "v_minus_u", "t2d")]
        out = torch.empty((5, 20, N), dtype=torch.int32)
        scratch = torch.empty((15, 30, N), dtype=torch.int32)
        rc = libs["ladder"].jj_ladder_affine(
            *[x.data_ptr() for x in planes], digits.data_ptr(), sm.NWINDOWS,
            scratch.data_ptr(), *[out[c].data_ptr() for c in range(5)], N,
            32, None)
        assert rc == 0
        want = ladder_affine_plain(planes, digits)
    else:
        planes = ladder_points()
        fn, entries, plain = (("jj_ladder", 15, ladder_plain)
                              if kind == "unsigned" else
                              ("jj_ladder_signed", 8, ladder_signed_plain))
        out, _ = run_ladder(libs, fn, planes, digits, entries)
        want = plain(planes, digits)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


def test_ladder_at_64_windows(libs):
    """A constant past 2^252 (2^256 - 1 and 2^252 + 5, as ``mul_const_scalar``
    gives them) takes a 64th window: the kernel runs every row it is given,
    limb for limb the plain version's."""
    planes = ladder_points()
    digits = torch.from_numpy(np.stack(
        [sm.const_scalar_digits(k) for k in
         [(1 << 256) - 1, (1 << 252) + 5] * (N // 2) + [(1 << 252) + 5]], 1))
    assert digits.shape == (64, N)
    n = digits.shape[1]
    out = torch.empty((5, 20, n), dtype=torch.int32)
    scratch = torch.empty((15, 40, n), dtype=torch.int32)
    rc = libs["ladder"].jj_ladder(
        *[x.data_ptr() for x in planes], digits.data_ptr(), 64,
        scratch.data_ptr(), *[out[c].data_ptr() for c in range(5)], n, 32,
        None)
    assert rc == 0
    want = ladder_plain(planes, digits)
    for c in range(5):
        assert torch.equal(out[c], want[c]), EXT[c]


def test_ladder_affine_lanes(phase_libs):
    """The affine-Niels ladder on 67 lanes (no multiple of a block), digits 0
    and 15 in every window on moving lanes, over the tables that
    ``_affine_niels_table`` builds: limb for limb
    ``_windowed_ladder(table, digits, affine=True)``."""
    p = sm.full_generator_table().mul_fused(
        Fr.from_int([i % 97 + 1 for i in range(N)], device=CPU))
    table = sm._affine_niels_table(batch_normalize(p))
    planes = [getattr(table, c).limbs.contiguous()
              for c in ("v_plus_u", "v_minus_u", "t2d")]
    digits = sm.window_digits(scalars()).clone()
    for w in range(digits.shape[0]):
        digits[w, (3 * w) % N] = 0
        digits[w, (3 * w + 1) % N] = 15
    digits = digits.contiguous()
    out = torch.empty((5, 20, N), dtype=torch.int32)
    scratch = torch.empty((15, 30, N), dtype=torch.int32)
    rc = phase_libs["ladder"].jj_ladder_affine(
        *[x.data_ptr() for x in planes], digits.data_ptr(), sm.NWINDOWS,
        scratch.data_ptr(), *[out[c].data_ptr() for c in range(5)], N, 32,
        None)
    assert rc == 0
    want = sm._windowed_ladder(table, digits, (N,), CPU, True)
    assert torch.equal(torch.stack(ladder_affine_plain(planes, digits)),
                       torch.stack([getattr(want, c).limbs for c in EXT]))
    for c, name in enumerate(EXT):
        assert torch.equal(out[c], getattr(want, name).limbs), name
    rc = phase_libs["ladder"].jj_ladder_affine(
        *[x.data_ptr() for x in planes], digits.data_ptr(), sm.NWINDOWS,
        None, *[out[c].data_ptr() for c in range(5)], N, 32, None)
    assert rc != 0


@pytest.mark.parametrize("wrapper,good,bad", [
    (ladder, (63, 64), (62, 65)),
    (ladder_signed, (64,), (62, 63, 65))], ids=["unsigned", "signed"])
def test_ladder_wrappers_check_digit_rows(wrapper, good, bad):
    """The unsigned ladder takes 63 or 64 digit rows, the signed one 64 and
    nothing else; any other count is refused before a launch."""
    planes = ladder_points()
    for rows in good + bad:
        digits = torch.zeros((rows, N), dtype=torch.int32)
        if rows in bad:
            with pytest.raises(ValueError, match="digits must be int32"):
                wrapper(planes, digits)
        else:
            out = wrapper(planes, digits)  # k = 0: the identity on each lane
            assert bool(ExtendedPoint(*[Fq(x) for x in out])
                        .is_identity().all())


def test_ladder_refuses_a_missing_table(libs):
    """Without a scratch tensor for the tables the entry point returns an
    error and launches nothing."""
    planes = ladder_points()
    digits = sm.window_digits(scalars()).contiguous()
    out = torch.zeros((5, 20, N), dtype=torch.int32)
    rc = libs["ladder"].jj_ladder(
        *[x.data_ptr() for x in planes], digits.data_ptr(), sm.NWINDOWS, None,
        *[out[c].data_ptr() for c in range(5)], N, 32, None)
    assert rc != 0 and int(out.abs().sum()) == 0


def test_ladder_table_packing_round_trip(libs):
    """The ladder's packed table (two 13-bit limbs a word, lo | hi << 16),
    read back from the scratch tensor and unpacked, holds the plain
    version's entries [1..15]P limb for limb."""
    planes = ladder_points()
    digits = sm.window_digits(scalars()).contiguous()
    _, scratch = run_ladder(libs, "jj_ladder", planes, digits, 15)
    words = scratch.reshape(15, 4, 10, N)
    limbs = torch.stack([words & 0xFFFF, words >> 16], dim=3).reshape(
        15, 4, 20, N)
    table = sm.extended_niels_table(ExtendedPoint(*[Fq(x) for x in planes]))
    for c, name in enumerate(("v_plus_u", "v_minus_u", "z", "t2d")):
        assert torch.equal(limbs[:, c], getattr(table, name).limbs[1:]), name
    assert int(scratch.min()) >= 0 and int((words >> 29).max()) == 0


@pytest.fixture(scope="module")
def scan_records():
    """Niels records (n, 80) of 97 points P_i = [k_i]G; the scan tests tile
    them to their shapes."""
    pts = sm.full_generator_table().mul_fused(
        Fr.from_int(rand_ints(5, 97, oracle.R), device=CPU))
    return _niels_records(pts)


def scan_input(records, nb, run, lanes):
    """(4, 20, nb, run, lanes) Niels planes: the records in a seeded order,
    repeated as needed."""
    n = nb * run * lanes
    order = np.random.default_rng(n).permutation(
        np.arange(n) % records.shape[0])
    return (records[torch.from_numpy(order)].T
            .reshape(4, 20, nb, run, lanes).contiguous())


def run_scan(libs, niels, threads, stages):
    _, _, nb, run, lanes = niels.shape
    out = torch.empty((5, 20, nb, run, lanes), dtype=torch.int32)
    rc = libs["scan"].jj_prefix_scan(niels.data_ptr(), out.data_ptr(), nb, run,
                                     lanes, threads, stages, None)
    assert rc == 0
    return out


def test_prefix_scan_lanes(phase_libs, scan_records):
    """Three batches of 5 lanes, runs of 4 sorted points (60 = 3 x 4 x 5)."""
    niels = scan_input(scan_records, 3, 4, 5)
    assert torch.equal(run_scan(phase_libs, niels, 128, 2),
                       prefix_scan_plain(niels))


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("nb,run,lanes,threads", [
    (1, 1, 40, 32),    # one step: the ring's prologue only
    (2, 3, 37, 32),    # 74 threads in 3 blocks, blocks straddle batches
    (1, 5, 70, 64),    # one batch, a ragged block
    (3, 5, 11, 32),    # 33 threads: one block holds all three batches
], ids=["run1", "run3_straddle", "run5_nb1", "run5_small_lanes"])
def test_prefix_scan_edge_shapes_and_stages(libs, scan_records, nb, run,
                                            lanes, threads, stages):
    """Runs of 1, 3 and 5 steps (no multiple of the stage count), one batch,
    and lane counts no block size divides, through rings of 1 to 4 stages."""
    niels = scan_input(scan_records, nb, run, lanes)
    assert torch.equal(run_scan(libs, niels, threads, stages),
                       prefix_scan_plain(niels))


def test_prefix_scan_refuses_bad_shapes(libs, scan_records):
    """Block sizes past 256 or off a warp and stage counts outside 1-4 are
    refused (-1) before any launch."""
    niels = scan_input(scan_records, 1, 2, 8)
    for threads, stages in ((512, 2), (96 + 16, 2), (128, 0), (128, 5)):
        out = torch.empty((5, 20, 1, 2, 8), dtype=torch.int32)
        rc = libs["scan"].jj_prefix_scan(niels.data_ptr(), out.data_ptr(), 1,
                                         2, 8, threads, stages, None)
        assert rc == -1, (threads, stages)


@pytest.mark.parametrize("op", ["add", "mul", "mixed"])
def test_int_chain_lanes(libs, op):
    a = torch.tensor(rand_ints(6, N, 1 << 32), dtype=torch.int64)
    b = torch.tensor(rand_ints(7, N, 1 << 32), dtype=torch.int64)
    a = torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)
    b = torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)
    out = torch.empty_like(a)
    rc = libs["roofline"].jj_int_chain(ro.OPS[op], a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), 37, N, 256, None)
    assert rc == 0 and torch.equal(out, ro.int_chain_plain(a, b, 37, op))


def test_mont_mul_chain_lanes(phase_libs):
    a, b = plane(FQ_SPEC, 8, 2), plane(FQ_SPEC, 9, 2)
    out = torch.empty_like(a)
    rc = phase_libs["roofline"].jj_mont_mul_chain(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), 9, N, 128, None)
    assert rc == 0 and torch.equal(out, ro.mont_mul_chain_plain(a, b, 9))


def sqrt_radicands():
    """N Fq radicands as integer values of limb planes (Montgomery
    residues): 0, 1 and p-1 and their lazy forms in [p, 2p), squares and
    non-squares (the generator times a square), each square or non-square
    lazy on every third lane, and raw values in [0, 2p)."""
    F = FQ_SPEC
    m = lambda v: v % F.p * F.R % F.p  # noqa: E731
    vals = [0, F.p, m(1), m(1) + F.p, m(F.p - 1), m(F.p - 1) + F.p]
    xs = rand_ints(30, 40, F.p)
    for i, x in enumerate(xs):
        v = m(x * x) if i % 2 == 0 else m(F.generator * x * x)
        vals.append(v + F.p if i % 3 == 0 else v)
    return vals + rand_ints(31, N - len(vals), 2 * F.p)


def test_fq_sqrt_lanes(phase_libs):
    """The host-built ``jj_fq_sqrt`` against ``_sqrt_tonelli_shanks`` at 67
    lanes: ``ok`` exactly, the root as a field element on the square lanes
    (after ``to_canonical``; a non-square's root is undefined), below 2p,
    and the oracle's verdict on every lane."""
    F = FQ_SPEC
    vals = sqrt_radicands()
    a = t(limb_plane(vals))
    root, ok = torch.empty_like(a), torch.empty(N, dtype=torch.bool)
    rc = phase_libs["sqrt"].jj_fq_sqrt(a.data_ptr(), root.data_ptr(),
                                       ok.data_ptr(), N, 128, None)
    want_root, want_ok = _sqrt_tonelli_shanks(F, a)
    assert rc == 0 and torch.equal(ok, want_ok)
    rinv = pow(F.R, -1, F.p)
    assert ok.tolist() == [oracle.sqrt_q(v * rinv % F.p) is not None
                           for v in vals]
    canon = mont.to_canonical(F, root)
    assert torch.equal(canon[:, ok], mont.to_canonical(F, want_root)[:, ok])
    for i in torch.nonzero(ok).flatten().tolist():
        r = sum(int(x) << (13 * j) for j, x in enumerate(root[:, i].tolist()))
        assert r < 2 * F.p and r * r * rinv % F.p == vals[i] % F.p, i
    assert ok[:6].tolist() == [True] * 6  # 0, 1, p-1 = -1: squares (p = 1 mod 4)
    assert not canon[:, :2].any()


def test_fq_sqrt_refuses_bad_shapes(libs):
    """The entry point refuses a block size off a warp, past 1024 or none,
    and a negative lane count (-1); the wrapper refuses another field, a
    plane that is not int32 and one without 20 limbs, before any launch."""
    a = t(limb_plane(sqrt_radicands()))
    root, ok = torch.empty_like(a), torch.empty(N, dtype=torch.bool)
    for n, threads in ((N, 48), (N, 2048), (N, 0), (-1, 128)):
        rc = libs["sqrt"].jj_fq_sqrt(a.data_ptr(), root.data_ptr(),
                                     ok.data_ptr(), n, threads, None)
        assert rc == -1, (n, threads)
    for F, x in ((FR_SPEC, a), (FQ_SPEC, a.long()), (FQ_SPEC, a[:19])):
        with pytest.raises(ValueError, match="fq_sqrt"):
            fq_sqrt(F, x)


@pytest.mark.parametrize("n,blocks,chunk", [(67, 1, 32), (20, 3, 32),
                                             (4099, 64, 6), (5, 8, 32)],
                         ids=["one-block", "under-a-chunk", "ragged-4099",
                              "more-blocks-than-points"])
@pytest.mark.parametrize("signed,wbits", [(True, 5), (False, 4)],
                         ids=["signed-5", "unsigned-4"])
def test_msm_window_sums_lanes(phase_libs, signed, wbits, n, blocks, chunk):
    """Partial window sums, one a window a block, limb for limb against the
    plain version: one block of several chunks, a batch smaller than a
    chunk, 4099 points that no chunk x blocks divides (ragged chunks and a
    short last block), and more blocks than points (empty blocks give the
    identity).  The chunk does not change the order of the additions."""
    p = sm.full_generator_table().mul_fused(
        Fr.from_int([i % 97 + 1 for i in range(n)], device=CPU))
    planes = [x.contiguous() for x in
              (p.u.limbs, p.v.limbs, p.z.limbs, (p.t1 * p.t2).limbs)]
    k = [0, 1, oracle.R - 1] + rand_ints(3, n, oracle.R)
    recode = sm.signed_window_digits_wide if signed else sm.window_digits_wide
    digits = recode(Fr.from_int(k[:n], device=CPU), wbits).contiguous()
    nwin, nentries = digits.shape[0], msm_ops.n_entries(wbits, signed)
    want = msm_ops.window_sums_plain(planes, digits, wbits, signed, blocks)
    acc = torch.empty((5, 20, nwin, blocks), dtype=torch.int32)
    rc = phase_libs["msm"].jj_msm_window_sums(
        *[x.data_ptr() for x in planes], digits.data_ptr(), nwin,
        n, int(signed), nentries, acc.data_ptr(), blocks, chunk, None)
    assert rc == 0 and torch.equal(acc, want)
    if blocks > n:  # the empty blocks' partials are the identity
        empty = ExtendedPoint(*[Fq(acc[c, :, :, n:]) for c in range(5)])
        assert bool(empty.is_identity().all())


@pytest.mark.parametrize("pattern", ["edges", "one_scalar"])
@pytest.mark.parametrize("signed,wbits", [(True, 5), (False, 4)],
                         ids=["signed-5", "unsigned-4"])
def test_msm_window_sums_scan_edge_digits(libs, signed, wbits, pattern):
    """The window threads' masked scan over a point's table in shared memory
    keeps the entry of digits 0, +-1 and the largest magnitudes (signed
    [-15, 16], unsigned [0, 15]) planted in every window, and with one
    scalar's digits for every point: limb for limb the plain version."""
    n, blocks, chunk = 67, 2, 32
    p = sm.full_generator_table().mul_fused(
        Fr.from_int([i % 97 + 1 for i in range(n)], device=CPU))
    planes = [x.contiguous() for x in
              (p.u.limbs, p.v.limbs, p.z.limbs, (p.t1 * p.t2).limbs)]
    nwin = msm_ops.n_windows(wbits, signed)
    lo, hi, edges = ((-15, 17, [0, 1, -1, 16, -15]) if signed
                     else (0, 16, [0, 1, 15]))
    rng = np.random.default_rng(17)
    if pattern == "one_scalar":
        d = np.repeat(rng.integers(lo, hi, (nwin, 1), dtype=np.int32), n, 1)
    else:
        d = rng.integers(lo, hi, (nwin, n), dtype=np.int32)
        for w in range(nwin):
            d[w, [(w + 5 * e) % n for e in range(len(edges))]] = edges
    digits = torch.from_numpy(np.ascontiguousarray(d))
    want = msm_ops.window_sums_plain(planes, digits, wbits, signed, blocks)
    acc = torch.empty((5, 20, nwin, blocks), dtype=torch.int32)
    rc = libs["msm"].jj_msm_window_sums(
        *[x.data_ptr() for x in planes], digits.data_ptr(), nwin, n,
        int(signed), msm_ops.n_entries(wbits, signed), acc.data_ptr(),
        blocks, chunk, None)
    assert rc == 0 and torch.equal(acc, want)


@pytest.fixture(scope="module")
def tail_points():
    """509 points [m]G of the full group (torsion included), as the
    fixed-base path leaves them (z != 1, t1 and t2 apart): planes
    (5, 20, 509)."""
    p = sm.full_generator_table().mul_fused(
        Fr.from_int([m * 7 + 3 for m in range(509)], device=CPU))
    return torch.stack([getattr(p, c).limbs for c in EXT])


def tail_planes(points, shape, seed):
    """Planes (5, 20, *shape) of points drawn from ``points``, with the
    identity at about one position in nine."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, points.shape[2], shape))
    out = points[:, :, idx].clone()
    ident = torch.from_numpy(rng.integers(0, 9, shape) == 0)
    one = torch.stack([getattr(ExtendedPoint.identity(device=CPU), c).limbs
                       for c in EXT])
    out[:, :, ident] = one[:, :, None]
    return out


@pytest.mark.parametrize("nwin,blocks", [(51, 264), (51, 1), (63, 7),
                                         (16, 3)])
def test_msm_reduce_lanes(phase_libs, tail_points, nwin, blocks):
    """The partials' reduction, one window after another, limb for limb
    against ``reduce_sum(axis=1)``: the verify cell's 51 windows of an
    H100's 264 blocks, a single block (a copy), and odd counts, whose last
    element each level carries; identity partials among the inputs."""
    partials = tail_planes(tail_points, (nwin, blocks), nwin * 1000 + blocks)
    out = torch.empty((5, 20, nwin), dtype=torch.int32)
    rc = phase_libs["msm_tail"].jj_msm_reduce(
        partials.data_ptr(), nwin, blocks, out.data_ptr(), None)
    want = reduce_sum(ExtendedPoint(*[Fq(partials[c]) for c in range(5)]),
                      axis=1)
    assert rc == 0
    assert torch.equal(out, torch.stack([getattr(want, c).limbs
                                         for c in EXT]))
    assert torch.equal(out, msm_ops.msm_reduce(partials))


@pytest.mark.parametrize("nwin,wbits", [(51, 5), (63, 4), (16, 16), (1, 5)])
def test_msm_fold_lanes(phase_libs, tail_points, nwin, wbits):
    """The fold of window sums, limb for limb against ``fold_plain``: the
    signed 5-bit and unsigned 4-bit windows of ``msm_fused``, the 16
    windows of 16 bits of ``msm_pippenger``, and a single window (no
    doubling); identity window sums among the inputs."""
    wsums = tail_planes(tail_points, (nwin,), nwin * 100 + wbits)
    out = torch.empty((5, 20), dtype=torch.int32)
    rc = phase_libs["msm_tail"].jj_msm_fold(wsums.data_ptr(), nwin, wbits,
                                            out.data_ptr(), None)
    assert rc == 0
    assert torch.equal(out, msm_ops.fold_plain(wsums, wbits))


def test_msm_tail_refuses_bad_shapes(libs, tail_points):
    """The entry points refuse no window, no block, more blocks than shared
    memory holds, and wbits 0 (-1); the wrappers refuse a plane that is
    not int32 or lacks a coordinate, before any launch."""
    partials = tail_planes(tail_points, (2, 3), 5)
    out = torch.empty((5, 20, 2), dtype=torch.int32)
    for nwin, blocks in ((0, 3), (2, 0), (2, msm_ops.REDUCE_MAX_BLOCKS + 1)):
        assert libs["msm_tail"].jj_msm_reduce(
            partials.data_ptr(), nwin, blocks, out.data_ptr(), None) == -1
    for nwin, wbits in ((0, 5), (2, 0)):
        assert libs["msm_tail"].jj_msm_fold(
            partials.data_ptr(), nwin, wbits, out.data_ptr(), None) == -1
    with pytest.raises(ValueError, match="msm_reduce"):
        msm_ops.msm_reduce(partials.long())
    with pytest.raises(ValueError, match="msm_reduce"):
        msm_ops.msm_reduce(partials[:4])
    with pytest.raises(ValueError, match="blocks"):
        msm_ops.msm_reduce(tail_planes(
            tail_points, (1, msm_ops.REDUCE_MAX_BLOCKS + 1), 6))
    with pytest.raises(ValueError, match="msm_fold"):
        msm_ops.msm_fold(partials[..., 0].long(), 5)
    with pytest.raises(ValueError, match="wbits"):
        msm_ops.msm_fold(partials[..., 0], 0)


def test_generated_constants_follow_the_field_specs():
    """The header the kernels include is generated from FieldSpec: it holds
    both fields' limbs of p and the key changes with the sources."""
    text = _build.constants_header()
    for F in (FQ_SPEC, FR_SPEC):
        assert "{" + ", ".join(str(int(x)) for x in F.p_limbs) + "}" in text
        assert f"return {int(F.inv_limb)}u;" in text
    # Fq's square root: -1, the exponent's schedule, the 2-Sylow tables
    F = FQ_SPEC
    sq = _build.sqrt_constants_header()
    mont_row = lambda v: "{" + ", ".join(  # noqa: E731
        str(x) for x in F.np_mont(v).tolist()) + "}"
    assert mont_row(F.p - 1) in sq
    steps = _build.sqrt_exponent_steps(F)
    e = steps[0][1]
    for squarings, mult in steps[1:]:
        assert mult in (0, 1, 3)
        e = e * 2 ** squarings + mult
    assert e == (F.t - 1) // 2 and steps[0][0] == 0
    assert "{" + ", ".join(str(4 * q + m) for q, m in steps) + "}" in sq
    cinv = [pow(F.root_of_unity_inv, 2 ** i, F.p) for i in range(F.s)]
    for i in range(F.s):
        assert mont_row(cinv[i]) in sq
        assert mont_row(cinv[i - 1] if i else 1) in sq
    assert len(_build.source_key()) == 16
    assert _build.source_key() != _build.source_key(flags=("-O0",))
    assert _build.kernel_label(
        "_ZN2jj17fixed_base_kernelILb1EEEvPKiS2_iiPiS3_S3_S3_S3_li") \
        == "fixed_base_kernel<signed>"
    assert _build.kernel_label(
        "_ZN2jj22msm_window_sums_kernelILb0EEEvPKiS2_S2_S2_S2_iliPiS3_l") \
        == "msm_window_sums_kernel<unsigned>"
    assert _build.kernel_label(
        "_ZN2jj13ladder_kernelILb1EEEvPKiS2_S2_S2_S2_S2_iPiS3_S3_S3_S3_S3_l") \
        == "ladder_kernel<signed>"
    assert _build.kernel_label(
        "_ZN2jj13ladder_kernelILb0EEEvPKiS2_S2_S2_S2_S2_iPjPiS4_S4_S4_S4_l") \
        == "ladder_kernel<unsigned>"
    assert _build.kernel_label(
        "_ZN2jj20ladder_affine_kernelEPKiS1_S1_S1_iPjPiS3_S3_S3_S3_l") \
        == "ladder_affine_kernel"
    assert _build.kernel_label("_ZN2jj9pt_doubleERNS_3ExtE") == "pt_double"
    assert _build.kernel_label("_ZN2jj16int_chain_kernelILi1EEEvPKiS2_Piil") \
        == "int_chain_kernel<mul>"
    assert _build.kernel_label("_ZN2jj21mont_mul_chain_kernelEPKiS1_Piil") \
        == "mont_mul_chain_kernel"
    assert _build.kernel_label("_ZN2jj18prefix_scan_kernelEPKiPillli") \
        == "prefix_scan_kernel"
    assert _build.kernel_label("_ZN2jj14fq_sqrt_kernelEPKiPiPhl") \
        == "fq_sqrt_kernel"
    assert _build.kernel_label("_ZN2jj17msm_reduce_kernelEPKiiiPi") \
        == "msm_reduce_kernel"
    assert _build.kernel_label("_ZN2jj15msm_fold_kernelEPKiiiPi") \
        == "msm_fold_kernel"


def test_ranks_never_build(tmp_path, monkeypatch):
    """``ensure_built(build=False)``, what every rank of a job calls, raises
    where the kernels were not built, and builds nothing."""
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_build_all", lambda out_dir: pytest.fail(
        "a rank started a build"))
    with pytest.raises(RuntimeError, match="not built"):
        _build.ensure_built(build=False)


def test_build_times_each_source_by_its_own_compiler(tmp_path, monkeypatch):
    """The sources compile in parallel; each one's seconds end when its own
    compiler exits, so a quick source collected after a slow one is not
    charged the slow one's time (a stand-in compiler sleeps 1.5 s for
    ladder.cu and 0.1 s for the others)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\n'
                    'prev=""\n'
                    'for a in "$@"; do\n'
                    '  if [ "$prev" = "-o" ]; then out="$a"; fi\n'
                    '  prev="$a"\n'
                    'done\n'
                    'case "$prev" in *ladder.cu) sleep 1.5;; *) sleep 0.1;; esac\n'
                    ': > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    info = _build._build_all(str(tmp_path / "out"))
    secs = {name: v["seconds"] for name, v in info["sources"].items()}
    assert set(secs) == {f"{n}.cu" for n in _build.KERNEL_SOURCES}
    assert secs["ladder.cu"] >= 1.5
    assert secs["msm.cu"] < 1.0 and secs["scan.cu"] < 1.0
    assert info["seconds"] >= secs["ladder.cu"]
