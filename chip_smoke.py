#!/usr/bin/env python3
"""Smoke test of jubjub_tpu_torch on one NVIDIA GPU (written for an H100).

Run from the repository's root, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``jubjub_tpu_torch/ops/csrc`` with
``nvcc``, holds every kernel against its plain PyTorch version on the card
(exact equality: this is integer arithmetic, the tolerance is 0), then
drives the package's paths through the normal entry points:

    roofline. the int32 probes (int_chain: add, mul, mixed chains at
              (256, 1024) x 8192; mont_mul_chain: 64 dependent Fq products
              at 65536 and 262144 lanes): the rates every bound is read
              against
    seeded numpy scalars -> Fr.from_canonical, 131072 lanes
      A. generator_table().mul_fused(k)        fixed-base kernel
      B. mul_extended(P, k)                    ladder kernel, P_i = [m_i]G
      ladder_signed. B with config.LADDER_SIGNED   signed ladder kernel
      affine_mul. batch_normalize(P) * k       affine-Niels table, then the
                                               ladder_affine kernel
      -> batch_normalize -> AffinePoint.to_bytes()     (32, N) uint8
      multiply_bits. B's first 4096 lanes, bit-serial (plain PyTorch)
    the subgroup API, 131072 lanes
      subgroup. encodings of subgroup, torsion-mixed, full-group,
           small-order and corrupted points -> SubgroupPoint.from_bytes
           (decode, torsion check: the ladder kernel with r's digits)
           -> to_affine -> to_bytes
      cofactor. random_extended (seeded torch.Generator) -> clear_cofactor
           -> into_subgroup -> to_bytes
    multi-scalar multiplication, 2^20 points P_i = [s_i]G8
      msm. msm_fused(P, k)                     window-sums kernel +
                                               msm_reduce + msm_fold (one
                                               launch each, no sync)
      e2e. 32-byte encodings of the P_i -> affine_from_bytes -> to_extended
           -> msm_fused -> batch_normalize -> affine_to_bytes
      pippenger. msm_pippenger(P, k)           sort + prefix-scan kernel +
                                               suffix sums + spine
      sharded_msm. msm P's points and scalars sharded over the ranks of a
           process group (parallel.msm_sharded): one rank over NCCL
           ("fused"), and four gloo ranks sharing the card ("fused",
           "sorted", and "torch" on the first 4096 points)

and checks the encodings of the leading lanes and of the edge scalars
(0, 1, r-1) of paths A and B, the signed and affine paths' encodings
against path B's on every lane (the bit-serial one's on its 4096), the
subgroup path's verdict and
bytes on every lane against the inputs' construction, every cofactor-cleared
point's membership and the leading lanes against the oracle, and the single
result of the three MSM paths against the package's Python-int oracle (and
the Pippenger result against msm_fused's), and every rank's result of the
sharded MSM against the oracle's and path msm's bytes.  The ``build`` line
counts the loads of the scan kernels in their SASS (``cuobjdump``): a
load predicated inside a loop of a kernel that selects by a digit fails
the run.
Each phase prints one JSON object on a line of its own.  Any failure ends
the run with a non-zero exit code; nothing runs on the CPU when no GPU is
found.

``--sweep`` additionally times ``mont_mul`` and the fixed-base kernel at
several block sizes (threads per block), the window-sums kernel at several
points a chunk and blocks an SM, and the ladders at several batch sizes and
lanes a block, and prints a ``sweep`` line; it changes nothing else.
``--boundaries`` builds the window-sums kernel, the ladder, the scan and the
fixed base with other outline boundaries (which functions are real calls,
which are inlined) and times each one that builds against the package's
own, printing a ``boundaries`` line.

The field core's product phase (schoolbook or Karatsuba) is chosen when
the kernels are built (``config.kernels_karatsuba``).  Every run also builds
``mont.cu`` and ``roofline.cu`` in the other phase and holds their kernels
against the plain versions (line ``karatsuba``), holds ``mul`` / ``square``
inside ``use_mxu_reduce`` (the matmul-form reduction, ``torch._int_mm``)
against the kernels at N lanes (line ``mxu_reduce``), and checks that the
host codec runs its C++ tier (line ``codec``).  ``--karatsuba`` builds the
other four sources in the other phase too, holds each kernel against the
package's build at the main shapes and reports, per kernel and phase, its
time, registers, spills, largest loop and predicated loads (line
``karatsuba_sources``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N = 131072          # lanes of the scalar-multiplication paths
N_MSM = 1 << 20     # points of the MSM paths
RAGGED = 4099       # a batch no block size divides
SPINE_LANES = (51, 16)  # small ladder launches: the MSM spines' windows
TAIL_BLOCKS = 264   # partials a window on an H100 SXM (2 blocks an SM)
SEED = 20240607
HEAD = 8            # leading lanes checked against the oracle
# the int32 probes' shapes, the reference's (benches/roofline.py): a chain
# of 8192 operations on (256, 1024) elements, and 64 Fq products a lane at
# 65536 lanes, with 262144 lanes beside them (a full wave of that kernel)
PROBE_SHAPE, PROBE_CHAIN = (256, 1024), 8192
FQ_CHAIN, FQ_CHAIN_LANES = 64, (65536, 262144)

# Published peaks of one H100 SXM (NVIDIA's data sheet and the Hopper
# architecture white paper): 3.35 TB/s of device memory; 67 TFLOP/s of
# float32 outside the tensor cores = 33.5e12 fused multiply-adds a second
# on 128 FP32 lanes an SM.  An SM has 64 INT32 lanes, half as many, so the
# card's peak for int32 multiply-adds is taken as 16.75e12 a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MAC_PER_S = 33.5e12 / 2
# Shared memory: 32 banks of 4 bytes a clock on each of the 132 SMs at the
# 1980 MHz boost clock (the Hopper white paper's figures).
PEAK_SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# The int32 rate every bound uses: the derived peak, unless the roofline
# phase measures a higher rate of dependent int32 multiplications (a bound
# is the least time the card could take), set once by main().
INT32_PEAK = {"mac_per_s": PEAK_INT32_MAC_PER_S, "source": "derived"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel_name: str) -> dict:
    """Mean milliseconds the card spends inside one launch of the kernel
    whose name contains ``kernel_name`` (``fn()`` launches one), from the
    device events of ``torch.profiler``.  Unlike ``time_ms`` it leaves out
    the gaps between launches, which the host's enqueue rate sets.  The
    profiler can lose the record of a launch, most often the first of a
    session, so the session opens with one launch more and the mean is over
    the launches it recorded.  Where it recorded none, the mean is taken
    from a pair of CUDA events around each single launch instead, which
    adds the wrapper's host time to a launch (some 20-50 us).
    Returns ``{"device_ms": mean, "recorded": k, "launched": reps + 1,
    "source": "profiler" or "events"}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    times = [ev.device_time for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and kernel_name in ev.name]
    out = {"recorded": len(times), "launched": reps + 1}
    if times:
        return dict(out, device_ms=sum(times) / len(times) / 1e3,
                    source="profiler")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps + 1)]
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return dict(out, device_ms=sum(a.elapsed_time(b) for a, b in pairs)
                / len(pairs), source="events")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, macs: int) -> tuple[float, str]:
    """Least milliseconds the card could take, and which limit sets it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = macs / INT32_PEAK["mac_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- multiply-add counts, derived from the code -------------------------------

def macs_reduce(F) -> int:
    """Montgomery reduction: 20 rounds, one multiply-add per limb of p that
    is neither 0 nor 1, plus the multiplication by -p^-1 unless it is -1."""
    per_round = sum(1 for x in F.p_limbs if int(x) not in (0, 1))
    per_round += 0 if int(F.inv_limb) == (1 << 13) - 1 else 1
    return 20 * per_round


# The product phase counts the limb products of its cheaper form, one level
# of Karatsuba (3 half products of 10 x 10 limbs; 3 half squares of 55), in
# both builds: a bound then does not depend on which phase a kernel was
# built with (config.kernels_karatsuba).

def macs_mul(F) -> int:
    return 300 + macs_reduce(F)          # Karatsuba: 3 x 10 x 10 products


def macs_square(F) -> int:
    return 165 + macs_reduce(F)          # Karatsuba: 3 x (10 + 45) products


def macs_fixed_base(F, nwin: int) -> int:
    return (nwin - 1) * 7 * macs_mul(F)  # add_affine_niels: 7 multiplications


def macs_ladder(F, nwin: int = 63) -> int:
    m, s = macs_mul(F), macs_square(F)
    double = 4 * s + 3 * m               # dbl-2008-bbjlp
    add = 8 * m                          # add_extended_niels
    to_niels = 2 * m
    table = to_niels + 14 * (add + to_niels)
    return table + nwin * (4 * double + add)


def macs_ladder_affine(F) -> int:
    """63 x (4 doublings, one 7M affine-Niels addition); the table is an
    input."""
    m, s = macs_mul(F), macs_square(F)
    return 63 * (4 * (4 * s + 3 * m) + 7 * m)


def macs_ladder_signed(F) -> int:
    m, s = macs_mul(F), macs_square(F)
    double = 4 * s + 3 * m
    add = 8 * m
    to_niels = 2 * m
    table = to_niels + 7 * (add + to_niels)
    return table + 63 * (4 * double + add)


def macs_msm(F, wbits: int, signed: bool) -> int:
    """Per point of the window-sums kernel: to_niels of the point, the table
    additions with their to_niels, one addition a window."""
    from jubjub_tpu_torch.ops.msm import n_entries, n_windows
    m = macs_mul(F)
    built = n_entries(wbits, signed) - 1  # entry [1]P is the point's to_niels
    return m * (2 + built * (8 + 2) + n_windows(wbits, signed) * 8)


def macs_msm_reduce(F, nwin: int, blocks: int) -> int:
    """The partials' reduction: blocks - 1 additions a window, each the
    other point's to_niels and an addition."""
    return nwin * (blocks - 1) * (2 + 8) * macs_mul(F)


def macs_msm_fold(F, nwin: int, wbits: int) -> int:
    """The fold: (nwin - 1) * wbits doublings and nwin - 1 additions with
    their to_niels."""
    m, s = macs_mul(F), macs_square(F)
    return (nwin - 1) * (wbits * (4 * s + 3 * m) + (2 + 8) * m)


def fixed_base_scan_bound(table: torch.Tensor, lanes: int) -> dict:
    """The fixed-base scan's second bound term: every lane reads each
    window's whole slice of the packed table from shared memory, nwin x 3 x
    10 x tsize words, and the card moves at most 128 bytes of shared memory
    a clock into a warp's registers on each SM (32 banks of 4 bytes; a
    broadcast saves bank conflicts, not that width).  Returns its bytes and
    milliseconds; ``bound_ms`` keeps the operations term."""
    nwin, rows, limbs, tsize = table.shape
    scan_bytes = lanes * nwin * rows * limbs * tsize * 4
    ms = scan_bytes / PEAK_SMEM_BYTES_PER_S * 1e3
    return {"scan_smem_bytes": scan_bytes, "scan_smem_ms": ms}


def msm_design_bytes(wbits: int, signed: bool, n: int, blocks: int) -> int:
    """Bytes of device memory the window-sums kernel's design moves: per
    point its 4 input planes and its digits, read once; one partial sum a
    window a block written at the end.  The tables and the partial sums
    during the launch stay on chip (shared memory, registers)."""
    from jubjub_tpu_torch.ops.msm import n_windows
    nwin = n_windows(wbits, signed)
    return n * (4 * 80 + 4 * nwin) + blocks * nwin * 5 * 80


# -- inputs -------------------------------------------------------------------

def seeded_scalars(n: int, seed: int, modulus: int) -> list[int]:
    """n scalars below ``modulus`` from a numpy generator; the last three
    are the edge values 0, 1 and modulus-1."""
    raw = np.random.default_rng(seed).bytes(32 * n)
    ks = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % modulus
          for i in range(n)]
    ks[-3:] = [0, 1, modulus - 1]
    return ks


def lazy_plane(F, n: int, seed: int, terms: int, device) -> torch.Tensor:
    """A (20, n) plane of redundant residues: the carry-normalized sum of
    ``terms`` canonical Montgomery residues (value < terms * p)."""
    from jubjub_tpu_torch.fields import mont
    from jubjub_tpu_torch.native import ints_to_limbs
    acc = None
    for t in range(terms):
        vals = seeded_scalars(n, seed + 1000 * t, F.p)
        x = torch.from_numpy(ints_to_limbs(vals)).to(device)
        acc = x if acc is None else mont.add(F, acc, x)
    return acc.contiguous()


def sqrt_radicands(n: int, seed: int, device) -> torch.Tensor:
    """(20, n) Fq radicands in Montgomery form: random squares and random
    non-squares (the generator times a square) on alternate lanes, every
    third lane lazy (plus p); in the first lanes 0, 1, p-1 and what the
    decode takes the root of for the three kinds of invalid encoding
    (``corrupted_encodings``: v >= q, whose v it zeroes, so -1; a v whose
    u^2 is no square; a ZIP 216 negative zero, so 0)."""
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.fields import mont
    from jubjub_tpu_torch.fields.element import FQ_SPEC as F
    from jubjub_tpu_torch.native import ints_to_limbs
    x = lazy_plane(F, n, seed, 1, device)
    sq = mont.square(F, x)
    nonsq = mont.mul(F, sq, mont.const_mont(F, F.generator, (n,), device))
    lane = torch.arange(n, device=device)
    v = torch.where(lane % 2 == 0, sq, nonsq)
    v = torch.where(lane % 3 == 0, mont.sub(F, v, torch.zeros_like(v), k=1), v)
    q, d = oracle.Q, oracle.EDWARDS_D
    bad, lanes = corrupted_encodings(np.zeros((32, 126), np.uint8), 63)
    head = [0, 1, q - 1]
    for i in lanes:
        y = int.from_bytes(bytes(bad[:, i]), "little") & ((1 << 255) - 1)
        y = 0 if y >= q else y
        head.append((y * y - 1) * pow(1 + d * y * y, -1, q) % q)
    head = [h * F.R % F.p for h in head][:n]
    v[:, :len(head)] = torch.from_numpy(ints_to_limbs(head)).to(device)
    return v.contiguous()


def canonical_where(ok: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """The canonical form of ``root`` where ``ok``, 0 elsewhere."""
    from jubjub_tpu_torch.fields import mont
    from jubjub_tpu_torch.fields.element import FQ_SPEC
    return torch.where(ok, mont.to_canonical(FQ_SPEC, root), 0)


def check_equal(name: str, got, want) -> int:
    """Max |got - want| over all planes; fails unless it is 0."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: shape/dtype {g.shape} {g.dtype} != {w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max().item()) if g.numel() else 0)
    if err != 0:
        fail(f"{name}: kernel disagrees with its plain version, max abs err {err}")
    return err


# -- phase: every kernel against its plain version ----------------------------

def check_kernels(device):
    """Returns ({kernel: entry for the final ``kernels`` line}, {kernel: {tag:
    its cases at the spine shapes ("spine") or with a constant's digits
    ("const")}}, [cases])."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.scalar_mul import (
        _affine_niels_table, const_scalar_digits, full_generator_table,
        generator_table, signed_window_digits, signed_window_digits_wide,
        window_digits, window_digits_wide)
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.fields.element import FQ_SPEC, FR_SPEC
    from jubjub_tpu_torch.ops.fixed_base import fixed_base, fixed_base_plain
    from jubjub_tpu_torch.ops.ladder import (ladder, ladder_affine,
                                             ladder_affine_plain, ladder_plain,
                                             ladder_signed, ladder_signed_plain)
    from jubjub_tpu_torch.ops.mont import (mont_mul, mont_mul_plain,
                                           mont_square, mont_square_plain)
    from jubjub_tpu_torch.ops.roofline import (int_chain, int_chain_plain,
                                               mont_mul_chain,
                                               mont_mul_chain_plain,
                                               ops_per_element)
    from jubjub_tpu_torch.ops.scan import prefix_scan, prefix_scan_plain
    from jubjub_tpu_torch.ops.sqrt import fq_sqrt, fq_sqrt_plain
    from jubjub_tpu_torch.ops.sqrt import op_counts as sqrt_op_counts
    from jubjub_tpu_torch.ops import msm as msm_ops

    cases = []
    main = {}
    side = {}  # kernel: {tag: its cases at the spine shapes or a constant's}

    def as_planes(x):
        return [x] if isinstance(x, torch.Tensor) else list(x)

    def measure(kernel, variant, lanes, fn, plain_fn, reps, is_main,
                inputs, macs, kname=None, post=None):
        """Hold ``fn()`` (the wrapper on CUDA tensors) against ``plain_fn()``
        on the same inputs, time both, and compute the bound (``macs``: the
        int32 operations of the whole call).  ``is_main``: True for the
        kernel's main-path case, "spine" for a case at a spine shape, "const"
        for one with a constant's digits on every lane (all three also get
        ``device_ms``).  ``kname``: the kernel's name in the
        profiler's events, if not ``<kernel>_kernel``.  ``post``: applied
        to both results before they are compared, outside the timing."""
        got = as_planes(post(fn()) if post else fn())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want = as_planes(post(want) if post else want)
        err = check_equal(f"{kernel} {variant} n={lanes}", got, want)
        del want
        b_ms, by = bound(nbytes(*inputs, *got), macs)
        case = {"kernel": kernel, "variant": variant, "lanes": lanes,
                "equal": True, "max_abs_err": err,
                "kernel_ms": time_ms(fn, reps), "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by}
        cases.append(case)
        if is_main:
            prof = device_ms(fn, 5, kname or f"{kernel}_kernel")
            case["device_ms"] = prof.pop("device_ms")
            case["device_launches"] = prof
        if is_main is True:
            main[kernel] = case
        elif is_main:
            side.setdefault(kernel, {}).setdefault(is_main, []).append(case)

    # warm-up: the first use of a PyTorch operator loads its CUDA module, which
    # would otherwise be charged to the first plain version that is timed
    w = lazy_plane(FQ_SPEC, 8, SEED, 1, device)
    mont_mul_plain(FQ_SPEC, w, w), mont_square_plain(FQ_SPEC, w)
    torch.cuda.synchronize()

    # mont_mul / mont_square: Fq and Fr, canonical and lazy, N and ragged
    for F in (FQ_SPEC, FR_SPEC):
        for lanes in (N, RAGGED):
            for kind, ta, tb in (("canonical", 1, 1), ("lazy", 5, 6)):
                # sums of 5 and 6 residues: 5 * 6 and 5 * 5 stay within the
                # documented precondition c_a * c_b <= 32 of mul and square
                a = lazy_plane(F, lanes, SEED + 1, ta, device)
                b = lazy_plane(F, lanes, SEED + 2, tb, device)
                is_main = F is FQ_SPEC and lanes == N and kind == "canonical"
                # rotate over 4 copies of the operands (> 50 MB at N) so that
                # a launch finds them in device memory, as on the main path
                sets = [(a.clone(), b.clone()) for _ in range(4)]
                it = itertools.count()
                measure("mont_mul", f"{F.name} {kind}", lanes,
                        lambda: mont_mul(F, *sets[next(it) % 4]),
                        lambda: mont_mul_plain(F, a, b), 20, is_main,
                        (a, b), macs_mul(F) * lanes)
                measure("mont_square", f"{F.name} {kind}", lanes,
                        lambda: mont_square(F, sets[next(it) % 4][0]),
                        lambda: mont_square_plain(F, a), 20, is_main,
                        (a,), macs_square(F) * lanes)
                del sets

    # the shape batch_normalize's one inversion gives both kernels: a single
    # element, batch shape ()
    for F in (FQ_SPEC, FR_SPEC):
        a = lazy_plane(F, RAGGED, SEED + 6, 2, device)[:, 7].contiguous()
        b = lazy_plane(F, RAGGED, SEED + 7, 2, device)[:, 7].contiguous()
        measure("mont_mul", f"{F.name} single element", 1,
                lambda: mont_mul(F, a, b), lambda: mont_mul_plain(F, a, b),
                20, False, (a, b), macs_mul(F))
        measure("mont_square", f"{F.name} single element", 1,
                lambda: mont_square(F, a), lambda: mont_square_plain(F, a),
                20, False, (a,), macs_square(F))

    # fixed_base: signed and unsigned 8-bit windows, ragged and N; at N also
    # one seeded scalar on every lane: the scan reads every entry of a
    # window's slice whatever the digit, so the time should not move
    one_k = seeded_scalars(4, SEED + 12, oracle.R)[0]
    for lanes, uniform in ((RAGGED, False), (N, False), (N, True)):
        k = Fr.from_int([one_k] * lanes if uniform else
                        seeded_scalars(lanes, SEED + 3, oracle.R),
                        device=device)  # Montgomery form made on the host
        for signed in ((True,) if uniform else (True, False)):
            table = generator_table().device_table(8, signed, device)
            recode = signed_window_digits_wide if signed else window_digits_wide
            digits = recode(k, 8).contiguous()
            measure("fixed_base", ("signed" if signed else "unsigned")
                    + (", one scalar on every lane" if uniform else ""), lanes,
                    lambda: fixed_base(table, digits, signed),
                    lambda: fixed_base_plain(table, digits, signed), 5,
                    "const" if uniform else signed and lanes == N,
                    (digits, table),
                    macs_fixed_base(FQ_SPEC, digits.shape[0]) * lanes)
            cases[-1].update(fixed_base_scan_bound(table, lanes))

    # ladder and ladder_signed: limb for limb at N, ragged, at the MSM paths'
    # spine shapes, 51 and 16 lanes, and at one lane; points P_i = [m_i]G
    for lanes in (RAGGED, N, SPINE_LANES[0], SPINE_LANES[1], 1):
        k = Fr.from_int(seeded_scalars(max(lanes, 3), SEED + 4,
                                       oracle.R)[-lanes:], device=device)
        m = Fr.from_int([i % 97 + 1 for i in range(lanes)], device=device)
        p = full_generator_table().mul_fused(m)
        planes = [getattr(p, c).limbs.contiguous()
                  for c in ("u", "v", "z", "t1", "t2")]
        role = (True if lanes == N else
                "spine" if lanes in SPINE_LANES else False)
        for signed in (False, True):
            if signed:
                digits = signed_window_digits(k).contiguous()
                fn, plain, macs = ladder_signed, ladder_signed_plain, \
                    macs_ladder_signed(FQ_SPEC)
            else:
                digits = window_digits(k).contiguous()
                fn, plain, macs = ladder, ladder_plain, macs_ladder(FQ_SPEC)
            measure(fn.__name__, f"{'signed' if signed else 'unsigned'} "
                    "4-bit", lanes, lambda: fn(planes, digits),
                    lambda: plain(planes, digits), 2, role,
                    (digits, *planes), macs * lanes,
                    kname=f"ladder_kernel<{'true' if signed else 'false'}>")

    # the unsigned ladder with a host constant's windows on every lane
    # (mul_const_scalar, the torsion check's route): 64 rows for a constant
    # past 2^252, the 63 rows of r; points P_i = [m_i]G
    m = Fr.from_int([i % 97 + 1 for i in range(N)], device=device)
    p = full_generator_table().mul_fused(m)
    planes = [getattr(p, c).limbs.contiguous()
              for c in ("u", "v", "z", "t1", "t2")]
    for label, const in (("2^256-1, 64 windows", (1 << 256) - 1),
                         ("r, 63 windows", oracle.R)):
        d = torch.from_numpy(const_scalar_digits(const)).to(device)
        digits = d[:, None].expand(-1, N).contiguous()
        measure("ladder", f"unsigned 4-bit, constant {label}", N,
                lambda: ladder(planes, digits),
                lambda: ladder_plain(planes, digits), 2, "const",
                (digits, *planes), macs_ladder(FQ_SPEC, len(d)) * N,
                kname="ladder_kernel<false>")

    # ladder_affine (mul_affine's kernel) over the tables _affine_niels_table
    # builds of P_i = [m_i]G, normalised; digits 0 and 15 on moving lanes of
    # every window.  The kernel reads the table's entries 1..15.
    w = torch.arange(63, device=device)
    for lanes in (RAGGED, N):
        k = Fr.from_int(seeded_scalars(lanes, SEED + 11, oracle.R),
                        device=device)
        m = Fr.from_int([i % 97 + 1 for i in range(lanes)], device=device)
        table = _affine_niels_table(
            jj.batch_normalize(full_generator_table().mul_fused(m)))
        tplanes = [getattr(table, c).limbs.contiguous()
                   for c in ("v_plus_u", "v_minus_u", "t2d")]
        digits = window_digits(k).clone()
        digits[w, (3 * w) % lanes] = 0
        digits[w, (3 * w + 1) % lanes] = 15
        measure("ladder_affine", "unsigned 4-bit, affine-Niels table", lanes,
                lambda: ladder_affine(tplanes, digits),
                lambda: ladder_affine_plain(tplanes, digits), 2, lanes == N,
                (digits, *[x[1:] for x in tplanes]),
                macs_ladder_affine(FQ_SPEC) * lanes,
                kname="ladder_affine_kernel")
    # the same tables with one digit sequence (r's) on every lane: beside
    # the random digits above it shows whether the time depends on the
    # digits, which the masked scan is meant to make it not
    d = torch.from_numpy(const_scalar_digits(oracle.R)).to(device)
    digits = d[:, None].expand(-1, N).contiguous()
    measure("ladder_affine", "unsigned 4-bit, affine-Niels table, the "
            "digits of r on every lane", N,
            lambda: ladder_affine(tplanes, digits),
            lambda: ladder_affine_plain(tplanes, digits), 2, "const",
            (digits, *[x[1:] for x in tplanes]),
            macs_ladder_affine(FQ_SPEC) * N, kname="ladder_affine_kernel")
    del table, tplanes

    # msm_window_sums: signed 5-bit and unsigned 4-bit windows, limb for limb
    # on the per-block partial sums and after reduce_sum + batch_normalize; at
    # the MSM paths' 2^20 points (signed) also its device time and its bounds
    for points in (65536, RAGGED, 16, 1):
        for wbits, signed in ((5, True), (4, False)):
            cases.append(check_msm_window_sums(points, wbits, signed, device))
    main["msm_window_sums"] = check_msm_window_sums(N_MSM, 5, True, device)
    cases.append(main["msm_window_sums"])
    # one scalar for every point: every window thread scans every entry
    # whatever the digit, so the time should not move
    cases.append(check_msm_window_sums(N_MSM, 5, True, device, uniform=True))
    side.setdefault("msm_window_sums", {})["const"] = [cases[-1]]

    # msm_reduce and msm_fold, the MSM's tail, limb for limb against
    # reduce_sum and fold_plain: at the MSM paths' shapes (51 windows of an
    # H100's 264 partials; 51 windows of 5 bits), one block, odd counts, the
    # unsigned 4-bit and the Pippenger path's windows, and one window.
    pts = tail_points(device)
    for nwin, blocks in ((51, TAIL_BLOCKS), (51, 1), (63, 7), (16, 3)):
        x = tail_planes(pts, (nwin, blocks), nwin + blocks)
        measure("msm_reduce", f"{nwin} windows x {blocks} partials", blocks,
                lambda: msm_ops.msm_reduce(x),
                lambda: msm_ops.msm_reduce_plain(x), 20,
                (nwin, blocks) == (51, TAIL_BLOCKS), (x,),
                macs_msm_reduce(FQ_SPEC, nwin, blocks))
    for nwin, wbits in ((51, 5), (63, 4), (16, 16), (1, 5)):
        x = tail_planes(pts, (nwin,), nwin + wbits)
        measure("msm_fold", f"{nwin} windows of {wbits} bits", nwin,
                lambda: msm_ops.msm_fold(x, wbits),
                lambda: msm_ops.fold_plain(x, wbits), 20,
                (nwin, wbits) == (51, 5), (x,),
                macs_msm_fold(FQ_SPEC, nwin, wbits))
    del pts

    # prefix_scan: the Pippenger path's own input at 2^20 points (16 windows
    # x 33792 lanes x runs of 32 sorted points), and ragged slices of it: 5
    # and 1 steps (no multiple of the stage count), 3 windows and 1, and
    # 4099 lanes (no multiple of the block, so blocks straddle windows)
    niels = pippenger_niels(device)
    slices = [niels[:, :, :3, :5, :RAGGED].contiguous(),
              niels[:, :, :1, :1, :RAGGED].contiguous()]
    for x, is_main in ((slices[0], False), (slices[1], False), (niels, True)):
        _, _, nb, run, ln = x.shape
        measure("prefix_scan", f"{nb} windows x {run} steps x {ln} lanes",
                nb * run * ln, lambda: prefix_scan(x),
                lambda: prefix_scan_plain(x), 5, is_main, (x,),
                8 * macs_mul(FQ_SPEC) * nb * run * ln)
    del niels, slices

    # fq_sqrt: the decode's 2^20 lanes, 2^18 and a ragged count; ok exactly,
    # the root as a field element (after to_canonical; the kernel's lazy
    # limbs are not always the plain version's) on the lanes where it is
    # defined, a square's
    counts = sqrt_op_counts()
    for lanes in (N_MSM, 1 << 18, RAGGED):
        a = sqrt_radicands(lanes, SEED + 80, device)
        measure("fq_sqrt", "squares, non-squares, invalid encodings' "
                "radicands", lanes, lambda: fq_sqrt(FQ_SPEC, a),
                lambda: fq_sqrt_plain(FQ_SPEC, a), 5, lanes == N_MSM, (a,),
                (counts["square"] * macs_square(FQ_SPEC)
                 + counts["mul"] * macs_mul(FQ_SPEC)
                 + counts["reduce"] * macs_reduce(FQ_SPEC)) * lanes,
                post=lambda r: (canonical_where(r[1], r[0]), r[1]))
        del a

    # the int32 probes: the reference's shapes (the phase roofline times
    # them) and a ragged one at a short chain
    rng = np.random.default_rng(SEED + 70)
    for shape, n_ops in (((RAGGED,), 64), (PROBE_SHAPE, PROBE_CHAIN)):
        a = torch.from_numpy(
            rng.integers(1, 1 << 15, shape, dtype=np.int32)).to(device)
        b = torch.from_numpy(
            rng.integers(1, 1 << 15, shape, dtype=np.int32)).to(device)
        for op in ("add", "mixed", "mul"):
            measure("int_chain", f"{op} x {n_ops}", a.numel(),
                    lambda: int_chain(a, b, n_ops, op),
                    lambda: int_chain_plain(a, b, n_ops, op), 20,
                    op == "mul" and n_ops == PROBE_CHAIN, (a, b),
                    a.numel() * ops_per_element(n_ops, op))
    for lanes, chain in ((RAGGED, 5), (FQ_CHAIN_LANES[1], FQ_CHAIN),
                         (FQ_CHAIN_LANES[0], FQ_CHAIN)):
        a = lazy_plane(FQ_SPEC, lanes, SEED + 71, 2, device)
        b = lazy_plane(FQ_SPEC, lanes, SEED + 72, 2, device)
        measure("mont_mul_chain", f"Fq x {chain}", lanes,
                lambda: mont_mul_chain(a, b, chain),
                lambda: mont_mul_chain_plain(a, b, chain), 20,
                lanes == FQ_CHAIN_LANES[0], (a, b),
                macs_mul(FQ_SPEC) * chain * lanes)
    return main, side, cases


def msm_inputs(n: int, seed: int, wbits: int, signed: bool, device,
               uniform: bool = False):
    """Kernel inputs for ``n`` points P_i = [m_i]G and seeded scalars (the
    edge scalars 0, 1, r-1 last; with ``uniform`` one seeded scalar for
    every point): planes (u, v, z, t1*t2) and the digits."""
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.scalar_mul import (
        full_generator_table, signed_window_digits_wide, window_digits_wide)
    from jubjub_tpu_torch.fields import Fr
    ks = seeded_scalars(max(n, 4), seed, oracle.R)
    k = Fr.from_int([ks[0]] * n if uniform else ks[-n:], device=device)
    m = Fr.from_int([i % 97 + 1 for i in range(n)], device=device)
    p = full_generator_table().mul_fused(m)
    planes = [x.contiguous() for x in
              (p.u.limbs, p.v.limbs, p.z.limbs, (p.t1 * p.t2).limbs)]
    recode = signed_window_digits_wide if signed else window_digits_wide
    return planes, recode(k, wbits).contiguous()


def tail_points(device) -> torch.Tensor:
    """RAGGED points [m]G of the full group (torsion included) as the
    fixed-base path leaves them: planes (5, 20, RAGGED)."""
    from jubjub_tpu_torch.curve.scalar_mul import full_generator_table
    from jubjub_tpu_torch.fields import Fr
    p = full_generator_table().mul_fused(
        Fr.from_int([i * 7 + 3 for i in range(RAGGED)], device=device))
    return torch.stack([getattr(p, c).limbs
                        for c in ("u", "v", "z", "t1", "t2")])


def tail_planes(points: torch.Tensor, shape, seed: int) -> torch.Tensor:
    """Planes (5, 20, *shape) of seeded picks from ``points``, with the
    identity at about one position in nine."""
    from jubjub_tpu_torch.curve.points import ExtendedPoint
    rng = np.random.default_rng(SEED + seed)
    idx = torch.from_numpy(rng.integers(0, points.shape[2], shape))
    out = points[:, :, idx.to(points.device)].contiguous()
    ident = torch.from_numpy(rng.integers(0, 9, shape) == 0).to(points.device)
    one = ExtendedPoint.identity(device=points.device)
    out[:, :, ident] = torch.stack([getattr(one, c).limbs for c in (
        "u", "v", "z", "t1", "t2")])[:, :, None]
    return out


def pippenger_inputs(n: int, seed: int, device):
    """``n`` points P_i = [m_i]G and seeded scalars (edge scalars last)."""
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.scalar_mul import full_generator_table
    from jubjub_tpu_torch.fields import Fr
    k = Fr.from_int(seeded_scalars(n, seed, oracle.R), device=device)
    m = Fr.from_int([i % 97 + 1 for i in range(n)], device=device)
    return full_generator_table().mul_fused(m), k


def pippenger_niels(device) -> torch.Tensor:
    """The scan kernel's input on the Pippenger path at N_MSM points: the
    digit-sorted Niels planes (4, 20, 16 windows, 32 steps, 33792 lanes on an
    H100 SXM)."""
    from jubjub_tpu_torch import config
    from jubjub_tpu_torch.ops.scan import n_lanes
    from jubjub_tpu_torch.parallel.pippenger import sorted_niels
    pts, k = pippenger_inputs(N_MSM, SEED + 60, device)
    niels, _ = sorted_niels(pts, k, config.PIPPENGER_WBITS,
                            n_lanes(N_MSM, device))
    return niels


def check_msm_window_sums(points, wbits, signed, device,
                          uniform: bool = False) -> dict:
    """The kernel against its plain version on the same inputs: the partial
    sums (one a window a block) limb for limb, and the window sums after
    reduce_sum and batch_normalize.  Every size is held so, 2^20 points
    included: the plain version adds a block's points one step at a time
    (about 20 ms a step on the card, 3972 steps at 2^20 points and 264
    blocks, some 100 s; 249 steps, 6 s, at 65536), and the 2^20 result is
    held besides by path_msm and path_e2e against the oracle's bytes."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch.curve import reduce_sum
    from jubjub_tpu_torch.fields.element import FQ_SPEC
    from jubjub_tpu_torch.ops.msm import (msm_window_sums, n_blocks,
                                          window_sums_plain)
    planes, digits = msm_inputs(points, SEED + 8, wbits, signed, device,
                                uniform)
    blocks = n_blocks(points, device)
    variant = f"{'signed' if signed else 'unsigned'} {wbits}-bit" + (
        ", one scalar for every point" if uniform else "")
    fn = lambda: msm_window_sums(planes, digits, wbits, signed, blocks)  # noqa: E731
    got = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = window_sums_plain(planes, digits, wbits, signed, blocks)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_peak = torch.cuda.max_memory_allocated()
    name = f"msm_window_sums {variant} n={points}"
    err = check_equal(name, [got], [want])

    def normalized(acc):
        aff = jj.batch_normalize(reduce_sum(
            jj.ExtendedPoint(*[jj.Fq(acc[c]) for c in range(5)]), axis=1))
        return aff.u.limbs, aff.v.limbs

    check_equal(f"{name} normalized", normalized(got), normalized(want))
    b_ms, by = bound(nbytes(*planes, digits, got),
                     macs_msm(FQ_SPEC, wbits, signed) * points)
    del want
    case = {"kernel": "msm_window_sums", "variant": variant, "lanes": points,
            "blocks": blocks, "equal": True, "normalized_equal": True,
            "max_abs_err": err, "kernel_ms": time_ms(fn, 2),
            "plain_ms": plain_ms, "plain_peak_bytes": plain_peak,
            "bound_ms": b_ms, "bound_by": by}
    if points == N_MSM:
        design = msm_design_bytes(wbits, signed, points, blocks)
        prof = device_ms(fn, 5, "msm_window_sums_kernel")
        case.update(device_ms=prof.pop("device_ms"), device_launches=prof,
                    design_bytes=design,
                    design_bytes_ms=design / PEAK_BYTES_PER_S * 1e3)
    return case


# -- phase: the main path -----------------------------------------------------

PATH_KERNEL = {"ladder": "ladder", "ladder_signed": "ladder_signed",
               "affine_mul": "ladder_affine"}


def drive_path(which: str, device):
    """One of the scalar-multiplication paths at N lanes, through the normal
    entry points: "fixed_base" (A), "ladder" (B), "ladder_signed" (B with
    ``config.LADDER_SIGNED``, on B's scalars and points) or "affine_mul"
    (B's points normalised, times B's scalars through ``AffinePoint *``:
    the affine-Niels table, then the ``ladder_affine`` kernel).  Returns the
    launch counts and the encodings."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import config, oracle
    from jubjub_tpu_torch.curve.scalar_mul import (full_generator_table,
                                                   generator_table,
                                                   mul_extended)
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.native import ints_to_limbs

    seed = SEED + (10 if which == "fixed_base" else 20)
    ks = seeded_scalars(N, seed, oracle.R)
    k_limbs = ints_to_limbs(ks)                     # canonical limbs, numpy
    if which != "fixed_base":
        ms_ = [i % 97 + 1 for i in range(N)]
        m = Fr.from_int(ms_, device=device)

    def run(mark):
        k = Fr.from_canonical(k_limbs, device=device)
        mark("from_canonical")
        if which == "fixed_base":
            prod = generator_table().mul_fused(k)
        else:
            base = full_generator_table().mul_fused(m)
            mark("base_points")
            if which == "affine_mul":
                base = jj.batch_normalize(base)
                mark("normalize_base")
                prod = base * k  # stage marks affine_table, ladder_affine
            else:
                prod = mul_extended(base, k)
        if which != "affine_mul":
            mark("scalar_mul")
        aff = jj.batch_normalize(prod)
        mark("batch_normalize")
        enc = aff.to_bytes()
        mark("to_bytes")
        return aff, enc

    signed_before = config.LADDER_SIGNED
    config.LADDER_SIGNED = which == "ladder_signed"
    try:
        aff, enc, wall_ms, counts, stages = _drive_scalar_mul(run)
    finally:
        config.LADDER_SIGNED = signed_before

    if tuple(enc.shape) != (32, N) or enc.dtype != torch.uint8:
        fail(f"path_{which}: encodings are {enc.dtype} {tuple(enc.shape)}")
    if not bool(aff.is_on_curve().all().item()):
        fail(f"path_{which}: a result is not on the curve")
    host = enc.cpu().numpy()
    lanes = list(range(HEAD)) + [N - 3, N - 2, N - 1]
    for i in lanes:
        if which == "fixed_base":
            want = oracle.mul(oracle.SUBGROUP_GENERATOR, ks[i])
        else:
            want = oracle.mul(oracle.mul(oracle.GENERATOR, ms_[i]), ks[i])
        if bytes(host[:, i]) != oracle.to_bytes(want):
            fail(f"path_{which}: lane {i} differs from the oracle's encoding")
    needed = ["mont_mul", "mont_square", "fixed_base"]
    if which != "fixed_base":
        needed.append(PATH_KERNEL[which])
    for name in needed:
        if counts[name] <= 0:
            fail(f"path_{which}: kernel {name} was never launched")
    emit({f"path_{which}": {"lanes": N, "wall_ms": wall_ms,
                            "lanes_per_s": N / (wall_ms / 1e3),
                            "stages_ms": stages,
                            "checked_lanes": lanes, "oracle_equal": True,
                            "on_curve": True, "launches": counts}})
    return counts, enc


def _passes(run):
    """A warm-up pass of ``run(mark)``, then the counted and timed pass (no
    synchronization inside), then a pass synchronized after every stage for
    the breakdown, at ``run``'s own marks and at the entry points' stage
    marks (``stages``).  Returns (the timed pass's result, the staged
    pass's, wall_ms, launch counts, stages_ms)."""
    from jubjub_tpu_torch import ops
    from jubjub_tpu_torch.stages import recording

    run(lambda name: None)  # warm-up: allocator, constant and table caches

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(lambda name: None)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()

    stages = {}
    last = [0.0]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - last[0]) * 1e3
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    with recording(mark):
        out2 = run(mark)
    return out, out2, wall_ms, counts, stages


def _drive_scalar_mul(run):
    """``_passes(run)`` of a path whose ``run`` returns (points, encodings);
    the timed and the staged pass must give the same encodings.  Returns
    (points, encodings, wall_ms, launch counts, stages_ms)."""
    (aff, enc), (_, enc2), wall_ms, counts, stages = _passes(run)
    if not torch.equal(enc, enc2):
        fail("two runs of a scalar-multiplication path on the same scalars "
             "disagree")
    return aff, enc, wall_ms, counts, stages


def check_multiply_bits(device, enc_ladder: torch.Tensor, lanes: int = 4096):
    """The bit-serial ``ExtendedPoint.multiply_bits`` (plain PyTorch: 252
    doublings and additions over the mont kernels) on the first ``lanes``
    points and scalars of path B: its encodings must equal path B's."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.scalar_mul import full_generator_table
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.native import ints_to_limbs
    ks = seeded_scalars(N, SEED + 20, oracle.R)[:lanes]
    k = Fr.from_canonical(ints_to_limbs(ks), device=device)
    base = full_generator_table().mul_fused(
        Fr.from_int([i % 97 + 1 for i in range(lanes)], device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = jj.batch_normalize(base.multiply_bits(k.to_bytes())).to_bytes()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(out, enc_ladder[:, :lanes]):
        fail("multiply_bits: encodings differ from path_ladder's")
    emit({"multiply_bits": {"lanes": lanes, "wall_ms": wall_ms,
                            "equal_to_path_ladder": True}})


SMALL_ORDER_LANE = 130  # path_subgroup: lanes 130-137, the 8 small-order points


def subgroup_inputs(device) -> tuple[np.ndarray, np.ndarray, dict]:
    """path_subgroup's N encodings and the ``ok`` their construction gives.
    Lane i with i % 4 in {0, 1}: [s_i]G8 (in the subgroup); i % 4 == 2:
    [s_i]G8 + T[j_i], j_i = (i // 4) mod 7, never the identity T[7] (not in
    it); i % 4 == 3: [m_i]G, a full-group point (in it exactly when 8 | m_i);
    lanes 130-137 the eight small-order points (only T[7], the identity, in
    it); and the 64 corrupted encodings of ``corrupted_encodings`` on the odd
    lanes below 128 (rejected).  The points are made on the card by the
    fixed-base kernel, outside any timed pass, and the leading lanes held to
    the oracle."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.points import select_point
    from jubjub_tpu_torch.curve.scalar_mul import (_take_entry_const,
                                                   full_generator_table,
                                                   generator_table)
    from jubjub_tpu_torch.curve.subgroup import (_torsion_table,
                                                 eight_torsion_host)
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.native import ints_to_limbs
    ss = seeded_scalars(N, SEED + 100, oracle.R)
    ms_ = seeded_scalars(N, SEED + 101, oracle.R)
    kind = np.arange(N) % 4
    js = (np.arange(N) // 4) % 7
    sub = generator_table().mul_fused(
        Fr.from_canonical(ints_to_limbs(ss), device=device))
    full = full_generator_table().mul_fused(
        Fr.from_canonical(ints_to_limbs(ms_), device=device))
    tor = _take_entry_const(_torsion_table(device),
                            torch.from_numpy(js).to(device))
    mixed = sub.add_affine_niels(tor.to_niels())
    kd = torch.from_numpy(kind).to(device)
    pts = select_point(kd == 2, mixed, select_point(kd == 3, full, sub))
    enc = jj.batch_normalize(pts).to_bytes().cpu().numpy()
    torsion = eight_torsion_host()
    g8 = oracle.SUBGROUP_GENERATOR
    for i in range(HEAD):
        want = (oracle.mul(g8, ss[i]) if kind[i] < 2 else
                oracle.add(oracle.mul(g8, ss[i]), torsion[js[i]])
                if kind[i] == 2 else oracle.mul(oracle.GENERATOR, ms_[i]))
        if bytes(enc[:, i]) != oracle.to_bytes(want):
            fail(f"path_subgroup: input lane {i} differs from the oracle's")
    ok = (kind < 2) | ((kind == 3) & np.array([m % 8 == 0 for m in ms_]))
    for t, pt in enumerate(torsion):
        enc[:, SMALL_ORDER_LANE + t] = np.frombuffer(oracle.to_bytes(pt),
                                                     np.uint8)
        ok[SMALL_ORDER_LANE + t] = pt == oracle.IDENTITY
    enc, bad = corrupted_encodings(enc, 64)
    ok[bad] = False
    made = {"subgroup": int((kind < 2).sum()), "torsion_mixed":
            int((kind == 2).sum()), "full_group": int((kind == 3).sum()),
            "small_order_lanes": [SMALL_ORDER_LANE, SMALL_ORDER_LANE + 7],
            "corrupted": len(bad), "oracle_checked_input_lanes": HEAD}
    return enc, ok, made


def drive_subgroup_path(device) -> dict:
    """path_subgroup: subgroup-checked decoding at N lanes, the check a
    Sapling verifier runs on every point it receives:
    ``SubgroupPoint.from_bytes`` (decode, then the torsion check through the
    ladder kernel, then the identity where either fails) -> ``to_affine``
    -> ``to_bytes``.  The ``ok`` mask must equal the construction's on every
    lane, and the output bytes the input bytes where ok and the identity's
    elsewhere.  Returns the launch counts."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import oracle
    enc, want_ok, made = subgroup_inputs(device)
    b = torch.from_numpy(enc).to(device)

    def run(mark):
        sp, ok = jj.SubgroupPoint.from_bytes(b)
        aff = sp.to_affine()
        mark("batch_normalize")
        out = aff.to_bytes()
        mark("to_bytes")
        return ok, out

    (ok, out), (ok2, out2), wall_ms, counts, stages = _passes(run)
    if not (torch.equal(ok, ok2) and torch.equal(out, out2)):
        fail("path_subgroup: two runs on the same encodings disagree")
    if tuple(out.shape) != (32, N) or tuple(ok.shape) != (N,):
        fail(f"path_subgroup: output {tuple(out.shape)}, ok {tuple(ok.shape)}")
    got_ok = ok.cpu().numpy()
    if not np.array_equal(got_ok, want_ok):
        fail("path_subgroup: ok differs from the construction on lanes "
             f"{np.nonzero(got_ok != want_ok)[0][:20].tolist()}")
    ident = torch.tensor(list(oracle.to_bytes(oracle.IDENTITY)),
                         dtype=torch.uint8, device=device)[:, None]
    if not torch.equal(out, torch.where(ok[None, :], b, ident)):
        fail("path_subgroup: output bytes are not the input's where ok and "
             "the identity's elsewhere")
    for name in ("mont_mul", "mont_square", "ladder"):
        if counts[name] <= 0:
            fail(f"path_subgroup: kernel {name} was never launched")
    emit({"path_subgroup": {
        "lanes": N, "wall_ms": wall_ms, "lanes_per_s": N / (wall_ms / 1e3),
        "stages_ms": stages, "inputs": made,
        "accepted": int(got_ok.sum()), "rejected": int(N - got_ok.sum()),
        "ok_equals_construction_on_every_lane": True,
        "bytes_checked_on_every_lane": True, "launches": counts}})
    return counts


def drive_cofactor_path(device) -> dict:
    """path_cofactor at N lanes: ``random_extended`` from a seeded
    ``torch.Generator`` on the card -> ``clear_cofactor`` ->
    ``into_subgroup`` (the torsion check through the ladder kernel) ->
    ``to_bytes``.  Every ``ok`` must be true, and the leading lanes equal
    the oracle's [8]([k]G8 + T[j]) from the same draws, made again from the
    same seed.  Returns the launch counts."""
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.subgroup import (clear_cofactor,
                                                 eight_torsion_host,
                                                 into_subgroup,
                                                 random_extended)
    from jubjub_tpu_torch.fields import Fr
    seed = SEED + 110

    def run(mark):
        gen = torch.Generator(device=device).manual_seed(seed)
        p = random_extended(gen, (N,), device)
        mark("random_extended")
        s = clear_cofactor(p)
        mark("clear_cofactor")
        sub, ok = into_subgroup(s.inner)
        mark("into_subgroup")
        aff = sub.to_affine()
        mark("batch_normalize")
        out = aff.to_bytes()
        mark("to_bytes")
        return ok, out

    (ok, out), (ok2, out2), wall_ms, counts, stages = _passes(run)
    if not (torch.equal(ok, ok2) and torch.equal(out, out2)):
        fail("path_cofactor: two runs from the same seed disagree")
    if tuple(out.shape) != (32, N) or not bool(ok.all().item()):
        fail("path_cofactor: a cofactor-cleared point failed into_subgroup")
    gen = torch.Generator(device=device).manual_seed(seed)
    k = Fr.random(gen, (N,), device)
    j = torch.randint(0, 8, (N,), generator=gen, device=device)
    ks = Fr(k.limbs[:, :HEAD]).to_ints()
    js = j[:HEAD].tolist()
    torsion = eight_torsion_host()
    host = out[:, :HEAD].cpu().numpy()
    for i in range(HEAD):
        want = oracle.mul(oracle.add(
            oracle.mul(oracle.SUBGROUP_GENERATOR, ks[i]), torsion[js[i]]), 8)
        if bytes(host[:, i]) != oracle.to_bytes(want):
            fail(f"path_cofactor: lane {i} differs from the oracle's")
    for name in ("mont_mul", "mont_square", "ladder"):
        if counts[name] <= 0:
            fail(f"path_cofactor: kernel {name} was never launched")
    emit({"path_cofactor": {
        "lanes": N, "wall_ms": wall_ms, "lanes_per_s": N / (wall_ms / 1e3),
        "stages_ms": stages, "all_ok": True, "checked_lanes": HEAD,
        "oracle_equal": True,
        "torsion_indices_drawn": torch.bincount(j, minlength=8).tolist(),
        "launches": counts}})
    return counts


def msm_oracle_bytes(ss: list[int], ks: list[int]) -> bytes:
    """The oracle's encoding of sum_i k_i [s_i]G8 = [sum_i k_i s_i mod r]G8,
    the sum taken on the host in Python ints."""
    from jubjub_tpu_torch import oracle
    c = sum(a * b for a, b in zip(ss, ks)) % oracle.R
    return oracle.to_bytes(oracle.mul(oracle.SUBGROUP_GENERATOR, c))


def corrupted_encodings(encs: np.ndarray, count: int) -> tuple[np.ndarray, list]:
    """Copies of ``encs`` (uint8 (32, n)) with ``count`` lanes corrupted in
    turn: a non-canonical v (at least q), a v whose u^2 is no square, and the
    two ZIP-216 negative zeros.  Returns the bytes and the corrupted lanes."""
    from jubjub_tpu_torch import oracle
    q, d = oracle.Q, oracle.EDWARDS_D
    non_square = []
    v = 2
    while len(non_square) < count:
        u2 = (v * v - 1) * pow(1 + d * v * v, -1, q) % q
        if oracle.sqrt_q(u2) is None:
            non_square.append(v)
        v += 1
    out = encs.copy()
    lanes = list(range(1, 2 * count, 2))  # every other lane, from lane 1
    for j, i in enumerate(lanes):
        kind = j % 3
        if kind == 0:      # v = q + j >= q, the sign bit kept
            b = bytearray((q + j).to_bytes(32, "little"))
            b[31] |= out[31, i] & 0x80
        elif kind == 1:    # u^2 is no square
            b = bytearray(non_square[j].to_bytes(32, "little"))
        else:              # ZIP 216: u = 0 with the sign bit set
            vv = 1 if j % 2 else q - 1
            b = bytearray(vv.to_bytes(32, "little"))
            b[31] |= 0x80
        out[:, i] = np.frombuffer(bytes(b), np.uint8)
    return out, lanes


def drive_msm_path(which: str, device):
    """The MSM leg ("msm": points in), the end-to-end slice ("e2e": 32-byte
    encodings in) or the sorted-scan MSM ("pippenger": points in, held also
    against ``msm_fused`` on the same inputs) at N_MSM points, through the
    normal entry points.  Returns the launch counts and the result's
    bytes."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch.curve.scalar_mul import generator_table
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.native import ints_to_limbs

    ss, ks = msm_path_scalars(which)
    # set-up, not timed: the points (fixed-base kernel), their encodings and
    # the scalars on the card
    pts = generator_table().mul_fused(
        Fr.from_canonical(ints_to_limbs(ss), device=device))
    k = Fr.from_canonical(ints_to_limbs(ks), device=device)
    enc = jj.batch_normalize(pts).to_bytes() if which == "e2e" else None
    want = msm_oracle_bytes(ss, ks)

    def run(mark):
        # the staged pass sees the entry points' stage marks, then "encode"
        ok = None
        if which == "msm":
            out = jj.msm_fused(pts, k)
        elif which == "pippenger":
            out = jj.msm_pippenger(pts, k)
        else:
            dec, ok = jj.affine_from_bytes(enc)
            out = jj.msm_fused(dec.to_extended(), k)
        res = jj.batch_normalize(out).to_bytes()
        mark("encode")
        return res, ok

    (res, ok), (res2, _), wall_ms, counts, stages = _passes(run)

    if tuple(res.shape) != (32,) or res.dtype != torch.uint8:
        fail(f"path_{which}: result is {res.dtype} {tuple(res.shape)}")
    if not torch.equal(res, res2):
        fail(f"path_{which}: two runs on the same inputs disagree")
    if bytes(res.cpu().numpy()) != want:
        fail(f"path_{which}: the result differs from the oracle's encoding")
    entry = {"points": N_MSM, "wall_ms": wall_ms,
             "points_per_s": N_MSM / (wall_ms / 1e3), "stages_ms": stages,
             "oracle_equal": True, "launches": counts}
    if which == "e2e":
        if tuple(ok.shape) != (N_MSM,) or not bool(ok.all().item()):
            fail("path_e2e: a canonical encoding was not decoded")
        entry["decoded_ok"] = N_MSM
        # rejection, outside the timed pass: 64 corrupted lanes among 128
        bad, lanes = corrupted_encodings(enc[:, :128].cpu().numpy(), 64)
        _, ok_bad = jj.affine_from_bytes(torch.from_numpy(bad).to(device))
        want_ok = np.ones(128, bool)
        want_ok[lanes] = False
        if not np.array_equal(ok_bad.cpu().numpy(), want_ok):
            fail("path_e2e: decode of corrupted encodings: ok differs on "
                 f"lanes {np.nonzero(ok_bad.cpu().numpy() != want_ok)[0]}")
        entry["rejected"] = {"corrupted": len(lanes), "of": 128,
                             "ok_false_exactly_there": True}
    if which == "pippenger":
        # outside the timed passes: the window-sums MSM on the same inputs
        fused = jj.batch_normalize(jj.msm_fused(pts, k)).to_bytes()
        if not torch.equal(fused, res):
            fail("path_pippenger: the result differs from msm_fused's")
        entry["msm_fused_equal"] = True
        needed = ("mont_mul", "mont_square", "prefix_scan", "msm_fold")
    else:
        needed = ("mont_mul", "mont_square", "msm_window_sums")
        # the tail: one launch of each kernel, no ladder, and (sync_probe)
        # nothing that waits for the card
        once = {name: counts[name] for name in (
            "msm_window_sums", "msm_reduce", "msm_fold", "ladder")}
        if once != {"msm_window_sums": 1, "msm_reduce": 1, "msm_fold": 1,
                    "ladder": 0}:
            fail(f"path_{which}: launches a call {once}, expected one each "
                 "of the window sums, msm_reduce and msm_fold, no ladder")
        if which == "msm":
            entry["msm_fused_syncs"] = sync_probe(
                lambda: jj.msm_fused(pts, k), pts.u.limbs)
    if which == "e2e":
        needed += ("fq_sqrt",)
    for name in needed:
        if counts[name] <= 0:
            fail(f"path_{which}: kernel {name} was never launched")
    emit({f"path_{which}": entry})
    return counts, bytes(res.cpu().numpy())


def sync_probe(fn, probe: torch.Tensor) -> dict:
    """Synchronisations with the host that ``fn()`` (warmed up) makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, beside a
    control that reads one value of ``probe`` back (one synchronisation)
    under the same mode.  Fails unless the control is seen and ``fn``
    makes none, naming the package's frames at each one it makes."""
    import traceback
    import warnings

    def where(message, *args, **kwargs):
        # not the notice that setting the mode itself gives once
        if "called a synchronizing" in str(message):
            frames = [f"{f.filename.rsplit('jubjub_tpu_torch/', 1)[-1]}:"
                      f"{f.lineno}" for f in traceback.extract_stack()
                      if "jubjub_tpu_torch" in f.filename]
            seen.append(" <- ".join(frames[::-1][:5]))

    def count(f):
        seen.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = where
            torch.cuda.set_sync_debug_mode("warn")
            try:
                f()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return list(seen)

    seen: list = []
    call = count(fn)
    out = {"call": len(call), "control": len(count(
        lambda: probe[0, 0].item()))}
    if out["control"] < 1:
        fail(f"sync probe: the control's read-back was not seen: {out}")
    if call:
        fail(f"sync probe: the call synchronised with the host: {call}")
    return out


def msm_path_scalars(which: str) -> tuple[list[int], list[int]]:
    """The MSM path ``which``'s scalars: s_i of its points P_i = [s_i]G8,
    and k_i."""
    from jubjub_tpu_torch import oracle
    seed = SEED + {"msm": 30, "e2e": 40, "pippenger": 50}[which]
    return (seeded_scalars(N_MSM, seed, oracle.R),
            seeded_scalars(N_MSM, seed + 1, oracle.R))


# path_sharded_msm: (world, backend, device of every rank, legs); a leg is
# (algorithm, points in all).  The card's machine has one GPU, so the four
# gloo ranks share it: they show that the collective, the replication and
# the kernels are right in every rank, not how the MSM scales.
SHARDED_RUNS = ((1, "nccl", "cuda", (("fused", N_MSM),)),
                (4, "gloo", "cuda:0", (("fused", N_MSM), ("sorted", N_MSM),
                                       ("torch", 4096))))


def _sharded_rank(rank, world, device, limbs_path, legs):
    """One rank of path_sharded_msm: for each leg, its shard of path_msm's
    points (made on the card by the fixed-base kernel, set-up) and scalars,
    then a warm-up pass, the counted and timed pass and a pass synchronised
    at every stage mark, each ``msm_sharded`` -> ``batch_normalize`` ->
    bytes, every pass begun together on every rank.  Returns, per leg, the
    bytes, wall_ms, stages_ms and the launch counts of the timed pass."""
    import torch.distributed as dist
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import ops, stages
    from jubjub_tpu_torch.curve.scalar_mul import generator_table
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.parallel import msm_sharded
    limbs = np.load(limbs_path, mmap_mode="r")       # (2, NLIMBS, N_MSM)
    out = []
    for algorithm, n in legs:
        lo, hi = rank * n // world, (rank + 1) * n // world
        pts = generator_table().mul_fused(Fr.from_canonical(
            np.array(limbs[0][:, lo:hi]), device=device))
        k = Fr.from_canonical(np.array(limbs[1][:, lo:hi]), device=device)

        def run():
            res = jj.batch_normalize(msm_sharded(pts, k, algorithm=algorithm))
            enc = res.to_bytes()
            stages.mark("encode")
            return enc

        run()
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        enc = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        dist.barrier()
        staged, last = {}, [time.perf_counter()]

        def mark(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            staged[name] = staged.get(name, 0.0) + (now - last[0]) * 1e3
            last[0] = now

        with stages.recording(mark):
            enc2 = run()
        out.append({"algorithm": algorithm, "points": hi - lo,
                    "bytes": bytes(enc.cpu().numpy()),
                    "staged_bytes": bytes(enc2.cpu().numpy()),
                    "wall_ms": wall_ms, "stages_ms": staged,
                    "launches": counts})
        del pts, k
        torch.cuda.empty_cache()
    return out


def drive_sharded_msm(msm_bytes: bytes) -> dict:
    """path_sharded_msm: ``msm_sharded`` on path_msm's 2^20 points and
    scalars, (a) on one rank over NCCL, (b) on four gloo ranks sharing the
    card (and the "torch" algorithm on their first 4096); every rank's
    bytes must equal path_msm's and the oracle's.  The kernels are built by
    this process before any rank starts (``spawn_ranks``).  Returns the
    launches of every rank's timed pass, summed."""
    import tempfile
    from jubjub_tpu_torch import ops
    from jubjub_tpu_torch.native import ints_to_limbs
    from jubjub_tpu_torch.parallel.launch import spawn_ranks
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    ss, ks = msm_path_scalars("msm")
    want = {N_MSM: msm_oracle_bytes(ss, ks)}
    if want[N_MSM] != msm_bytes:
        fail("path_sharded_msm: path_msm's bytes differ from the oracle's")
    counts = {name: 0 for name in ops.launch_counts()}
    runs, spawns = [], []
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        limbs_path = os.path.join(tmp, "limbs.npy")
        np.save(limbs_path, np.stack([ints_to_limbs(ss), ints_to_limbs(ks)]))
        for world, backend, dev, legs in SHARDED_RUNS:
            for _, n in legs:
                if n not in want:
                    want[n] = msm_oracle_bytes(ss[:n], ks[:n])
            t0 = time.perf_counter()
            ranks = spawn_ranks(world, _sharded_rank, backend, dev,
                                limbs_path, legs)
            spawns.append({"world": world, "backend": backend,
                           "spawn_to_join_ms":
                               (time.perf_counter() - t0) * 1e3})
            for j, (algorithm, n) in enumerate(legs):
                label = f"world {world} {backend} {algorithm}"
                for rank, res in enumerate(ranks):
                    leg = res[j]
                    if leg["bytes"] != leg["staged_bytes"]:
                        fail(f"path_sharded_msm {label}: rank {rank}'s two "
                             "passes disagree")
                    if leg["bytes"] != want[n]:
                        fail(f"path_sharded_msm {label}: rank {rank}'s "
                             "bytes differ from the oracle's")
                    if n == N_MSM and leg["bytes"] != msm_bytes:
                        fail(f"path_sharded_msm {label}: rank {rank}'s "
                             "bytes differ from path_msm's")
                    for name, c in leg["launches"].items():
                        counts[name] += c
                needed = {"fused": "msm_reduce", "sorted": "prefix_scan",
                          "torch": "mont_mul"}[algorithm]
                for name in (needed, "msm_fold", "mont_mul", "mont_square"):
                    if any(r[j]["launches"][name] <= 0 for r in ranks):
                        fail(f"path_sharded_msm {label}: a rank never "
                             f"launched {name}")
                runs.append({
                    "world": world, "backend": backend, "device": dev,
                    "algorithm": algorithm, "points": n,
                    "points_a_rank": [r[j]["points"] for r in ranks],
                    "wall_ms": [r[j]["wall_ms"] for r in ranks],
                    "stages_ms": [r[j]["stages_ms"] for r in ranks],
                    "launches": [r[j]["launches"] for r in ranks],
                    "equal_on_every_rank": True, "oracle_equal": True,
                    **({"path_msm_equal": True} if n == N_MSM else {})})
    emit({"path_sharded_msm": {
        "runs": runs, "spawns": spawns,
        "one_card": torch.cuda.device_count() == 1,
        "note": "the gloo ranks share one card in turns: right in every "
                "rank, not a measure of scaling"}})
    return counts


def phase_roofline(device) -> tuple[dict, dict]:
    """The int32 probes at the reference's shapes: dependent int32 chains
    (add, mul, mixed) of PROBE_CHAIN operations on PROBE_SHAPE elements, and
    FQ_CHAIN dependent Fq multiplications a lane at FQ_CHAIN_LANES.  Returns
    the launch counts and the rates."""
    from jubjub_tpu_torch import ops
    from jubjub_tpu_torch.fields.element import FQ_SPEC
    from jubjub_tpu_torch.ops.roofline import (int_chain, mont_mul_chain,
                                               ops_per_element)
    rng = np.random.default_rng(SEED + 80)
    a = torch.from_numpy(
        rng.integers(1, 1 << 15, PROBE_SHAPE, dtype=np.int32)).to(device)
    b = torch.from_numpy(
        rng.integers(1, 1 << 15, PROBE_SHAPE, dtype=np.int32)).to(device)
    planes = {lanes: (lazy_plane(FQ_SPEC, lanes, SEED + 81, 2, device),
                      lazy_plane(FQ_SPEC, lanes, SEED + 82, 2, device))
              for lanes in FQ_CHAIN_LANES}
    ops.reset_launch_counts()
    out = {"int32_ops_per_s": {}, "int32_ms": {}}
    for op in ("add", "mul", "mixed"):
        ms = time_ms(lambda: int_chain(a, b, PROBE_CHAIN, op), 20)
        out["int32_ms"][op] = ms
        out["int32_ops_per_s"][op] = (
            a.numel() * ops_per_element(PROBE_CHAIN, op) / (ms / 1e3))
    out["fq_mul_per_s"], out["fq_mul_ms"] = {}, {}
    for lanes, (x, y) in planes.items():
        ms = time_ms(lambda: mont_mul_chain(x, y, FQ_CHAIN), 20)
        out["fq_mul_ms"][str(lanes)] = ms
        out["fq_mul_per_s"][str(lanes)] = lanes * FQ_CHAIN / (ms / 1e3)
    counts = ops.launch_counts()
    best = max(out["fq_mul_per_s"].values())
    out["fq_mul_int32_macs_per_s"] = best * macs_mul(FQ_SPEC)
    out["shape"], out["chain"] = list(PROBE_SHAPE), PROBE_CHAIN
    out["fq_mul_chain"] = FQ_CHAIN
    out["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return counts, out


def sweep(device):
    """Times of ``mont_mul`` at several block sizes; of the fixed-base
    kernel (N lanes, signed) and the scan (the Pippenger path's input) at
    several block sizes and ring depths; of the window-sums kernel at 2^20
    points at several (points a chunk, blocks an SM); of both ladders at
    several batch sizes and lanes a block (``sweep_ladder``).  A shape the
    card refuses (too much shared memory) is recorded as refused."""
    from jubjub_tpu_torch import config, oracle
    from jubjub_tpu_torch.curve.scalar_mul import (
        full_generator_table, generator_table, signed_window_digits,
        signed_window_digits_wide, window_digits)
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.fields.element import FQ_SPEC
    from jubjub_tpu_torch.native import ints_to_limbs
    from jubjub_tpu_torch.ops import fixed_base as fb_ops
    from jubjub_tpu_torch.ops import msm as msm_ops
    from jubjub_tpu_torch.ops import scan as scan_ops
    from jubjub_tpu_torch.ops.fixed_base import fixed_base
    from jubjub_tpu_torch.ops.mont import mont_mul

    def timed(fn, reps):
        try:
            return time_ms(fn, reps)
        except RuntimeError as e:  # a launch the card refused
            return f"refused: {e}"

    k = Fr.from_canonical(ints_to_limbs(seeded_scalars(N, SEED + 5, oracle.R)),
                          device=device)
    table = generator_table().device_table(8, True, device)
    sdig = signed_window_digits_wide(k, 8).contiguous()
    p = full_generator_table().mul_fused(k)
    planes = [getattr(p, c).limbs.contiguous()
              for c in ("u", "v", "z", "t1", "t2")]
    out = {}
    keep = config.MONT_THREADS
    try:
        for threads in (32, 64, 128, 256):
            config.MONT_THREADS = threads
            out[str(threads)] = {"mont_mul_ms": time_ms(
                lambda: mont_mul(FQ_SPEC, planes[0], planes[1]), 20)}
    finally:
        config.MONT_THREADS = keep

    # the fixed-base kernel (signed, N lanes) and the scan (the Pippenger
    # path's input) at each block size and ring depth, in interleaved rounds
    fb_out, scan_out = {}, {}
    niels = pippenger_niels(device)
    scan_shape = list(niels.shape)
    keep = (config.FIXED_BASE_THREADS, fb_ops.STAGES, scan_ops.THREADS,
            scan_ops.STAGES)
    try:
        for _, threads, stages in itertools.product(
                range(2), (64, 128, 256), (1, 2, 3, 4)):
            key = f"{threads} threads, {stages} stages"
            if stages <= 3:
                config.FIXED_BASE_THREADS, fb_ops.STAGES = threads, stages
                fb_out.setdefault(key, []).append(
                    timed(lambda: fixed_base(table, sdig, True), 5))
            scan_ops.THREADS, scan_ops.STAGES = threads, stages
            scan_out.setdefault(key, []).append(
                timed(lambda: scan_ops.prefix_scan(niels), 3))
    finally:
        (config.FIXED_BASE_THREADS, fb_ops.STAGES, scan_ops.THREADS,
         scan_ops.STAGES) = keep
    del niels

    mplanes, mdig = msm_inputs(N_MSM, SEED + 9, 5, True, device)
    msm_out = {}
    keep = (msm_ops.CHUNK, msm_ops.BLOCKS_PER_SM)
    try:
        for chunk, per_sm in ((16, 2), (24, 2), (32, 2), (32, 1), (48, 1),
                              (64, 1), (96, 1)):
            msm_ops.CHUNK, msm_ops.BLOCKS_PER_SM = chunk, per_sm
            blocks = msm_ops.n_blocks(N_MSM, device)
            msm_out[f"chunk {chunk}, {per_sm} blocks an SM"] = timed(
                lambda: msm_ops.msm_window_sums(mplanes, mdig, 5, True,
                                                blocks), 2)
    finally:
        msm_ops.CHUNK, msm_ops.BLOCKS_PER_SM = keep
    del mplanes, mdig

    emit({"sweep": {"lanes": N, "threads_per_block": out,
                    "fixed_base_signed_ms": fb_out,
                    "prefix_scan_ms": scan_out,
                    "prefix_scan_shape": scan_shape,
                    "msm_points": N_MSM, "msm_window_sums_ms": msm_out,
                    "ladder_ms": sweep_ladder(planes, k, 2)}})


LADDER_SWEEP_LANES = (SPINE_LANES[1], SPINE_LANES[0], RAGGED, 8448, N)


def sweep_ladder(planes, k, rounds: int) -> dict:
    """Times of both ladders at each batch size of ``LADDER_SWEEP_LANES``
    (the first ``n`` lanes of ``planes`` and ``k``) at 32 to 256 lanes a
    block and at the package's own choice (``lanes_per_block``), over
    ``rounds`` interleaved rounds: {lanes: {shape: [ms of each round]}}."""
    from jubjub_tpu_torch.curve.scalar_mul import (signed_window_digits,
                                                   window_digits)
    from jubjub_tpu_torch.ops import ladder as lad

    digs = {False: window_digits(k).contiguous(),
            True: signed_window_digits(k).contiguous()}
    own = lad.lanes_per_block
    out = {}
    try:
        for n in LADDER_SWEEP_LANES:
            pl = [x[:, :n].contiguous() for x in planes]
            dg = {sg: d[:, :n].contiguous() for sg, d in digs.items()}
            row = out[str(n)] = {}
            for _, lanes, signed in itertools.product(
                    range(rounds), (32, 64, 128, 256, None), (False, True)):
                lad.lanes_per_block = own if lanes is None else (
                    lambda lanes: lambda n, sms: lanes)(lanes)
                fn = lad.ladder_signed if signed else lad.ladder
                key = (f"{'own choice' if lanes is None else lanes} lanes a "
                       f"block, {'signed' if signed else 'unsigned'}")
                row.setdefault(key, []).append(
                    time_ms(lambda: fn(pl, dg[signed]), 3))
    finally:
        lad.lanes_per_block = own
    return out


# The package's own outline boundary of each source (its #define lines,
# which stand just before the include given beside them) and the others
# ``--boundaries`` builds in their place.
_GROUP, _MUL = "#define JJ_OUTLINE_GROUP\n", "#define JJ_OUTLINE_MUL\n"
OWN_BOUNDARY = {"msm": (_MUL, '#include "packed.cuh"\n'),
                "ladder": (_GROUP + _MUL, '#include "packed.cuh"\n'),
                "scan": ("", '#include "point.cuh"\n'),
                "fixed_base": ("", '#include "point.cuh"\n')}
_CALLED_ADD = """#ifdef __CUDACC__
__host__ __device__ __noinline__
#else
inline
#endif
void msm_add_one(Ext& acc, ScannedNiels<int, SharedTable>& o) {
  pt_add_scanned(acc, o);
}

"""
_ALL_BOUNDARIES = {"nothing outlined": "", "products called": _MUL,
                   "group operations called, products inlined": _GROUP,
                   "group operations and products called": _GROUP + _MUL}
# Text changes a variant may make beside its boundary: (old, new) pairs.
_CHANGES = {
    "add": (("    pt_add_scanned(acc, o);", "    msm_add_one(acc, o);"),
            ("// 3. acc +=", _CALLED_ADD + "// 3. acc +=")),
    # the completion's three products unrolled: the step loop's code grows
    # past the instruction cache
    "unrolled": (("  hwcd_finish_rolled(s, a, b, c, d);",
                  "  hwcd_finish(s, a, b, c, d);"),),
    "no barrier": (("    block_sync();\n", ""),),
}
BOUNDARIES = {
    "msm": {
        "group operations called, products inlined": (_GROUP, None),
        "group operations and the window addition called, products inlined":
            (_GROUP, "add"),
        "group operations and products called": (_GROUP + _MUL, None),
        "nothing outlined": ("", None)},
    "ladder": {
        "group operations called, products inlined": (_GROUP, None),
        "products called": (_MUL, None),
        "nothing outlined": ("", None)},
    **{src: {label: (defines, None)
             for label, defines in _ALL_BOUNDARIES.items()
             if defines != OWN_BOUNDARY[src][0]
             # nvcc 12.9 builds scan.cu with both outlined into a kernel
             # whose limbs are wrong on the card (ROADMAP, queue C)
             and not (src == "scan" and defines == _GROUP + _MUL)}
       for src in ("scan", "fixed_base")},
}
BOUNDARIES["scan"].update({
    "nothing outlined, completion unrolled": ("", "unrolled"),
    "nothing outlined, no barrier a step": ("", "no barrier"),
    # the same at cicc's default stack of 8 MB (ops/_build.py)
    "nothing outlined, completion unrolled, 8 MB stack": ("", "unrolled")})


def _default_stack() -> None:
    """``preexec_fn`` of a build at the usual default stack of 8 MB."""
    import resource
    _, hard = resource.getrlimit(resource.RLIMIT_STACK)
    resource.setrlimit(resource.RLIMIT_STACK, (8 << 20, hard))


def _sass(so: str) -> dict:
    """{function label: [its SASS lines]} of a built library
    (``cuobjdump -sass``)."""
    import re
    from jubjub_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _build.kernel_label(m.group(1))
            out.setdefault(name, [])
        elif name:
            out[name].append(line)
    return out


def _loops(lines) -> list[tuple[int, int]]:
    """(first, last) instruction addresses of every loop of a function: the
    span of each backward branch."""
    import re
    spans = []
    for line in lines:
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA 0x([0-9a-f]+)",
                      line)
        if m and int(m.group(2), 16) <= int(m.group(1), 16):
            spans.append((int(m.group(2), 16), int(m.group(1), 16)))
    return spans


def loop_instructions(so: str) -> dict:
    """{kernel: instructions of its largest loop} of a built library, from
    its SASS: the longest backward branch."""
    return {name: max((b - a) // 16 for a, b in spans)
            for name, spans in ((k, _loops(v)) for k, v in _sass(so).items())
            if spans}


# Kernels whose selects scan a table by a secret digit (the ladders, the
# window sums, the fixed base).  None of their loads inside a loop is
# predicated: lanes past the batch's end load the last lane's digits.
SCAN_KERNELS = ("ladder_kernel", "ladder_affine_kernel",
                "msm_window_sums_kernel", "fixed_base_kernel")


def sass_loads(so: str) -> dict:
    """{function: {"LDG": [loads, predicated], "LDS": [...], "LD": [...],
    "predicated_in_loops": [their SASS lines]}} of a built library.  A load
    behind a predicate (``@P0 LDG``) is executed only by the lanes whose
    predicate holds: a masked scan whose loads the compiler predicates on
    the select reads only the selected entry."""
    import re
    out = {}
    for name, lines in _sass(so).items():
        spans = _loops(lines)
        entry = {"predicated_in_loops": []}
        for line in lines:
            # @!PT (never true) marks a placeholder that never executes
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-6]\s+)?(LDG|LDS|LD)\b",
                          line)
            if not m:
                continue
            c = entry.setdefault(m.group(3), [0, 0])
            c[0] += 1
            if m.group(2) is not None:
                c[1] += 1
                addr = int(m.group(1), 16)
                if any(a <= addr <= b for a, b in spans):
                    entry["predicated_in_loops"].append(" ".join(line.split()))
        if len(entry) > 1 or entry["predicated_in_loops"]:
            out[name] = entry
    return out


def check_scan_loads(loads: dict) -> None:
    """Fails if a scan kernel holds a predicated load inside a loop."""
    for name, entry in loads.items():
        if name.startswith(SCAN_KERNELS) and entry["predicated_in_loops"]:
            fail(f"build: {name} holds predicated loads in a loop, which a "
                 f"digit may decide: {entry['predicated_in_loops'][:8]}")


def _patched(text: str, old: str, new: str, src: str) -> str:
    """``text`` with its one occurrence of ``old`` replaced by ``new``; fails
    unless ``old`` occurs exactly once and the replacement changes the text,
    so that a variant is never the package's own source under another
    label."""
    if text.count(old) != 1:
        fail(f"boundaries: {src}.cu holds {text.count(old)} of {old!r}")
    if old == new:
        fail(f"boundaries: replacing {old!r} in {src}.cu changes nothing")
    return text.replace(old, new)


def boundaries(device):
    """Builds msm.cu, ladder.cu, scan.cu and fixed_base.cu with other
    outline boundaries than their own (``BOUNDARIES``) into a directory of
    their own, reports what nvcc says of each (registers, stack and spill
    bytes, or its exit code), and times each build that succeeds against the
    package's own build at the main paths' shapes: the window sums at 2^20
    points, signed 5-bit; both ladders at N lanes and at 51 lanes; the scan
    on the Pippenger path's input; the fixed base at N lanes, signed.  Each
    result must equal the package's kernel's, and each variant must differ
    from the package's source where it says it does."""
    import ctypes
    from jubjub_tpu_torch import config, oracle
    from jubjub_tpu_torch.curve.scalar_mul import (
        full_generator_table, generator_table, signed_window_digits,
        signed_window_digits_wide, window_digits)
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.device import sm_count
    from jubjub_tpu_torch.ops import _build
    from jubjub_tpu_torch.ops import fixed_base as fb_ops
    from jubjub_tpu_torch.ops import ladder as lad
    from jubjub_tpu_torch.ops import msm as msm_ops
    from jubjub_tpu_torch.ops import scan as scan_ops

    out_dir = os.path.join(_build.ensure_built(), "boundaries")
    _build._write_constants(out_dir)
    procs = {}
    for src, variants in BOUNDARIES.items():
        with open(os.path.join(_build.CSRC, f"{src}.cu")) as fh:
            text = fh.read()
        for i, (label, (defines, change)) in enumerate(variants.items()):
            own_defines, anchor = OWN_BOUNDARY[src]
            body = text
            if defines != own_defines:
                body = _patched(body, own_defines + anchor, defines + anchor,
                                src)
            for old, new in _CHANGES.get(change, ()):
                body = _patched(body, old, new, src)
            if body == text:
                fail(f"boundaries: {src}.cu variant {label!r} is the "
                     "package's own source")
            path = os.path.join(out_dir, f"{src}_{i}.cu")
            with open(path, "w") as fh:
                fh.write(body)
            so = os.path.join(out_dir, f"lib{src}_{i}.so")
            log = open(os.path.join(out_dir, f"{src}_{i}.log"), "w")
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", out_dir,
                   "-I", _build.CSRC, "-o", so, path]
            cmd[1:1] = _build.phase_flags()  # the package's phase
            stack = (_default_stack if "8 MB stack" in label
                     else _build.nvcc_stack_limit)
            procs[(src, label)] = (so, log, subprocess.Popen(
                ["timeout", "420", *cmd], stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=stack))
    report, libs = {}, {}
    for (src, label), (so, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        with open(log.name) as fh:
            fns = _build.parse_ptxas(fh.read())
        report[f"{src}: {label}"] = {"nvcc_exit": rc, "kernels": {
            _build.kernel_label(k): v for k, v in fns.items() if v["entry"]}}
        if rc == 0:
            libs[(src, label)] = _build._bind(ctypes.CDLL(so), src)
            report[f"{src}: {label}"]["loop_instructions"] = \
                loop_instructions(so)
    own_loops = {src: loop_instructions(os.path.join(
        _build.ensure_built(), f"libjj_{src}.so")) for src in BOUNDARIES}

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    planes, digits = msm_inputs(N_MSM, SEED + 9, 5, True, device)
    blocks = msm_ops.n_blocks(N_MSM, device)
    want = msm_ops.msm_window_sums(planes, digits, 5, True, blocks)
    own = {"msm": time_ms(lambda: msm_ops.msm_window_sums(
        planes, digits, 5, True, blocks), 2)}
    for (src, label), lib in libs.items():
        if src != "msm":
            continue
        got = torch.empty_like(want)

        def run_msm():
            _build.check(lib.jj_msm_window_sums(
                *[x.data_ptr() for x in planes], digits.data_ptr(), 51, N_MSM,
                1, msm_ops.n_entries(5, True), got.data_ptr(), blocks,
                msm_ops.CHUNK, stream()), label)
        report[f"msm: {label}"]["ms"] = time_ms(run_msm, 2)
        report[f"msm: {label}"]["equal"] = bool(torch.equal(got, want))
    del planes, digits, want

    k = Fr.from_int(seeded_scalars(N, SEED + 5, oracle.R), device=device)
    p = full_generator_table().mul_fused(
        Fr.from_int([i % 97 + 1 for i in range(N)], device=device))
    big = [getattr(p, c).limbs.contiguous()
           for c in ("u", "v", "z", "t1", "t2")]
    digs = {False: window_digits(k).contiguous(),
            True: signed_window_digits(k).contiguous()}
    spine = SPINE_LANES[0]
    shapes = {"N": (big, digs), "spine": (
        [x[:, :spine].contiguous() for x in big],
        {sg: d[:, :spine].contiguous() for sg, d in digs.items()})}
    for signed in (False, True):
        wrap = lad.ladder_signed if signed else lad.ladder
        name = "ladder_signed" if signed else "ladder"
        for shape, (pl, dg) in shapes.items():
            want = torch.stack(wrap(pl, dg[signed]))
            own[f"{name} {shape}"] = time_ms(lambda: wrap(pl, dg[signed]), 3)
            n = dg[signed].shape[1]
            entries = lad.SIGNED_TABLE_ENTRIES if signed else lad.TABLE_ENTRIES
            scratch = torch.empty((entries, lad.PACKED_WORDS, n),
                                  dtype=torch.int32, device=device)
            lanes = lad.lanes_per_block(n, sm_count(device))
            for (src, label), lib in libs.items():
                if src != "ladder":
                    continue
                got = torch.empty_like(want)
                fn = getattr(lib, "jj_ladder_signed" if signed else "jj_ladder")

                def run_ladder():
                    _build.check(fn(
                        *[x.data_ptr() for x in pl], dg[signed].data_ptr(), 63,
                        scratch.data_ptr(),
                        *[got[c].data_ptr() for c in range(5)], n, lanes,
                        stream()), label)
                entry = report[f"ladder: {label}"]
                entry[f"{name} {shape} ms"] = time_ms(run_ladder, 3)
                entry[f"{name} {shape} equal"] = bool(torch.equal(got, want))
    del big, digs, shapes, p

    # the fixed base at N lanes, signed 8-bit; the scan on the Pippenger
    # path's input; each at the wrapper's block size and ring depth
    table = generator_table().device_table(8, True, device)
    sdig = signed_window_digits_wide(k, 8).contiguous()
    want = torch.stack(fb_ops.fixed_base(table, sdig, True))
    own["fixed_base"] = time_ms(lambda: fb_ops.fixed_base(table, sdig, True), 5)
    for (src, label), lib in libs.items():
        if src != "fixed_base":
            continue
        got = torch.empty_like(want)

        def run_fixed_base():
            _build.check(lib.jj_fixed_base(
                1, sdig.data_ptr(), table.data_ptr(), table.shape[0],
                table.shape[3], *[got[c].data_ptr() for c in range(5)], N,
                config.FIXED_BASE_THREADS, fb_ops.STAGES, stream()), label)
        report[f"fixed_base: {label}"]["ms"] = time_ms(run_fixed_base, 5)
        report[f"fixed_base: {label}"]["equal"] = bool(torch.equal(got, want))
    niels = pippenger_niels(device)
    scan_shape = list(niels.shape)
    want = scan_ops.prefix_scan(niels)
    own["prefix_scan"] = time_ms(lambda: scan_ops.prefix_scan(niels), 3)
    for (src, label), lib in libs.items():
        if src != "scan":
            continue
        got = torch.empty_like(want)

        def run_scan():
            _build.check(lib.jj_prefix_scan(
                niels.data_ptr(), got.data_ptr(), *niels.shape[2:],
                scan_ops.THREADS, scan_ops.STAGES, stream()), label)
        report[f"scan: {label}"]["ms"] = time_ms(run_scan, 3)
        report[f"scan: {label}"]["equal"] = bool(torch.equal(got, want))
        del got
    del niels, want
    emit({"boundaries": {"own_ms": own, "own_loop_instructions": own_loops,
                         "variants": report,
                         "msm_points": N_MSM, "ladder_lanes": [N, spine],
                         "fixed_base_lanes": N,
                         "scan_shape": scan_shape}})
    for name, entry in report.items():
        if any(v is False for key, v in entry.items() if "equal" in key):
            fail(f"boundaries: {name} differs from the package's kernel")


# -- phase: the other product phase, the matmul-form reduction, the codec -----

PHASES = {False: "schoolbook", True: "karatsuba"}
# the sources every run builds in the other product phase, and those
# --karatsuba adds
OTHER_PHASE_SOURCES = ("mont", "roofline")
OTHER_PHASE_FULL = ("fixed_base", "ladder", "msm", "scan")


def start_other_phase(sources):
    """Starts building ``sources`` in the product phase the package does not
    give them (one ``nvcc`` a source, all at once, beside the package's own
    build) into ``<build>/other_phase/<phase>``, or reuses that build where
    it already holds them.  Returns a callable that waits and gives
    {source: {"dir", "karatsuba", "info"}}; a build that fails fails the
    run there."""
    from jubjub_tpu_torch import config
    from jubjub_tpu_torch.ops import _build
    kar = not config.kernels_karatsuba()
    out_dir = os.path.join(_build.BUILD_ROOT, _build.source_key(),
                           "other_phase", PHASES[kar])
    info_path = os.path.join(out_dir, "build_info.json")

    def result(info: dict) -> dict:
        return {src: {"dir": out_dir, "karatsuba": kar, "info": info}
                for src in sources}
    if os.path.exists(info_path) and all(os.path.exists(os.path.join(
            out_dir, f"libjj_{src}.so")) for src in sources):
        with open(info_path) as fh:
            info = dict(json.load(fh), cached=True)
        return lambda: result(info)
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(_build._build_all, out_dir, tuple(sources), kar)
    pool.shutdown(wait=False)

    def finish() -> dict:
        try:
            return result(dict(future.result(), cached=False))
        except RuntimeError as e:
            fail(f"other product phase ({PHASES[kar]}): {e}")
    return finish


@contextlib.contextmanager
def libraries_from(dirs: dict):
    """Scope in which the wrappers load source ``s``'s library from
    ``dirs[s]`` (another build) instead of the package's own build."""
    from jubjub_tpu_torch.ops import _build
    own = _build.library
    _build.library = lambda name, out_dir=None: own(name,
                                                    dirs.get(name, out_dir))
    try:
        yield
    finally:
        _build.library = own


def build_report(src: str, out_dir: str, info: dict) -> dict:
    """Registers, stack and spill bytes of every kernel of ``src``'s library
    in ``out_dir``, its largest loops and its loads (``sass_loads``)."""
    from jubjub_tpu_torch.ops import _build
    so = os.path.join(out_dir, f"libjj_{src}.so")
    kernels = {_build.kernel_label(k): v for k, v in info["kernels"].items()
               if _build.kernel_label(k) in _sass(so)}
    return {"kernels": kernels, "loop_instructions": loop_instructions(so),
            "loads": sass_loads(so),
            "seconds": info["sources"][f"{src}.cu"]["seconds"]}


def in_turns(own, other, own_karatsuba: bool, kname: str, reps: int) -> dict:
    """``device_ms`` of the package's build (``own``, in the phase
    ``own_karatsuba``) and of the other phase's, in turns (own, other,
    other, own): {"<phase>_device_ms": mean, "<phase>_device_ms_runs":
    [..], "<phase>_sources": [..]}.  The mean is over the turns the
    profiler recorded, where there are any: a turn timed by CUDA events
    around single launches adds the wrapper's host time (some 0.1 ms, ten
    times a short kernel's), so a turn the profiler lost is taken again,
    up to three times."""
    tags = {own: PHASES[own_karatsuba], other: PHASES[not own_karatsuba]}
    got: dict = {tag: [] for tag in tags.values()}
    for fn in (own, other, other, own):
        for _ in range(3):
            prof = device_ms(fn, reps, kname)
            if prof["source"] == "profiler":
                break
        got[tags[fn]].append((prof["device_ms"], prof["source"]))
    out = {}
    for tag, runs in got.items():
        best = [ms for ms, src in runs if src == "profiler"] or [
            ms for ms, _ in runs]
        out.update({f"{tag}_device_ms": sum(best) / len(best),
                    f"{tag}_device_ms_runs": [ms for ms, _ in runs],
                    f"{tag}_sources": [src for _, src in runs]})
    return out


def check_other_phase_mont(device, other: dict) -> dict:
    """``mont_mul``, ``mont_square`` and ``mont_mul_chain`` of the other
    product phase against their plain versions, limb for limb, at the main
    shapes (N lanes, Fq and Fr, canonical and lazy; 64 dependent Fq
    products at 65536 lanes), and both phases' device times."""
    from jubjub_tpu_torch.fields.element import FQ_SPEC, FR_SPEC
    from jubjub_tpu_torch.ops.mont import (mont_mul, mont_mul_plain,
                                           mont_square, mont_square_plain)
    from jubjub_tpu_torch.ops.roofline import (mont_mul_chain,
                                               mont_mul_chain_plain)
    dirs = {src: other[src]["dir"] for src in OTHER_PHASE_SOURCES}
    cases = []

    def hold(kernel, src, variant, lanes, fn, plain_fn, kname, timed):
        kar = other[src]["karatsuba"]
        want = plain_fn()
        with libraries_from(dirs):
            got = fn()
        err = check_equal(f"karatsuba: {kernel} {variant} ({PHASES[kar]} "
                          "build)", [got], [want])
        case = {"kernel": kernel, "variant": variant, "lanes": lanes,
                "phase": PHASES[kar], "equal": True, "max_abs_err": err}
        if timed:

            def other_fn():
                with libraries_from(dirs):
                    return fn()
            case.update(in_turns(fn, other_fn, not kar, kname, 20))
        cases.append(case)

    for F in (FQ_SPEC, FR_SPEC):
        for kind, ta, tb in (("canonical", 1, 1), ("lazy", 5, 6)):
            a = lazy_plane(F, N, SEED + 91, ta, device)
            b = lazy_plane(F, N, SEED + 92, tb, device)
            timed = F is FQ_SPEC and kind == "canonical"
            hold("mont_mul", "mont", f"{F.name} {kind}", N,
                 lambda: mont_mul(F, a, b), lambda: mont_mul_plain(F, a, b),
                 "mont_mul_kernel", timed)
            hold("mont_square", "mont", f"{F.name} {kind}", N,
                 lambda: mont_square(F, a), lambda: mont_square_plain(F, a),
                 "mont_square_kernel", timed)
    lanes = FQ_CHAIN_LANES[0]
    a = lazy_plane(FQ_SPEC, lanes, SEED + 93, 2, device)
    b = lazy_plane(FQ_SPEC, lanes, SEED + 94, 2, device)
    hold("mont_mul_chain", "roofline", f"Fq x {FQ_CHAIN}", lanes,
         lambda: mont_mul_chain(a, b, FQ_CHAIN),
         lambda: mont_mul_chain_plain(a, b, FQ_CHAIN),
         "mont_mul_chain_kernel", True)
    return {"package_phase": {s: PHASES[not other[s]["karatsuba"]]
                              for s in OTHER_PHASE_SOURCES},
            "other_phase_builds": {s: build_report(s, other[s]["dir"],
                                                   other[s]["info"])
                                   for s in OTHER_PHASE_SOURCES},
            "cases": cases}


def check_other_phase_sources(device, other: dict) -> dict:
    """The other product phase of the ladders, the window sums, the fixed
    base and the scan, each held limb for limb against the package's build
    at the main shapes (the three ladders at N lanes, the window sums at
    2^20 points with signed 5-bit windows, the fixed base signed at N
    lanes, the scan on the Pippenger input), with both phases' device
    times, registers, stack, spills, largest loop and predicated loads."""
    import jubjub_tpu_torch as jj
    from jubjub_tpu_torch import oracle
    from jubjub_tpu_torch.curve.scalar_mul import (
        _affine_niels_table, full_generator_table, generator_table,
        signed_window_digits, signed_window_digits_wide, window_digits)
    from jubjub_tpu_torch.fields import Fr
    from jubjub_tpu_torch.ops import _build
    from jubjub_tpu_torch.ops.fixed_base import fixed_base
    from jubjub_tpu_torch.ops.ladder import ladder, ladder_affine, ladder_signed
    from jubjub_tpu_torch.ops.msm import msm_window_sums, n_blocks
    from jubjub_tpu_torch.ops.scan import prefix_scan
    dirs = {src: other[src]["dir"] for src in OTHER_PHASE_FULL}
    cases = []

    def hold(kernel, src, fn, kname, reps):
        kar = other[src]["karatsuba"]
        want = fn()
        with libraries_from(dirs):
            got = fn()
        err = check_equal(f"karatsuba: {kernel} ({PHASES[kar]} build)",
                          list(got) if isinstance(got, tuple) else [got],
                          list(want) if isinstance(want, tuple) else [want])
        del got, want

        def other_fn():
            with libraries_from(dirs):
                return fn()
        cases.append({"kernel": kernel, "source": src, "phase": PHASES[kar],
                      "equal": True, "max_abs_err": err,
                      **in_turns(fn, other_fn, not kar, kname, reps)})

    k = Fr.from_int(seeded_scalars(N, SEED + 95, oracle.R), device=device)
    m = Fr.from_int([i % 97 + 1 for i in range(N)], device=device)
    p = full_generator_table().mul_fused(m)
    planes = [getattr(p, c).limbs.contiguous()
              for c in ("u", "v", "z", "t1", "t2")]
    udig = window_digits(k).contiguous()
    sdig = signed_window_digits(k).contiguous()
    hold("ladder", "ladder", lambda: ladder(planes, udig),
         "ladder_kernel<false>", 2)
    hold("ladder_signed", "ladder", lambda: ladder_signed(planes, sdig),
         "ladder_kernel<true>", 2)
    table = _affine_niels_table(jj.batch_normalize(p))
    tplanes = [getattr(table, c).limbs.contiguous()
               for c in ("v_plus_u", "v_minus_u", "t2d")]
    hold("ladder_affine", "ladder", lambda: ladder_affine(tplanes, udig),
         "ladder_affine_kernel", 2)
    del planes, table, tplanes, p
    fb_table = generator_table().device_table(8, True, device)
    wdig = signed_window_digits_wide(k, 8).contiguous()
    hold("fixed_base", "fixed_base", lambda: fixed_base(fb_table, wdig, True),
         "fixed_base_kernel", 5)
    mplanes, mdig = msm_inputs(N_MSM, SEED + 9, 5, True, device)
    blocks = n_blocks(N_MSM, device)
    hold("msm_window_sums", "msm",
         lambda: msm_window_sums(mplanes, mdig, 5, True, blocks),
         "msm_window_sums_kernel", 2)
    del mplanes, mdig
    niels = pippenger_niels(device)
    hold("prefix_scan", "scan", lambda: prefix_scan(niels),
         "prefix_scan_kernel", 3)
    del niels
    built = _build.ensure_built()
    builds = {}
    for src in OTHER_PHASE_FULL:
        own = PHASES[not other[src]["karatsuba"]]
        builds[src] = {
            own: build_report(src, built, _build.build_info()),
            PHASES[other[src]["karatsuba"]]: build_report(
                src, other[src]["dir"], other[src]["info"])}
    return {"package_phase": {s: PHASES[not other[s]["karatsuba"]]
                              for s in OTHER_PHASE_FULL},
            "builds": builds, "cases": cases}


def check_mxu_reduce(device) -> dict:
    """``mul`` and ``square`` inside ``use_mxu_reduce`` (columns in PyTorch,
    the matmul-form reduction through ``torch._int_mm``) against the
    ``mont_mul`` / ``mont_square`` kernels, limb for limb, at N lanes, Fq
    and Fr, canonical and lazy operands; times of both at the canonical
    ones (CUDA events around 5 / 20 calls)."""
    from jubjub_tpu_torch.fields import mont
    from jubjub_tpu_torch.fields.element import FQ_SPEC, FR_SPEC
    from jubjub_tpu_torch.ops.mont import mont_mul, mont_square
    cases = []
    for F in (FQ_SPEC, FR_SPEC):
        for kind, ta, tb in (("canonical", 1, 1), ("lazy", 2, 2)):
            a = lazy_plane(F, N, SEED + 96, ta, device)
            b = lazy_plane(F, N, SEED + 97, tb, device)

            def scoped_mul():
                with mont.use_mxu_reduce(F):
                    return mont.mul(F, a, b)

            def scoped_square():
                with mont.use_mxu_reduce(F):
                    return mont.square(F, a)
            for name, fn, kern in (
                    ("mul", scoped_mul, lambda: mont_mul(F, a, b)),
                    ("square", scoped_square, lambda: mont_square(F, a))):
                err = check_equal(f"mxu_reduce: {name} {F.name} {kind}",
                                  [fn()], [kern()])
                case = {"op": name, "field": F.name, "operands": kind,
                        "lanes": N, "equal": True, "max_abs_err": err}
                if kind == "canonical":
                    case.update(mxu_ms=time_ms(fn, 5),
                                kernel_ms=time_ms(kern, 20))
                cases.append(case)
    return {"cases": cases}


def check_codec() -> dict:
    """The host codec's tier after its first use (the C++ one, or the run
    fails), its bytes against the NumPy tier's, and both tiers' times at
    N_MSM elements (host clock)."""
    from jubjub_tpu_torch import native
    native.bytes_to_limbs(bytes(32))  # builds the C++ tier if need be
    if not native.HAVE_NATIVE:
        fail("codec: the C++ tier did not build (native.HAVE_NATIVE false)")
    blob = np.random.default_rng(SEED + 98).integers(
        0, 256, 32 * N_MSM, dtype=np.uint8)
    t0 = time.perf_counter()
    limbs = native.bytes_to_limbs(blob)
    cxx_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = native.bytes_to_limbs_plain(blob)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    seed = bytes(range(16))
    equal = {"bytes_to_limbs": bool(np.array_equal(limbs, want)),
             "limbs_to_bytes": bool(np.array_equal(
                 native.limbs_to_bytes(limbs),
                 native.limbs_to_bytes_plain(limbs))),
             "xorshift_bytes": native.xorshift_bytes(seed, 4099)
             == native.xorshift_bytes_plain(seed, 4099)}
    if not all(equal.values()):
        fail(f"codec: the C++ tier differs from the NumPy tier: {equal}")
    return {"tier": "c++", "equal": equal, "elements": N_MSM,
            "bytes_to_limbs_ms": {"c++": cxx_ms, "numpy": numpy_ms}}


# -- main ---------------------------------------------------------------------

REPLACES = {
    "mont_mul": ("jubjub_tpu_torch/ops/csrc/mont.cu",
                 "jubjub_tpu/ops/pallas_mont.py:68"),
    "mont_square": ("jubjub_tpu_torch/ops/csrc/mont.cu",
                    "jubjub_tpu/ops/pallas_mont.py:92"),
    "fixed_base": ("jubjub_tpu_torch/ops/csrc/fixed_base.cu",
                   "jubjub_tpu/ops/pallas_fixed_base.py:37"),
    "ladder": ("jubjub_tpu_torch/ops/csrc/ladder.cu",
               "jubjub_tpu/ops/pallas_ladder.py:38"),
    "msm_window_sums": ("jubjub_tpu_torch/ops/csrc/msm.cu",
                        "jubjub_tpu/ops/pallas_msm.py:62"),
    "ladder_signed": ("jubjub_tpu_torch/ops/csrc/ladder.cu",
                      "jubjub_tpu/ops/pallas_ladder.py:102"),
    "prefix_scan": ("jubjub_tpu_torch/ops/csrc/scan.cu",
                    "jubjub_tpu/ops/pallas_scan.py:43"),
    "int_chain": ("jubjub_tpu_torch/ops/csrc/roofline.cu",
                  "benches/roofline.py:46"),
    "mont_mul_chain": ("jubjub_tpu_torch/ops/csrc/roofline.cu",
                       "benches/roofline.py:125"),
    "ladder_affine": ("jubjub_tpu_torch/ops/csrc/ladder.cu",
                      "jubjub_tpu/curve/scalar_mul.py:279 mul_affine (XLA; "
                      "no Pallas kernel)"),
    "fq_sqrt": ("jubjub_tpu_torch/ops/csrc/sqrt.cu",
                "jubjub_tpu/fields/sqrt.py:48 _sqrt_tonelli_shanks (XLA; "
                "no Pallas kernel)"),
    "msm_reduce": ("jubjub_tpu_torch/ops/csrc/msm_tail.cu",
                   "jubjub_tpu/ops/pallas_msm.py:318 reduce_sum (XLA; no "
                   "Pallas kernel)"),
    "msm_fold": ("jubjub_tpu_torch/ops/csrc/msm_tail.cu",
                 "jubjub_tpu/parallel/msm.py:110 horner_spine (XLA; no "
                 "Pallas kernel)"),
}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on a GPU only",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from jubjub_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    emit({"device": {"nvidia_smi": smi, "torch": torch.__version__,
                     "cuda": torch.version.cuda,
                     "kind": torch.cuda.get_device_name(0)}})

    other_phase = start_other_phase(
        OTHER_PHASE_SOURCES + (OTHER_PHASE_FULL if "--karatsuba" in argv
                               else ()))
    info = _build.build_info()
    built = _build.ensure_built()
    loads, loops = {}, {}
    for src in ("ladder", "msm", "fixed_base"):
        so = os.path.join(built, f"libjj_{src}.so")
        loads.update(sass_loads(so))
        loops[src] = loop_instructions(so)
    emit({"build": {"seconds": info["seconds"], "cached": info["cached"],
                    "sources": info["sources"],
                    "kernels": {_build.kernel_label(k): v
                                for k, v in info["kernels"].items()},
                    "ladder_loop_instructions": loops["ladder"],
                    "loop_instructions": {k: v for d in loops.values()
                                          for k, v in d.items()},
                    "loads": loads}})
    check_scan_loads(loads)
    emit({"codec": check_codec()})
    other = other_phase()

    # the probes first: their int32 rate may raise the peak of every bound
    total = {name: 0 for name in REPLACES}
    counts, rates = phase_roofline(device)
    for name in ("int_chain", "mont_mul_chain"):
        if counts[name] <= 0:
            fail(f"phase roofline: kernel {name} was never launched")
        total[name] += counts[name]
    mul_rate = rates["int32_ops_per_s"]["mul"]
    if mul_rate > PEAK_INT32_MAC_PER_S:
        INT32_PEAK.update(mac_per_s=mul_rate, source="measured")
    emit({"roofline": dict(rates, derived_peak_int32_mac_per_s=
                           PEAK_INT32_MAC_PER_S,
                           measured_mul_over_derived=mul_rate
                           / PEAK_INT32_MAC_PER_S,
                           bound_peak_int32_mac_per_s=INT32_PEAK["mac_per_s"],
                           bound_peak_source=INT32_PEAK["source"],
                           launches=counts)})

    main_cases, side, cases = check_kernels(device)
    emit({"kernel_checks": cases})
    emit({"karatsuba": check_other_phase_mont(device, other)})
    emit({"mxu_reduce": check_mxu_reduce(device)})

    encodings = {}
    for which in ("fixed_base", "ladder", "ladder_signed", "affine_mul"):
        counts, encodings[which] = drive_path(which, device)
        for name, c in counts.items():
            total[name] += c
    for which in ("ladder_signed", "affine_mul"):
        if not torch.equal(encodings["ladder"], encodings[which]):
            fail(f"path_{which}: encodings differ from path_ladder's")
        emit({f"path_{which}_vs_ladder": {"lanes": N, "equal": True}})
    check_multiply_bits(device, encodings["ladder"])
    del encodings
    for drive in (drive_subgroup_path, drive_cofactor_path):
        for name, c in drive(device).items():
            total[name] += c
    msm_bytes = {}
    for which in ("msm", "e2e", "pippenger"):
        counts, msm_bytes[which] = drive_msm_path(which, device)
        for name, c in counts.items():
            total[name] += c
    for name, c in drive_sharded_msm(msm_bytes["msm"]).items():
        total[name] += c

    if "--sweep" in argv:
        sweep(device)
    if "--boundaries" in argv:
        boundaries(device)
    if "--karatsuba" in argv:
        report = check_other_phase_sources(device, other)
        emit({"karatsuba_sources": report})
        for src, phases in report["builds"].items():
            check_scan_loads(phases[PHASES[other[src]["karatsuba"]]]["loads"])

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        c = main_cases[name]
        if total[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None,
            "device_ms": c["device_ms"],
            "device_launches": c["device_launches"],
            "lanes": c["lanes"], "variant": c["variant"], "equal": c["equal"],
            **{key: c[key] for key in ("design_bytes", "design_bytes_ms",
                                       "scan_smem_bytes", "scan_smem_ms")
               if key in c}})
        for tag, tcases in side.get(name, {}).items():
            kernels[-1][f"{tag}_cases"] = [
                {**{key: sc[key] for key in (
                    "lanes", "variant", "max_abs_err", "kernel_ms",
                    "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "scan_smem_ms") if key in sc},
                 **({"device_ms_over_main": sc["device_ms"] / c["device_ms"]}
                    if tag == "const" else {})}
                for sc in tcases]
    emit({"kernels": kernels})
    emit({"seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
