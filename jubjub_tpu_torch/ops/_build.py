"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library of its own, loaded with
``ctypes``.  Nothing includes PyTorch's headers, so a build takes seconds,
not minutes.  The libraries are built at first use (all sources at once, one
``nvcc`` process each, started together) into ``ops/build/<key>/``, where
``<key>`` hashes the sources, the generated constants and the compiler
flags: an edited source gets a new directory and stale libraries are never
loaded.

The product phase of the field core is chosen when the sources are built
(``config.kernels_karatsuba``): in the Karatsuba phase every source is
compiled with ``-DJJ_MUL_KARATSUBA`` (``csrc/field.cuh``), by ``nvcc`` and by
the host compiler alike, and the flag is part of the key, so two phases
never share a library.

The field constants the kernels use (p, k*p, -p^-1 mod 2^13, R mod p, the
curve's 2d) are not typed into the sources.  ``constants_header`` generates
``field_constants.cuh`` from the package's ``FieldSpec`` objects and the
oracle's curve parameters, so the kernels and the tensor-level code cannot
disagree about them.  ``sqrt_constants_header`` generates
``sqrt_constants.cuh`` the same way: the schedule of Fq's exponent
(t-1)/2 and the 2-Sylow constants of its square root (``csrc/sqrt.cu``).

``build_host`` compiles the same sources as plain C++ with the host compiler:
the lane functions then run in a loop on the CPU.  Only the test suite uses
it, to hold the kernels' arithmetic against the plain PyTorch versions on a
machine without a GPU; no entry point of the package reaches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import resource
import shutil
import subprocess
import time

from .. import config, oracle
from ..fields.spec import LIMB_BITS, NLIMBS, int_to_limbs

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "build")

KERNEL_SOURCES = ("mont", "fixed_base", "ladder", "msm", "msm_tail", "scan",
                  "roofline", "sqrt")  # csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++")
MAX_KP = 8  # largest k of a k*p constant (8p < 2^260 for both fields)
# Stack of each nvcc process.  cicc (CUDA 12.9) recurses deeply on a group
# addition inlined with its products into a loop and overflows the default
# stack of 8 MB (it segfaults, exit 139; chip_smoke.py --boundaries builds
# such a scan.cu at both limits).  The limit must be finite: with an
# unlimited one, cicc's threads get glibc's default stack of a few MB and
# the build segfaults again.
NVCC_STACK_BYTES = 256 << 20

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
ARGTYPES = {
    "jj_mont_mul": [_I, _P, _P, _P, _L, _I, _P],
    "jj_mont_square": [_I, _P, _P, _L, _I, _P],
    "jj_fixed_base": [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "jj_ladder": [_P] * 6 + [_I] + [_P] * 6 + [_L, _I, _P],
    "jj_ladder_signed": [_P] * 6 + [_I] + [_P] * 6 + [_L, _I, _P],
    "jj_ladder_affine": [_P] * 4 + [_I] + [_P] * 6 + [_L, _I, _P],
    "jj_msm_window_sums": [_P] * 5 + [_I, _L, _I, _I, _P, _L, _I, _P],
    "jj_msm_reduce": [_P, _I, _L, _P, _P],
    "jj_msm_fold": [_P, _I, _I, _P, _P],
    "jj_prefix_scan": [_P, _P, _L, _L, _L, _I, _I, _P],
    "jj_int_chain": [_I, _P, _P, _P, _I, _L, _I, _P],
    "jj_mont_mul_chain": [_P, _P, _P, _I, _L, _I, _P],
    "jj_fq_sqrt": [_P, _P, _P, _L, _I, _P],
}
FUNCTIONS = {"mont": ("jj_mont_mul", "jj_mont_square"),
             "fixed_base": ("jj_fixed_base",),
             "ladder": ("jj_ladder", "jj_ladder_signed", "jj_ladder_affine"),
             "msm": ("jj_msm_window_sums",),
             "msm_tail": ("jj_msm_reduce", "jj_msm_fold"),
             "scan": ("jj_prefix_scan",),
             "roofline": ("jj_int_chain", "jj_mont_mul_chain"),
             "sqrt": ("jj_fq_sqrt",)}

KARATSUBA_FLAGS = ("-DJJ_MUL_KARATSUBA",)

_LIBS: dict = {}   # (product phase or build directory, source) -> library
_INFO: dict = {}   # build directory -> build_info()


def phase_flags(karatsuba: bool | None = None) -> tuple:
    """Compiler flags of the product phase ``karatsuba`` or, where that is
    None, of ``config.kernels_karatsuba()``."""
    if karatsuba is None:
        karatsuba = config.kernels_karatsuba()
    return KARATSUBA_FLAGS if karatsuba else ()


# ---------------------------------------------------------------------------
# Generated constants
# ---------------------------------------------------------------------------

def _row(vals) -> str:
    return "{" + ", ".join(str(int(v)) for v in vals) + "}"


def _field_struct(name: str, F) -> str:
    kp = ",\n        ".join(_row(int_to_limbs(k * F.p)) for k in range(MAX_KP + 1))
    return f"""struct {name} {{  // {F.name}: p = {hex(F.p)}
  static JJ_CX uint32_t inv_limb() {{ return {F.inv_limb}u; }}
  static JJ_CX uint32_t p(int j) {{
    constexpr uint32_t T[{NLIMBS}] = {_row(F.p_limbs)};
    return T[j];
  }}
  static JJ_CX int32_t kp(int k, int j) {{  // limb j of k*p
    constexpr int32_t T[{MAX_KP + 1}][{NLIMBS}] = {{
        {kp}}};
    return T[k][j];
  }}
  static JJ_CX int32_t one(int j) {{  // R mod p
    constexpr int32_t T[{NLIMBS}] = {_row(F.r_limbs)};
    return T[j];
  }}
}};
"""


def constants_header() -> str:
    """Text of ``field_constants.cuh``, derived from the package's specs."""
    from ..fields.element import FQ_SPEC, FR_SPEC
    q = FQ_SPEC

    def mont_limbs(x):
        return int_to_limbs(x % q.p * q.R % q.p)

    return f"""// GENERATED by jubjub_tpu_torch/ops/_build.py from FieldSpec; do not edit.
#pragma once
#include <stdint.h>
#define JJ_NLIMBS {NLIMBS}
#define JJ_LIMB_BITS {LIMB_BITS}
#ifdef __CUDACC__
#define JJ_CX __host__ __device__ constexpr
#else
#define JJ_CX constexpr
#endif

namespace jj {{

{_field_struct("FqC", FQ_SPEC)}
{_field_struct("FrC", FR_SPEC)}
struct CurveC {{  // Montgomery forms over Fq
  static JJ_CX int32_t d2(int j) {{  // 2d, d = -(10240/10241)
    constexpr int32_t T[{NLIMBS}] = {_row(mont_limbs(oracle.EDWARDS_D2))};
    return T[j];
  }}
  static JJ_CX int32_t four(int j) {{
    constexpr int32_t T[{NLIMBS}] = {_row(mont_limbs(4))};
    return T[j];
  }}
}};

}}  // namespace jj
"""


def sqrt_exponent_steps(F) -> list[tuple[int, int]]:
    """The schedule of a^((t-1)/2) in ``csrc/sqrt.cu``: left-to-right
    windows of at most two bits over the exponent's bits, each ending in a
    set bit, so that a window is a^1 or a^3.  Returns [(squarings,
    multiplier)]: the first entry is (0, m), the start acc = a^m; each later
    one squares acc that many times, then multiplies it by a^multiplier
    (none for 0, which only trailing zero bits give)."""
    bits = bin((F.t - 1) // 2)[2:]
    steps, squarings, i = [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            squarings, i = squarings + 1, i + 1
            continue
        width = 2 if bits[i + 1:i + 2] == "1" else 1
        steps.append((squarings + width if steps else 0, 2 ** width - 1))
        squarings, i = 0, i + width
    if squarings:
        steps.append((squarings, 0))
    return steps


def _table(name: str, rows) -> str:
    body = ",\n    ".join(_row(r) for r in rows)
    return (f"JJ_TABLE int32_t {name}[{len(rows)}][{NLIMBS}] = {{\n"
            f"    {body}}};\n")


def sqrt_constants_header() -> str:
    """Text of ``sqrt_constants.cuh``: Fq's square root, p - 1 = 2^s * t
    (``fields/sqrt.py:_sqrt_tonelli_shanks`` has the algorithm; the 2-Sylow
    tables are its own, ``_sylow_consts``)."""
    from ..fields.element import FQ_SPEC
    from ..fields.sqrt import _sylow_consts
    F = FQ_SPEC
    steps = sqrt_exponent_steps(F)
    cinv_pows, half_pows = (t.T.tolist() for t in _sylow_consts(F, "cpu"))
    return f"""// GENERATED by jubjub_tpu_torch/ops/_build.py from FieldSpec; do not edit.
#pragma once
#include "field_constants.cuh"
// Tables indexed by a loop counter: constant memory on the card (the
// index is the same in every thread of a warp, a broadcast read).
#ifdef __CUDACC__
#define JJ_TABLE static __constant__
#else
#define JJ_TABLE static const
#endif

namespace jj {{

struct FqSqrtC {{  // Fq: p - 1 = 2^S * t, t odd
  static constexpr int S = {F.s};
  static constexpr int NSTEPS = {len(steps)};
  static JJ_CX int32_t minus_one(int j) {{  // Montgomery form of p - 1
    constexpr int32_t T[{NLIMBS}] = {_row(F.np_mont(F.p - 1))};
    return T[j];
  }}
}};

// a^((t-1)/2): step k squares acc (FQ_SQRT_STEPS[k] >> 2) times, then
// multiplies it by a^(FQ_SQRT_STEPS[k] & 3) (1, 3, or 0: none); step 0
// starts acc = a^(FQ_SQRT_STEPS[0] & 3).  (ops/_build.py:
// sqrt_exponent_steps)
JJ_TABLE int32_t FQ_SQRT_STEPS[{len(steps)}] = {_row(4 * q + m for q, m in steps)};
// cinv^(2^i), cinv = 1 / ROOT_OF_UNITY, Montgomery form
{_table("FQ_SQRT_CINV_POW", cinv_pows)}
// the root's corrections cinv^(2^(i-1)), 1 at i = 0, Montgomery form
{_table("FQ_SQRT_HALF_POW", half_pows)}
}}  // namespace jj
"""


GENERATED = {"field_constants.cuh": constants_header,
             "sqrt_constants.cuh": sqrt_constants_header}


def _source_files() -> list[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def source_key(flags=NVCC_FLAGS, karatsuba: bool | None = None) -> str:
    """Hash of every source, the generated constants and the flags, the
    product phase's (``phase_flags``) among them."""
    h = hashlib.sha256()
    for f in _source_files():
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    for make in GENERATED.values():
        h.update(make().encode())
    h.update(" ".join((*flags, *phase_flags(karatsuba))).encode())
    return h.hexdigest()[:16]


def _write_constants(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, make in GENERATED.items():
        path = os.path.join(out_dir, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            fh.write(make())
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# nvcc build
# ---------------------------------------------------------------------------

def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of jubjub_tpu_torch "
                       "are built from source at first use and need the CUDA "
                       "toolkit (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def nvcc_stack_limit() -> None:
    """``preexec_fn`` of an nvcc process: a finite stack of
    ``NVCC_STACK_BYTES`` (or the hard limit, if lower)."""
    _, hard = resource.getrlimit(resource.RLIMIT_STACK)
    soft = NVCC_STACK_BYTES
    if hard != resource.RLIM_INFINITY:
        soft = min(soft, hard)
    resource.setrlimit(resource.RLIMIT_STACK, (soft, hard))


def parse_ptxas(log: str) -> dict:
    """``-Xptxas -v`` output -> {function: {entry, registers, stack bytes,
    spill bytes}} for every kernel entry and every called device function."""
    out: dict = {}
    entries = set()
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.add(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            cur["entry"] = m.group(1) in entries
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def kernel_label(entry: str) -> str:
    """Readable name of a mangled kernel entry function, e.g.
    ``mont_mul_kernel<Fq>``, ``fixed_base_kernel<signed>``,
    ``int_chain_kernel<mul>`` or ``fq_sqrt_kernel``."""
    m = re.search(r"(mont_mul_chain|mont_mul|mont_square|fixed_base|fq_sqrt"
                  r"|ladder_affine|ladder"
                  r"|msm_window_sums|msm_reduce|msm_fold|prefix_scan"
                  r"|int_chain)_kernel"
                  r"|fe_mul|fe_square|pt_double|pt_add_extended_niels"
                  r"|pt_to_niels", entry)
    if not m:
        return entry
    for tag, variant in (("FqC", "<Fq>"), ("FrC", "<Fr>"),
                         ("Lb1", "<signed>"), ("Lb0", "<unsigned>"),
                         ("ILi0E", "<add>"), ("ILi1E", "<mul>"),
                         ("ILi2E", "<mixed>")):
        if tag in entry:
            return m.group(0) + variant
    return m.group(0)


def _build_all(out_dir: str, sources=KERNEL_SOURCES,
               karatsuba: bool | None = None) -> dict:
    """Builds ``sources`` into ``out_dir``, one ``nvcc`` each, all started
    together, in the product phase ``phase_flags(karatsuba)``.
    Returns the build's record (``build_info``), also written to
    ``out_dir/build_info.json``."""
    nvcc = find_nvcc()
    _write_constants(out_dir)
    t0 = time.perf_counter()
    procs = {}
    for name in sources:
        tmp = os.path.join(out_dir, f"libjj_{name}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *phase_flags(karatsuba), "-I", out_dir,
               "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        log = os.path.join(out_dir, f"{name}.log")
        with open(log, "w") as fh:
            procs[name] = (tmp, log, time.perf_counter(), subprocess.Popen(
                cmd, stdout=fh, stderr=subprocess.STDOUT,
                preexec_fn=nvcc_stack_limit))
    # a source's seconds end when its own nvcc exits, polled, so that a
    # quick source collected after a slow one is not charged the slow one's
    secs: dict = {}
    while len(secs) < len(procs):
        for name, (_, _, started, proc) in procs.items():
            if name not in secs and proc.poll() is not None:
                secs[name] = time.perf_counter() - started
        time.sleep(0.02)
    info = {"seconds": None, "nvcc": nvcc, "sources": {}, "kernels": {}}
    failed = []
    for name, (tmp, log_path, _, proc) in procs.items():
        with open(log_path) as fh:
            log = fh.read()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, os.path.join(out_dir, f"libjj_{name}.so"))
        fns = parse_ptxas(log)
        info["sources"][f"{name}.cu"] = {
            "seconds": round(secs[name], 3),
            "karatsuba": bool(phase_flags(karatsuba)),
            "called_functions": {kernel_label(k): v for k, v in fns.items()
                                 if not v["entry"]}}
        info["kernels"].update({k: v for k, v in fns.items() if v["entry"]})
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    info["seconds"] = round(time.perf_counter() - t0, 3)
    with open(os.path.join(out_dir, "build_info.json"), "w") as fh:
        json.dump(info, fh, indent=1)
    return info


def ensure_built(build: bool = True) -> str:
    """Directory holding the libraries for the current sources, built now if
    it does not hold them yet.  With ``build=False`` a missing library
    raises instead: the ranks of a job (``parallel/launch.py``) load what
    the process that started them built, and never build."""
    out_dir = os.path.join(BUILD_ROOT, source_key())
    info_path = os.path.join(out_dir, "build_info.json")
    have = os.path.exists(info_path) and all(
        os.path.exists(os.path.join(out_dir, f"libjj_{n}.so"))
        for n in KERNEL_SOURCES)
    if not have and not build:
        raise RuntimeError(f"jubjub_tpu_torch: the CUDA kernels are not built "
                           f"in {out_dir}; build them before the ranks start "
                           f"(ops._build.ensure_built())")
    if not have:
        _INFO[out_dir] = dict(_build_all(out_dir), cached=False)
    elif out_dir not in _INFO:
        with open(info_path) as fh:
            _INFO[out_dir] = dict(json.load(fh), cached=True)
    return out_dir


def build_info() -> dict:
    """Seconds of the build and registers / spill bytes per kernel, as
    ``nvcc -Xptxas -v`` reported them (builds if necessary)."""
    return _INFO[ensure_built()]


def _bind(lib, name: str):
    for fn in FUNCTIONS[name]:
        f = getattr(lib, fn)
        f.argtypes = ARGTYPES[fn]
        f.restype = ctypes.c_int
    return lib


def library(name: str, out_dir: str | None = None):
    """ctypes handle of ``libjj_<name>.so`` with argument types set: of the
    package's build for the sources as first loaded in the current product
    phase, or of the build in ``out_dir`` (``_build_all``)."""
    key = (out_dir or config.kernels_karatsuba(), name)
    lib = _LIBS.get(key)
    if lib is None:
        lib = _bind(ctypes.CDLL(os.path.join(out_dir or ensure_built(),
                                             f"libjj_{name}.so")), name)
        _LIBS[key] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch was refused (``cudaGetLastError()`` != 0)."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")


# ---------------------------------------------------------------------------
# Host build of the lane functions (tests only)
# ---------------------------------------------------------------------------

def build_host(out_dir: str, compiler: str = "c++",
               karatsuba: bool | None = None) -> dict:
    """Compile every source as plain C++ into ``out_dir`` and return
    {name: ctypes library}; the product phase as ``phase_flags`` gives it.
    The C interface is the kernels' own; ``threads`` and ``stream`` are
    ignored and the lanes run in a loop.  The compilers run in parallel."""
    _write_constants(out_dir)
    procs = {}
    for name in KERNEL_SOURCES:
        so = os.path.join(out_dir, f"libjj_{name}_host.so")
        cmd = [compiler, *HOST_FLAGS, *phase_flags(karatsuba), "-I", out_dir,
               "-I", CSRC, "-o", so, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {name}.cu failed:\n{err}")
        libs[name] = _bind(ctypes.CDLL(so), name)
    return libs
