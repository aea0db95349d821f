"""``fq_sqrt``: Fq's square root as one CUDA kernel a call.

Replaces no TPU kernel: the reference package computes the root in XLA
(``jubjub_tpu/fields/sqrt.py``), and so does the port's plain version,
``fields/sqrt.py:_sqrt_tonelli_shanks``, in plain PyTorch: about 1,350
``mont_square`` / ``mont_mul`` launches and thousands of carry-chain
launches a call, each sending a 20-limb plane of the whole batch through
device memory.  Source: ``csrc/sqrt.cu`` over ``csrc/field.cuh``, with the
exponent's schedule and the 2-Sylow constants generated from the field's
spec (``_build.sqrt_constants_header``).

What bounds it on an H100: operations.  A lane does ``op_counts()``'s
squarings and products (about 475,000 int32 multiply-adds) against 81 bytes
moved, so the design keeps every value of the computation in one thread's
registers: one thread a lane, the ``(20, N)`` layout read as it lies, the
ragged edge masked by the kernel, flattening done here, as in
``mont_square``.  Of the plain version's 992 squarings only the 496 whose
results are read are run.

Plain version: ``fq_sqrt_plain`` (``_sqrt_tonelli_shanks`` with every
product in plain PyTorch).  A CPU tensor takes it; a CUDA tensor launches the
kernel or raises.  ``ok`` is identical; the root is the same field element
(equal after ``mont.to_canonical``), lazily reduced below 2p, its limbs not
always the plain version's.
"""

from __future__ import annotations

import torch

from ..fields import mont
from ..fields.element import FQ_SPEC
from ..fields.spec import NLIMBS, FieldSpec
from ..fields.sqrt import _sqrt_tonelli_shanks
from . import _build

THREADS = 128  # threads per block; one thread a lane


def op_counts(F: FieldSpec = FQ_SPEC) -> dict:
    """Field operations the kernel does a lane: {"square", "mul",
    "reduce"}, counted from its schedule (``csrc/sqrt.cu``)."""
    steps = _build.sqrt_exponent_steps(F)
    return {
        # a^2 for a^3; the exponent's; the 2-Sylow ladders' s-1-i each
        "square": 1 + sum(q for q, _ in steps) + F.s * (F.s - 1) // 2,
        # a^3; the exponent's; x and b; two a bit; the root
        "mul": 1 + sum(1 for _, m in steps[1:] if m) + 2 + 2 * F.s + 1,
        "reduce": 1,  # the zero test
    }


def fq_sqrt_plain(F: FieldSpec, a: torch.Tensor):
    """The kernel's plain PyTorch version."""
    with mont.plain_only():
        return _sqrt_tonelli_shanks(F, a)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def fq_sqrt(F: FieldSpec, a: torch.Tensor):
    """(sqrt(a), is_square) over Fq for an int32 ``(20, *batch)`` plane of
    Montgomery residues below 5p: the root lazily reduced (< 2p), 0 where
    ``a`` is 0, undefined where ``ok`` is False."""
    if F != FQ_SPEC:
        raise ValueError(f"fq_sqrt: Fq only, got {F.name}")
    if a.dtype != torch.int32 or a.ndim < 1 or a.shape[0] != NLIMBS:
        raise ValueError(f"fq_sqrt: expected an int32 ({NLIMBS}, *batch) "
                         f"limb plane, got {a.dtype} {tuple(a.shape)}")
    if not a.is_cuda:
        return fq_sqrt_plain(F, a)
    a2 = a.reshape(NLIMBS, -1).contiguous()
    n = a2.shape[1]
    root = torch.empty_like(a2)
    ok = torch.empty(n, dtype=torch.bool, device=a.device)
    if n:
        with torch.cuda.device(a.device):
            rc = _build.library("sqrt").jj_fq_sqrt(
                a2.data_ptr(), root.data_ptr(), ok.data_ptr(), n, THREADS,
                _stream())
        _build.check(rc, "fq_sqrt")
        fq_sqrt.launches += 1
    return root.reshape(a.shape), ok.reshape(a.shape[1:])


fq_sqrt.launches = 0
