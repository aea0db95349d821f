"""Operations and bytes of the fixed-base kernel (``ops/csrc/fixed_base.cu``,
signed 8-bit windows), frozen: what one lane's k*B needs.

Per lane, with M a product of Fq (``field_ops``):
  - 32 signed 8-bit windows of a scalar below 2^252 (no carry window: the
    top window holds 4 bits), a table of the magnitudes 1..128 a window;
  - window 0 seeds the accumulator by linear operations alone; each of the
    31 others is an affine-Niels addition (7M): 217M.
  - the scan: every lane reads the whole of each window's table slice from
    shared memory, 3 coordinates x 10 words (two limbs a word) x 128
    entries x 4 bytes = 15,360 B a window, 491,520 B a lane, at an H100
    SXM's shared-memory rate of 132 SMs x 128 B a clock x 1.98 GHz.
  - device memory: the lane's 32 digit words in and 5 planes of 20 words
    out, 528 B, far below either term.

The bound is the larger of the operations over the int32 rate (``peaks``)
and the scan's shared-memory reads, as PERF.md's kernel table states it at
131072 lanes: 1.121 ms and 1.926 ms, so 1.926 ms, set by the scan.
"""

from . import field_ops, peaks

NWIN = 32
ENTRIES = 128
SMS = 132                          # an H100 SXM's SMs
SMEM_BYTES_PER_S = SMS * 128 * 1.98e9


def macs() -> int:
    """int32 multiply-adds of one lane."""
    return (NWIN - 1) * 7 * field_ops.MUL


def smem_bytes() -> int:
    """Shared-memory bytes one lane's scan reads."""
    return NWIN * 3 * 10 * ENTRIES * 4


def bound_ms(lanes: int) -> tuple[float, str]:
    """The least milliseconds the card could take for ``lanes`` lanes, and
    which term sets it: the operations or the scan's shared memory."""
    t_ops = peaks.bound_ms(0, lanes * macs())[0]
    t_smem = lanes * smem_bytes() / SMEM_BYTES_PER_S * 1e3
    return (t_smem, "shared memory") if t_smem >= t_ops else (t_ops,
                                                              "operations")
