"""fixed_base_roofline: the fixed-base kernel's share of its roofline, in %:
the frozen bound (``counts/fixed_base.py``: the operations and the scan's
shared-memory reads of the cell's lanes, one a transaction) over the
kernel's mean device time a launch.  That time comes from the profiler's
kernel records where it kept one for every launch, otherwise from CUDA
events at the program's stage marks "checks" and "fixed_base" (the kernel
and the few launches that form its scalars), and the run says so on
standard error."""

import sys

from portbench.counts import fixed_base
from portbench.trace import kernel_ms


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    ms = kernel_ms(run.trace, "fixed_base",
                   run.trace.between_marks_ms("validate", "checks",
                                              "fixed_base"),
                   lambda s: print(f"fixed_base_roofline: {s}",
                                   file=sys.stderr))
    if not ms:
        return None
    return 100.0 * fixed_base.bound_ms(run.shape["transactions"])[0] / ms
