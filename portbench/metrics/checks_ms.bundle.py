"""checks_ms.bundle: device milliseconds a batch spends on the consensus
checks (the small-order rule on cv, rk and epk, the scalars, each
transaction's ``ok``), from the program's stage mark "sqrt" to "checks"
inside the path's ``validate`` span, by CUDA events, averaged over the
traced window's batches."""

from portbench.trace import mean


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return mean(run.trace.between_marks_ms("validate", "sqrt", "checks"))
