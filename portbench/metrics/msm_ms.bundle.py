"""msm_ms.bundle: device milliseconds a batch spends on the batch
equation's mask, its basepoint coefficients and ``msm_fused``, from the
program's stage mark "bvk" to "spine" inside the path's ``validate`` span,
by CUDA events, averaged over the traced window's batches."""

from portbench.trace import mean


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return mean(run.trace.between_marks_ms("validate", "bvk", "spine"))
