"""bvk_ms.bundle: device milliseconds a batch spends forming and encoding
every transaction's bvk ([valueBalance] V by the fixed-base kernel, the
segmented sum, ``batch_normalize``, ``to_bytes``), from the program's stage
mark "checks" to "bvk" inside the path's ``validate`` span, by CUDA events,
averaged over the traced window's batches."""

from portbench.trace import mean


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return mean(run.trace.between_marks_ms("validate", "checks", "bvk"))
