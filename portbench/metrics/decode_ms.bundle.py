"""decode_ms.bundle: device milliseconds a batch spends decoding every
encoding of the batch (``affine_from_bytes``), from the start of the path's
``validate`` span to the program's stage mark "sqrt", by CUDA events,
averaged over the traced window's batches."""

from portbench.trace import mean


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return mean(run.trace.span_to_mark_ms("validate", "sqrt"))
