"""port_launches.bundle: launches a batch of the program's kernel wrappers
(``ops/mont.py``, ``ops/fixed_base.py``, ``ops/msm.py``, ``ops/ladder.py``,
``ops/sqrt.py``), from ``jubjub_tpu_torch.ops.launch_counts()`` read around
every batch of the traced window."""

from portbench.trace import launches_per_batch


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return launches_per_batch(run.trace, port=True)
