"""torch_launches.bundle: kernel launches a batch that plain PyTorch makes
(the field code of ``fields/mont.py``, the points' code of
``curve/points.py``, the masks and sums of ``sapling.py``; copies and sets
excluded): the launch calls in the profiler's runtime records over the
traced window, less the program's own wrappers' launches
(``ops.launch_counts``), over its batches."""

from portbench.trace import launches_per_batch


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return launches_per_batch(run.trace, port=False)
