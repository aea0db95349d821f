"""Stage marks for a timing breakdown of the entry points.

``affine_from_bytes``, ``window_sums_fused``, ``msm_fused``,
``segment_sum`` and ``verify_bundles`` call ``mark(name)`` at the end of
each of their stages.  Nothing happens unless a
caller installs a callback for a block of code::

    with stages.recording(lambda name: ...):
        jj.msm_fused(points, scalars)

The callback sees the names in order ("digits", "window_sums_kernel",
"partial_reduction", "spine" for ``msm_fused``); a caller that synchronizes
the card in it reads the time of each stage.  The entry points keep the
reference package's signatures.
"""

from __future__ import annotations

import contextlib

_callback = None


def mark(name: str) -> None:
    """The end of stage ``name``: calls the installed callback, if any."""
    if _callback is not None:
        _callback(name)


@contextlib.contextmanager
def recording(callback):
    """Calls ``callback(name)`` at every stage mark inside the block."""
    global _callback
    outer, _callback = _callback, callback
    try:
        yield
    finally:
        _callback = outer
