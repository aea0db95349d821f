"""Hand-written CUDA kernels (``csrc/``), their wrappers and launch counts."""

from __future__ import annotations


def _wrappers():
    from .fixed_base import fixed_base
    from .ladder import ladder, ladder_affine, ladder_signed
    from .mont import mont_mul, mont_square
    from .msm import msm_fold, msm_reduce, msm_window_sums
    from .roofline import int_chain, mont_mul_chain
    from .scan import prefix_scan
    from .sqrt import fq_sqrt
    return {"mont_mul": mont_mul, "mont_square": mont_square,
            "fixed_base": fixed_base, "ladder": ladder,
            "msm_window_sums": msm_window_sums, "msm_reduce": msm_reduce,
            "msm_fold": msm_fold,
            "ladder_signed": ladder_signed, "prefix_scan": prefix_scan,
            "int_chain": int_chain, "mont_mul_chain": mont_mul_chain,
            "ladder_affine": ladder_affine, "fq_sqrt": fq_sqrt}


def launch_counts() -> dict:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: w.launches for name, w in _wrappers().items()}


def reset_launch_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
