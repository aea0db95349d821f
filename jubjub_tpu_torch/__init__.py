"""jubjub_tpu_torch: the Jubjub elliptic curve, batched, in PyTorch and CUDA.

The GPU counterpart of the ``jubjub_tpu`` package, with the capabilities of
the zkcrypto/jubjub Rust crate as far as they are ported: two prime fields,
the point representations, constant-pattern fixed-base and variable-base
scalar multiplication, multi-scalar multiplication, batch
normalization/inversion, the canonical 32-byte point encoding and decoding,
the prime-order subgroup with its subgroup-checked decoding, sums of
contiguous segments of a batch of points (``segment_sum``), and the Jubjub
part of Sapling bundle validation (``verify_bundles``: decoding, the
small-order rule, each transaction's bvk and one batch equation over the
spend-authorisation and binding signatures, its point and its basepoints'
coefficients).  The hot loops are
hand-written CUDA kernels for Hopper (``ops/``), built from source at first
use.

Design: field elements are planes of 20x13-bit limbs in int32 tensors, limb
axis leading, kept in Montgomery form; points are structs-of-arrays of such
planes; every operation is batched and data-independent.  Entry points run
on the GPU; pass ``device="cpu"`` to a constructor to run the kernels' plain
PyTorch versions on the CPU instead.
"""

from .fields import Fq, Fr
from .curve import (AffineNielsPoint, AffinePoint, ExtendedNielsPoint,
                    ExtendedPoint, SubgroupPoint, affine_from_bytes,
                    batch_normalize, full_generator, segment_sum,
                    subgroup_generator)
from .ops.msm import msm_fused, window_sums_fused
from .parallel import msm, msm_pippenger
from .sapling import verify_bundles
from . import oracle

# Reference crate type aliases (src/lib.rs:64-71)
Base = Fq
Scalar = Fr

__version__ = "0.1.0"

__all__ = [
    "Fq", "Fr", "Base", "Scalar", "oracle", "AffineNielsPoint", "AffinePoint",
    "ExtendedNielsPoint", "ExtendedPoint", "SubgroupPoint", "batch_normalize",
    "full_generator", "subgroup_generator", "affine_from_bytes", "msm",
    "msm_fused", "msm_pippenger", "window_sums_fused", "segment_sum",
    "verify_bundles", "__version__",
]
