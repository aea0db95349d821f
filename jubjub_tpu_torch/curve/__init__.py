"""Curve layer: Jubjub group law, scalar multiplication, encoding, the
prime-order subgroup."""

from .points import (AffineNielsPoint, AffinePoint, CompletedPoint,
                     ExtendedNielsPoint, ExtendedPoint, batch_normalize,
                     full_generator, reduce_sum, segment_sum, select_point,
                     subgroup_generator)
from .encoding import affine_from_bytes, affine_to_bytes
from .scalar_mul import (FixedBaseTable, full_generator_table,
                         generator_table, mul_affine, mul_const_scalar,
                         mul_extended, multiply_bits,
                         multiply_bits_affine_niels, window_digits)
from .subgroup import (SubgroupPoint, clear_cofactor, eight_torsion_host,
                       into_subgroup, random_extended,
                       recommended_wnaf_window)

__all__ = [
    "AffineNielsPoint", "AffinePoint", "CompletedPoint", "ExtendedNielsPoint",
    "ExtendedPoint", "SubgroupPoint", "batch_normalize", "full_generator",
    "select_point", "reduce_sum", "segment_sum", "subgroup_generator",
    "affine_from_bytes",
    "affine_to_bytes", "FixedBaseTable", "full_generator_table",
    "generator_table", "mul_affine", "mul_const_scalar", "mul_extended",
    "multiply_bits", "multiply_bits_affine_niels", "window_digits",
    "clear_cofactor", "eight_torsion_host", "into_subgroup",
    "random_extended", "recommended_wnaf_window",
]
