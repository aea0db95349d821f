"""Jubjub point representations and group law, batched struct-of-arrays.

Four public representations, mirroring the reference crate's src/lib.rs:
  - ``AffinePoint {u, v}``                       (lib.rs:78-125)
  - ``ExtendedPoint {u, v, z, t1, t2}``          (lib.rs:127-181), invariant
    ``T1 * T2 = UV/Z``
  - ``AffineNielsPoint {v_plus_u, v_minus_u, t2d}``     (lib.rs:251-322)
  - ``ExtendedNielsPoint {v_plus_u, v_minus_u, z, t2d}`` (lib.rs:324-396)
plus the private ``CompletedPoint`` intermediate (lib.rs:1032-1061).

Formulas:
  - doubling: "dbl-2008-bbjlp" (lib.rs:739-828)
  - unified addition: Hisil-Wong-Carter-Dawson, 8M extended / 7M affine-niels
    (lib.rs:883-1030), complete on this curve because d is non-square.

Every point holds a *batch*: each coordinate is an ``Fq`` whose limb plane has
shape (NLIMBS, *batch).  All predicates return boolean masks of the batch
shape.  The lazy-bound schedule (every ``k`` of a lazy subtraction, every
``reduce_once`` site) is the reference package's, so coordinates agree with
it limb for limb; the CUDA kernels' ``csrc/point.cuh`` follows the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import oracle, stages
from ..fields import Fq, mont
from ..fields.element import FQ_SPEC
from ..fields.spec import NLIMBS


def map_point(fn, p, *others):
    """Apply ``fn`` to the limb planes of one or several points of the same
    type, coordinate by coordinate, and rebuild the point."""
    cls = type(p)
    return cls(*[Fq(fn(*[getattr(q, f.name).limbs for q in (p,) + others]))
                 for f in dataclasses.fields(cls)])


def _d2(shape, device):
    """2d as a broadcast constant (src/lib.rs:407-412)."""
    return Fq.from_int(oracle.EDWARDS_D2, shape, device)


def _mulk(*pairs):
    """k independent field products in ONE stacked ``mont.mul`` call.

    The group-law formulas need several independent products at each step
    (e.g. HWCD's A, B, C, D).  They are stacked on axis 1 (the limb axis
    stays axis 0): one multiplication over a (NLIMBS, k, *batch) plane, which
    on the GPU is one kernel launch instead of k."""
    xs = [p[0].limbs for p in pairs]
    ys = [p[1].limbs for p in pairs]
    shape = torch.broadcast_shapes(*[a.shape for a in xs + ys])
    xs = [a.expand(shape) for a in xs]
    ys = [a.expand(shape) for a in ys]
    m = mont.mul(FQ_SPEC, torch.stack(xs, dim=1), torch.stack(ys, dim=1))
    return [Fq(m[:, i]) for i in range(len(pairs))]


def _squarek(*els):
    """k independent squarings in ONE stacked ``mont.square`` call."""
    xs = [e.limbs for e in els]
    shape = torch.broadcast_shapes(*[a.shape for a in xs])
    xs = [a.expand(shape) for a in xs]
    s = mont.square(FQ_SPEC, torch.stack(xs, dim=1))
    return [Fq(s[:, i]) for i in range(len(els))]


@dataclass
class AffinePoint:
    """Affine coordinates (u, v); identity is (0, 1)
    (src/lib.rs:78-125, :416-421)."""

    u: Fq
    v: Fq

    @classmethod
    def identity(cls, shape=(), device=None):
        return cls(u=Fq.zero(shape, device), v=Fq.one(shape, device))

    @classmethod
    def from_raw_unchecked(cls, u, v, shape=(), device=None):
        """Host ints -> point, no curve check (src/lib.rs:662-664)."""
        return cls(u=Fq.from_int(u, shape, device),
                   v=Fq.from_int(v, shape, device))

    @property
    def shape(self):
        return self.u.shape

    @property
    def device(self):
        return self.u.device

    def __neg__(self):
        return AffinePoint(u=-self.u, v=self.v)

    def to_extended(self) -> "ExtendedPoint":
        """(u, v) -> (u, v, 1, u, v) (src/lib.rs:640-648)."""
        one = Fq.one(self.shape, self.device)
        return ExtendedPoint(u=self.u, v=self.v, z=one, t1=self.u, t2=self.v)

    def to_niels(self) -> "AffineNielsPoint":
        """(src/lib.rs:652-658).  Lazy bounds: coords < 2p, so v+u < 4p and
        v-u+2p < 4p, both inside the mul precondition."""
        return AffineNielsPoint(
            v_plus_u=self.v.lazy_add(self.u),
            v_minus_u=self.v.lazy_sub(self.u, 2),
            t2d=self.u * self.v * _d2(self.shape, self.device),
        )

    def is_identity(self):
        return self.u.is_zero() & self.v.ct_eq(Fq.one(self.shape, self.device))

    def is_on_curve(self):
        """Batch mask: -u^2 + v^2 == 1 + d u^2 v^2 (the reference crate's
        test-only is_on_curve_vartime, lib.rs:669-675)."""
        u2, v2 = _squarek(self.u, self.v)
        d = Fq.from_int(oracle.EDWARDS_D, self.shape, self.device)
        return (v2 - u2).ct_eq(Fq.one(self.shape, self.device) + d * u2 * v2)

    is_on_curve_vartime = is_on_curve

    def is_small_order(self):
        return self.to_extended().is_small_order()

    def is_torsion_free(self):
        return self.to_extended().is_torsion_free()

    def is_prime_order(self):
        e = self.to_extended()
        return e.is_torsion_free() & ~e.is_identity()

    def mul_by_cofactor(self) -> "ExtendedPoint":
        return self.to_extended().mul_by_cofactor()

    def get_u(self) -> Fq:
        return self.u

    def get_v(self) -> Fq:
        return self.v

    def ct_eq(self, other) -> torch.Tensor:
        return self.u.ct_eq(other.u) & self.v.ct_eq(other.v)

    __eq__ = ct_eq

    def __hash__(self):  # pragma: no cover
        raise TypeError("batched points are unhashable")

    def __add__(self, other):
        return self.to_extended() + other

    def __sub__(self, other):
        return self.to_extended() - other

    def __mul__(self, scalar):
        """AffinePoint * Fr through the 7M affine-Niels ladder
        (src/lib.rs:1109-1117)."""
        from .scalar_mul import mul_affine
        return mul_affine(self, scalar)

    __rmul__ = __mul__

    def to_bytes(self):
        from .encoding import affine_to_bytes
        return affine_to_bytes(self)

    @classmethod
    def from_bytes(cls, b, zip_216_enabled: bool = True):
        """(point, ok) of uint8 (32, *batch) encodings (src/lib.rs:469-534)."""
        from .encoding import affine_from_bytes
        return affine_from_bytes(b, zip_216_enabled=zip_216_enabled)

    @classmethod
    def from_bytes_pre_zip216_compatibility(cls, b):
        """Consensus-critical legacy decoder (src/lib.rs:474-490)."""
        from .encoding import affine_from_bytes
        return affine_from_bytes(b, zip_216_enabled=False)

    @classmethod
    def batch_from_bytes(cls, b, zip_216_enabled: bool = True):
        """The decoder is batched already (src/lib.rs:536-627): the same as
        ``from_bytes``."""
        from .encoding import affine_from_bytes
        return affine_from_bytes(b, zip_216_enabled=zip_216_enabled)


@dataclass
class CompletedPoint:
    """Intermediate (U:Z, V:T) point (src/lib.rs:1032-1050)."""

    u: Fq
    v: Fq
    z: Fq
    t: Fq

    def into_extended(self) -> "ExtendedPoint":
        """Homogenize with 3 muls (one stacked call); T1/T2 stay unmultiplied
        (src/lib.rs:1052-1060)."""
        u, v, z = _mulk((self.u, self.t), (self.v, self.z), (self.z, self.t))
        return ExtendedPoint(u=u, v=v, z=z, t1=self.u, t2=self.v)


@dataclass
class ExtendedPoint:
    """Extended twisted Edwards coordinates (src/lib.rs:127-145)."""

    u: Fq
    v: Fq
    z: Fq
    t1: Fq
    t2: Fq

    @classmethod
    def identity(cls, shape=(), device=None):
        """(0, 1, 1, 0, 0) (src/lib.rs:680-688)."""
        return cls(u=Fq.zero(shape, device), v=Fq.one(shape, device),
                   z=Fq.one(shape, device), t1=Fq.zero(shape, device),
                   t2=Fq.zero(shape, device))

    @classmethod
    def from_affine(cls, p: AffinePoint) -> "ExtendedPoint":
        return p.to_extended()

    @property
    def shape(self):
        return self.u.shape

    @property
    def device(self):
        return self.u.device

    def ct_eq(self, other) -> torch.Tensor:
        """(u/z, v/z) == (u'/z', v'/z') via cross-multiplication
        (src/lib.rs:153-163)."""
        uz, zu, vz, zv = _mulk((self.u, other.z), (other.u, self.z),
                               (self.v, other.z), (other.v, self.z))
        return uz.ct_eq(zu) & vz.ct_eq(zv)

    __eq__ = ct_eq

    def __hash__(self):  # pragma: no cover
        raise TypeError("batched points are unhashable")

    def __neg__(self):
        """(src/lib.rs:195-206). t1 carries the widest lazy bound (< 6p from
        double's completed u), so negate with k=6."""
        return ExtendedPoint(u=-self.u, v=self.v, z=self.z,
                             t1=self.t1.neg_bounded(6), t2=self.t2)

    def is_identity(self) -> torch.Tensor:
        """u == 0 && v == z (src/lib.rs:691-696)."""
        return self.u.is_zero() & self.v.ct_eq(self.z)

    def is_small_order(self) -> torch.Tensor:
        """Double twice and check u == 0 (src/lib.rs:699-705)."""
        return self.double().double().u.is_zero()

    def is_torsion_free(self) -> torch.Tensor:
        """Multiply by r and compare with the identity (src/lib.rs:709-711):
        on a CUDA batch one launch of the ladder kernel."""
        from .scalar_mul import mul_const_scalar
        return mul_const_scalar(self, oracle.R).is_identity()

    def is_prime_order(self) -> torch.Tensor:
        return self.is_torsion_free() & ~self.is_identity()

    def mul_by_cofactor(self) -> "ExtendedPoint":
        """[8]P by three doublings (src/lib.rs:713-724)."""
        return self.double().double().double()

    def to_niels(self) -> "ExtendedNielsPoint":
        """(src/lib.rs:726-735).  Lazy bounds: u,v < 2p, t1 < 6p, t2 < 4p,
        so t1*t2 stays under the 32p^2 mul precondition."""
        return ExtendedNielsPoint(
            v_plus_u=self.v.lazy_add(self.u),
            v_minus_u=self.v.lazy_sub(self.u, 2),
            z=self.z,
            t2d=self.t1 * self.t2 * _d2(self.shape, self.device),
        )

    def double(self) -> "ExtendedPoint":
        """dbl-2008-bbjlp, 3M + 4S (src/lib.rs:739-828).

        Lazy-reduction bounds (multiples of p): inputs u,v,z < 2p;
        uu,vv,zz2,uv2 < 2p/4p; completed u < 6p, v,z < 4p, t < 8p reduced
        once to < 4p so every into_extended product stays under the 32p^2
        mul precondition."""
        uu, vv, zz, uv2 = _squarek(self.u, self.v, self.z,
                                   self.u.lazy_add(self.v))
        zz2 = zz.lazy_double()
        vv_plus_uu = vv.lazy_add(uu)
        vv_minus_uu = vv.lazy_sub(uu, 2)
        return CompletedPoint(
            u=uv2.lazy_sub(vv_plus_uu, 4),
            v=vv_plus_uu,
            z=vv_minus_uu,
            t=zz2.lazy_sub(vv_minus_uu, 4).reduce_once(4),
        ).into_extended()

    # -- HWCD unified additions (src/lib.rs:883-1030) -----------------------

    def add_extended_niels(self, o: "ExtendedNielsPoint") -> "ExtendedPoint":
        # Lazy bounds: a,b,c < 2p; d doubled then reduced once back to < 2p,
        # so completed coords are < 4p and into_extended products < 16p^2.
        a, b, tt, zz = _mulk((self.v.lazy_sub(self.u, 2), o.v_minus_u),
                             (self.v.lazy_add(self.u), o.v_plus_u),
                             (self.t1, self.t2), (self.z, o.z))
        c = tt * o.t2d
        d = zz.lazy_double().reduce_once(2)
        return CompletedPoint(u=b.lazy_sub(a, 2), v=b.lazy_add(a),
                              z=d.lazy_add(c),
                              t=d.lazy_sub(c, 2)).into_extended()

    def sub_extended_niels(self, o: "ExtendedNielsPoint") -> "ExtendedPoint":
        a, b, tt, zz = _mulk((self.v.lazy_sub(self.u, 2), o.v_plus_u),
                             (self.v.lazy_add(self.u), o.v_minus_u),
                             (self.t1, self.t2), (self.z, o.z))
        c = tt * o.t2d
        d = zz.lazy_double().reduce_once(2)
        return CompletedPoint(u=b.lazy_sub(a, 2), v=b.lazy_add(a),
                              z=d.lazy_sub(c, 2),
                              t=d.lazy_add(c)).into_extended()

    def add_affine_niels(self, o: "AffineNielsPoint") -> "ExtendedPoint":
        a, b, tt = _mulk((self.v.lazy_sub(self.u, 2), o.v_minus_u),
                         (self.v.lazy_add(self.u), o.v_plus_u),
                         (self.t1, self.t2))
        c = tt * o.t2d
        d = self.z.lazy_double().reduce_once(2)
        return CompletedPoint(u=b.lazy_sub(a, 2), v=b.lazy_add(a),
                              z=d.lazy_add(c),
                              t=d.lazy_sub(c, 2)).into_extended()

    def sub_affine_niels(self, o: "AffineNielsPoint") -> "ExtendedPoint":
        a, b, tt = _mulk((self.v.lazy_sub(self.u, 2), o.v_plus_u),
                         (self.v.lazy_add(self.u), o.v_minus_u),
                         (self.t1, self.t2))
        c = tt * o.t2d
        d = self.z.lazy_double().reduce_once(2)
        return CompletedPoint(u=b.lazy_sub(a, 2), v=b.lazy_add(a),
                              z=d.lazy_sub(c, 2),
                              t=d.lazy_add(c)).into_extended()

    def __add__(self, other):
        if isinstance(other, ExtendedNielsPoint):
            return self.add_extended_niels(other)
        if isinstance(other, AffineNielsPoint):
            return self.add_affine_niels(other)
        if isinstance(other, AffinePoint):
            return self.add_affine_niels(other.to_niels())
        if isinstance(other, ExtendedPoint):
            return self.add_extended_niels(other.to_niels())
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, ExtendedNielsPoint):
            return self.sub_extended_niels(other)
        if isinstance(other, AffineNielsPoint):
            return self.sub_affine_niels(other)
        if isinstance(other, AffinePoint):
            return self.sub_affine_niels(other.to_niels())
        if isinstance(other, ExtendedPoint):
            return self.sub_extended_niels(other.to_niels())
        return NotImplemented

    def __mul__(self, scalar):
        from .scalar_mul import mul_extended
        return mul_extended(self, scalar)

    __rmul__ = __mul__

    def multiply_bits(self, scalar_bytes) -> "ExtendedPoint":
        """Bit-serial double-and-add over 32-byte little-endian scalars
        (src/lib.rs:356-385)."""
        from .scalar_mul import multiply_bits
        return multiply_bits(self, scalar_bytes)

    def to_affine(self) -> AffinePoint:
        """Projective -> affine; batched with ONE inversion
        (Curve::to_affine + batch_normalize, src/lib.rs:840-858, :1077-1107)."""
        return batch_normalize(self)

    def sum(self, axis: int) -> "ExtendedPoint":
        """Reduce a batch axis by point addition (the Sum impl,
        src/lib.rs:183-193), as a log-depth tree."""
        return reduce_sum(self, axis)

    # GroupEncoding for ExtendedPoint (src/lib.rs:1407-1418): a
    # curve-checked decode, no subgroup check
    def to_bytes(self):
        return self.to_affine().to_bytes()

    @classmethod
    def from_bytes(cls, b):
        aff, ok = AffinePoint.from_bytes(b)
        return aff.to_extended(), ok


@dataclass
class AffineNielsPoint:
    """Precomputed affine point for cheap (7M) re-addition
    (src/lib.rs:251-269)."""

    v_plus_u: Fq
    v_minus_u: Fq
    t2d: Fq

    @classmethod
    def identity(cls, shape=(), device=None):
        return cls(v_plus_u=Fq.one(shape, device), v_minus_u=Fq.one(shape, device),
                   t2d=Fq.zero(shape, device))

    def multiply_bits(self, scalar_bytes) -> "ExtendedPoint":
        """(src/lib.rs:272-301)."""
        from .scalar_mul import multiply_bits_affine_niels
        return multiply_bits_affine_niels(self, scalar_bytes)

    def __mul__(self, scalar) -> "ExtendedPoint":
        """AffineNielsPoint * Fr -> ExtendedPoint (src/lib.rs:304-312)."""
        return self.multiply_bits(scalar.to_bytes())

    __rmul__ = __mul__


@dataclass
class ExtendedNielsPoint:
    """Precomputed extended point for cheap (8M) re-addition
    (src/lib.rs:324-354)."""

    v_plus_u: Fq
    v_minus_u: Fq
    z: Fq
    t2d: Fq

    @classmethod
    def identity(cls, shape=(), device=None):
        return cls(v_plus_u=Fq.one(shape, device), v_minus_u=Fq.one(shape, device),
                   z=Fq.one(shape, device), t2d=Fq.zero(shape, device))

    def multiply_bits(self, scalar_bytes) -> "ExtendedPoint":
        from .scalar_mul import multiply_bits
        return multiply_bits(self, scalar_bytes, from_niels=True)

    def __mul__(self, scalar) -> "ExtendedPoint":
        """ExtendedNielsPoint * Fr -> ExtendedPoint (src/lib.rs:388-396)."""
        return self.multiply_bits(scalar.to_bytes())

    __rmul__ = __mul__


def select_point(mask, a, b):
    """Batched conditional select over two points of the same type
    (conditional_select, src/lib.rs:106-125, :314-343)."""
    return map_point(lambda x, y: torch.where(mask, x, y), a, b)


def batch_normalize(p: ExtendedPoint) -> AffinePoint:
    """Extended -> affine for a whole batch with ONE field inversion
    (src/lib.rs:1077-1107).  Works for any batch shape, including scalars."""
    if p.shape == ():
        aff = batch_normalize(map_point(lambda x: x[:, None], p))
        return map_point(lambda x: x[:, 0], aff)
    zl = p.z.limbs.reshape((NLIMBS, -1))
    zinv = Fq(mont.batch_invert(FQ_SPEC, zl, axis=1).reshape(p.z.limbs.shape))
    return AffinePoint(u=p.u * zinv, v=p.v * zinv)


def reduce_sum(p: ExtendedPoint, axis: int,
               sequential: bool = False) -> ExtendedPoint:
    """Point-addition reduction over one batch axis (the axis is removed).

    Default: a log-depth tree, halves added pairwise with an odd element
    carried along.  ``sequential=True`` folds from the first element in
    order instead.  The order of additions is the reference package's, so
    results agree with it limb for limb."""
    axis = axis % len(p.shape)
    larr = axis + 1  # limb axis is 0 on the raw planes
    n = p.shape[axis]
    if sequential:
        acc = map_point(lambda x: x.select(larr, 0), p)
        for i in range(1, n):
            acc = acc.add_extended_niels(
                map_point(lambda x: x.select(larr, i), p).to_niels())
        return acc
    while n > 1:
        half = n // 2
        lo = map_point(lambda x: x.narrow(larr, 0, half), p)
        hi = map_point(lambda x: x.narrow(larr, half, half), p)
        s = lo.add_extended_niels(hi.to_niels())
        if n % 2:
            s = map_point(
                lambda a, b: torch.cat([a, b.narrow(larr, 2 * half, 1)],
                                       dim=larr), s, p)
        p = s
        n = p.shape[axis]
    return map_point(lambda x: x.squeeze(larr), p)


def segment_sum(p: ExtendedPoint, offsets: torch.Tensor) -> ExtendedPoint:
    """Sums of contiguous segments of a batch of shape (N,).

    ``offsets``: int64 (S + 1,), nondecreasing from 0 to N; segment ``s`` is
    the lanes ``[offsets[s], offsets[s + 1])``.  Returns a batch of shape
    (S,): each segment's sum, the identity for an empty segment.

    A segmented inclusive scan in the manner of Hillis and Steele.  At step
    d = 0, 1, ..., every lane i at least 2^d lanes past the start of its
    segment becomes ``acc[i - 2^d] + acc[i]``: the earlier partial sum adds
    the later one as an extended Niels point.  After ceil(log2 L) steps, L
    the longest segment, a segment's last lane holds its sum.  The lanes are
    sorted once by how far into their segment they lie, so that each step
    adds only the lanes that take part: sum over the segments of
    max(0, length - 2^d) at step d, worked out on the host from the
    offsets' copy there.  So offsets that lie on the host make the scan wait
    for nothing on the card (they go up once, pinned); offsets that lie on
    the card are read back once.  The launches grow with log2 L, not with
    N.  Stage mark (``stages``): "segment_sum"."""
    if len(p.shape) != 1:
        raise ValueError(f"segment_sum: expected a batch of shape (N,), got "
                         f"{p.shape}")
    if (offsets.ndim != 1 or offsets.shape[0] < 1
            or offsets.is_floating_point()):
        raise ValueError(f"segment_sum: offsets must be integers (S + 1,), "
                         f"got {offsets.dtype} {tuple(offsets.shape)}")
    dev = p.device
    (n,), nseg = p.shape, offsets.shape[0] - 1
    host = offsets.to(device="cpu", dtype=torch.int64)
    lengths = host.diff()
    longest = int(lengths.max()) if nseg else 0
    counts = [int((lengths - (1 << d)).clamp_(min=0).sum())
              for d in range(max(longest - 1, 0).bit_length())]
    if offsets.device != dev:
        offsets = (host.pin_memory() if dev.type == "cuda" else host).to(
            dev, non_blocking=True)
    offsets = offsets.to(torch.int64)
    ident = ExtendedPoint.identity((nseg,), dev)
    if n == 0 or nseg == 0:
        stages.mark("segment_sum")
        return ident
    lane = torch.arange(n, device=dev)
    seg = torch.searchsorted(offsets[1:], lane, right=True).clamp(max=nseg - 1)
    pos = lane - offsets[seg]  # lanes into the segment
    order = torch.argsort(pos, descending=True, stable=True)
    acc = map_point(lambda x: x.clone(), p)
    for d, cnt in enumerate(counts):
        idx = order[:cnt]
        lo = map_point(lambda x: x[:, idx - (1 << d)], acc)
        hi = map_point(lambda x: x[:, idx], acc)
        s = lo.add_extended_niels(hi.to_niels())
        for c in dataclasses.fields(ExtendedPoint):
            getattr(acc, c.name).limbs.index_copy_(
                1, idx, getattr(s, c.name).limbs)
    last = (offsets[1:] - 1).clamp(min=0, max=n - 1)
    out = select_point(offsets[1:] > offsets[:-1],
                       map_point(lambda x: x[:, last], acc), ident)
    stages.mark("segment_sum")
    return out


# -- Named constant points --------------------------------------------------

def full_generator(shape=(), device=None) -> AffinePoint:
    """Full-curve generator: lowest positive v with even u
    (src/lib.rs:1380-1396)."""
    return AffinePoint.from_raw_unchecked(
        oracle.GENERATOR_U, oracle.GENERATOR_V, shape, device)


def subgroup_generator(shape=(), device=None) -> AffinePoint:
    """Prime-order-subgroup generator = full generator * cofactor
    (src/lib.rs:1304-1306)."""
    return AffinePoint.from_raw_unchecked(*oracle.SUBGROUP_GENERATOR, shape,
                                          device)
