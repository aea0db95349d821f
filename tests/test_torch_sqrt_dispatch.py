"""Which square root ``fields/sqrt.py:sqrt`` runs: Fq's goes to the
``fq_sqrt`` kernel for a tensor the kernels take (on the card, outside
``mont.plain_only``), to the plain ``_sqrt_tonelli_shanks`` for any other;
Fr's (p = 3 mod 4) never reaches the kernel.  There is no card here, so the
card is stood in for by ``mont._to_kernel`` answering as it would for a
CUDA tensor; the kernel's wrapper, given a CPU tensor, then computes its
plain version."""

import pytest
import torch

from jubjub_tpu_torch import ops
from jubjub_tpu_torch.fields import Fq, mont
from jubjub_tpu_torch.fields import sqrt as sqrt_mod
from jubjub_tpu_torch.fields.element import FQ_SPEC, FR_SPEC
from jubjub_tpu_torch.ops import sqrt as sqrt_ops

from helpers_torch import CPU, limb_plane, rand_ints, t


def radicands(F):
    return t(limb_plane([v * F.R % F.p for v in rand_ints(40, 6, F.p)]))


@pytest.fixture
def kernel_calls(monkeypatch):
    """The fields that reached ``ops.sqrt.fq_sqrt``, which still computes."""
    calls = []
    real = sqrt_ops.fq_sqrt

    def spy(F, a):
        calls.append(F.name)
        return real(F, a)
    monkeypatch.setattr(sqrt_ops, "fq_sqrt", spy)
    return calls


@pytest.fixture
def as_on_card(monkeypatch):
    monkeypatch.setattr(mont, "_to_kernel",
                        lambda x: not mont._PLAIN_ONLY.get())


def test_cpu_tensor_takes_the_plain_version(kernel_calls):
    a = radicands(FQ_SPEC)
    root, ok = sqrt_mod.sqrt(FQ_SPEC, a)
    want_root, want_ok = sqrt_mod._sqrt_tonelli_shanks(FQ_SPEC, a)
    assert torch.equal(root, want_root) and torch.equal(ok, want_ok)
    Fq(a).sqrt()
    assert kernel_calls == []


def test_card_tensor_takes_the_kernel_but_not_under_plain_only(
        kernel_calls, as_on_card):
    a = radicands(FQ_SPEC)
    root, ok = sqrt_mod.sqrt(FQ_SPEC, a)
    assert kernel_calls == ["Fq"]
    want_root, want_ok = sqrt_mod._sqrt_tonelli_shanks(FQ_SPEC, a)
    assert torch.equal(ok, want_ok)
    assert torch.equal(mont.to_canonical(FQ_SPEC, root),
                       mont.to_canonical(FQ_SPEC, want_root))
    Fq(a).sqrt()
    assert kernel_calls == ["Fq", "Fq"]
    with mont.plain_only():
        sqrt_mod.sqrt(FQ_SPEC, a)
        Fq(a).sqrt()
    assert kernel_calls == ["Fq", "Fq"]


def test_fr_root_never_reaches_the_kernel(kernel_calls, as_on_card):
    a = radicands(FR_SPEC)
    root, ok = sqrt_mod.sqrt(FR_SPEC, a)
    want_root, want_ok = sqrt_mod._sqrt_p34(FR_SPEC, a)
    assert torch.equal(root, want_root) and torch.equal(ok, want_ok)
    assert kernel_calls == []


def test_launch_counts_list_fq_sqrt():
    ops.reset_launch_counts()
    assert ops.launch_counts()["fq_sqrt"] == 0
    sqrt_ops.fq_sqrt(FQ_SPEC, radicands(FQ_SPEC).to(CPU))  # plain: no launch
    assert ops.launch_counts()["fq_sqrt"] == 0
