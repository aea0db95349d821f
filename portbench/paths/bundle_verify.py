"""Timed path of a node's Sapling bundle validation (Zcash Protocol Spec
4.4, 4.5, 4.13, 5.4.7 and B.1; zcash/redjubjub's ``batch::Verifier``):
``jubjub_tpu_torch.verify_bundles`` over a batch of transactions.

One batch: the encodings of every spend's cv, rk and R, every output's cv
and epk and every binding signature's R, the transactions' offsets and
valueBalance, and the scalars z, z c and z S of every signature go up to the
card (span ``upload``); ``verify_bundles`` decodes, applies the small-order
rule, forms and encodes each bvk and sums the batch equation (span
``validate``); ``ok``, every repr(bvk), the equation's encoding and its two
basepoint coefficients come back to the host (span ``download``).  The products z c and z S are formed on the
host when the batch is made, as the crate forms them on the CPU.
"""

from __future__ import annotations

import torch

from jubjub_tpu_torch import verify_bundles

INPUTS = ("spends", "outputs", "binding_r", "spend_offsets", "output_offsets",
          "value_balance", "spend_scalars", "binding_scalars")


def prepare(pool: dict, device) -> dict:
    """What the window reuses: the device and the three basepoints (the
    fixed-base table of V is built at the first batch)."""
    return {"device": torch.device(device), "bases": pool["bases"]}


def run_batch(state: dict, batch: dict, span) -> dict:
    """One batch through the timed path; returns the host's copies: ``ok``,
    bool (T,), repr(bvk), uint8 (32, T), the equation's encoding, uint8
    (32,), and its basepoints' coefficients, uint8 (32, 2)."""
    dev = state["device"]
    with span("upload"):
        args = [batch[k].to(dev, non_blocking=True) for k in INPUTS]
    with span("validate"):
        ok, bvk, result, coeffs = verify_bundles(*args, state["bases"])
    with span("download"):
        return {"ok": ok.cpu(), "bvk": bvk.cpu(), "result": result.cpu(),
                "coeffs": coeffs.cpu()}
