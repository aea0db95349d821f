"""The benchmark's Sapling bundle cell, ``bundle-256k-tx``: its manifest
entries and files, the metrics it reports, a run at a tiny size on the CPU
(the program's plain versions) that comes out correct, each control and
fault of its reference that comes out not correct, and the fixed-base
kernel's frozen bound."""

import json
import os
import re

import pytest

from portbench import control, harness
from portbench.counts import fixed_base

ROOT, BENCH = harness.ROOT, harness.HERE
CELL = "bundle-256k-tx"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = (1 << 31) + 1414213
NEW_METRICS = {"decode_ms.bundle", "checks_ms.bundle", "bvk_ms.bundle",
               "msm_ms.bundle", "fixed_base_roofline", "port_launches.bundle",
               "torch_launches.bundle", "device_idle_pct.bundle"}


@pytest.fixture(scope="module")
def manifest():
    return harness.read_json(ROOT, "BENCHMARK.json")


def tiny_cell() -> harness.Cell:
    """The cell with a pool of one batch of eight transactions of four small
    shapes: one of each invalid kind, one torsion-carrying rk, one S off by
    one."""
    c = harness.load_cell(CELL)
    mix = dict(c.mix, pool=1, invalid_every=1, transactions=8,
               torsion_valid=1, invalid_txs=5,
               shapes=[[1, 2, 1], [0, 2, 1], [2, 2, 1], [1, 5, 1]])
    return harness.Cell(c.name, c.workload, c.config, mix, c.metrics, c.bench)


def test_the_manifest_accepts_the_configuration_traffic_and_cell(manifest):
    conf = {c["name"]: c for c in manifest["configs"]}["sapling-bundle-verify"]
    cell = {w["name"]: w for w in manifest["workloads"]}[CELL]
    assert cell == {"name": CELL, **harness.read_json(BENCH, "workloads",
                                                      f"{CELL}.json")}
    assert cell["config"] == "sapling-bundle-verify" and cell["chips"] == 1
    assert cell["traffic"] == "bundle-batch256k"
    assert 1 <= len(cell["why"]) <= 200 and 1 <= len(conf["why"]) <= 200
    assert 1 <= len(conf["source"]) <= 200
    file = harness.read_json(ROOT, conf["file"])
    assert file["name"] == conf["name"] and file["path"] == "bundle_verify"
    assert file["reduced"] == conf["reduced"] == ["host_scalar_products"]
    assert set(file["sizes"]) == set(file["origin"]) == {
        "point_bytes", "scalar_bytes", "z_bits", "cofactor",
        "value_balance_bits"}
    mix = harness.read_json(BENCH, "traffic", "bundle-batch256k.json")
    gen = harness.load_module("generators", "bundle_verify")
    assert set(mix) == {"kind", *gen.PARAMS}
    assert sum(w for _, _, w in mix["shapes"]) == 256
    for sub in ("paths", "reference", "generators"):
        assert os.path.exists(os.path.join(BENCH, sub, "bundle_verify.py"))
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in manifest[sec]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_the_cell_reports_its_rate_setup_and_eight_new_metrics(manifest):
    got = harness.cell_metrics(manifest, CELL)
    assert {m["name"] for m in got["end_to_end"]} == {"verify_sigs_per_s",
                                                      "setup_s"}
    assert {m["name"] for m in got["per_layer"]} == NEW_METRICS
    for m in got["per_layer"]:
        assert m["moves"] == "verify_sigs_per_s" and m["workloads"] == [CELL]
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))


def test_the_readers_find_nothing_in_an_untraced_run():
    run = harness.Run("bundle_verify", 10, {"transactions": 4}, 1.0,
                      [(0, 0.0, 1.0)])
    for name in NEW_METRICS:
        assert harness.load_module("metrics", name).read(run) is None


def test_a_tiny_run_on_the_cpu_is_correct():
    res = harness.run_cell(tiny_cell(), SEED, 0.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(res["checks"]) == {"ok_mismatch", "bvk_mismatch",
                                  "result_mismatch", "coeff_mismatch"}
    assert set(res["metrics"]) == {"verify_sigs_per_s", "setup_s"}


def _reading(reading, cell, seed, monkeypatch) -> dict:
    """One control or fault of the reference, driven through a run."""
    ref = harness.load_module("reference", "bundle_verify")
    monkeypatch.setattr(ref, "READINGS", {reading: ref.READINGS[reading]})
    real = harness.load_module
    monkeypatch.setattr(harness, "load_module",
                        lambda kind, name, bench=BENCH: ref
                        if kind == "reference" else real(kind, name, bench))
    out = control.readings(cell, seed, 0.0, "cpu")
    assert [r["reading"] for r in out] == [reading]
    return out[0]


@pytest.mark.parametrize("reading", sorted(harness.load_module(
    "reference", "bundle_verify").READINGS))
def test_each_control_and_fault_is_not_correct(reading, monkeypatch):
    out = _reading(reading, tiny_cell(), SEED, monkeypatch)
    assert not out["correct"], out
    assert any(v > 0 for v in out["checks"].values())


@pytest.mark.parametrize("seed", [SEED + 1, SEED + 2, (1 << 32) + 7])
@pytest.mark.parametrize("reading", [
    "fault: the second half of the transactions left out",
    "fault: the second half's points left out, their z S kept"])
def test_transactions_left_out_show_in_a_batch_of_valid_signatures(
        reading, seed, monkeypatch):
    """A batch with no invalid transaction and no bad S: its point is the
    identity whether or not its valid transactions are in the equation, so
    only the coefficients (left out with them) or the point (their points
    left out alone) can show them missing, on every seed."""
    c = tiny_cell()
    mix = dict(c.mix, pool=1, invalid_every=2, invalid_txs=0)
    cell = harness.Cell(c.name, c.workload, c.config, mix, c.metrics, c.bench)
    out = _reading(reading, cell, seed, monkeypatch)
    assert not out["correct"], out
    assert out["checks"]["ok_mismatch"] == out["checks"]["bvk_mismatch"] == 0
    moved = ("coeff_mismatch" if reading.endswith("transactions left out")
             else "result_mismatch")
    assert out["checks"][moved] == 1, out


def test_the_fixed_base_bound_at_the_kernel_tables_shape():
    """PERF.md's kernel table: 1.926 ms at 131072 lanes, set by the scan's
    shared-memory reads (the operations 1.121 ms)."""
    got, by = fixed_base.bound_ms(131072)
    assert by == "shared memory" and round(got, 3) == 1.926
    assert round(fixed_base.peaks.bound_ms(0, 131072 * fixed_base.macs())[0],
                 3) == 1.121
    assert fixed_base.macs() == 31 * 7 * 660
    assert fixed_base.smem_bytes() == 32 * 3 * 10 * 128 * 4
