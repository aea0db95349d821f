"""The harness: the manifest and the files it names, a new cell made of new
files only, and ``correct`` coming out false when the timed path is broken
underneath (the program's plain versions on the CPU, the rest of a run as
the card would run it)."""

import json
import os
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

import jubjub_tpu_torch as jj
from jubjub_tpu_torch.curve import encoding
from jubjub_tpu_torch.curve.points import ExtendedPoint
from jubjub_tpu_torch.ops import ladder

from portbench import control, generate, harness

import portbench_tiny as tiny

ROOT, BENCH = harness.ROOT, harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.read_json(ROOT, "BENCHMARK.json")


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in manifest[sec]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for w in manifest["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in manifest["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_file_a_cell_names_exists(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["why"] == w["why"]
        kind = cell.config["path"]
        assert cell.mix["kind"] == kind
        for sub in ("paths", "reference", "generators"):
            assert os.path.exists(os.path.join(BENCH, sub, f"{kind}.py"))
        assert harness.load_module("reference", kind).READINGS
        gen = harness.load_module("generators", kind)
        assert set(cell.mix) == {"kind", *gen.PARAMS}
        got = cell.metrics
        assert "setup_s" in {m["name"] for m in got["end_to_end"]}
        rates = [m["name"] for m in got["end_to_end"]
                 if m["unit"].endswith("/s")]
        assert len(rates) == 1, (w["name"], rates)
        assert len(got["end_to_end"]) >= 2 and got["per_layer"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = harness.cell_metrics(manifest, cell)["end_to_end"]
            assert m["moves"] in {x["name"] for x in moved}


def test_a_new_cell_needs_only_new_files(tmp_path, manifest):
    """A copy of the benchmark's files with a new traffic mix, a new cell
    and a new metric's reader added as files, and entries in the manifest:
    the harness runs the cell and reads the metric."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "traffic" / "scan-tiny.json").write_text(json.dumps(
        dict(harness.read_json(BENCH, "traffic", "scan-batch1m-1ivk.json"),
             outputs=24, invalid=3)))
    (bench / "workloads" / "scan-tiny.json").write_text(json.dumps(
        {"config": "sapling-ivk-scan", "traffic": "scan-tiny", "chips": 1,
         "why": "a test's cell"}))
    (bench / "metrics" / "batches_in_window.py").write_text(
        "def read(run):\n    return len(run.batches)\n")
    m = json.loads(json.dumps(manifest))
    m["workloads"].append({"name": "scan-tiny", "config": "sapling-ivk-scan",
                           "traffic": "scan-tiny", "chips": 1,
                           "why": "a test's cell"})
    m["end_to_end"].append({"name": "batches_in_window", "unit": "batches",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock", "workloads": ["scan-tiny"]})
    for x in m["end_to_end"]:
        if x["name"] == "scan_outputs_per_s":
            x["workloads"].append("scan-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.load_cell("scan-tiny", str(tmp_path))
    assert cell.bench == str(bench)
    res = harness.run_cell(cell, tiny.SEED, 0.0, False, device="cpu")
    assert res["correct"]
    assert res["metrics"]["batches_in_window"]["value"] == 2
    assert set(res["metrics"]) == {"batches_in_window", "scan_outputs_per_s",
                                   "setup_s"}


def _metric_files(bench) -> dict:
    return {p.name: p.read_bytes()
            for p in pathlib.Path(bench, "metrics").glob("*.py")}


# kind copied -> (its configuration, its traffic mix at a tiny size)
KINDS = {
    "ivk_scan": ("sapling-ivk-scan", "scan-batch1m-1ivk",
                 dict(outputs=24, invalid=3)),
    "batch_verify": ("redjubjub-batch-verify", "verify-batch512k",
                     dict(signatures=12)),
}


@pytest.mark.parametrize("kind, rate", [
    ("ivk_scan", "scan_outputs_per_s"),
    ("batch_verify", "verify_sigs_per_s"),
    ("ivk_scan", "verify_sigs_per_s"),
    ("ivk_scan", "new_per_s"),
])
def test_a_new_kind_of_path_needs_only_new_files(tmp_path, manifest, kind,
                                                 rate):
    """A new kind of deployment, with its path, reference (its controls
    and faults with it) and generator as new files, a configuration and a
    traffic mix naming it, and a cell: the harness runs the cell and
    reports the rate, and the controls run over it.  A rate the benchmark
    has is reported through the cell's entry and its name in the rate's
    ``workloads`` alone, with no file under ``metrics/`` added or edited; a
    rate it has not (``new_per_s``) brings its reader."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    config, mix, tiny_sizes = KINDS[kind]
    for sub in ("paths", "reference", "generators"):
        shutil.copy(bench / sub / f"{kind}.py", bench / sub / "new_kind.py")
    (bench / "configs" / "new-config.json").write_text(json.dumps(
        dict(harness.read_json(BENCH, "configs", f"{config}.json"),
             name="new-config", path="new_kind")))
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(
        dict(harness.read_json(BENCH, "traffic", f"{mix}.json"),
             kind="new_kind", **tiny_sizes)))
    (bench / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "new-config", "traffic": "new-mix", "chips": 1,
         "why": "a test's cell"}))
    m = json.loads(json.dumps(manifest))
    m["configs"].append(dict(m["configs"][0], name="new-config",
                             file="portbench/configs/new-config.json"))
    m["workloads"].append({"name": "new-cell", "config": "new-config",
                           "traffic": "new-mix", "chips": 1,
                           "why": "a test's cell"})
    if rate == "new_per_s":
        (bench / "metrics" / "new_per_s.py").write_text(
            "def read(run):\n    return run.work_done / run.window_s\n")
        m["end_to_end"].append({"name": "new_per_s", "unit": "outputs/s",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["new-cell"]})
    else:
        for x in m["end_to_end"]:
            if x["name"] == rate:
                x["workloads"].append("new-cell")
        assert _metric_files(bench) == _metric_files(BENCH)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.load_cell("new-cell", str(tmp_path))
    res = harness.run_cell(cell, tiny.SEED, 0.0, False, device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["metrics"][rate]["value"] > 0
    out = control.readings(cell, tiny.SEED, 0.0, "cpu")
    assert len(out) == 4 and not any(r["correct"] for r in out)


def test_a_mix_with_a_key_no_generator_reads_is_refused():
    c = tiny.scan(callers=8)
    with pytest.raises(ValueError, match="callers"):
        harness.run_cell(c, tiny.SEED, 0.0, False, device="cpu")


def test_every_array_of_the_pool_becomes_a_tensor():
    for make in (tiny.scan, tiny.verify):
        c = make()
        pool = generate.pin(generate.pool(c.mix, c.config, tiny.SEED, "cpu"),
                            "cpu")
        for batch in pool["batches"]:
            assert not any(isinstance(v, np.ndarray) for v in batch.values())
            assert isinstance(batch["enc"], torch.Tensor)


# -- faults planted under the timed path ---------------------------------------

def _flip_first_byte(orig):
    """The encoder with byte 0 of every encoding it makes altered."""
    def altered(p):
        b = orig(p)
        b[0] ^= 1
        return b
    return altered


def _scan_half_path():
    path = harness.load_module("paths", "ivk_scan")
    real = path.run_batch

    def run_batch(state, batch, span):
        n = batch["enc"].shape[1]
        half = dict(batch, enc=batch["enc"][:, :n // 2].contiguous())
        out = real(state, half, span)
        sec = torch.zeros(out["secrets"].shape[:2] + (n,), dtype=torch.uint8)
        sec[:, :, :n // 2] = out["secrets"]
        ok = torch.zeros(n, dtype=torch.bool)
        ok[:n // 2] = out["ok"]
        return {"secrets": sec, "ok": ok}
    path.run_batch = run_batch
    return path


SCAN_FAULTS = {
    "state unchanged": lambda mp: mp.setattr(ladder, "mul_const_fused",
                                             lambda p, k: p),
    "an answer altered": lambda mp: mp.setattr(
        encoding, "affine_to_bytes", _flip_first_byte(encoding.affine_to_bytes)),
}


@pytest.mark.parametrize("fault", sorted(SCAN_FAULTS))
def test_scan_fault_is_not_correct(fault, monkeypatch):
    SCAN_FAULTS[fault](monkeypatch)
    res = harness.run_cell(tiny.scan(), tiny.SEED, 0.0, False, device="cpu")
    assert not res["correct"], res["checks"]


def test_scan_half_the_batch_left_out_is_not_correct():
    res = harness.run_cell(tiny.scan(), tiny.SEED, 0.0, False, device="cpu",
                           path=_scan_half_path())
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


def _msm_half(orig):
    def half(points, scalars):
        n = points.shape[0] // 2
        sub = ExtendedPoint(*[type(getattr(points, c))(getattr(points, c).limbs[:, :n])
                              for c in ("u", "v", "z", "t1", "t2")])
        return orig(sub, type(scalars)(scalars.limbs[:, :n]))
    return half


VERIFY_FAULTS = {
    "state unchanged": lambda mp: mp.setattr(
        jj, "msm_fused", lambda p, k: ExtendedPoint.identity((), p.device)),
    "half the batch left out": lambda mp: mp.setattr(
        jj, "msm_fused", _msm_half(jj.msm_fused)),
    "an answer altered": lambda mp: mp.setattr(
        encoding, "affine_to_bytes", _flip_first_byte(encoding.affine_to_bytes)),
}


@pytest.mark.parametrize("fault", sorted(VERIFY_FAULTS))
def test_verify_fault_is_not_correct(fault, monkeypatch):
    VERIFY_FAULTS[fault](monkeypatch)
    res = harness.run_cell(tiny.verify(), tiny.SEED, 0.0, False, device="cpu")
    assert not res["correct"], res["checks"]


# -- the controls, at a size a test run holds ----------------------------------

@pytest.mark.parametrize("make", [tiny.scan, tiny.verify])
def test_controls_and_faults_in_the_programs_place_are_not_correct(make):
    out = control.readings(make(), tiny.SEED, 0.0, "cpu")
    assert len(out) == 4
    for r in out:
        assert not r["correct"], r
        assert any(v > 0 for v in r["checks"].values())


def test_controls_on_the_card():
    """The controls and faults at every cell's own sizes, on the card (on
    more seeds: ``portbench/control.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls at the cells' sizes")
    for w in harness.read_json(ROOT, "BENCHMARK.json")["workloads"]:
        for r in control.readings(harness.load_cell(w["name"]), tiny.SEED,
                                  0.0, "cuda"):
            assert not r["correct"], r
