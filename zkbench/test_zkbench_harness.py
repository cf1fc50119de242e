"""CPU tests of the harness: the manifest against the contract, a cell, a
traffic mix and a metric added as files only, the MSM work count by hand, the
trace's reduction, the modules a run loads, and the check failing under the
control and under faults planted in the timed path.  Tiny stand-ins of the
two configurations run the whole harness on the CPU; the test marked `cuda`
runs them on the card and skips here.

    python -m pytest zkbench/test_zkbench_harness.py -q
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from zkbench import manifest, trace, yardstick
from zkbench.control import control
from zkbench.run import run_cell

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = ("plonk-2e20-prove", "kzg-2e22-commit-open")
SEED = 2 ** 31 + 12345


def tiny_root(tmp_path) -> str:
    """A checkout's benchmark with both configurations cut to tiny sizes."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "zkbench"), os.path.join(root, "zkbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load(REPO)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        if "log_gates" in cfg:
            cfg["log_gates"] = 3
        else:
            cfg["coefficients"] = 32
        with open(path, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, trace_on=False, seconds=0.0, seed=SEED):
    return run_cell(root, cell, seed, seconds, trace_on, "cpu", time.time())[0]


# -- the manifest --

def test_manifest_keeps_to_the_contract():
    bench = manifest.load(REPO)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["zkbench"] and bench["command"] == ["python3", "zkbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("zkbench/") and os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["source"].startswith("https://") and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in CELLS:
        cell = manifest.Cell(REPO, bench, w)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_traffic_and_metric_added_as_files_only(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in _files(root) if not p.endswith("BENCHMARK.json")}
    with open(os.path.join(root, "zkbench", "configs", "plonk_mulchain_2e4.json"), "w") as f:
        json.dump({"driver": "plonk_mulchain", "log_gates": 4}, f)
    with open(os.path.join(root, "zkbench", "traffic", "prove_one_witness.json"), "w") as f:
        json.dump({"loop": "closed", "clients": 1, "witness_pool": 1, "check_sample": 1}, f)
    with open(os.path.join(root, "zkbench", "metrics", "proofs.tiny.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.requests)\n")
    bench = manifest.load(root)
    bench["configs"].append({"name": "plonk_mulchain_2e4", "source": "https://example.org",
                             "file": "zkbench/configs/plonk_mulchain_2e4.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "plonk-2e4-one-witness", "config": "plonk_mulchain_2e4",
                               "traffic": "prove_one_witness", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("plonk-2e4-one-witness")
    bench["per_layer"].append({"name": "proofs.tiny", "unit": "proofs", "better": "higher",
                               "source": "program_counter", "layer": "PLONK rounds", "moves": "prove_s",
                               "workloads": ["plonk-2e4-one-witness"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = manifest.Cell(root, bench, "plonk-2e4-one-witness")
    assert cell.config["log_gates"] == 4 and cell.traffic["witness_pool"] == 1
    assert {m["name"] for m in cell.per_layer} == {"proofs.tiny"}
    res = _run(root, "plonk-2e4-one-witness", trace_on=True)
    assert res["correct"] and res["metrics"]["proofs.tiny"]["value"] == 1.0
    res = _run(root, "plonk-2e4-one-witness")
    assert res["correct"] and set(res["metrics"]) == {"prove_s", "setup_s"}
    after = {p: hashlib.sha256(open(p, "rb").read()).hexdigest() for p in before}
    assert after == before


def _files(root):
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" not in d:
                yield os.path.join(d, f)


# -- the yardstick and the trace --

def test_msm_work_count_by_hand():
    # N = 1: c = 1 gives 255 windows of 1 + 2 additions, the fewest
    assert yardstick.bucket_adds(1) == 255 * 3
    # N = 16: c = 1: 255 * 18 = 4590; c = 2: 128 * 22 = 2816; c = 3: 85 * 30 = 2550;
    # c = 4: 64 * 46 = 2944; c = 5: 51 * 78 = 3978
    assert yardstick.bucket_adds(16) == 2550
    # N = 2^20: c = 16: 16 windows of 2^20 + 2^17 - 2 = 18,874,336; c = 15: 17 of 2^20 + 2^16 - 2 =
    # 18,939,870; c = 17: 15 of 2^20 + 2^18 - 2 = 19,660,770
    assert yardstick.bucket_adds(1 << 20) == 16 * ((1 << 20) + (1 << 17) - 2) == 18_874_336
    assert yardstick.bucket_adds(1 << 20, 3) == 3 * yardstick.bucket_adds(1 << 20)
    assert yardstick.msm_muladds(16) == 2550 * 11 * 300 * 2
    assert yardstick.bucket_adds(0) == 0


def test_trace_reduction_takes_the_union_and_names_the_gaps():
    events = [  # (name, start us, end us, on device, thread)
        ("zkbench.window", 0.0, 100.0, False, 1),
        ("aten::mul", 5.0, 30.0, False, 1),
        ("cudaLaunchKernel", 6.0, 7.0, False, 1),
        ("cudaLaunchKernel", 8.0, 9.0, False, 1),
        ("k1", 10.0, 40.0, True, 0),
        ("k2", 20.0, 50.0, True, 0),  # overlaps k1: counted once
        ("aten::item", 55.0, 70.0, False, 1),
        ("other_thread_op", 50.0, 90.0, False, 2),
        ("k1", 70.0, 80.0, True, 0),
    ]
    out = trace.reduce(events, (0.0, 100.0), thread=1)
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["launches"] == 2
    assert out["device_ops"][0] == ["k1", pytest.approx(40e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(10e-6)  # 0-10: midpoint 5 is inside aten::mul
    assert gaps["aten::item"] == pytest.approx(20e-6)  # 50-70
    assert gaps["zkbench.window"] == pytest.approx(20e-6)  # 80-100

    class Ev:
        def __init__(self, name, dev, annotation):
            self.name, self.is_user_annotation, self.thread = name, annotation, 1
            self.device_type = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU
            self.time_range = dataclasses.make_dataclass("T", ["start", "end"])(1.0, 2.0)

    class Prof:
        def events(self):
            return [Ev("zkbench.window", True, True), Ev("zkbench.window", True, False), Ev("k", True, False),
                    Ev("zkbench.window", False, False)]

    got = trace.profiler_events(Prof())
    assert [(e[0], e[3]) for e in got] == [("k", True), ("zkbench.window", False)]


# -- runs of the tiny cells on the CPU --

@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_correct(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check" and all(c["value"] == 0 for k, c in res["check"].items()
                                            if k.endswith("_wrong"))
    assert set(res["metrics"]) == {"setup_s", "prove_s" if cell.startswith("plonk") else "commit_open_s"}


def test_a_run_loads_neither_jax_nor_zktpu(tiny):
    code = ("import sys, json, time; sys.path.insert(0, sys.argv[1]);"
            "from zkbench.run import run_cell;"
            "r, _ = run_cell(sys.argv[2], 'kzg-2e22-commit-open', 7, 0.0, False, 'cpu', time.time());"
            "print(json.dumps([r['correct'], sorted({m.split('.')[0] for m in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", code, REPO, tiny], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "zktpu_torch" in tops and "zkbench" in tops
    assert not {"jax", "jaxlib", "flax", "zktpu"} & set(tops)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import zkbench.reference.plonk, zkbench.reference.kzg;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, REPO], capture_output=True, text=True, timeout=300)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not {"zktpu_torch", "zktpu", "jax"} & tops


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(tiny, cell):
    out = control(tiny, cell, SEED, 3, 128, torch.device("cpu"))
    assert not out["correct"] and out["check"]["commitments_wrong"]["value"] > 0


def _plonk_fault(kind, monkeypatch):
    from zktpu_torch.kzg.scheme import KzgScheme
    from zktpu_torch.plonk import prover

    if kind == "half of each commitment's scalars left out":
        orig = KzgScheme.commit_coeffs
        monkeypatch.setattr(KzgScheme, "commit_coeffs",
                            lambda self, c: orig(self, c[: max(1, c.shape[0] // 2)]))
    elif kind == "an answer altered where it is produced":
        orig = prover.generate_proof

        def altered(*a, **k):
            proof = orig(*a, **k)
            proof.bar_a = (proof.bar_a + 1) % (2 ** 255)
            return proof
        monkeypatch.setattr(prover, "generate_proof", altered)


def _kzg_fault(kind, monkeypatch):
    from zktpu_torch.kzg.scheme import KzgScheme

    if kind == "half of each commitment's scalars left out":
        orig = KzgScheme.commit_coeffs
        monkeypatch.setattr(KzgScheme, "commit_coeffs",
                            lambda self, c: orig(self, c[: max(1, c.shape[0] // 2)]))
    elif kind == "an answer altered where it is produced":
        orig = KzgScheme.open

        def altered(self, poly, z):
            op = orig(self, poly, z)
            op.evaluation += 1
            return op
        monkeypatch.setattr(KzgScheme, "open", altered)


FAULTS = ("a request that returns the state it was given", "half of each commitment's scalars left out",
          "an answer altered where it is produced")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_timed_path_fails_the_check(tiny, cell, fault, monkeypatch):
    cls = manifest.Cell(tiny, manifest.load(tiny), cell).driver.Cell
    if fault == FAULTS[0]:  # every request hands back the answer of one made before the window
        warm, request = cls.warm, cls.request

        def stale_warm(self):
            warm(self)
            self._stale = request(self, -1)
        monkeypatch.setattr(cls, "warm", stale_warm)
        monkeypatch.setattr(cls, "request", lambda self, i: self._stale)
    else:
        (_plonk_fault if cell.startswith("plonk") else _kzg_fault)(fault, monkeypatch)
    res = _run(tiny, cell)
    assert not res["correct"]
    assert sum(c["value"] for k, c in res["check"].items() if k.endswith("_wrong")) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run_cell(tiny, cell, SEED, 1.0, True, torch.device("cuda", 0), time.time())[0]
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert not control(tiny, cell, SEED, 3, 128, torch.device("cuda", 0))["correct"]
