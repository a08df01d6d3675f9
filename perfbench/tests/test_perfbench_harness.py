"""The harness: cells, mixes, configurations and metrics found by name from
new files alone; no measurement without a card; and the comparison that
decides ``correct``, driven on the CPU at a small size with the timed path
broken underneath (each fault a cell can have) and with the control, the
reference one precision below the configuration's, in the program's place."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness, judge
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**35 + 3


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "modelnet_nolbo.json").read_text())
    (bench_dir / "configs" / "modelnet_nolbo_z32.json").write_text(json.dumps(dict(cfg, name="modelnet_nolbo_z32")))
    mix = json.loads((bench_dir / "traffic" / "train_b32.json").read_text())
    (bench_dir / "traffic" / "train_b16.json").write_text(json.dumps(dict(mix, batch=16)))
    (bench_dir / "metrics" / "steps_a_second.train.py").write_text(
        "def read(ctx):\n    return ctx.counts['steps'] / ctx.counts['window_s']\n")
    bench["configs"].append(dict(bench["configs"][0], name="modelnet_nolbo_z32",
                                 file="perfbench/configs/modelnet_nolbo_z32.json"))
    bench["workloads"].append({"name": "modelnet_nolbo_z32.train_b16", "config": "modelnet_nolbo_z32",
                               "traffic": "train_b16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_a_second.train", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "train step", "moves": "train_samples_per_s",
                               "workloads": ["modelnet_nolbo_z32.train_b16"]})
    bench["end_to_end"][0]["workloads"].append("modelnet_nolbo_z32.train_b16")

    cell = harness.find_cell(bench, "modelnet_nolbo_z32.train_b16", bench_dir)
    assert cell.config["name"] == "modelnet_nolbo_z32" and cell.traffic["batch"] == 16
    assert [m["name"] for m in cell.per_layer] == ["steps_a_second.train"]
    assert "train_samples_per_s" in [m["name"] for m in cell.end_to_end]
    assert harness.driver_class(cell.traffic["kind"]).__module__ == "perfbench.drivers.train"
    reader = harness.metric_reader("steps_a_second.train", bench_dir)
    assert reader(type("Ctx", (), {"counts": {"steps": 30, "window_s": 2.0}})) == 15.0
    # the same quantity split by a new rate it moves needs no file: the unsuffixed reader reads it
    assert not (bench_dir / "metrics" / "host_batch_ms.b16.py").exists()
    reader = harness.metric_reader("host_batch_ms.b16", bench_dir)
    assert reader(type("Ctx", (), {"spans": {"train.batch_host": [10.0, 30.0]}})) == 20.0
    after = _digests(bench_dir)
    assert all(after[p] == d for p, d in before.items())  # no file that was there changed


def _run(cwd: Path, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "modelnet_nolbo.train_b32", "--seed", "5",
           "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_refuses_to_measure_without_a_card():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""  # no result line, so no CPU number under any metric
    assert "CUDA card" in proc.stderr


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _train(workload, faults=()):
    cell = tiny.cell(workload)
    drv = harness.driver_class("train")(cell, SEED, "cpu", faults=faults)
    drv.setup()
    drv.release()
    numbers, ref = drv.check()
    return cell, drv, numbers, ref


TRAIN = ["modelnet_nolbo.train_b32", "pascal_nolbo.train_b32_ms", "modelnet_nolbo.train_b32_f32"]


@pytest.mark.parametrize("workload", TRAIN)
def test_train_cell_is_correct_and_each_fault_fails_it(workload):
    cell, _, numbers, _ = _train(workload)
    assert judge.verdict(numbers, cell.limits)[0], numbers
    for fault in ("unchanged", "half"):
        _, _, bad, _ = _train(workload, (fault,))
        assert not judge.verdict(bad, cell.limits)[0], (fault, bad)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails(workload):
    cell, drv, _, ref = _train(workload)
    control = drv.reference(cell.traffic["control"])
    assert not judge.verdict(judge.train_numbers(control, ref), cell.limits)[0]


def _serve(faults=()):
    cell = tiny.cell("modelnet_nolbo.serve_b32_anytime")
    drv = harness.driver_class("serve")(cell, SEED, "cpu", faults=faults)
    drv.setup()
    drv.window(1.0)
    drv.release()
    return cell, drv, drv.check()[0]


def test_serve_cell_is_correct_and_each_fault_fails_it():
    cell, drv, numbers = _serve()
    assert judge.verdict(numbers, cell.limits)[0], numbers
    ids = drv.sample()
    control = drv.judge_answers(ids, drv.control_answers(ids, cell.traffic["control"]))
    assert not judge.verdict(control, cell.limits)[0], control
    for fault in ("category", "rows", "bits"):
        assert not judge.verdict(_serve((fault,))[2], cell.limits)[0], fault


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["modelnet_nolbo.train_b32", "modelnet_nolbo.serve_b32_anytime"])
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "perfbench/run.py", "--workload", workload, "--seed", "12345678901", "--seconds", "2",
           "--trace", "0"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert "setup_s" in out["metrics"] and list(out)[-1] == "checks"
