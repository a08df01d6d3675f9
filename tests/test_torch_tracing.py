"""PyTorch port, the program's spans (``utils/profiling.py``) on the CPU:
off, no ``record_function`` is entered; under ``torch.profiler`` with every
thread profiled, a prefetched ``Trainer`` run and a ``MicroBatcher`` over
the packed serving program write each stage's span on the thread that does
the work; a profiler started or stopped inside an open span leaves the
trace well formed; and ``torch.export`` of the serving program under a
running profiler captures no profiler op."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from anytime3d_tpu_torch.cli.train import build_batch_fn
from anytime3d_tpu_torch.data.modelnet import SyntheticVoxelLoader
from anytime3d_tpu_torch.data.packing import pack_voxels
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.serving.batcher import MicroBatcher
from anytime3d_tpu_torch.serving.export import export_infer, load_infer, make_packed_infer
from anytime3d_tpu_torch.train.state import create_train_state
from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig
from anytime3d_tpu_torch.utils import profiling

DIM, Z, CAT, B = 32, 8, 5, 2
ITEM = (DIM, DIM, DIM, 1)
STEPS = 3

MAIN = ("trainer.batch_wait", "trainer.step", "trainer.fetch", "trainer.log", "step.forward", "step.backward",
        "step.update", "model.encode", "model.decode")
WORKER = ("prefetch.make", "prefetch.stage", "batch.pack")
DISPATCHER = ("batcher.collect", "batcher.assemble", "batcher.h2d", "batcher.launch", "batcher.backpressure",
              "serve.unpack", "serve.classify", "serve.pack", "model.encode", "model.decode")
COMPLETER = ("batcher.fetch", "batcher.resolve")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per machine
    yield
    torch.set_num_threads(saved)


def tiny():
    """``modelnet_nolbo``'s layout at 32^3 with narrow filters."""
    base = configs.modelnet_nolbo(z_dim=Z, category_dim=CAT)
    return dataclasses.replace(
        base,
        encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32)),
        decoder=dataclasses.replace(base.decoder, output_shape=ITEM, filter_nums=(32, 16, 16, 8, 1)),
        prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, Z)),
    )


def trainer(steps=STEPS, depth=2, step_fn=None):
    """A prefetched trainer over packed batches of procedural shapes, as ``cli/train.py`` builds it."""
    model = MultiModalVAE(tiny(), generator=torch.Generator().manual_seed(0))
    loader = SyntheticVoxelLoader(num_samples=8, dim=DIM, num_classes=CAT, num_inst=3, seed=0)
    tr = Trainer(model, create_train_state(model), build_batch_fn(loader, model.config, B, packed=True),
                 loss_config=configs.loss_config("modelnet_nolbo"),
                 config=TrainerConfig(total_steps=steps, eval_every=0, log_every=1, prefetch_depth=depth))
    if step_fn is not None:
        tr.step_fn = step_fn(tr.step_fn)
    return tr


def profiler():
    """``torch.profiler`` on the CPU with every thread recorded, as the benchmark's tracer runs it."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=_ExperimentalConfig(profile_all_threads=True))


def spans(prof, tmp_path):
    """{span name: [(tid, ts, dur), ...]} of the program's spans in ``prof``'s Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            assert float(e["dur"]) >= 0.0, e
            out.setdefault(e["name"], []).append((e["tid"], float(e["ts"]), float(e["dur"])))
    return out


# ---------------------------------------------------------------- off


def test_off_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler on")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span("trainer.step") is profiling.span("batcher.launch")  # one shared no-op
    tr = trainer(steps=2)
    tr.run()
    assert tr.state.step == 2 and len(tr.history) == 2
    with MicroBatcher(make_packed_infer(tr.model, ITEM), B, (DIM**3 // 8,), Z, input_dtype=np.uint8,
                      device="cpu") as mb:
        out = mb.submit(pack_voxels(np.ones((1, *ITEM), np.float32))[0]).result(timeout=120)
    assert out["pred_packed"].shape == (DIM**3 // 8,)


# ---------------------------------------------------------------- the trainer's spans


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 3-step trainer run at prefetch depth 2 under the profiler: (trace spans, main thread id)."""
    tr = trainer()
    with profiler() as prof:
        tr.run()
    assert tr.state.step == STEPS
    return spans(prof, tmp_path_factory.mktemp("trainer")), threading.get_native_id()


@pytest.mark.parametrize("name", MAIN + WORKER)
def test_trainer_run_writes_each_span_on_its_thread(trained, name):
    found, main = trained
    tids = {tid for tid, _, _ in found.get(name, [])}
    assert tids, f"no {name} span"
    if name in MAIN:
        assert tids == {main}, name
    else:  # the prefetcher's worker makes and stages the batches
        assert main not in tids and len(tids) == 1, name


def test_each_step_holds_its_stages_in_order(trained):
    found, main = trained
    assert len(found["trainer.step"]) == STEPS
    for _, a, dur in found["trainer.step"]:
        inside = {name: [ts for tid, ts, d in found[name] if a <= ts and ts + d <= a + dur]
                  for name in ("step.forward", "step.backward", "step.update", "model.encode", "model.decode")}
        assert all(len(v) == 1 for v in inside.values()), inside
        assert inside["step.forward"][0] < inside["step.backward"][0] < inside["step.update"][0]
        assert inside["step.forward"][0] <= inside["model.encode"][0] < inside["model.decode"][0]
    # a wait, a step, a fetch and a log line an iteration, on the loop's thread, in that order
    order = sorted((ts, name) for name in MAIN[:4] for _, ts, _ in found[name])
    assert [name for _, name in order] == list(MAIN[:4]) * STEPS


# ---------------------------------------------------------------- the micro-batcher's spans


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Six requests through a CPU ``MicroBatcher`` over the packed program under the profiler."""
    model = MultiModalVAE(tiny(), generator=torch.Generator().manual_seed(1))
    grids = (np.random.default_rng(0).uniform(size=(6, *ITEM)) > 0.7).astype(np.float32)
    with profiler() as prof:
        with MicroBatcher(make_packed_infer(model, ITEM), B, (DIM**3 // 8,), Z, max_wait_s=0.05,
                          input_dtype=np.uint8, max_in_flight=1, device="cpu") as mb:
            futures = [mb.submit(bits) for bits in pack_voxels(grids)]
            results = [f.result(timeout=120) for f in futures]
    assert len(results) == 6 and mb.batches_run >= 3
    return spans(prof, tmp_path_factory.mktemp("batcher")), threading.get_native_id()


@pytest.mark.parametrize("name", DISPATCHER + COMPLETER)
def test_batcher_writes_each_span_on_its_thread(served, name):
    found, main = served
    tids = {tid for tid, _, _ in found.get(name, [])}
    assert len(tids) == 1 and main not in tids, name
    (dispatcher,) = {tid for tid, _, _ in found["batcher.launch"]}
    (completer,) = {tid for tid, _, _ in found["batcher.fetch"]}
    assert dispatcher != completer
    assert tids == ({completer} if name in COMPLETER else {dispatcher}), name


def test_the_serving_program_runs_inside_the_launch(served):
    found, _ = served
    launches = found["batcher.launch"]
    for name in ("serve.unpack", "model.encode", "serve.classify", "model.decode", "serve.pack"):
        assert len(found[name]) == len(launches), name
        for _, ts, dur in found[name]:
            assert any(a <= ts and ts + dur <= a + d for _, a, d in launches), name


# ---------------------------------------------------------------- a profiler inside an open span


@pytest.mark.parametrize("where", ["start", "stop", "both"])
def test_a_profiler_started_or_stopped_inside_a_step_leaves_the_trace_whole(tmp_path, where):
    """As the benchmark's tracer does: the profiler starts inside the
    ``trainer.step`` of step 1 (opened with no profiler) and stops inside
    that of step 3 (opened under it); the spans after the stop record
    nothing and the run goes on."""
    prof = profiler()
    start_at = 1 if where in ("start", "both") else None
    stop_at = 3 if where in ("stop", "both") else None
    if start_at is None:
        prof.start()

    def wrap(step):
        def timed(state, batch, generator=None):
            i = state.step
            out = step(state, batch, generator)
            if i == start_at:
                prof.start()
            if i == stop_at:
                prof.stop()
            return out

        return timed

    tr = trainer(steps=5, step_fn=wrap)
    tr.run()
    if stop_at is None:
        prof.stop()
    assert tr.state.step == 5 and all(np.isfinite(h["loss_total"]) for h in tr.history)
    assert not torch.autograd.profiler._is_profiler_enabled
    found = spans(prof, tmp_path)
    steps = sorted(ts for _, ts, _ in found["trainer.step"])
    # step 0 (profiler on from the start) or steps 2, 3 (started in step 1), up to step 3 where it stops
    want = {"start": 3, "stop": 4, "both": 2}[where]
    assert len(steps) == want
    assert len(found["trainer.fetch"]) == {"start": 4, "stop": 3, "both": 2}[where]


# ---------------------------------------------------------------- torch.export


def test_export_under_a_profiler_captures_no_profiler_op(monkeypatch):
    model = MultiModalVAE(tiny(), generator=torch.Generator().manual_seed(2))
    entered = []

    def recorded(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", recorded)
    with profiler():
        artifact = export_infer(model, (B, *ITEM), packed_input=True, packed_output=True)
        assert entered == []  # no span opened while torch.export traced
        with profiling.span("serve.unpack"):  # though the profiler is on
            pass
    assert entered == ["serve.unpack"]
    program = torch.export.load(__import__("io").BytesIO(artifact))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    grids = (np.random.default_rng(3).uniform(size=(B, *ITEM)) > 0.7).astype(np.float32)
    bits = torch.from_numpy(pack_voxels(grids))
    mask = torch.from_numpy((np.random.default_rng(4).uniform(size=(B, Z)) < 0.5).astype(np.float32))
    got, want = load_infer(artifact)(bits, mask), make_packed_infer(model, ITEM)(bits, mask)
    assert set(got) == set(want)
    for k in want:
        if k in ("category", "pred_packed"):
            assert torch.equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
