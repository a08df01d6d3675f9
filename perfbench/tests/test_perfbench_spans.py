"""The readers of the program's spans (``spans.py``, ``metrics/*.py``) on
small hand-made Chrome traces: a train cell's, with the train loop's thread,
the prefetcher's worker and the autograd engine's thread, and a serve cell's,
with the micro-batcher's dispatcher and completion threads. Each reader
returns its number, and None where its span or the trace is missing."""

import pytest

from perfbench import harness
from perfbench.drivers.common import Readings
from perfbench.tracereader import Trace

MAIN, WORKER, AUTOGRAD, DISPATCHER, COMPLETER = 1, 2, 3, 11, 12
X = dict(ph="X")


def span(name, tid, ts, dur):
    return dict(X, cat="user_annotation", name=name, tid=tid, ts=float(ts), dur=float(dur))


def launch(tid, ts, corr, name="cudaLaunchKernel"):
    return dict(X, cat="cuda_runtime", name=name, tid=tid, ts=float(ts), dur=2.0, args={"correlation": corr})


def device(cat, corr, ts, dur):
    return dict(X, cat=cat, name=f"{cat}_{corr}", ts=float(ts), dur=float(dur), args={"correlation": corr})


def train_events(drop=()):
    """Three steps in the window; the profiler stopped inside the third, so
    the readings cover the two cycles from the first step's start to the third's."""
    events = [
        span("perfbench.window", MAIN, 0, 1000),
        span("trainer.batch_wait", MAIN, 10, 20),  # before the first cycle: left out
        span("trainer.step", MAIN, 40, 200), span("model.encode", MAIN, 50, 30), span("model.decode", MAIN, 90, 20),
        span("trainer.fetch", MAIN, 250, 30),
        span("trainer.batch_wait", MAIN, 300, 40),
        span("trainer.step", MAIN, 350, 200), span("model.encode", MAIN, 360, 30), span("model.decode", MAIN, 400, 20),
        span("trainer.batch_wait", MAIN, 600, 60),
        span("trainer.step", MAIN, 700, 200), span("model.encode", MAIN, 705, 30),
        launch(MAIN, 55, 1), launch(MAIN, 95, 2), launch(MAIN, 365, 3), launch(MAIN, 405, 4), launch(MAIN, 710, 5),
        device("kernel", 1, 100, 100), device("kernel", 2, 200, 50), device("kernel", 3, 420, 80),
        device("kernel", 4, 500, 40), device("kernel", 5, 750, 90),
        # the backward's launches, on the autograd engine's thread while a step is open
        dict(X, cat="cpu_op", name="autograd::engine::evaluate_function: ConvolutionBackward0", tid=AUTOGRAD,
             ts=150.0, dur=50.0),
        launch(AUTOGRAD, 160, 6), launch(AUTOGRAD, 460, 7), device("kernel", 6, 260, 70), device("kernel", 7, 560, 30),
        # the prefetcher's copies on its worker thread, one a cycle; the memset beside the second is not a copy
        span("prefetch.h2d", WORKER, 120, 10), launch(WORKER, 122, 8, "cudaMemcpyAsync"),
        device("gpu_memcpy", 8, 130, 25),
        span("prefetch.h2d", WORKER, 420, 10), launch(WORKER, 421, 9, "cudaMemcpyAsync"),
        launch(WORKER, 424, 10, "cudaMemsetAsync"), device("gpu_memcpy", 9, 430, 35), device("gpu_memset", 10, 470, 5),
    ]
    return [e for e in events if e.get("name") not in drop]


def serve_events(drop=()):
    events = [
        span("perfbench.window", DISPATCHER, 0, 1000),
        span("batcher.assemble", DISPATCHER, 80, 15), span("batcher.h2d", DISPATCHER, 85, 10),
        launch(DISPATCHER, 86, 20, "cudaMemcpyAsync"), device("gpu_memcpy", 20, 90, 50),
        span("batcher.launch", DISPATCHER, 100, 50), span("serve.unpack", DISPATCHER, 105, 10),
        launch(DISPATCHER, 106, 23), device("kernel", 23, 150, 12),
        span("batcher.backpressure", DISPATCHER, 160, 30),
        span("batcher.resolve", COMPLETER, 300, 12),
        span("batcher.assemble", DISPATCHER, 380, 15), span("batcher.h2d", DISPATCHER, 385, 10),
        launch(DISPATCHER, 386, 21, "cudaMemcpyAsync"), device("gpu_memcpy", 21, 390, 40),
        span("batcher.launch", DISPATCHER, 400, 50), span("serve.unpack", DISPATCHER, 405, 10),
        launch(DISPATCHER, 406, 24), device("kernel", 24, 440, 8),
        span("model.encode", DISPATCHER, 415, 20), launch(DISPATCHER, 420, 25), device("kernel", 25, 450, 100),
        span("batcher.backpressure", DISPATCHER, 460, 50),
        span("batcher.resolve", COMPLETER, 600, 8),
        span("batcher.assemble", DISPATCHER, 680, 15), span("batcher.h2d", DISPATCHER, 685, 10),
        launch(DISPATCHER, 686, 22, "cudaMemcpyAsync"), device("gpu_memcpy", 22, 690, 60),
        span("batcher.launch", DISPATCHER, 700, 50),
    ]
    return [e for e in events if e.get("name") not in drop]


def ctx(events):
    return Readings(spans={}, counts={}, trace=Trace(events))


TRAIN = {
    "batch_wait_ms.train": (40 + 60) / 2 / 1e3,
    "h2d_ms.train": (25 + 35) / 2 / 1e3,
    "kernel_launches.train": 6 / 2,  # kernels 1, 2, 6 and 3, 4, 7
    "encode_device_ms.train": (100 + 80) / 2 / 1e3,
    "decode_device_ms.train": (50 + 40) / 2 / 1e3,
}
SERVE = {
    "h2d_ms.serve": (40 + 60) / 2 / 1e3,
    "kernel_launches.serve": 3 / 2,
    "encode_device_ms.serve": 100 / 2 / 1e3,
    "serve_dispatch_ms": (15 + 15 + 10 + 10 + 50 + 50) / 2 / 1e3,
    "serve_backpressure_ms": (30 + 50) / 2 / 1e3,
    "serve_resolve_ms": (12 + 8) / 2 / 1e3,
    "serve_unpack_ms": (12 + 8) / 2 / 1e3,
}
NEW = sorted(set(TRAIN) | set(SERVE) | {"decode_device_ms.serve"})


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_each_reader_reads_the_train_trace(name):
    assert harness.metric_reader(name)(ctx(train_events())) == pytest.approx(TRAIN[name])


@pytest.mark.parametrize("name", sorted(SERVE))
def test_each_reader_reads_the_serve_trace(name):
    assert harness.metric_reader(name)(ctx(serve_events())) == pytest.approx(SERVE[name])


def test_the_suffixes_of_a_reader_read_alike():
    for stem in ("batch_wait_ms", "h2d_ms", "kernel_launches", "encode_device_ms", "decode_device_ms"):
        values = {harness.metric_reader(f"{stem}.{s}")(ctx(train_events())) for s in ("train", "image", "f32")}
        assert len(values) == 1, stem


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_span_or_a_trace_gives_none(name):
    assert harness.metric_reader(name)(Readings(spans={}, counts={}, trace=None)) is None
    # a program without the spans: the same trace without any of them
    bare = [e for e in train_events() + serve_events() if e.get("cat") != "user_annotation"]
    assert harness.metric_reader(name)(ctx(bare)) is None
    # a single unit of work has no cycle to read
    one = [e for e in train_events() if not (e.get("name") == "trainer.step" and e["ts"] > 100)]
    assert harness.metric_reader(name)(ctx(one)) is None


@pytest.mark.parametrize("name,drop", [("decode_device_ms.train", "model.decode"), ("h2d_ms.train", "prefetch.h2d"),
                                       ("batch_wait_ms.train", "trainer.batch_wait"),
                                       ("serve_resolve_ms", "batcher.resolve"),
                                       ("serve_unpack_ms", "serve.unpack"), ("decode_device_ms.serve", "")])
def test_a_missing_span_leaves_its_reader_out_and_the_others_in(name, drop):
    serve = name.startswith("serve") or name.endswith(".serve")
    events, others = (serve_events((drop,)), SERVE) if serve else (train_events((drop,)), TRAIN)
    assert harness.metric_reader(name)(ctx(events)) is None
    for other, want in others.items():
        if other != name:
            assert harness.metric_reader(other)(ctx(events)) == pytest.approx(want), other


def test_every_new_entry_names_a_reader_and_its_cells():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {"train": "modelnet_nolbo.train_b32", "image": "pascal_nolbo.train_b32_ms",
             "f32": "modelnet_nolbo.train_b32_f32", "serve": "modelnet_nolbo.serve_b32_anytime"}
    new = [m for m in bench["per_layer"] if m["source"] == "program_span" and callable(harness.metric_reader(m["name"]))
           and m["name"].split(".")[0] in {n.split(".")[0] for n in NEW}]
    assert len(new) == 23
    for m in new:
        suffix = m["name"].rsplit(".", 1)[1] if "." in m["name"] else "serve"
        assert m["workloads"] == [cells[suffix]], m["name"]
        assert m["better"] == "lower" and entries[m["name"]] is m
