"""The yardstick's arithmetic: the operations and bytes of a ``conv_k2``
call pinned to a row of the port's kernel table, and each per-layer metric's
reader on a small hand-made trace."""

import math

import pytest

from perfbench import flops, harness, readers
from perfbench.drivers.common import Readings
from perfbench.tracereader import Trace

BF16, F32 = "c10::BFloat16", "float"


def test_conv_k2_row_of_the_kernel_table():
    # B=32 bf16, 16^3, 512 -> 128 (the encoder head's second conv): bound 0.1263 ms, by its operations
    ops, nbytes, compute = flops.conv_k2_work(flops.CONV_K2_OPS[0], [[32, 16, 16, 16, 512], [2, 2, 2, 512, 128]],
                                              [BF16, F32])
    assert ops == 2 * 32 * 512 * 128 * 31**3 == 124_952_510_464
    assert nbytes == 32 * 16**3 * 512 * 2 + 8 * 512 * 128 * 4 + 32 * 16**3 * 128 * 2
    assert compute == "bf16"
    assert round(flops.bound_s(ops, nbytes, compute) * 1e3, 4) == 0.1263
    assert ops / 989e12 > nbytes / 3.35e12


def test_dx_and_dw_count_the_same_operations():
    x, g, w = [32, 16, 16, 16, 512], [32, 16, 16, 16, 128], [2, 2, 2, 512, 128]
    fwd = flops.conv_k2_work(flops.CONV_K2_OPS[0], [x, w], [BF16, F32])
    dx = flops.conv_k2_work(flops.CONV_K2_OPS[1], [g, w], [BF16, F32])
    dw = flops.conv_k2_work(flops.CONV_K2_OPS[2], [x, g], [BF16, BF16])
    assert fwd[0] == dx[0] == dw[0]
    assert dx[1] == math.prod(g) * 2 + math.prod(w) * 4 + math.prod(x) * 2
    assert dw[1] == math.prod(x) * 2 + math.prod(g) * 2 + math.prod(w) * 4
    assert flops.conv_k2_work(flops.CONV_K2_OPS[0], [x], [BF16]) is None


def _trace():
    conv = {"Input Dims": [[32, 16, 16, 16, 512], [2, 2, 2, 512, 128]], "Input type": [BF16, F32]}
    x = dict(ph="X")
    return Trace([
        dict(x, cat="user_annotation", name="perfbench.window", tid=1, ts=0.0, dur=1000.0),
        dict(x, cat="user_annotation", name="perfbench.step", tid=1, ts=0.0, dur=1000.0),
        dict(x, cat="cpu_op", name="anytime3d_torch::conv_k2", tid=1, ts=100.0, dur=50.0, args=conv),
        dict(x, cat="cpu_op", name="anytime3d_torch::conv_k2", tid=1, ts=105.0, dur=40.0, args=conv),  # nested
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", tid=1, ts=110.0, dur=5.0, args={"correlation": 7}),
        dict(x, cat="cuda_runtime", name="cudaMemsetAsync", tid=1, ts=120.0, dur=5.0, args={"correlation": 8}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", tid=1, ts=500.0, dur=5.0, args={"correlation": 9}),
        dict(x, cat="kernel", name="conv_k2_fwd_wgmma", ts=200.0, dur=200.0, args={"correlation": 7}),
        dict(x, cat="gpu_memset", name="Memset", ts=380.0, dur=52.684, args={"correlation": 8}),
        dict(x, cat="kernel", name="elementwise", ts=600.0, dur=100.0, args={"correlation": 9}),
    ])


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.window_us == 1000.0
    assert t.busy_us() == pytest.approx(200.0 + 32.684 + 100.0)
    assert [(round(a, 3), round(b, 3)) for a, b in t.gaps()] == [(0.0, 200.0), (432.684, 600.0), (700.0, 1000.0)]
    ops = dict(t.device_ops())
    assert ops["conv_k2_fwd_wgmma"] == pytest.approx(200e-6) and ops["elementwise"] == pytest.approx(100e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["anytime3d_torch::conv_k2"] == pytest.approx(200e-6)  # the outer call holds t = 100
    assert gaps["perfbench.step"] == pytest.approx((167.316 + 300.0) * 1e-6)
    [(event, us)] = t.launched_by(flops.CONV_K2_OPS)  # the nested call is not counted again
    assert event["dur"] == 50.0 and us == pytest.approx(252.684)


def _ctx(trace=None, traced_work=0, **counts):
    spans = {"train.batch_host": [10.0, 20.0], "train.step_device": [40.0, 50.0], "train.encoder_fwd": [3.0],
             "train.decoder_fwd": [5.0, 7.0], "serve.batch_device": [12.0, 14.0],
             "serve.latency": [float(v) for v in range(1, 101)]}
    return Readings(spans=spans, counts=counts, trace=trace, traced_work=traced_work)


WANT = {"conv_k2_roofline": 50.0, "device_idle_pct": 66.7316, "mfu_pct": 50.0, "host_batch_ms": 15.0,
        "step_device_ms": 45.0, "encoder_fwd_ms": 3.0, "decoder_fwd_ms": 6.0, "serve_batch_device_ms": 13.0,
        "serve_p95_ms": 95.05, "serve_batch_fill": 31.5}
PER_LAYER = [m["name"] for m in harness.load_benchmark()["per_layer"]]


@pytest.mark.parametrize("name", PER_LAYER)
def test_each_metric_reads_the_hand_made_trace(name):
    want = WANT[name.split(".")[0]]
    # the trace is busy 332.684 us over 2 steps; the window ran 2000 steps in its second
    ctx = _ctx(_trace(), traced_work=2, flops=989e12 * 0.5, window_s=1.0, compute="bf16", requests=63000, work=2000)
    assert harness.metric_reader(name)(ctx) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("name", ["conv_k2_roofline.train", "device_idle_pct.serve", "mfu_pct.train",
                                  "serve_batch_fill", "serve_p95_ms"])
def test_a_reader_with_nothing_to_read_gives_none(name):
    ctx = Readings(spans={}, counts={}, trace=None)
    assert harness.metric_reader(name)(ctx) is None


def test_the_bench_has_a_reader_for_each_per_layer_metric():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert readers.percentile(_ctx(), "serve.latency", 50.0) == pytest.approx(50.5)


def test_each_mix_takes_its_mfu_against_a_peak_the_card_has_for_its_work():
    for path in sorted((harness.BENCH / "traffic").glob("*.json")):
        mix = harness.read_json(path)
        peak = mix.get("peak", mix["compute"])
        assert peak in flops.PEAK_FLOPS, path.name
        if mix["compute"] == "f32":  # cuDNN may run its convolutions in TF32: not the 67 TFLOP/s of FFMA
            assert flops.PEAK_FLOPS[peak] == 494.5e12, path.name
