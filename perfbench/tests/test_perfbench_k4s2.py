"""The reader of ``conv_k4s2_roofline``: the lowered stride-2 k=4 conv's
operations and bytes pinned to a row of the port's kernel table, and its
share on a small hand-made trace."""

import math

import pytest

from perfbench import flops, harness
from perfbench.drivers.common import Readings
from perfbench.tracereader import Trace

BF16, F32 = "c10::BFloat16", "float"
READER = harness.metric_reader("conv_k4s2_roofline.train")
_work = READER.__globals__["work"]  # the reader's module is loaded by path, as the harness loads it
OPS = READER.__globals__["OPS"]
X, W, G = [32, 16, 16, 16, 128], [256, 128, 4, 4, 4], [32, 8, 8, 8, 256]


def test_the_first_flagship_stage_of_the_kernel_table():
    # B=32 bf16, 16^3 -> 8^3, 128 -> 256: 68.72 GFLOP in every tap, of which 56.62 GFLOP land on x's grid (30 of
    # the 32 (row, tap) pairs of each axis); bound 0.0573 ms by its operations at 989 TFLOP/s
    ops, nbytes, compute = _work(OPS[0], [X, W], [BF16, F32])
    every_tap = 2 * 32 * 8**3 * 64 * 128 * 256
    assert every_tap == 68_719_476_736
    assert ops == every_tap * (30 / 32) ** 3 == 2 * 32 * 128 * 256 * 30**3 == 56_623_104_000
    assert ops == flops.conv_k2_ops(32, 8, 8, 8, 8 * 128, 256)
    assert nbytes == math.prod(X) * 2 + math.prod(W) * 4 + math.prod(G) * 2
    assert compute == "bf16"
    assert round(flops.bound_s(ops, nbytes, compute) * 1e3, 4) == 0.0573
    assert ops / 989e12 > nbytes / 3.35e12


def test_dx_and_dw_count_the_same_operations():
    fwd = _work(OPS[0], [X, W], [BF16, F32])
    dx = _work(OPS[1], [G, W], [BF16, F32])
    dw = _work(OPS[2], [X, G], [BF16, BF16])
    assert fwd[0] == dx[0] == dw[0]
    assert dx[1] == math.prod(G) * 2 + math.prod(W) * 4 + math.prod(X) * 2
    assert dw[1] == math.prod(X) * 2 + math.prod(G) * 2 + math.prod(W) * 4
    assert _work(OPS[0], [X], [BF16]) is None and _work("anytime3d_torch::conv_k2", [X, W], [BF16, F32]) is None


def _trace(with_ops=True):
    x = dict(ph="X")
    events = [
        dict(x, cat="user_annotation", name="perfbench.window", tid=1, ts=0.0, dur=1000.0),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", tid=1, ts=110.0, dur=5.0, args={"correlation": 7}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", tid=2, ts=310.0, dur=5.0, args={"correlation": 8}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", tid=2, ts=410.0, dur=5.0, args={"correlation": 9}),
        dict(x, cat="kernel", name="conv_k4s2_fwd_wgmma", ts=200.0, dur=139.0, args={"correlation": 7}),
        dict(x, cat="kernel", name="conv_k4s2_fwd_wgmma", ts=400.0, dur=139.0, args={"correlation": 8}),
        dict(x, cat="kernel", name="conv_k4s2_dw_wgmma", ts=600.0, dur=139.0, args={"correlation": 9}),
    ]
    if with_ops:
        events += [
            dict(x, cat="cpu_op", name=OPS[0], tid=1, ts=100.0, dur=50.0,
                 args={"Input Dims": [X, W], "Input type": [BF16, F32]}),
            dict(x, cat="cpu_op", name=OPS[0], tid=1, ts=105.0, dur=40.0,  # the nested call of the CUDA kernel
                 args={"Input Dims": [X, W], "Input type": [BF16, F32]}),
            dict(x, cat="cpu_op", name=OPS[1], tid=2, ts=300.0, dur=50.0,
                 args={"Input Dims": [G, W, []], "Input type": [BF16, F32, "ScalarList"]}),
            dict(x, cat="cpu_op", name=OPS[2], tid=2, ts=400.0, dur=50.0,
                 args={"Input Dims": [X, G], "Input type": [BF16, BF16]}),
        ]
    return Trace(events)


def test_the_reader_on_a_hand_made_trace():
    # three calls of 56.62 GFLOP, each bound at 0.05725 ms, each launching 0.139 ms: 41.19%
    share = READER(Readings(spans={}, counts={}, trace=_trace(), traced_work=1))
    assert share == pytest.approx(100 * 56_623_104_000 / 989e12 / 139e-6, rel=1e-9)
    assert 41.1 < share < 41.2


@pytest.mark.parametrize("trace", [None, "without the ops"])
def test_a_program_without_the_ops_reads_nothing(trace):
    t = _trace(with_ops=False) if trace else None
    assert READER(Readings(spans={}, counts={}, trace=t, traced_work=1)) is None
