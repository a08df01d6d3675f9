"""The lowered stride-2 k=4 SAME conv (``kernels/conv_k4s2.py``) on the CPU:
the lowering and its plain ops against ``F.conv3d`` in float64, the routing
of ``Conv3d`` by shape, dtype and device, and the fake kernels under
``torch.export``. The CUDA kernels are held to these plain versions in
``tests/test_torch_cuda.py``."""

import pytest
import torch
import torch.nn.functional as F

from anytime3d_tpu_torch.kernels import conv_k4s2 as k4
from anytime3d_tpu_torch.kernels.conv_k2 import wgmma_plan
from anytime3d_tpu_torch.nn.blocks import Conv3d


def _float64_conv(x, w, g):
    """y, dx and dw of flax's k=4 s=2 SAME conv through ``F.conv3d`` and autograd, as ``Conv3d`` runs it."""
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    pads = []
    for n in reversed(x.shape[1:4]):
        total = max((-(-n // 2) - 1) * 2 + 4 - n, 0)
        pads += [total // 2, total - total // 2]
    y = F.conv3d(F.pad(x.permute(0, 4, 1, 2, 3), pads), w, stride=2).permute(0, 2, 3, 4, 1)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    return y.detach(), dx, dw


@pytest.mark.parametrize("n", [16, 8, 7, 5])
def test_lowering_and_its_plain_ops_equal_conv3d_in_float64(n):
    """Forward, dx and dw: the plain versions, and the op through autograd on the CPU, equal ``F.conv3d``
    and its gradients in float64 (to 1e-12 of the largest entry: the same products summed in another
    order), on even and odd grids and a non-cubic one."""
    gen = torch.Generator().manual_seed(n)
    shape = (2, n, n, n + 2, 6) if n == 8 else (2, n, n, n, 6)
    x = torch.randn(*shape, generator=gen, dtype=torch.float64)
    w = torch.randn(5, 6, 4, 4, 4, generator=gen, dtype=torch.float64)
    out = tuple(-(-s // 2) for s in shape[1:4])
    g = torch.randn(2, *out, 5, generator=gen, dtype=torch.float64)
    y64, dx64, dw64 = _float64_conv(x, w, g)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_op = k4.conv_k4s2(xr, wr)
    dx_op, dw_op = torch.autograd.grad(y_op, (xr, wr), g)
    y_op = y_op.detach()
    got = {"forward": (k4.conv_k4s2_reference(x, w), y_op, y64),
           "dx": (k4.conv_k4s2_dx_reference(g, w, shape[1:4]), dx_op, dx64),
           "dw": (k4.conv_k4s2_dw_reference(x, g), dw_op, dw64)}
    for what, (plain, op, exact) in got.items():
        tol = 1e-12 * float(exact.abs().max())
        assert plain.shape == op.shape == exact.shape, what
        assert float((plain - exact).abs().max()) <= tol, what
        assert float((op - exact).abs().max()) <= tol, what
    assert dw_op.dtype == torch.float64 and k4.conv_k4s2_dw(x.float(), g.float()).dtype == torch.float32
    w2 = k4.lower_weight(w)
    assert w2.shape == (2, 2, 2, 48, 5) and torch.equal(k4.raise_weight(w2), w)
    # W2[bd, bh, bw, (pd, ph, pw, c), n] = w[n, c, 2 bd + pd, 2 bh + ph, 2 bw + pw]
    assert w2[1, 0, 1, (0 * 4 + 1 * 2 + 1) * 6 + 4, 3] == w[3, 4, 2, 1, 3]


# (shape of x, N, dtype, device type, whether Conv3d lowers it); the two flagship stages at B=32 and B=8
ROUTES = [((32, 16, 16, 16, 128), 256, torch.bfloat16, "cuda", True),
          ((32, 8, 8, 8, 256), 512, torch.bfloat16, "cuda", True),
          ((8, 16, 16, 16, 128), 256, torch.bfloat16, "cuda", True),
          ((8, 8, 8, 8, 256), 512, torch.bfloat16, "cuda", True),
          ((32, 16, 16, 16, 128), 256, torch.float32, "cuda", False),  # f32: cuDNN (TF32), as the f32 cell states
          ((32, 16, 16, 16, 128), 256, torch.bfloat16, "cpu", False),
          ((32, 64, 64, 64, 1), 64, torch.bfloat16, "cuda", False),  # the C = 1 stem of a classic encoder
          ((1, 8, 8, 8, 256), 512, torch.bfloat16, "cuda", False),  # 4^3 at B=1: no box of 128 rows
          ((32, 15, 15, 15, 128), 256, torch.bfloat16, "cuda", False),  # an odd grid
          ((32, 32, 32, 32, 64), 128, torch.bfloat16, "cuda", False)]  # dx's 128 columns span two phases


@pytest.mark.parametrize("shape,N,dtype,device,lowered", ROUTES)
def test_routing_by_shape_dtype_and_device(shape, N, dtype, device, lowered):
    """``Conv3d``'s choice (``lowering_plans``, on an H100's 132 SMs): the flagship's two stride-2 stages in
    bf16 on the card take the lowering, with the plans of the ``mid_blocked`` stages' shapes (8^3 1024 ->
    256, 4^3 2048 -> 512); everything else stays on ``F.conv3d``. A k=4 s=1 or k=2 conv is never lowered."""
    plans = k4.lowering_plans(shape, N, 4, 2, dtype, device, sms=132)
    assert (plans is not None) == lowered
    if lowered:
        fwd, dx = plans
        B, m, C = shape[0], shape[1] // 2, shape[4]
        assert fwd == wgmma_plan(B, m, m, m, 8 * C, N) and fwd.tiles == B * m**3 // fwd.bm * (N // fwd.bn)
        assert dx == wgmma_plan(B, m, m, m, N, 8 * C, split=False) and C % dx.bn == 0 and dx.splits == 1
    for k, s in ((4, 1), (2, 1), (3, 2)):
        assert k4.lowering_plans(shape, N, k, s, dtype, device, sms=132) is None


def test_conv3d_on_the_cpu_keeps_conv3d():
    """On CPU tensors ``Conv3d`` runs ``F.conv3d`` as before: no op of the lowering is called."""
    layer = Conv3d(128, 256, 4, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 4, 4, 128, dtype=torch.bfloat16)
    assert not k4.lowers(x, layer.weight, 4, 2)
    y = layer(x)
    ref = F.conv3d(F.pad(x.permute(0, 4, 1, 2, 3), (1, 1) * 3), layer.weight.to(x.dtype), stride=2)
    assert torch.equal(y, ref.permute(0, 2, 3, 4, 1).contiguous())


class _Forward(torch.nn.Module):
    def forward(self, x, w):
        return k4.conv_k4s2(x, w)


class _Backward(torch.nn.Module):
    def forward(self, x, g, w):
        return k4.conv_k4s2_dx(g, w, x.shape[1:4]), k4.conv_k4s2_dw(x, g)


def test_fake_kernels_trace_under_export_on_the_meta_device():
    """``torch.export`` traces the forward and the dx and dw ops on the meta device through their fake
    implementations: the exported graphs call the ops and give their shapes and dtypes."""
    meta = torch.device("meta")
    x = torch.empty(32, 16, 16, 16, 128, dtype=torch.bfloat16, device=meta)
    w = torch.empty(256, 128, 4, 4, 4, device=meta)
    g = torch.empty(32, 8, 8, 8, 256, dtype=torch.bfloat16, device=meta)
    fwd = torch.export.export(_Forward(), (x, w))
    bwd = torch.export.export(_Backward(), (x, g, w))
    targets = {str(n.target) for p in (fwd, bwd) for n in p.graph.nodes if n.op == "call_function"}
    assert {"anytime3d_torch.conv_k4s2.default", "anytime3d_torch.conv_k4s2_dx.default",
            "anytime3d_torch.conv_k4s2_dw.default"} <= targets
    [y], (dx, dw) = ([a.meta["val"] for a in p.graph.output_node().args[0]] for p in (fwd, bwd))
    assert y.shape == (32, 8, 8, 8, 256) and y.dtype == torch.bfloat16
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dw.shape == w.shape and dw.dtype == torch.float32
