"""PyTorch port, kernels: ``conv_k2`` against the JAX package, its build, and
that the port never imports JAX.

On the CPU the wrapper runs its plain version (``conv_k2_reference``); the
CUDA kernel itself is checked on the card by tests/test_torch_cuda.py."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.kernels.conv_k2 import conv_k2 as jax_conv_k2
from anytime3d_tpu.kernels.conv_k2 import _conv_k2_bwd_impl, conv_k2_xla
from anytime3d_tpu_torch.kernels import build
from anytime3d_tpu_torch.kernels.conv_k2 import conv_k2, conv_k2_backward_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, D, C, N) of tests/test_kernels.py::TestConvK2: the Pallas im2col body,
# the matmul8 body, every boundary row, and the small-C XLA fallback
TEST_SHAPES = [(2, 4, 8, 16), (1, 4, 136, 8), (1, 4, 8, 8), (2, 4, 4, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def _inputs(B, D, C, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, D, D, C)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("B,D,C,N", TEST_SHAPES)
def test_plain_conv_k2_matches_jax(B, D, C, N):
    x, w = _inputs(B, D, C, N)
    before = conv_k2.launches
    y = conv_k2(torch.from_numpy(x), torch.from_numpy(w))
    assert conv_k2.launches == before  # a CPU tensor never reaches the kernel
    assert y.shape == (B, D, D, D, N) and y.is_contiguous()
    # f32 on every side, only the summation order differs (depth 8C <= 1088):
    # the 2e-4 that tests/test_kernels.py holds the Pallas kernel to
    np.testing.assert_allclose(y.numpy(), np.asarray(conv_k2_xla(jnp.asarray(x), jnp.asarray(w))), atol=2e-4, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_conv_k2(jnp.asarray(x), jnp.asarray(w))), atol=2e-4, rtol=0)


@pytest.mark.parametrize("B,D,C,N", TEST_SHAPES)
def test_plain_backward_matches_jax(B, D, C, N):
    """``conv_k2_backward_reference`` against ``_conv_k2_bwd_impl`` and
    ``jax.vjp(conv_k2_xla)``: f32, summation order only (atol 2e-4)."""
    x, w = _inputs(B, D, C, N)
    g = np.random.default_rng(1).normal(size=(B, D, D, D, N)).astype(np.float32)
    dx, dw = conv_k2_backward_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    assert dx.shape == x.shape and dw.shape == w.shape and dw.dtype == torch.float32
    for ref_dx, ref_dw in (_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)),
                           jax.vjp(conv_k2_xla, jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(g))):
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=2e-4, rtol=0)
        np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), atol=2e-4, rtol=0)


@pytest.mark.parametrize("B,D,C,N", TEST_SHAPES)
def test_autograd_through_conv_k2_matches_jax(B, D, C, N):
    """Autograd through the wrapper on the CPU (a permuted, non-contiguous
    gradient, as a model hands it over) against ``jax.vjp`` of the JAX wrapper."""
    x, w = _inputs(B, D, C, N)
    g = np.random.default_rng(2).normal(size=(B, N, D, D, D)).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    before = (conv_k2.launches, conv_k2.launches_dx, conv_k2.launches_dw)
    conv_k2(xt, wt).permute(0, 4, 1, 2, 3).backward(torch.from_numpy(g))
    assert (conv_k2.launches, conv_k2.launches_dx, conv_k2.launches_dw) == before
    g_last = jnp.asarray(g.transpose(0, 2, 3, 4, 1))
    ref_dx, ref_dw = jax.vjp(jax_conv_k2, jnp.asarray(x), jnp.asarray(w))[1](g_last)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), atol=2e-4, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_dw), atol=2e-4, rtol=0)


def test_bf16_input_with_f32_weight_gives_f32_weight_gradient():
    """The wrapper casts an f32 parameter to x's dtype; its gradient comes back f32."""
    x, w = _inputs(1, 4, 8, 8)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv_k2(xt, wt)
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    ref = conv_k2_backward_reference(xt.detach(), wt.detach(), torch.ones_like(y))[1]
    np.testing.assert_allclose(wt.grad.numpy(), ref.numpy(), rtol=2e-2, atol=2e-2)  # F.conv3d sums in bf16 here


@pytest.mark.parametrize("xs,ws", [((2, 4, 4, 4, 8), (2, 2, 2, 4, 8)), ((2, 4, 4, 8), (2, 2, 2, 8, 8)),
                                   ((2, 4, 4, 4, 8), (3, 2, 2, 8, 8))])
def test_conv_k2_rejects_bad_shapes(xs, ws):
    with pytest.raises(ValueError):
        conv_k2(torch.zeros(xs), torch.zeros(ws))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("conv_k2")
    assert not build.library_path("conv_k2").exists()


def test_library_path_keyed_by_sources_and_flags(monkeypatch):
    path = build.library_path("conv_k2")
    assert path.name == "libconv_k2.so" and path.parent.parent == build.BUILD_ROOT
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("conv_k2") != path


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax or flax
    (a subprocess: this test process has jax loaded by conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import anytime3d_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'anytime3d_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 28


def test_chip_smoke_fails_alone_and_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result in a directory that
    holds nothing else of the repo, and (on this machine) without a GPU."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    runs = [tmp_path] if torch.cuda.is_available() else [tmp_path, REPO]
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0, cwd
        assert '"ok"' not in out.stdout, cwd
