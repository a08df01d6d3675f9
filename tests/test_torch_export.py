"""PyTorch port, the exported serving program on the CPU: the ``conv_k2``
custom ops under ``torch.library.opcheck`` and ``gradcheck``, the artifact of
``export_infer`` loaded by ``load_infer`` against the eager program and
against the JAX artifact on the same weights, ``cli.export``, and
``cli.serve --artifact`` over HTTP.

The JAX serving program applies a second sigmoid to the decoder's output;
the port's ``pred`` is the decoder's output, so its sigmoid is held to the
JAX ``pred`` (``tests/test_torch_serving.py``)."""

import base64
import http.client
import json
import os
import queue
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.serving import export as jax_export
from anytime3d_tpu_torch.cli import export as cli_export
from anytime3d_tpu_torch.cli import serve as serve_cli
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.packing import pack_voxels
from anytime3d_tpu_torch.kernels import conv_k2 as k2
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.serving.export import export_infer, load_infer, make_infer_fn, make_packed_infer
from anytime3d_tpu_torch.train.checkpoint import save_params

from tests.test_torch_serving import PRED_TOL, Z_TOL
from tests.test_torch_train import small_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, Z, DIM = 4, 8, 32
ITEM = (DIM, DIM, DIM, 1)
EXPORT_TOL = dict(rtol=0, atol=1e-6)  # the artifact runs the eager program's ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


# ---------------------------------------------------------------- the ops


def _operands(dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, 4, 5, 8, generator=gen).to(dtype)
    w = torch.randn(2, 2, 2, 8, 16, generator=gen) * 0.2
    g = torch.randn(2, 3, 4, 5, 16, generator=gen).to(dtype)
    return x, w, g


@pytest.mark.parametrize("case", ["forward", "forward_bf16_x_f32_w", "dx", "dw"])
def test_ops_pass_opcheck(case):
    x, w, g = _operands(torch.bfloat16 if case.endswith("bf16_x_f32_w") else torch.float32)
    if case == "dx":
        op, args = k2._conv_k2_dx_op, (g, w)
    elif case == "dw":
        op, args = k2._conv_k2_dw_op, (x, g)
    else:  # the forward with its registered backward
        op, args = k2._conv_k2_op, (x.requires_grad_(), w.requires_grad_())
    results = torch.library.opcheck(op, args)
    assert set(results.values()) == {"SUCCESS"}, results


def test_ops_are_registered_under_their_names():
    for name in ("conv_k2", "conv_k2_dx", "conv_k2_dw"):
        assert hasattr(torch.ops.anytime3d_torch, name)


def test_gradcheck_through_the_op_in_float64():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 2, 3, 2, 8, generator=gen, dtype=torch.float64, requires_grad=True)
    w = (torch.randn(2, 2, 2, 8, 8, generator=gen, dtype=torch.float64) * 0.2).requires_grad_()
    assert torch.autograd.gradcheck(k2.conv_k2, (x, w))


def test_dw_comes_back_in_the_parameter_dtype_from_the_f32_sum():
    """bf16 x with an f32 parameter: dw is the op's float32 sum, never rounded through bf16."""
    x, w, g = _operands(torch.bfloat16)
    x.requires_grad_()
    w.requires_grad_()
    k2.conv_k2(x, w).backward(g)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert torch.equal(w.grad, k2.conv_k2_dw_reference(x.detach(), g))


# ---------------------------------------------------------------- the artifact


@pytest.fixture(scope="module")
def models():
    """The 32^3 blocked model in flax and in the port on the same weights."""
    jax_cfg, cfg = small_configs()
    jax_model = JaxVAE(jax_cfg)
    tree = jax.tree.map(np.asarray, jax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, *ITEM)), method=JaxVAE.initialize)["params"])
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    return jax_model, tree, model


@pytest.fixture(scope="module")
def artifacts(models):
    *_, model = models
    return {"float": export_infer(model, (B, *ITEM)),
            "packed": export_infer(model, (B, *ITEM), packed_input=True, packed_output=True)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(B, *ITEM)) > 0.7).astype(np.float32)
    mask = (rng.uniform(size=(B, Z)) < 0.5).astype(np.float32)
    mask[0] = 1.0
    mask[1] = 0.0
    return x, mask


@pytest.mark.parametrize("io", ["float", "packed"])
def test_loaded_artifact_matches_the_eager_program(models, artifacts, io):
    *_, model = models
    fn = load_infer(artifacts[io])
    x, mask = _inputs(1)
    mask_t = torch.from_numpy(mask)
    if io == "float":
        xt, eager = torch.from_numpy(x), make_infer_fn(model)
        assert (fn.input_shape, fn.input_dtype) == ((B, *ITEM), torch.float32)
    else:
        xt, eager = torch.from_numpy(pack_voxels(x)), make_packed_infer(model, ITEM)
        assert (fn.input_shape, fn.input_dtype) == ((B, DIM**3 // 8), torch.uint8)
    assert fn.mask_shape == (B, Z) and fn.device == torch.device("cpu")
    got, want = fn(xt, mask_t), eager(xt, mask_t)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k in ("category", "pred_packed"):
            assert torch.equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **EXPORT_TOL, err_msg=k)


def test_artifact_calls_the_conv_k2_op(artifacts):
    program = torch.export.load(__import__("io").BytesIO(artifacts["packed"]))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("anytime3d_torch.conv_k2.default") == 4


def test_artifact_matches_the_jax_artifact(models, artifacts):
    jax_model, tree, _ = models
    jax_fn = jax_export.load_infer(jax_export.export_infer(jax_model, tree, (B, *ITEM)))
    x, mask = _inputs(2)
    ref = jax.tree.map(np.asarray, jax_fn(jnp.asarray(x), jnp.asarray(mask)))
    got = {k: v.numpy() for k, v in load_infer(artifacts["float"])(torch.from_numpy(x), torch.from_numpy(mask)).items()}
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["category"], ref["category"])
    np.testing.assert_allclose(got["z_mean"], ref["z_mean"], **Z_TOL)
    np.testing.assert_allclose(got["z_log_var"], ref["z_log_var"], **Z_TOL)
    np.testing.assert_allclose(1 / (1 + np.exp(-got["pred"])), ref["pred"], **PRED_TOL)


def test_cli_export_writes_the_float_artifact(monkeypatch, tmp_path, models):
    *_, model = models
    _, tiny = small_configs()
    monkeypatch.setitem(configs.REGISTRY, "modelnet_nolbo", lambda: tiny)
    save_params(str(tmp_path / "ckpt"), model.state_dict())
    out = tmp_path / "model.pt2"
    cli_export.main(["--config", "modelnet_nolbo", "--ckpt", str(tmp_path / "ckpt"), "--batch-size", "2",
                     "--out", str(out), "--device", "cpu"])
    fn = load_infer(out.read_bytes())
    assert (fn.input_shape, fn.input_dtype, fn.mask_shape) == ((2, *ITEM), torch.float32, (2, Z))
    x, mask = (t[:2] for t in _inputs(3))
    got = fn(torch.from_numpy(x), torch.from_numpy(mask))
    want = make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.equal(got["category"], want["category"])
    np.testing.assert_allclose(got["pred"].numpy(), want["pred"].numpy(), **EXPORT_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            cli_export.main(["--config", "modelnet_nolbo", "--out", str(out)])


# ---------------------------------------------------------------- serving


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/infer", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_serve_artifact_raw_input_over_http(models, artifacts, tmp_path):
    *_, model = models
    path = tmp_path / "model.pt2"
    path.write_bytes(artifacts["float"])
    args = serve_cli.parse_args(["--artifact", str(path), "--device", "cpu", "--mask-dim", str(Z)])
    server, what = serve_cli.build_server(args)
    assert f"batch {B}" in what and "float" in what
    try:
        port = server.serve(0, background=True)
        x, mask = _inputs(4)
        status, out = _post(port, {"input": x[0].tolist(), "mask": mask[0].tolist()})
        assert status == 200, out
        # the batcher pads the request to the program's batch with zero grids and full masks
        x[1:], mask[1:] = 0.0, 1.0
        ref = make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask))
        assert out["category"] == int(ref["category"][0])
        np.testing.assert_allclose(out["z_mean"], ref["z_mean"][0].numpy(), rtol=1e-5, atol=1e-5)
        assert "pred" not in out  # 32768 values > 4096: raw float32 bytes
        pred = np.frombuffer(base64.b64decode(out["pred_f32_b64"]), np.float32).reshape(ITEM)
        np.testing.assert_allclose(pred, ref["pred"][0].numpy(), **EXPORT_TOL)
        status, out = _post(port, {"voxels_packed_b64": base64.b64encode(pack_voxels(x[:1])[0].tobytes()).decode()})
        assert status == 400  # packed bits do not fit a float program's item
    finally:
        server.close()


def test_serve_artifact_checks_its_flags(artifacts, tmp_path):
    path = tmp_path / "model.pt2"
    path.write_bytes(artifacts["packed"])
    for flags, match in ((["--mask-dim", str(Z + 1)], "--mask-dim"), (["--item-bytes", "7"], "--item-bytes"),
                         (["--batch-size", str(B + 1)], "--batch-size"), (["--bf16"], "--bf16")):
        with pytest.raises(SystemExit, match=match):
            serve_cli.build_server(serve_cli.parse_args(["--artifact", str(path), "--device", "cpu", *flags]))
    server, what = serve_cli.build_server(serve_cli.parse_args(
        ["--artifact", str(path), "--device", "cpu", "--item-bytes", str(DIM**3 // 8)]))
    server.close()
    assert "packed" in what
    path.write_bytes(artifacts["float"])
    with pytest.raises(SystemExit, match="--item-bytes"):
        serve_cli.build_server(serve_cli.parse_args(["--artifact", str(path), "--device", "cpu", "--item-bytes", "8"]))


def test_serve_artifact_in_a_subprocess_answers_packed_requests(artifacts, tmp_path, models):
    """``python -m anytime3d_tpu_torch.cli.serve --artifact`` on an ephemeral
    port, as a user starts it; a float request to the packed program fails."""
    *_, model = models
    path = tmp_path / "model.pt2"
    path.write_bytes(artifacts["packed"])
    proc = subprocess.Popen([sys.executable, "-m", "anytime3d_tpu_torch.cli.serve", "--artifact", str(path),
                             "--device", "cpu", "--port", "0"], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True).start()
    try:
        line = lines.get(timeout=120)  # the program's first line names its port
        assert line.startswith("serving "), line
        port = int(line.rsplit(":", 1)[1])
        x, mask = _inputs(5)
        status, out = _post(port, {"voxels_packed_b64": base64.b64encode(pack_voxels(x[:1])[0].tobytes()).decode(),
                                   "mask": mask[0].tolist()})
        assert status == 200, out
        x[1:], mask[1:] = 0.0, 1.0  # the batcher's padding
        ref = make_packed_infer(model, ITEM)(torch.from_numpy(pack_voxels(x)), torch.from_numpy(mask))
        assert out["category"] == int(ref["category"][0])
        assert base64.b64decode(out["pred_packed_b64"]) == ref["pred_packed"][0].numpy().tobytes()
        status, out = _post(port, {"input": x[0].tolist()})
        assert status == 400 and "voxels_packed_b64" in out["error"]
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
    assert rc == 0
