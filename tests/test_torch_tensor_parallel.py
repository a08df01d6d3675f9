"""PyTorch port, tensor parallelism over a ("data", "model") mesh of 2 x 2
gloo ranks against the JAX package, on the CPU.

The placements come first, without any process: for ``modelnet_nolbo``,
``pascal_nolbo`` and ``modelnet_nolbo_acc`` at full width (JAX's tree from
``jax.eval_shape``, the port's model on the ``meta`` device), every leaf's
placement under ``parallel.param_sharding_rules`` at a model axis of 2 is
JAX's ``param_sharding_rules`` on a (4, 2) mesh of the 8 CPU devices (sharded
or not, and along which flax axis), and ``tp_coverage`` is JAX's to the
parameter.

Then one module-scoped launch of 4 processes
(``tests/_torch_tensor_parallel_child.py``, joined by gloo on a free
localhost port through ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
``PROCESS_ID``; no JAX there) runs ``make_mesh(data=2, model=2)`` and every
tensor-parallel path on models sharded by ``parallel.tensor.parallelize``,
while this process computes the references on the same weights (converted
with ``convert.params_from_flax``), batches and draws:

- the flagship layout of ``test_torch_train.small_configs`` (32^3, blocked
  head and tail, packed-blocked input) and the 16^3 equiv-layout model of
  ``tests/test_train.py::test_equiv_layout_graph_on_mesh`` (its config
  verbatim, with its default ``LossConfig``, whose kernel L2 is on, and
  its prior net's dropout, whose masks are JAX's, recorded and injected): the
  tensor-parallel ``make_train_step`` against JAX's single-device one on the
  global batch, the draws JAX's and injected, at ``dryrun_multichip``'s
  tolerances (metrics ``rtol=2e-3, atol=1e-5``; the parameters after one
  Adam step ``rtol=5e-3, atol=2.2e-4``); its gradients against the port's
  1-rank step on the global batch within 1e-5 of each leaf's largest entry
  (only the order of the dx sums over "model" differs); every rank's
  gathered parameters bit for bit alike;
- ``make_train_step_dp`` on the model axis: finite, and against the
  tensor-parallel ``make_train_step`` on the same rows and draws without the
  prior repulsion (which pairs rows within a shard in the one and across the
  batch in the other) within one bfloat16 rounding at each leaf's scale;
- a NaN planted in one entry of one rank's slice of a sharded gradient
  zeroes every rank's update;
- each column-parallel layer kind (``Dense``, ``ConvK2``, ``Conv3d``,
  ``ConvTranspose3d``, ``ConvTransposeEquiv3D``, ``Conv2d``): the output and
  the input and weight gradients equal the whole layer's, so that a gathered
  gradient summed over the ranks (twice the right one) shows.
"""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.data.packing import pack_voxels_blocked as jax_pack_voxels_blocked
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MMVAEConfig as JaxMMVAEConfig
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig as JaxDecoder3DConfig
from anytime3d_tpu.nn.autoencoder3d import Encoder3DConfig as JaxEncoder3DConfig
from anytime3d_tpu.nn.priornet import PriorNetConfig as JaxPriorNetConfig
from anytime3d_tpu.parallel import make_mesh as jax_make_mesh
from anytime3d_tpu.parallel.mesh import param_sharding_rules as jax_param_sharding_rules
from anytime3d_tpu.parallel.mesh import tp_coverage as jax_tp_coverage
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu.train.state import TrainState as JaxTrainState
from anytime3d_tpu_torch import convert
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.packing import pack_voxels_blocked
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MMVAEConfig, MultiModalVAE
from anytime3d_tpu_torch.nn import blocks, priornet
from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
from anytime3d_tpu_torch.nn.priornet import PriorNetConfig
from anytime3d_tpu_torch.parallel import param_sharding_rules, tp_coverage
from anytime3d_tpu_torch.train.step import LossConfig, loss_and_grads
from tests import test_torch_pretrain as pre_tests
from tests import test_torch_train as train_tests
from tests.test_torch_parallel import BF16_ULP, _free_port, _voxel_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
MODEL = 2  # the "model" axis; "data" is RANKS // MODEL
# dryrun_multichip's bounds (__graft_entry__.py): metrics, and parameters after one Adam step at lr 1e-4
METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-5
PARAM_RTOL, PARAM_ATOL = 5e-3, 2.2e-4
GRAD_REL = 1e-5  # the tensor-parallel step against the port's 1-rank step, relative to each leaf's largest entry
LAYER_REL = 1e-6  # a column-parallel layer against the whole one: the same products, summed in another order
EQUIV_B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


# ------------------------------------------------------------- placements


def _port_axis(module: str, name: str, shape, flax_axis: int):
    """The axis of the port's leaf that the flax leaf's ``flax_axis`` becomes
    under ``convert``: an index grid along that axis alone, carried through
    the converter's flips and transposes as a view."""
    grid = np.broadcast_to(np.arange(shape[flax_axis]).reshape([-1 if i == flax_axis else 1
                                                                 for i in range(len(shape))]), shape)
    port_name, leaf = convert._leaf(module, name, grid)
    (axis,) = [i for i, s in enumerate(leaf.strides) if s != 0]
    return port_name, axis


def _jax_placements(shapes, mesh) -> dict:
    """{port name: port axis or None} of JAX's placements over the flax tree of ``shapes``."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(jax_param_sharding_rules(shapes, mesh))[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    for path, sharding in flat:
        keys = [p.key for p in path]
        spec = list(sharding.spec)
        flax_axis = spec.index("model") if "model" in spec else None
        shape = leaves[path].shape
        if flax_axis is None:
            port_leaf, _ = convert._leaf(keys[-2], keys[-1], np.broadcast_to(np.float32(0), shape))
            axis = None
        else:
            port_leaf, axis = _port_axis(keys[-2], keys[-1], shape, flax_axis)
        out[".".join([k.lower() for k in keys[:-1]] + [port_leaf])] = axis
    return out


@pytest.mark.parametrize("name", ["modelnet_nolbo", "pascal_nolbo", "modelnet_nolbo_acc"])
def test_placements_and_coverage_are_jaxs(name):
    """Every leaf placed as JAX places it at model=2, and the same coverage,
    which is at least 0.9 (``tests/test_train.py::test_tp_rules_cover_flagship``)."""
    cfg = jax_configs.REGISTRY[name]()
    jax_model = JaxVAE(cfg)
    x = jnp.zeros((1, 64, 64, 64, 1) if cfg.encoder == "voxel" else (1, 64, 64, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_model.init({"params": key, "dropout": key}, x,
                                                   method=jax_model.initialize)["params"])
    mesh = jax_make_mesh(data=4, model=MODEL)
    want = _jax_placements(shapes, mesh)
    with torch.device("meta"):
        model = MultiModalVAE(configs.REGISTRY[name]())
    params = dict(model.named_parameters())
    got = param_sharding_rules(params, MODEL)
    assert got == want
    assert sum(a is not None for a in got.values()) > 0
    cov = tp_coverage(params, MODEL)
    assert cov == jax_tp_coverage(shapes, mesh)
    assert cov >= 0.9, f"{name}: the rules cover only {cov:.1%}"


@pytest.mark.parametrize("device,backend,want", [("cuda", None, "nccl"), ("cuda", "gloo", "gloo"),
                                                 ("cpu", None, "gloo")])
def test_initialize_takes_gloo_on_cuda_only_by_name(monkeypatch, device, backend, want):
    """The backend ``initialize`` asks for: NCCL on CUDA unless gloo is
    named, gloo on the CPU (CUDA faked; the join itself stopped)."""
    from anytime3d_tpu_torch.parallel import multihost

    asked = []

    def join(backend, **kw):
        asked.append(backend)
        raise InterruptedError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: None)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group", join)
    with pytest.raises(InterruptedError):
        multihost.initialize(device=device, backend=backend)
    assert asked == [want]


def test_initialize_on_cuda_without_cuda_raises(monkeypatch):
    """No fallback to gloo on the CPU, whichever backend is asked for (CUDA
    absent, a process group of another test or none)."""
    from anytime3d_tpu_torch.parallel import multihost

    def join(backend, **kw):
        raise AssertionError(f"joined a {backend} group")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group", join)
    for backend in (None, "gloo"):
        with pytest.raises(RuntimeError, match="needs CUDA"):
            multihost.initialize(device="cuda", backend=backend)


# ------------------------------------------------------------- the 4-rank run


def _equiv_config(enc, dec, prior, mmvae):
    """``tests/test_train.py::test_equiv_layout_graph_on_mesh``'s model, from one package's classes."""
    return mmvae(
        z_category_dim=8,
        z_inst_dim=0,
        category_dim=4,
        encoder="voxel",
        encoder3d=enc(
            output_dim=16, filter_nums=(8, 16, 32), filter_sizes=(4, 4, 4, 4),
            strides=(2, 2, 2, 1), head_blocked=True,
        ),
        decoder=dec(
            input_dim=8, output_shape=(16, 16, 16, 1),
            filter_nums=(32, 16, 8, 1), filter_sizes=(4, 4, 4, 4),
            strides=(1, 2, 2, 2), final_mode="transpose_equiv",
            tail_blocked=False, mid_equiv=True,
        ),
        prior_category=prior(input_dim=4, unit_nums=(8, 8), const_log_var=0.0),
        variational=True,
    )


# kind: (submodule name, constructor arguments, input shape)
LAYERS = {
    "Dense": ("dense_0", (12, 8), (3, 12)),
    "ConvK2": ("conv_0", (6, 8), (2, 3, 4, 5, 6)),
    "Conv3d": ("conv_0", (6, 8, 4, 2), (2, 6, 5, 6, 6)),
    "ConvTranspose3d": ("convtranspose_0", (6, 8, 4, 2), (2, 3, 2, 3, 6)),
    "ConvTransposeEquiv3D": ("convtransposeequiv3d_0", (6, 8), (2, 3, 2, 3, 6)),
    "Conv2d": ("conv_0", (6, 8, 3, 2), (2, 7, 6, 6)),
}


def _layer(kind, rng):
    """(holder of the whole layer, the case the children read)."""
    name, args, shape = LAYERS[kind]
    holder = torch.nn.Module()
    holder.add_module(name, getattr(blocks, kind)(*args))
    params = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in holder.state_dict().items()}
    holder.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x = rng.standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        y = getattr(holder, name)(torch.from_numpy(x))
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    return holder, {"name": name, "args": args, "params": params, "x": x, "dy": dy}


def _prior_masks(jax_model, tree, onehot, key) -> list:
    """The dropout masks of JAX's prior net in the train step keyed by
    ``key`` (its dropout key is the 7th of ``split(key, 7)``), recorded from
    an eager call of the same ``priors_category``, as float32 arrays: the
    port keeps a unit where its uniform draw is >= the rate, so 1 keeps and 0
    drops."""
    masks = []
    bernoulli = jax.random.bernoulli

    def recorded(k, p=0.5, shape=None):
        mask = bernoulli(k, p, shape)
        masks.append(np.asarray(mask, np.float32))
        return mask

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", recorded)
        jax_model.apply({"params": tree}, jnp.asarray(onehot), False, method=JaxVAE.priors_category,
                        rngs={"dropout": jax.random.split(key, 7)[6]})
    return masks


def _inputs():
    """(what the children read, what the references need)."""
    rng = np.random.default_rng(0)
    cases, jax_side = {}, {}

    jax_cfg, cfg = train_tests.small_configs()
    b = train_tests.B
    vox = (rng.uniform(size=(b,) + (train_tests.DIM,) * 3 + (1,)) > 0.7).astype(np.float32)
    onehot = np.eye(train_tests.CAT, dtype=np.float32)[rng.integers(0, train_tests.CAT, b)]
    loss_cfg = configs.loss_config("modelnet_nolbo")
    key = train_tests.key_with_coin(loss_cfg, True)
    cases["flagship"] = {"config": cfg, "loss_cfg": loss_cfg, "draws": _voxel_draws(key, loss_cfg, b),
                         "batch": {"input_packed_blocked": pack_voxels_blocked(vox, 4), "category_onehot": onehot}}
    jax_side["flagship"] = (jax_cfg, jax_configs.loss_config("modelnet_nolbo"), key,
                            {"input_packed_blocked": jax_pack_voxels_blocked(vox, 4), "category_onehot": onehot})

    jax_cfg = _equiv_config(JaxEncoder3DConfig, JaxDecoder3DConfig, JaxPriorNetConfig, JaxMMVAEConfig)
    cfg = _equiv_config(Encoder3DConfig, Decoder3DConfig, PriorNetConfig, MMVAEConfig)
    vox = (rng.uniform(size=(EQUIV_B, 16, 16, 16, 1)) > 0.7).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, EQUIV_B)]
    key = jax.random.PRNGKey(1)
    cases["equiv"] = {"config": cfg, "loss_cfg": LossConfig(), "draws": _voxel_draws(key, LossConfig(), EQUIV_B),
                      "batch": {"input": vox, "category_onehot": onehot}}
    jax_side["equiv"] = (jax_cfg, jax_step.LossConfig(), key, {"input": vox, "category_onehot": onehot})

    for tag, (jcfg, _, _, jbatch) in jax_side.items():
        jax_model = JaxVAE(jcfg)
        x = jnp.zeros((1,) + jcfg.decoder.output_shape)
        tree = pre_tests.random_tree(lambda k, m=jax_model, x=x: m.init({"params": k, "dropout": k}, x,
                                                                        method=JaxVAE.initialize), rng)
        cases[tag]["params"] = params_from_flax(tree)
        cases[tag]["prior_masks"] = _prior_masks(jax_model, tree, jbatch["category_onehot"], jax_side[tag][2])
        jax_side[tag] = (jax_model, tree) + jax_side[tag][1:]
    assert not cases["flagship"]["prior_masks"] and cases["equiv"]["prior_masks"]  # the flagship's rate is 0

    layers, holders = {}, {}
    for kind in LAYERS:
        holders[kind], layers[kind] = _layer(kind, rng)
    cases["layers"] = layers
    return cases, jax_side, holders


def _references(cases, jax_side, holders):
    """JAX's single-device step (metrics, parameters after Adam), the port's
    1-rank gradients and metrics, and each whole layer's output and gradients."""
    refs = {}
    for tag in ("flagship", "equiv"):
        jax_model, tree, loss_cfg, key, batch = jax_side[tag]
        tx = optax.adam(1e-4)
        params = jax.tree.map(jnp.asarray, tree)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                              apply_fn=jax_model.apply, tx=tx)
        new, metrics = jax_step.make_train_step(jax_model, loss_cfg, donate=False)(
            state, jax.tree.map(jnp.asarray, batch), key)
        c = cases[tag]
        model = MultiModalVAE(c["config"])
        model.load_state_dict(c["params"])
        with pytest.MonkeyPatch.context() as mp:
            masks = itertools.cycle(c["prior_masks"])
            mp.setattr(priornet, "uniform", lambda shape, generator, device: torch.from_numpy(next(masks)))
            grads, port_metrics = loss_and_grads(model, c["loss_cfg"], train_tests.to_torch(c["batch"]),
                                                 draws=train_tests.to_torch(c["draws"]))
        refs[tag] = {"jax_metrics": {k: float(v) for k, v in metrics.items()},
                     "jax_params": {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray,
                                                                                          new.params)).items()},
                     "grads": {k: v.numpy() for k, v in grads.items()},
                     "metrics": {k: float(v) for k, v in port_metrics.items()}}
    for kind, holder in holders.items():
        c = cases["layers"][kind]
        x = torch.from_numpy(c["x"]).requires_grad_(True)
        y = getattr(holder, c["name"])(x)
        y.backward(torch.from_numpy(c["dy"]))
        refs[kind] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                      "grad": {n: p.grad.numpy() for n, p in holder.named_parameters()}}
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(every rank's npz, the references)."""
    workdir = str(tmp_path_factory.mktemp("tensor_parallel"))
    cases, jax_side, holders = _inputs()
    torch.save(cases, os.path.join(workdir, "inputs.pt"))
    port = _free_port()
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(RANKS),
                   PROCESS_ID=str(rank), PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-m", "tests._torch_tensor_parallel_child", workdir], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        refs = _references(cases, jax_side, holders)  # while the ranks run
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(RANKS)], refs


def _part(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_rel(got, want, rel, what):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float64)
        top = float(np.abs(w).max()) + 1e-12
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= rel * top, (what, name, err, top)


@pytest.mark.parametrize("tag", ["flagship", "equiv"])
def test_tp_step_is_jaxs_single_device_step(ranks, tag):
    """Every metric and every parameter after one Adam step against JAX's
    ``make_train_step`` on the global batch, at ``dryrun_multichip``'s
    tolerances, on each rank."""
    outs, refs = ranks
    want_metrics, want_params = refs[tag]["jax_metrics"], refs[tag]["jax_params"]
    for out in outs:
        got = {k: float(v) for k, v in _part(out, f"{tag}/metric/").items()}
        assert set(want_metrics) <= set(got)
        for k, w in want_metrics.items():
            np.testing.assert_allclose(got[k], w, rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)
        params = _part(out, f"{tag}/param/")
        assert params.keys() == want_params.keys()
        for k, w in want_params.items():
            np.testing.assert_allclose(params[k], w, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    assert want_metrics["grads_finite"] == 1.0


@pytest.mark.parametrize("tag", ["flagship", "equiv"])
def test_tp_gradients_are_the_one_rank_steps(ranks, tag):
    """The gathered gradients (before Adam) against the port's step on one
    rank and the whole batch, each leaf within 1e-5 of its largest entry;
    the metrics within float32 rounding. The equiv model's L2 counts each
    sharded kernel once over the model ranks."""
    outs, refs = ranks
    for out in outs:
        _assert_rel(_part(out, f"{tag}/grad/"), refs[tag]["grads"], GRAD_REL, tag)
        got = {k: float(v) for k, v in _part(out, f"{tag}/metric/").items()}
        for k, w in refs[tag]["metrics"].items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    if tag == "equiv":
        assert LossConfig().l2_weight > 0


@pytest.mark.parametrize("tag", ["flagship", "equiv", "dp"])
def test_every_rank_applies_the_same_update(ranks, tag):
    """The four ranks' gathered gradients, metrics and (after Adam) parameters, bit for bit."""
    outs, _ = ranks
    assert [int(o["rank"]) for o in outs] == list(range(RANKS))
    first = outs[0]
    for out in outs[1:]:
        for part in ("grad", "metric", "param"):
            a, b = _part(first, f"{tag}/{part}/"), _part(out, f"{tag}/{part}/")
            assert a.keys() == b.keys() and (a or part == "param")
            assert all(np.array_equal(a[k], b[k]) for k in a), (tag, part)
        if f"{tag}/digest" in first:
            assert str(out[f"{tag}/digest"]) == str(first[f"{tag}/digest"])


def test_explicit_dp_step_on_the_model_axis(ranks):
    """``make_train_step_dp`` (bfloat16 all-reduce over "data") on the
    sharded model: finite, and the tensor-parallel step's gradients within
    one bfloat16 rounding at each leaf's scale (each data shard's gradient is
    rounded to bfloat16, then their sum), on the same rows and draws without
    the prior repulsion; the other metrics, float32 means of the shards'
    means, within float32 rounding (``loss_reg`` is still reported, over
    the pairs of a shard against the pairs of the batch)."""
    outs, _ = ranks
    for out in outs:
        dp, ref = _part(out, "dp/grad/"), _part(out, "dp_ref/grad/")
        assert float(out["dp/metric/grads_finite"]) == 1.0
        assert all(np.isfinite(g).all() for g in dp.values())
        _assert_rel(dp, ref, BF16_ULP, "dp")
        for k, w in _part(out, "dp_ref/metric/").items():
            if k == "loss_reg":
                continue
            np.testing.assert_allclose(float(out[f"dp/metric/{k}"]), float(w), rtol=1e-5, atol=1e-7, err_msg=k)


def test_a_non_finite_slice_zeroes_every_ranks_update(ranks):
    """A NaN in one entry of global rank 1's slice of a sharded kernel's
    gradient: the all-reduce over "data" carries it to rank 3, the flag over
    "model" to ranks 0 and 2; every rank's parameters stay as they were."""
    outs, _ = ranks
    assert str(outs[0]["poison/target"]).endswith(".weight")
    for out in outs:
        assert float(out["poison/grads_finite"]) == 0.0
        assert str(out["poison/after"]) == str(out["poison/before"])
    assert len({str(o["poison/before"]) for o in outs}) == 1


@pytest.mark.parametrize("kind", list(LAYERS))
def test_column_parallel_layer_is_the_whole_layer(ranks, kind):
    """The layer sharded over "model": its gathered output, its input's
    gradient (summed over the model ranks) and its gathered weight gradient
    (the bias's whole) against the whole layer's, on every rank."""
    outs, refs = ranks
    want = refs[kind]
    for out in outs:
        _assert_rel({"y": out[f"layer/{kind}/y"], "dx": out[f"layer/{kind}/dx"]},
                    {"y": want["y"], "dx": want["dx"]}, LAYER_REL, kind)
        _assert_rel(_part(out, f"layer/{kind}/grad/"), want["grad"], LAYER_REL, kind)
