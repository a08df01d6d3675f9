"""PyTorch port, modules: each block, the prior net, the encoder and the
decoder against their flax counterparts, on the same weights (converted with
``convert.params_from_flax``) and the same inputs (numpy, seeded), on the CPU.

Every comparison is float32 on both sides; the tolerances cover summation
order only and are stated where they are set."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.nn import autoencoder3d as jax_ae
from anytime3d_tpu.nn import blocks as jax_blocks
from anytime3d_tpu.nn.priornet import PriorNet as JaxPriorNet
from anytime3d_tpu.nn.priornet import PriorNetConfig as JaxPriorNetConfig
from anytime3d_tpu_torch.convert import load_flax_npz, params_from_flax
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn import blocks
from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3D, Encoder3D
from anytime3d_tpu_torch.nn.priornet import PriorNet, PriorNetConfig

TOL = dict(rtol=1e-4, atol=1e-5)  # f32 both sides, summation order only


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def small_configs(z=8, cat=5):
    """modelnet_nolbo's layout (blocked head and tail) cut to a 32^3 grid and
    narrow filters, as (jax config, port config). At 16^3 the decoder would
    start from a 1^3 grid, where GroupNorm zeroes every single-element group
    and the output is a constant."""
    out = []
    for mod in (jax_configs, configs):
        base = mod.modelnet_nolbo(z_dim=z, category_dim=cat)
        out.append(dataclasses.replace(
            base,
            encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32)),
            decoder=dataclasses.replace(base.decoder, output_shape=(32, 32, 32, 1), filter_nums=(32, 16, 16, 8, 1)),
            prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, z)),
        ))
    return out


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _flax_init(module, *args):
    return _np_tree(module.init(jax.random.PRNGKey(0), *args)["params"])


def _perturb(tree, seed):
    """Move ones/zeros norm params off their init, so the affine part is tested."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + rng.normal(scale=0.3, size=a.shape)).astype(np.float32), tree)


def _port(module, tree):
    module.load_state_dict(params_from_flax(tree))
    return module.eval()


@pytest.mark.parametrize("b", [2, 4])
def test_space_depth_roundtrip_matches_jax(b):
    x = np.random.default_rng(0).normal(size=(2, 8, 4, 12, 3)).astype(np.float32)
    s2d = blocks.space_to_depth3d(torch.from_numpy(x), b)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jax_blocks.space_to_depth3d(jnp.asarray(x), b)))
    np.testing.assert_array_equal(blocks.depth_to_space3d(s2d, b).numpy(), x)
    np.testing.assert_array_equal(
        blocks.depth_to_space3d(s2d, b).numpy(), np.asarray(jax_blocks.depth_to_space3d(jnp.asarray(s2d.numpy()), b))
    )


@pytest.mark.parametrize("channels", [8, 48, 512])
def test_group_norm_matches_flax(channels):
    x = (np.random.default_rng(1).normal(size=(2, 3, 4, 5, channels)) * 3 + 1).astype(np.float32)
    flax_gn = jax_blocks.group_norm(channels)
    tree = _perturb(_flax_init(flax_gn, x), 2)
    y = _port(blocks.group_norm(channels), tree)(torch.from_numpy(x))
    assert blocks._num_groups(channels) == flax_gn.num_groups
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(flax_gn.apply({"params": tree}, x)), **TOL)


def test_dense_block_matches_flax_layernorm_epsilon():
    """A dense output of variance ~1e-6 makes LayerNorm's epsilon decide the
    result: flax's 1e-6 and PyTorch's default 1e-5 differ by ~2x here."""
    x = np.random.default_rng(3).normal(size=(4, 2, 3)).astype(np.float32)
    flax_block = jax_blocks.DenseBlock(16)
    tree = _flax_init(flax_block, x)
    tree["Dense_0"]["kernel"] = tree["Dense_0"]["kernel"] * 1e-3
    tree["LayerNorm_0"] = _perturb(tree["LayerNorm_0"], 4)
    ref = np.asarray(flax_block.apply({"params": tree}, x))
    y = _port(blocks.DenseBlock(6, 16), tree)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)


# flax SAME padding for even kernels and flax ConvTranspose (transpose_kernel
# False); non-cubic inputs so a pad on the wrong axis shows
@pytest.mark.parametrize("kind,k,s,spatial", [
    ("conv", 2, 1, (4, 6, 2)),
    ("conv", 4, 1, (4, 6, 2)),
    ("conv", 4, 2, (4, 6, 2)),
    ("conv", 4, 2, (5, 3, 4)),
    ("transpose", 4, 1, (4, 6, 2)),
    ("transpose", 4, 2, (4, 6, 2)),
    ("transpose", 4, 2, (5, 3, 1)),
])
def test_conv_padding_recipes_match_flax(kind, k, s, spatial):
    cin, cout = 8, 12
    x = np.random.default_rng(5).normal(size=(2, *spatial, cin)).astype(np.float32)
    if kind == "conv":
        flax_block = jax_blocks.ConvBlock3D(cout, k, s)
        port = blocks.ConvBlock3D(cin, cout, k, s)
    else:
        flax_block = jax_blocks.DeconvBlock3D(cout, k, s)
        port = blocks.DeconvBlock3D(cin, cout, k, s)
    tree = _flax_init(flax_block, x)
    ref = np.asarray(flax_block.apply({"params": tree}, x))
    y = _port(port, tree)(torch.from_numpy(x)).detach().numpy()
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, **TOL)


def test_priornet_matches_flax():
    cfg = PriorNetConfig(input_dim=5, unit_nums=(16, 12, 8), const_log_var=0.0)
    flax_net = JaxPriorNet(JaxPriorNetConfig(**dataclasses.asdict(cfg)))
    onehot = np.eye(5, dtype=np.float32)[np.random.default_rng(6).integers(0, 5, 7)]
    tree = _perturb(_flax_init(flax_net, onehot), 7)
    mean_ref, lv_ref = flax_net.apply({"params": tree}, onehot)
    mean, lv = _port(PriorNet(cfg), tree)(torch.from_numpy(onehot))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(mean_ref), **TOL)
    np.testing.assert_array_equal(lv.detach().numpy(), np.asarray(lv_ref))


@pytest.fixture(scope="module")
def small_model():
    """The 32^3 blocked model in flax (initialised once) and in the port, on the same weights."""
    jax_cfg, cfg = small_configs()
    jax_model = JaxVAE(jax_cfg)
    x0 = jnp.zeros((1, 32, 32, 32, 1))
    tree = _np_tree(jax_model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x0,
                                   method=JaxVAE.initialize)["params"])
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    return jax_model, tree, model.eval()


def test_encoder_matches_flax(small_model):
    jax_model, tree, model = small_model
    x = (np.random.default_rng(8).uniform(size=(3, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    ref = jax_model.apply({"params": tree}, x, method=lambda m, v: m.encoder3d(v))
    with torch.no_grad():
        y = model.encoder3d(torch.from_numpy(x)).numpy()
    assert y.shape == (3, 16)
    np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_decoder_matches_flax(small_model):
    jax_model, tree, model = small_model
    z = np.random.default_rng(9).normal(size=(3, 8)).astype(np.float32)
    ref = np.asarray(jax_model.apply({"params": tree}, z, method=JaxVAE.decode))
    with torch.no_grad():
        y = model.decode(torch.from_numpy(z)).numpy()
    assert y.shape == ref.shape == (3, 32, 32, 32, 1)
    assert ref.std() > 0.05  # a constant output would make the comparison vacuous
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)


def test_blocked_input_matches_flax(small_model):
    """The encoder fed the space-to-depth(4) layout directly, against flax's
    ``blocked_input=True`` and against the dense path of the port itself."""
    jax_model, tree, model = small_model
    x = (np.random.default_rng(10).uniform(size=(3, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    xb = np.asarray(jax_blocks.space_to_depth3d(jnp.asarray(x), 4))
    ref = jax_model.apply({"params": tree}, xb, method=lambda m, v: m.encoder3d(v, blocked_input=True))
    with torch.no_grad():
        y = model.encoder3d(torch.from_numpy(np.array(xb)), blocked_input=True)
        assert torch.equal(y, model.encoder3d(torch.from_numpy(x)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_blocked_output_matches_flax(small_model):
    """The decoder's blocked output (final activation applied, no d2s) against
    flax's ``blocked_output=True``; it is the space-to-depth(4) of the normal output."""
    jax_model, tree, model = small_model
    z = np.random.default_rng(11).normal(size=(3, 8)).astype(np.float32)
    ref = np.asarray(jax_model.apply({"params": tree}, z, blocked_output=True, method=JaxVAE.decode))
    with torch.no_grad():
        y = model.decode(torch.from_numpy(z), blocked_output=True)
        assert torch.equal(blocks.space_to_depth3d(model.decode(torch.from_numpy(z)), 4), y)
    assert y.shape == ref.shape == (3, 8, 8, 8, 64)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_blocked_io_predicates_match_jax():
    from anytime3d_tpu.models import mmvae as jax_mmvae
    from anytime3d_tpu_torch.models import mmvae

    for jax_cfg, cfg in (small_configs(), (jax_configs.modelnet_nolbo(), configs.modelnet_nolbo())):
        assert mmvae.blocked_io_block(cfg) == jax_mmvae.blocked_io_block(jax_cfg) == 4
        assert mmvae.decoder_blocked_block(cfg) == jax_mmvae.decoder_blocked_block(jax_cfg) == 4
    jax_cfg, cfg = small_configs()
    odd = dict(output_shape=(34, 32, 32, 1))
    assert mmvae.blocked_io_block(dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **odd))) is None
    assert jax_mmvae.blocked_io_block(
        dataclasses.replace(jax_cfg, decoder=dataclasses.replace(jax_cfg.decoder, **odd))) is None
    assert MultiModalVAE(cfg).blocked_io_block == 4


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_priornet_dropout_follows_mode_and_generator(rate):
    cfg = PriorNetConfig(input_dim=5, unit_nums=(64, 8), const_log_var=0.0, dropout_rate=rate)
    net = PriorNet(cfg, generator=torch.Generator().manual_seed(0))
    onehot = torch.eye(5)
    still = net.eval()(onehot)[0]
    net.train()
    a = net(onehot, torch.Generator().manual_seed(1))[0]
    b = net(onehot, torch.Generator().manual_seed(1))[0]
    c = net(onehot, torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b)
    assert torch.equal(a, still) == (rate == 0.0) and torch.equal(a, c) == (rate == 0.0)


def test_compute_dtype_casts_at_use(small_model):
    """``dtype=torch.bfloat16``: float32 parameters, bfloat16 activations, the
    same function as the float32 model within bf16's 8 bits of mantissa."""
    _, tree, model = small_model
    low = MultiModalVAE(model.config, dtype=torch.bfloat16)
    low.load_state_dict(params_from_flax(tree))
    low.eval()
    assert all(p.dtype == torch.float32 for p in low.parameters())
    x = torch.from_numpy((np.random.default_rng(12).uniform(size=(2, 32, 32, 32, 1)) > 0.7).astype(np.float32))
    with torch.no_grad():
        enc, ref = low.encode(x), model.encode(x)
        pred, pred_ref = low.decode(ref.mean), model.decode(ref.mean)
        prior = low.priors_category(torch.eye(5))[0]
    assert enc.mean.dtype == pred.dtype == prior.dtype == torch.bfloat16
    assert float((enc.mean.float() - ref.mean).abs().max()) <= 0.05 * max(1.0, float(ref.mean.abs().max()))
    assert float((pred.float() - pred_ref).abs().max()) <= 0.05


def test_flat_npz_loads_like_the_tree(small_model, tmp_path):
    _, tree, model = small_model
    flat = {"/".join(k.key for k in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    np.savez(tmp_path / "params.npz", **flat)
    loaded = load_flax_npz(tmp_path / "params.npz")
    expected = params_from_flax(tree)
    assert loaded.keys() == expected.keys() == model.state_dict().keys()
    for k in expected:
        assert torch.equal(loaded[k], expected[k]), k


def test_init_is_seeded_and_flax_shaped():
    _, cfg = small_configs()
    a = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    b = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["encoder3d.convblock3d_2.conv_0.weight"]  # k=4 conv, fan-in 4^3 * 16
    assert float(w.abs().max()) <= 2 / (4**3 * 16) ** 0.5 / 0.87962566103423978 + 1e-6  # truncated at 2 std
    assert abs(float(w.std()) * (4**3 * 16) ** 0.5 - 1.0) < 0.05  # lecun variance 1/fan_in
    assert torch.equal(a["decoder.groupnorm_0.weight"], torch.ones(64))


@pytest.mark.parametrize("name", sorted(jax_configs.REGISTRY))
def test_modelnet_nolbo_config_mirrors_jax(name):
    """Each of the JAX package's 16 ``REGISTRY`` names, its config and its
    loss config, field for field; the two registries hold the same names."""
    assert set(configs.REGISTRY) == set(jax_configs.REGISTRY)
    assert dataclasses.asdict(configs.REGISTRY[name]()) == dataclasses.asdict(jax_configs.REGISTRY[name]())
    assert dataclasses.asdict(configs.loss_config(name)) == dataclasses.asdict(jax_configs.loss_config(name))


@pytest.mark.parametrize("part,change", [
    ("encoder3d", {"head_blocked": False}),
    ("encoder3d", {"mid_blocked": True}),
    ("decoder", {"tail_blocked": False, "final_mode": "transpose"}),
    ("decoder", {"final_mode": "transpose_equiv"}),
    ("decoder", {"mid_equiv": True}),
    ("decoder", {"tail_phase_norm": True}),
    ("decoder", {"mid_blocked": True}),
])
def test_unported_layouts_raise(part, change):
    """The layouts the flagship does not use, on its 32^3 narrow form: each
    one (``mid_blocked`` too, since it was ported) builds with flax's
    submodule names and computes flax's encoder or decoder on the same random
    weights."""
    jax_cfg, cfg = (dataclasses.replace(getattr(c, part), **change) for c in small_configs())
    cls = Encoder3D if part == "encoder3d" else Decoder3D
    rng = np.random.default_rng(len(str(change)))
    if part == "encoder3d":
        jax_mod, x = jax_ae.Encoder3D(jax_cfg), (rng.uniform(size=(2, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    else:
        jax_mod, x = jax_ae.Decoder3D(jax_cfg), rng.normal(size=(2, cfg.input_dim)).astype(np.float32)
    tree = _perturb(_np_tree(jax.jit(lambda k: jax_mod.init(k, jnp.asarray(x)))(jax.random.PRNGKey(0))["params"]), 11)
    port = _port(cls(cfg), tree)
    ref = np.asarray(jax.jit(lambda p, v: jax_mod.apply({"params": p}, v))(tree, jnp.asarray(x)))
    with torch.no_grad():
        y = port(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape and ref.std() > 1e-3
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)
