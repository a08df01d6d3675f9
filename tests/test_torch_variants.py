"""PyTorch port, the model variants and layouts beyond the flagship's against
the JAX package on the CPU: the 16 ``REGISTRY`` names and their loss
configs; ``PhaseGroupNorm``, ``ConvTransposeEquiv3D`` and
``DeconvEquivBlock3D``; the classic encoder (s2d stems 1 and 2, max and no
pool); the decoder's transposed-conv, phase-equivalent, ``mid_equiv``,
``tail_phase_norm`` and ``tail_init_match_transpose`` layouts;
``remap_decoder_params``; the converter on every name at full width; and,
for models without a category prior, ``anytime_eval`` with external class
anchors, the serving program with them and with the zero fill,
``category_vectors``, and ``cli.evaluate --latents-out`` -> ``cli.export
--prior-means`` -> ``cli.serve --artifact``.

Weights are flax trees drawn in numpy and converted with
``convert.params_from_flax``; inputs come from numpy seeds; the JAX side runs
under ``jax.jit``. Comparisons are float32; each tolerance is stated where it
is set.
"""

import base64
import dataclasses
import http.client
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.anytime import engine as jax_engine
from anytime3d_tpu.cli import evaluate as jax_cli_evaluate
from anytime3d_tpu.evaluation import dump as jax_dump
from anytime3d_tpu.evaluation import protocols as jax_protocols
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.nn import autoencoder3d as jax_ae
from anytime3d_tpu.nn import blocks as jax_blocks
from anytime3d_tpu.serving.export import make_infer_fn as jax_make_infer_fn
from anytime3d_tpu_torch.anytime import engine
from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
from anytime3d_tpu_torch.cli import export as cli_export
from anytime3d_tpu_torch.cli import probe_transpose
from anytime3d_tpu_torch.cli import serve as cli_serve
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.packing import pack_voxels
from anytime3d_tpu_torch.evaluation import dump, protocols
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE, decoder_blocked_block
from anytime3d_tpu_torch.nn import autoencoder3d as ae
from anytime3d_tpu_torch.nn import blocks
from anytime3d_tpu_torch.serving.export import make_infer_fn
from anytime3d_tpu_torch.train.checkpoint import save_params

TOL = dict(rtol=1e-4, atol=1e-5)  # f32 both sides, summation order only, through a few layers
GRAD_REL = 1e-4  # each gradient leaf against JAX's, relative to that leaf's largest entry
Z_TOL = dict(rtol=1e-4, atol=1e-4)  # latents through ~10 layers of f32
PRED_TOL = 1e-5  # decoded occupancies, absolute
LOSS_RTOL = 1e-4  # loss terms: sums of 32768 voxel terms a sample in another order
PR_ATOL = 5e-4  # P and R count voxels against 0.5; one within rounding of it moves them
B, Z, K, DIM = 4, 8, 5, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def random_tree(init, rng, noise=0.05):
    """A flax param tree of the shapes ``init(key)`` makes, drawn in numpy:
    kernels normal with variance 1/fan_in; norm scales 1 and biases 0, moved
    by ``noise`` times a normal so that nothing is special."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        if path[-1].key == "kernel":
            return rng.standard_normal(s.shape, np.float32) / np.float32(math.sqrt(math.prod(s.shape[:-1])))
        base = np.ones(s.shape, np.float32) if path[-1].key == "scale" else np.zeros(s.shape, np.float32)
        return base + np.float32(noise) * rng.standard_normal(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def convert(tree, root=None):
    """``params_from_flax`` of a module's tree; ``root``: the flax class name
    of a module whose own leaves sit at the tree's top (converted as flax
    would nest it, then unnested)."""
    if root is None:
        return params_from_flax(tree)
    return {k.split(".", 1)[1]: v for k, v in params_from_flax({f"{root}_0": tree}).items()}


def check_module(jax_mod, port_mod, x, seed=0, root=None, **kw):
    """Forward and the gradients of the input and of every leaf (through a
    random cotangent) of ``port_mod`` against ``jax_mod`` on one random tree,
    flax names mapped; the converted tree must fill ``port_mod`` exactly.
    Returns the tree and the port's output."""
    rng = np.random.default_rng(seed)
    tree = random_tree(lambda k: jax_mod.init(k, jnp.asarray(x), **kw), rng)
    fn = jax.jit(lambda p, xx: jax_mod.apply({"params": p}, xx, **kw))
    y_ref, vjp = jax.vjp(fn, tree, jnp.asarray(x))
    g = rng.standard_normal(y_ref.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(g))
    state = convert(tree, root)
    assert state.keys() == port_mod.state_dict().keys()
    port_mod.load_state_dict(state)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_mod(xt, **kw)
    names, params = zip(*port_mod.named_parameters())
    grads = torch.autograd.grad(y, [xt, *params], torch.from_numpy(g))
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    want = convert(np_tree(dp), root)
    want["x"] = torch.from_numpy(np.array(dx))
    for n, gr in zip(("x", *names), grads):  # sums over many voxels: relative to the leaf's largest entry
        w = want[n].numpy()
        assert float(np.abs(gr.numpy() - w).max()) <= GRAD_REL * float(np.abs(w).max()), n
    return tree, y.detach()


# ---------------------------------------------------------------- configs


def test_variant_overrides_as_jax():
    """``variant``: the name's config and loss config (held to JAX's in
    ``test_torch_nn.py``); overrides reach a factory that takes them; a `_dr`
    lambda refuses any, in both packages."""
    for name in configs.REGISTRY:
        assert configs.variant(name) == (configs.REGISTRY[name](), configs.loss_config(name))
    assert configs.variant("pascal_nolbo", category_dim=7)[0].category_dim == 7
    for mod in (configs, jax_configs):
        with pytest.raises(TypeError):
            mod.variant("modelnet_ae_dr", z_dim=4)


@pytest.mark.parametrize("name", sorted(jax_configs.REGISTRY))
def test_every_name_converts_at_full_width(name):
    """The flax tree of each name, at full width, fills the port's model
    exactly (no leaf left over or missing, every shape equal): the converter
    knows every layout's names."""
    cfg = jax_configs.REGISTRY[name]()
    x = jnp.zeros((1, 64, 64, 3)) if cfg.encoder == "image" else jnp.zeros((1, *cfg.decoder.output_shape))
    shapes = jax.eval_shape(lambda k: JaxVAE(cfg).init({"params": k, "dropout": k}, x, method=JaxVAE.initialize),
                            jax.random.PRNGKey(0))["params"]
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with torch.device("meta"):
        model = MultiModalVAE(configs.REGISTRY[name]())
    model.load_state_dict(params_from_flax(tree), strict=True, assign=True)
    assert decoder_blocked_block(configs.REGISTRY[name]()) == JaxVAE(cfg).decoder_block


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("f", [64, 12])
def test_phase_group_norm_matches_flax(f):
    """Groups over every phase and a slice of the fine channels
    (``_num_groups(f)`` of them), not per phase: forward and gradients."""
    x = np.random.default_rng(f).normal(size=(2, 3, 2, 4, 8 * f)).astype(np.float32)
    x[..., :f] += 3.0  # phase 0 off the others: per-phase statistics would differ
    _, y = check_module(jax_blocks.PhaseGroupNorm(f, phases=8), blocks.PhaseGroupNorm(f, 8), x, root="PhaseGroupNorm")
    per_phase = blocks.group_norm(8 * f)(torch.from_numpy(x)).detach()
    assert float((y - per_phase).abs().max()) > 0.1


@pytest.mark.parametrize("phase_output", [False, True])
def test_conv_transpose_equiv_matches_flax(phase_output):
    """``ConvTransposeEquiv3D``, fine and phase output (B, D, H, W, 8 Cout):
    forward and gradients; the weight in ``ConvTranspose3d``'s layout, whose
    module computes the same function from it."""
    x = np.random.default_rng(1).normal(size=(2, 4, 3, 5, 6)).astype(np.float32)
    port = blocks.ConvTransposeEquiv3D(6, 3)
    _, y = check_module(jax_blocks.ConvTransposeEquiv3D(3), port, x, root="ConvTransposeEquiv3D",
                        phase_output=phase_output)
    classic = blocks.ConvTranspose3d(6, 3, 4, 2)
    classic.load_state_dict(port.state_dict())
    fine = classic(torch.from_numpy(x)).detach()
    want = blocks.space_to_depth3d(fine, 2) if phase_output else fine
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)


def test_probe_times_two_forms_of_one_function():
    """``cli/probe_transpose.py`` holds its two lowerings to each other before timing them (CPU: the check alone)."""
    res = probe_transpose.main(["--device", "cpu", "--batch", "1", "--grid", "4", "--cin", "8"])
    assert set(res) == {"float32", "tf32", "bfloat16"}


def test_deconv_equiv_block_matches_flax():
    x = np.random.default_rng(2).normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
    check_module(jax_blocks.DeconvEquivBlock3D(4), blocks.DeconvEquivBlock3D(8, 4), x)


# ---------------------------------------------------------------- encoder, decoder


def encoder_configs(stem, pool):
    """(jax, port) classic encoders on 32^3 x 1, narrow filters."""
    return [mod.Encoder3DConfig(output_dim=6, filter_nums=(4, 8, 8, 16), strides=(2, 2, 2, 2, 1), final_pool=pool,
                                stem_space_to_depth=stem) for mod in (jax_ae, ae)]


@pytest.mark.parametrize("stem,pool", [(1, "average"), (2, "average"), (2, "max"), (1, "none")])
def test_classic_encoder_matches_flax(stem, pool):
    """The classic encoder (``head_blocked`` off): a k=4 s=2 stem on the
    grid, or (s2d 2) a k=2 s=1 stem over 8 channels, ``conv_k2``; mean, max
    or no pool."""
    jax_cfg, cfg = encoder_configs(stem, pool)
    x = (np.random.default_rng(stem).uniform(size=(2, 32, 32, 32, 1)) > 0.6).astype(np.float32)
    enc = ae.Encoder3D(cfg)
    assert isinstance(enc.convblock3d_0.conv_0, blocks.ConvK2) == (stem == 2)
    _, y = check_module(jax_ae.Encoder3D(jax_cfg), enc, x)
    assert y.shape == ((2, 6) if pool != "none" else (2, 2, 2, 2, 6))
    with pytest.raises(ValueError, match="blocked_input"):
        enc(torch.from_numpy(x), blocked_input=True)


def decoder_configs(layout):
    """(jax, port) decoders of each layout: 16^3 classic ones, a 32^3 blocked tail."""
    out = []
    for mod in (jax_ae, ae):
        if layout.startswith("tail"):
            base = mod.Decoder3DConfig(input_dim=4, output_shape=(32, 32, 32, 1), filter_nums=(16, 8, 8, 4, 1),
                                       strides=(1, 2, 2, 2, 2), tail_blocked=True)
        else:
            base = mod.Decoder3DConfig(input_dim=4, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 4, 1),
                                       filter_sizes=(4, 4, 4, 4), strides=(1, 2, 2, 2), final_mode="transpose")
        change = {"transpose": {}, "transpose_s1": {"strides": (2, 2, 2, 1)},
                  "equiv": {"final_mode": "transpose_equiv"}, "equiv_blocked": {"final_mode": "transpose_equiv"},
                  "mid_equiv": {"final_mode": "transpose_equiv", "mid_equiv": True},
                  "tail_phase_norm": {"tail_phase_norm": True}, "tail_phase_norm_blocked": {"tail_phase_norm": True},
                  "tail_init_match_transpose": {"tail_init_match_transpose": True}}[layout]
        out.append(dataclasses.replace(base, **change))
    return out


DECODER_NAMES = {
    "transpose": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "convtranspose_0"],
    "transpose_s1": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "convtranspose_0"],
    "equiv": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "convtransposeequiv3d_0"],
    "equiv_blocked": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "convtransposeequiv3d_0"],
    "mid_equiv": ["deconvblock3d_0", "deconvequivblock3d_0", "deconvequivblock3d_1", "convtransposeequiv3d_0"],
    "tail_phase_norm": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "conv_0", "phasegroupnorm_0",
                        "conv_1"],
    "tail_phase_norm_blocked": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "conv_0",
                                "phasegroupnorm_0", "conv_1"],
    "tail_init_match_transpose": ["deconvblock3d_0", "deconvblock3d_1", "deconvblock3d_2", "conv_0", "groupnorm_0",
                                  "conv_1"],
}


@pytest.mark.parametrize("layout", sorted(DECODER_NAMES))
def test_decoder_layouts_match_flax(layout):
    """Each decoder layout: flax's submodule names (numbered per class),
    forward and gradients; ``blocked_output`` where the layout has it (the
    phase-equivalent final stage emits the space-to-depth(4) layout of its
    fine output straight from the phase tensor)."""
    jax_cfg, cfg = decoder_configs(layout)
    dec = ae.Decoder3D(cfg)
    assert [n for n, _ in dec.named_children()] == ["denseblock_0"] + DECODER_NAMES[layout]
    z = np.random.default_rng(len(layout)).normal(size=(2, 4)).astype(np.float32)
    blocked = layout.endswith("blocked")
    _, y = check_module(jax_ae.Decoder3D(jax_cfg), dec, z, blocked_output=blocked)
    if blocked:
        np.testing.assert_allclose(y.numpy(), blocks.space_to_depth3d(dec(torch.from_numpy(z)).detach(), 4).numpy(),
                                   rtol=0, atol=1e-6)
    elif not (jax_ae.decoder_tail_blocked_active(jax_cfg) or jax_ae.decoder_final_equiv_active(jax_cfg)):
        with pytest.raises(ValueError, match="blocked_output"):
            dec(torch.from_numpy(z), blocked_output=True)


def test_tail_init_match_transpose_scales_the_init():
    """The blocked tail's two convs start at std sqrt(1/8) of lecun's (flax
    ``TRANSPOSE_MATCH_INIT``); the other stages keep lecun's."""
    jax_cfg, cfg = decoder_configs("tail_init_match_transpose")
    plain = ae.Decoder3D(dataclasses.replace(cfg, tail_init_match_transpose=False),
                         generator=torch.Generator().manual_seed(0))
    scaled = ae.Decoder3D(cfg, generator=torch.Generator().manual_seed(0))
    flax = np_tree(jax.jit(lambda k: jax_ae.Decoder3D(jax_cfg).init(k, jnp.zeros((1, 4))))(jax.random.PRNGKey(0))
                   ["params"])
    for conv in ("conv_0", "conv_1"):
        w, w0 = getattr(scaled, conv).weight.detach(), getattr(plain, conv).weight.detach()
        fan_in = 8 * w.shape[3]
        for std in (float(w.std()), float(np.std(flax[conv.replace("conv", "Conv")]["kernel"]))):
            assert abs(std * math.sqrt(8 * fan_in) - 1.0) < 0.1, (conv, std)
        assert abs(float(w.std()) / float(w0.std()) - 8**-0.5) < 0.05
    assert torch.equal(scaled.deconvblock3d_1.convtranspose_0.weight, plain.deconvblock3d_1.convtranspose_0.weight)


def test_remap_decoder_params_both_ways_as_jax():
    """The classic decoder's weights renamed into the phase-equivalent layout
    (``mid_equiv`` + ``transpose_equiv``) and back: the JAX package's renaming
    on the converted tree, and the same function from either."""
    _, classic = decoder_configs("transpose")
    jax_classic, _ = decoder_configs("transpose")
    jax_equiv, equiv = decoder_configs("mid_equiv")
    tree = random_tree(lambda k: jax_ae.Decoder3D(jax_classic).init(k, jnp.zeros((1, 4))), np.random.default_rng(5))
    there = jax_ae.remap_decoder_params(tree, jax_classic, jax_equiv)
    got = ae.remap_decoder_params(params_from_flax(tree), classic, equiv)
    want = params_from_flax(there)
    assert got.keys() == want.keys() == ae.Decoder3D(equiv).state_dict().keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    back = ae.remap_decoder_params(got, equiv, classic)
    src = params_from_flax(tree)
    assert back.keys() == src.keys() and all(torch.equal(back[k], src[k]) for k in src)
    z = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 4)).astype(np.float32))
    a, b = ae.Decoder3D(classic), ae.Decoder3D(equiv)
    a.load_state_dict(src)
    b.load_state_dict(got)
    np.testing.assert_allclose(a(z).detach().numpy(), b(z).detach().numpy(), **TOL)


def test_remap_decoder_params_refuses_what_jax_refuses():
    """A blocked tail or a pixel shuffle and the classic decoder are other
    parameterizations; stage counts must agree; a conv leaf beyond the weight
    would be dropped. Each refused as the JAX package refuses it."""
    jax_classic, classic = decoder_configs("transpose")
    tree = random_tree(lambda k: jax_ae.Decoder3D(jax_classic).init(k, jnp.zeros((1, 4))), np.random.default_rng(7))
    for change, match in (({"final_mode": "pixel_shuffle", "tail_blocked": True}, "not tensor-compatible"),
                          ({"final_mode": "pixel_shuffle"}, "not tensor-compatible"),
                          ({"filter_nums": (16, 8, 1), "filter_sizes": (4, 4, 4), "strides": (1, 2, 2)},
                           "stage mismatch")):
        with pytest.raises(ValueError, match=match):
            jax_ae.remap_decoder_params(tree, jax_classic, dataclasses.replace(jax_classic, **change))
        with pytest.raises(ValueError, match=match):
            ae.remap_decoder_params(params_from_flax(tree), classic, dataclasses.replace(classic, **change))
    _, equiv = decoder_configs("mid_equiv")
    state = params_from_flax(tree)
    state["deconvblock3d_1.convtranspose_0.bias"] = torch.zeros(8)
    with pytest.raises(ValueError, match="drop"):
        ae.remap_decoder_params(state, classic, equiv)


@pytest.mark.parametrize("part,change", [("encoder3d", {"mid_blocked": True}), ("decoder", {"mid_blocked": True})])
def test_mid_blocked_stays_unported(part, change):
    """``mid_blocked``, once refused, is ported: at full width on
    ``modelnet_nolbo`` the flax tree of that layout fills the port's model
    exactly (the folded encoder stages' 8 C-deep k=2 convs, the decoder's
    middle ``Conv_i`` and ``GroupNorm_i`` numbered with the tail's), and
    the stages it folds run on ``conv_k2``."""
    jax_base, base = jax_configs.modelnet_nolbo(), configs.modelnet_nolbo()
    jax_cfg = dataclasses.replace(jax_base, **{part: dataclasses.replace(getattr(jax_base, part), **change)})
    cfg = dataclasses.replace(base, **{part: dataclasses.replace(getattr(base, part), **change)})
    shapes = jax.eval_shape(lambda k: JaxVAE(jax_cfg).init({"params": k, "dropout": k},
                                                           jnp.zeros((1, *cfg.decoder.output_shape)),
                                                           method=JaxVAE.initialize), jax.random.PRNGKey(0))["params"]
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with torch.device("meta"):
        model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree), strict=True, assign=True)
    convs = [m for m in getattr(model, part).modules() if isinstance(m, blocks.ConvK2)]
    assert len(convs) == 2 + 2  # the blocked head's or tail's two, and the two folded stages


# ---------------------------------------------------------------- the model without a category prior


def small_voxel(name):
    """(jax, port) configs of ``name`` (a voxel config) at 32^3, narrow filters, z = Z."""
    out = []
    for mod in (jax_configs, configs):
        base = getattr(mod, name)(z_dim=Z)
        out.append(dataclasses.replace(
            base,
            encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32)),
            decoder=dataclasses.replace(base.decoder, output_shape=(DIM,) * 3 + (1,), filter_nums=(32, 16, 16, 8, 1)),
        ))
    return out


_MODELS = {}


def voxel_model(name):
    """(jax model, tree, port model) of ``small_voxel(name)`` on one random tree, built once."""
    if name not in _MODELS:
        jax_cfg, cfg = small_voxel(name)
        jax_model = JaxVAE(jax_cfg)
        tree = random_tree(lambda k: jax_model.init({"params": k, "dropout": k}, jnp.zeros((1, DIM, DIM, DIM, 1)),
                                                    method=JaxVAE.initialize), np.random.default_rng(len(name)))
        model = MultiModalVAE(cfg)
        model.load_state_dict(params_from_flax(tree))
        _MODELS[name] = (jax_model, tree, model.eval())
    return _MODELS[name]


def voxel_batch(seed, n=B):
    rng = np.random.default_rng(seed)
    vox = (rng.uniform(size=(n, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32)
    return {"input": vox, "target": vox, "category_onehot": np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]}


def anchors(seed=9):
    return np.random.default_rng(seed).normal(scale=0.5, size=(K, Z)).astype(np.float32)


def test_ae_encodes_means_alone():
    """``variational=False``: the encoder's output is the latent, every log-var None."""
    jax_model, tree, model = voxel_model("modelnet_ae")
    x = voxel_batch(0)["input"]
    enc = model.encode(torch.from_numpy(x))
    ref = jax.jit(lambda p, xx: jax_model.apply({"params": p}, xx, method=JaxVAE.encode))(tree, jnp.asarray(x))
    assert enc.log_var is None and enc.log_var_category is None and ref.log_var is None
    assert enc.mean.shape == (B, Z)
    np.testing.assert_allclose(enc.mean.detach().numpy(), np.asarray(ref.mean), **Z_TOL)


def anytime_draws(key, missing_prob, variational):
    k_cat, _, k_mask, k_corr = jax.random.split(key, 4)
    d = {"eps_cat": jax.random.normal(k_cat, (B, Z))} if variational else {}
    if missing_prob > 0:
        d["keep"] = jax.random.bernoulli(k_mask, 1.0 - jnp.float32(missing_prob), (B, Z))
        d["eps_corr"] = jax.random.normal(k_corr, (B, Z))
    return np_tree(d)


@pytest.mark.parametrize("name", ["modelnet_ae", "modelnet_vae"])
@pytest.mark.parametrize("missing_prob", [0.0, 0.5])
def test_anytime_eval_with_external_anchors_matches_jax(name, missing_prob):
    """A model without a category prior evaluated against external class
    anchors (``category_vectors``'s role): every metric as JAX's; the AE's
    latent is its mean (no draw); without anchors both refuse."""
    jax_model, tree, model = voxel_model(name)
    batch, pm = voxel_batch(1), anchors()
    key = jax.random.PRNGKey(4)
    ref = np_tree(jax_engine.anytime_eval_jit(jax_model, tree, jax.tree.map(jnp.asarray, batch), key, missing_prob,
                                              prior_means=jnp.asarray(pm)))
    draws = t(anytime_draws(key, missing_prob, name == "modelnet_vae"))
    got = engine.anytime_eval(model, t({k: v for k, v in batch.items() if k != "target"}),
                              missing_prob=missing_prob, prior_means=torch.from_numpy(pm), draws=draws)
    assert set(got) == set(ref)
    for k in ref:
        if "acc" in k:
            assert float(got[k]) == float(ref[k]), k
        elif "precision" in k or "recall" in k:
            assert abs(float(got[k]) - float(ref[k])) <= PR_ATOL, k
        else:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=LOSS_RTOL, err_msg=k)
    with pytest.raises(ValueError, match="prior_means required"):
        engine.anytime_eval(model, t({"input": batch["input"]}), missing_prob=missing_prob, draws=draws)


def test_category_vectors_on_an_ae_match_jax():
    jax_model, tree, model = voxel_model("modelnet_ae")
    batches = [voxel_batch(10 + i) for i in range(2)]
    want = jax_protocols.category_vectors(jax_model, tree, lambda b: jax.tree.map(jnp.asarray, batches[b]), K, 2)
    got = protocols.category_vectors(model, lambda b: batches[b], K, 2)
    np.testing.assert_allclose(got, want, **Z_TOL)


@pytest.mark.parametrize("with_anchors", [True, False])
def test_dump_reconstructions_of_an_ae_match_jax(tmp_path, with_anchors):
    """An AE's dumps decode its mean (no posterior draw): the JAX files,
    keys and grids, with external anchors (corrected grids and classes) and
    without (neither)."""
    jax_model, tree, model = voxel_model("modelnet_ae")
    batch, rates, seed = voxel_batch(5, n=2), (0.5,), 3
    pm = anchors() if with_anchors else None
    jax_paths = jax_dump.dump_reconstructions(jax_model, tree, jax.tree.map(jnp.asarray, batch), str(tmp_path / "jax"),
                                              rates=rates, prior_means=None if pm is None else jnp.asarray(pm),
                                              seed=seed)
    draws = {}
    for rate in rates:
        _, k_m, k_c = jax.random.split(jax.random.PRNGKey(seed + int(rate * 1000)), 3)
        draws[rate] = t({"keep": jax.random.bernoulli(k_m, 1.0 - rate, (2, Z)),
                         "eps_corr": jax.random.normal(k_c, (2, Z))})
    paths = dump.dump_reconstructions(model, t({k: v for k, v in batch.items() if k != "target"}),
                                      str(tmp_path / "port"), rates=rates,
                                      prior_means=None if pm is None else torch.from_numpy(pm), seed=seed, draws=draws)
    for rate in rates:
        with np.load(paths[str(rate)]) as got, np.load(jax_paths[str(rate)]) as ref:
            assert set(got.files) == set(ref.files) == {"gt", "pred", "mask", "rate"} | (
                {"pred_corrected", "pred_class"} if with_anchors else set())
            for k in set(ref.files) - {"pred", "pred_corrected"}:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            for k in {"pred", "pred_corrected"} & set(ref.files):
                np.testing.assert_allclose(got[k], ref[k], atol=PRED_TOL, rtol=0, err_msg=k)


def masks(n=B, seed=0):
    m = (np.random.default_rng(seed).uniform(size=(n, Z)) < 0.5).astype(np.float32)
    m[0], m[1] = 1.0, 0.0
    return m


@pytest.mark.parametrize("name", ["modelnet_ae", "modelnet_vae"])
@pytest.mark.parametrize("with_anchors", [True, False])
def test_serving_without_class_priors_matches_jax(name, with_anchors):
    """``make_infer_fn`` with external anchors (a ``category``, the missing
    dims filled from the nearest) and without (no ``category``, missing dims
    0): JAX's outputs; ``z_log_var`` zeros for the AE; the port's ``pred``
    is the decoder's output (JAX applies a second sigmoid)."""
    jax_model, tree, model = voxel_model(name)
    x, mask = voxel_batch(2)["input"], masks()
    pm = anchors() if with_anchors else None
    ref = np_tree(jax.jit(jax_make_infer_fn(jax_model, prior_means=None if pm is None else jnp.asarray(pm)))(
        tree, jnp.asarray(x), jnp.asarray(mask)))
    out = {k: v.numpy() for k, v in make_infer_fn(model, prior_means=pm)(torch.from_numpy(x),
                                                                          torch.from_numpy(mask)).items()}
    assert set(out) == set(ref) == {"z_mean", "z_log_var", "pred"} | ({"category"} if with_anchors else set())
    if with_anchors:
        np.testing.assert_array_equal(out["category"], ref["category"])
    np.testing.assert_allclose(out["z_mean"], ref["z_mean"], **Z_TOL)
    np.testing.assert_allclose(out["z_log_var"], ref["z_log_var"], **Z_TOL)
    if name == "modelnet_ae":
        assert not out["z_log_var"].any()
    if not with_anchors:
        assert not out["z_mean"][1].any()  # the empty mask: every dim filled with 0
    np.testing.assert_allclose(1 / (1 + np.exp(-out["pred"])), ref["pred"], atol=PRED_TOL, rtol=0)
    with pytest.raises(ValueError, match="expected"):
        make_infer_fn(model, prior_means=np.zeros((K, Z + 1), np.float32))


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/infer", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_latents_export_and_serve_an_ae_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``cli.evaluate --latents-out`` on an AE (its batches carry the class
    labels; the JAX command's omit them and fail), ``cli.export
    --prior-means`` of those vectors, ``cli.serve --artifact``: the replies
    carry the class of the eager program with the same anchors. A wrong
    anchor shape is refused."""
    jax_cfg, cfg = small_voxel("modelnet_ae")
    _, _, model = voxel_model("modelnet_ae")
    monkeypatch.setitem(configs.REGISTRY, "modelnet_ae", lambda: cfg)
    monkeypatch.setitem(jax_configs.REGISTRY, "modelnet_ae", lambda: jax_cfg)
    with pytest.raises(KeyError, match="category_onehot"):
        jax_cli_evaluate.main(["--config", "modelnet_ae", "--latents-out", str(tmp_path / "jax.npy"),
                               "--batches", "1", "--batch-size", "2"])
    save_params(str(tmp_path / "ckpt"), model.state_dict())
    vec_path = tmp_path / "v.npy"
    vecs = cli_evaluate.main(["--config", "modelnet_ae", "--ckpt", str(tmp_path / "ckpt"), "--latents-out",
                              str(vec_path), "--batches", "2", "--batch-size", "4", "--device", "cpu"])
    assert vecs.shape == (40, Z) and np.isfinite(vecs).all() and np.abs(vecs).sum() > 0
    np.testing.assert_array_equal(np.load(vec_path), vecs)
    out = tmp_path / "ae.pt2"
    cli_export.main(["--config", "modelnet_ae", "--ckpt", str(tmp_path / "ckpt"), "--batch-size", "2",
                     "--prior-means", str(vec_path), "--out", str(out), "--device", "cpu"])
    np.save(tmp_path / "bad.npy", vecs[:, :-1])
    with pytest.raises(SystemExit, match="expected"):
        cli_export.main(["--config", "modelnet_ae", "--prior-means", str(tmp_path / "bad.npy"), "--out",
                         str(tmp_path / "bad.pt2"), "--device", "cpu"])
    x, mask = voxel_batch(3, n=2)["input"], masks(n=2)
    server, _ = cli_serve.build_server(cli_serve.parse_args(["--artifact", str(out), "--device", "cpu"]))
    try:
        port = server.serve(0, background=True)
        replies = []
        for i in range(2):
            status, reply = _post(port, {"input": x[i].tolist(), "mask": mask[i].tolist()})
            assert status == 200, reply
            replies.append(reply)
    finally:
        server.close()
    ref = make_infer_fn(model, prior_means=vecs)(torch.from_numpy(x), torch.from_numpy(mask))
    for i, reply in enumerate(replies):
        assert reply["category"] == int(ref["category"][i])
        np.testing.assert_allclose(reply["z_mean"], ref["z_mean"][i].numpy(), rtol=1e-5, atol=1e-5)
        assert not any(reply["z_log_var"])


def test_serve_config_without_priors_fills_zeros(monkeypatch, tmp_path):
    """``cli.serve --config`` of a VAE without a category prior: replies
    without ``category``, as the eager program of the same weights answers."""
    _, cfg = small_voxel("modelnet_vae")
    _, _, model = voxel_model("modelnet_vae")
    monkeypatch.setitem(configs.REGISTRY, "modelnet_vae", lambda: cfg)
    save_params(str(tmp_path / "ckpt"), model.state_dict())
    server, _ = cli_serve.build_server(cli_serve.parse_args(["--config", "modelnet_vae", "--dim", str(DIM),
                                                             "--checkpoint", str(tmp_path / "ckpt"),
                                                             "--device", "cpu", "--batch-size", "2"]))
    x, mask = voxel_batch(4, n=2)["input"], masks(n=2)
    try:
        port = server.serve(0, background=True)
        status, reply = _post(port, {"voxels_packed_b64": base64.b64encode(pack_voxels(x[:1])[0].tobytes()).decode(),
                                     "mask": mask[0].tolist()})
    finally:
        server.close()
    assert status == 200 and "category" not in reply, reply
    assert set(reply) == {"z_mean", "z_log_var", "pred_packed_b64"}
    ref = make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(reply["z_mean"], ref["z_mean"][0].numpy(), rtol=1e-5, atol=1e-5)
