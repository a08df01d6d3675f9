"""PyTorch port, the streaming ``AnytimeReconstructor`` against the JAX
package's on the CPU.

The model is ``tests/test_train.py::tiny_voxel_cfg`` (a variational voxel
model, z = 8, 5 classes, 16^3), as ``tests/test_anytime_reconstructor.py``
runs it, on weights converted from the flax tree (flax's init moved off ones
and zeros by a seeded normal). Each of that file's four reconstructor tests is
mirrored here against the JAX reconstructor, with its property checks kept:
the streaming loop (monotone uncertainty, the decoded shape; the sampled
decode on JAX's normal draw handed over), ``observe_stream`` against the loop
(the mesh form at one rank), ``classify`` and ``correct``; then
the class anchors, ``encode_observation`` and the occupancy-space fusion.

Tolerances (float32 both sides): the encoded blocks and the class anchors
1e-4 relative and 1e-5 absolute (a few layers summed in another order); the
beliefs' information and precision 1e-4 of each array's largest entry (sums
of exp(-log_var) of those blocks); decoded grids 1e-5 absolute
(probabilities); labels exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.anytime import AnytimeReconstructor as JaxReconstructor
from anytime3d_tpu.anytime.engine import GaussianBelief as JaxBelief
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu_torch.anytime import AnytimeReconstructor
from anytime3d_tpu_torch.anytime.engine import GaussianBelief
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.models.mmvae import MMVAEConfig, MultiModalVAE
from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
from anytime3d_tpu_torch.nn.priornet import PriorNetConfig
from tests.test_train import synth_batch, tiny_voxel_cfg

Z, CAT = 8, 5
ENC_TOL = dict(rtol=1e-4, atol=1e-5)
BELIEF_REL = 1e-4
PRED_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def port_config(jax_cfg) -> MMVAEConfig:
    """The port's MMVAEConfig with the same fields as the JAX one."""
    d = dataclasses.asdict(jax_cfg)
    d["encoder3d"] = Encoder3DConfig(**d["encoder3d"])
    d["decoder"] = Decoder3DConfig(**d["decoder"])
    d["prior_category"] = PriorNetConfig(**d["prior_category"])
    return MMVAEConfig(**d)


@pytest.fixture(scope="module")
def recs():
    """(JAX reconstructor, port reconstructor, input batch as numpy)."""
    jax_cfg = tiny_voxel_cfg(variational=True, with_prior=True)
    jax_model = JaxVAE(jax_cfg)
    batch = {k: np.array(v) for k, v in synth_batch(n=8).items()}
    init = jax.jit(lambda k1, k2: jax_model.init({"params": k1, "dropout": k2}, jnp.asarray(batch["input"]),
                                                 method=JaxVAE.initialize))(jax.random.PRNGKey(0),
                                                                            jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=a.shape)).astype(np.float32), init)
    model = MultiModalVAE(port_config(jax_cfg))
    model.train()  # the anchors must come from the prior net in eval mode all the same
    rec = AnytimeReconstructor(model, params_from_flax(tree))
    assert model.training
    return JaxReconstructor(jax_model, jax.tree.map(jnp.asarray, tree)), rec, batch


def np_(x):
    return np.asarray(x)


def assert_beliefs_close(got: GaussianBelief, want):
    for name in ("info", "precision"):
        a, b = getattr(got, name).numpy(), np_(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=BELIEF_REL * float(np.abs(b).max()), err_msg=name)


def encode_both(jrec, rec, x):
    jm, jlv = jrec.encode_observation(jnp.asarray(x))
    m, lv = rec.encode_observation(torch.from_numpy(x))
    np.testing.assert_allclose(m.numpy(), np_(jm), **ENC_TOL)
    np.testing.assert_allclose(lv.numpy(), np_(jlv), **ENC_TOL)
    return (jm[0], jlv[0]), (m[0], lv[0])


def test_anchors_and_encode_match_jax(recs):
    jrec, rec, batch = recs
    np.testing.assert_allclose(rec.prior_means.numpy(), np_(jrec.prior_means), **ENC_TOL)
    np.testing.assert_allclose(rec.prior_log_vars.numpy(), np_(jrec.prior_log_vars), **ENC_TOL)
    assert rec.prior_means.shape == (CAT, Z)
    encode_both(jrec, rec, batch["input"])


def test_streaming_observation_loop(recs):
    """Four masked observations of one object: the belief after each
    against JAX's, the uncertainty falling; the mean decode and a sampled
    decode (JAX's normal draw from the same key) against JAX's."""
    jrec, rec, batch = recs
    (jm, jlv), (m, lv) = encode_both(jrec, rec, batch["input"][:1])
    jbelief, belief = jrec.new_object(), rec.new_object()
    assert belief.mean.shape == (Z,)
    rng = np.random.default_rng(0)
    uncert = []
    for _ in range(4):
        mask = (rng.uniform(size=(Z,)) > 0.5).astype(np.float32)
        jbelief = jrec.observe(jbelief, jm, jlv, jnp.asarray(mask))
        belief = rec.observe(belief, m, lv, torch.from_numpy(mask))
        assert_beliefs_close(belief, jbelief)
        uncert.append(float((1.0 / belief.precision).sum()))
    assert all(b <= a + 1e-6 for a, b in zip(uncert, uncert[1:]))
    shape = rec.decode(belief)
    assert shape.shape == (1, 16, 16, 16, 1)
    np.testing.assert_allclose(shape.numpy(), np_(jrec.decode(jbelief)), rtol=0, atol=PRED_ATOL)
    key = jax.random.PRNGKey(7)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (Z,))))
    np.testing.assert_allclose(rec.decode(belief, eps=eps).numpy(), np_(jrec.decode(jbelief, key)), rtol=0,
                               atol=PRED_ATOL)
    gen = torch.Generator().manual_seed(0)
    assert rec.decode(belief, generator=gen).shape == shape.shape


def test_observe_stream_matches_loop(recs):
    """Eight observations at once against the loop and against JAX's stream;
    the mesh form at one rank (gloo, an in-process store) against the
    stream. Over 2 ranks it is held to JAX's in ``test_torch_parallel.py``."""
    jrec, rec, batch = recs
    (jm, jlv), (m, lv) = encode_both(jrec, rec, batch["input"][:1])
    T = 8
    rng = np.random.default_rng(1)
    masks = (rng.uniform(size=(T, Z)) > 0.5).astype(np.float32)
    means = torch.stack([m + 0.01 * t for t in range(T)])
    lvs = torch.stack([lv for _ in range(T)])
    belief0 = rec.new_object()
    loop = belief0
    for t in range(T):
        loop = rec.observe(loop, means[t], lvs[t], torch.from_numpy(masks[t]))
    stream = rec.observe_stream(belief0, means, lvs, torch.from_numpy(masks))
    np.testing.assert_allclose(stream.precision.numpy(), loop.precision.numpy(), rtol=1e-5)
    np.testing.assert_allclose(stream.mean.numpy(), loop.mean.numpy(), rtol=1e-4, atol=1e-6)
    jstream = jrec.observe_stream(jrec.new_object(), jnp.stack([jm + 0.01 * t for t in range(T)]),
                                  jnp.stack([jlv] * T), jnp.asarray(masks))
    assert_beliefs_close(stream, jstream)
    import torch.distributed as dist

    from anytime3d_tpu_torch.parallel import mesh as mesh_module

    try:
        sharded = rec.observe_stream(belief0, means, lvs, torch.from_numpy(masks),
                                     mesh=mesh_module.make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
        mesh_module._mesh.cache_clear()
    np.testing.assert_allclose(sharded.precision.numpy(), stream.precision.numpy(), rtol=1e-6)
    np.testing.assert_allclose(sharded.mean.numpy(), stream.mean.numpy(), rtol=1e-5, atol=1e-7)


def test_classify_returns_index(recs):
    """One object and a batch of 8, fully observed: JAX's labels."""
    jrec, rec, batch = recs
    (jm, jlv), (m, lv) = encode_both(jrec, rec, batch["input"][:1])
    label = rec.classify(rec.observe(rec.new_object(), m, lv))
    assert label.shape == (1,) and 0 <= int(label[0]) < CAT
    assert int(label[0]) == int(jrec.classify(jrec.observe(jrec.new_object(), jm, jlv))[0])
    jall, all_ = jrec.encode_observation(jnp.asarray(batch["input"])), rec.encode_observation(
        torch.from_numpy(batch["input"]))
    labels = rec.classify(rec.observe(rec.new_object((8,)), *all_))
    np.testing.assert_array_equal(labels.numpy(), np_(jrec.classify(jrec.observe(jrec.new_object((8,)), *jall))))


@pytest.mark.parametrize("batched", [False, True])
def test_correct_fills_unobserved(recs, batched):
    """Half the dims observed: the observed ones keep their mean, the
    unobserved ones become informative; JAX's corrected belief, one object
    or a batch of 8 with masks of their own."""
    jrec, rec, batch = recs
    n = 8 if batched else 1
    jm, jlv = jrec.encode_observation(jnp.asarray(batch["input"][:n]))
    m, lv = rec.encode_observation(torch.from_numpy(batch["input"][:n]))
    mask = np.tile(np.asarray([1.0] * 4 + [0.0] * 4, np.float32), (n, 1))
    if batched:
        mask = np.stack([np.roll(row, i) for i, row in enumerate(mask)])
    else:
        jm, jlv, m, lv, mask = jm[0], jlv[0], m[0], lv[0], mask[0]
    jbelief = jrec.observe(jrec.new_object(jm.shape[:-1]), jm, jlv, jnp.asarray(mask))
    belief = rec.observe(rec.new_object(m.shape[:-1]), m, lv, torch.from_numpy(mask))
    corrected = rec.correct(belief)
    assert corrected.mean.shape == belief.mean.shape
    seen = mask > 0
    np.testing.assert_allclose(corrected.mean.numpy()[seen], belief.mean.numpy()[seen], atol=1e-5)
    assert (corrected.precision.numpy()[~seen] > 0.5).all()
    assert_beliefs_close(corrected, jrec.correct(jbelief))


def test_observe_decoded_matches_jax(recs):
    """Three views' latents decoded into the log-odds belief, the last with a
    visibility mask, and a ``GaussianBelief`` decoded by its mean."""
    jrec, rec, batch = recs
    jz, _ = jrec.encode_observation(jnp.asarray(batch["input"][:3]))
    z, lv = rec.encode_observation(torch.from_numpy(batch["input"][:3]))
    vis = (np.random.default_rng(2).uniform(size=(1, 16, 16, 16, 1)) > 0.3).astype(np.float32)
    jocc, occ = jrec.new_shape_belief((1, 16, 16, 16, 1)), rec.new_shape_belief((1, 16, 16, 16, 1))
    for t in range(3):
        mask = vis if t == 2 else None
        jocc = jrec.observe_decoded(jocc, jz[t], None if mask is None else jnp.asarray(mask))
        occ = rec.observe_decoded(occ, z[t], None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(occ.log_odds.numpy(), np_(jocc.log_odds), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(occ.count.numpy(), np_(jocc.count))
    np.testing.assert_allclose(occ.probs.numpy(), np_(jocc.probs), rtol=0, atol=PRED_ATOL)
    belief = GaussianBelief.from_moments(z[0], lv[0])
    jbelief = JaxBelief.from_moments(jz[0], jnp.asarray(lv[0].numpy()))
    np.testing.assert_allclose(rec.observe_decoded(rec.new_shape_belief((1, 16, 16, 16, 1)), belief).probs.numpy(),
                               np_(jrec.observe_decoded(jrec.new_shape_belief((1, 16, 16, 16, 1)), jbelief).probs),
                               rtol=0, atol=PRED_ATOL)


def test_model_without_a_prior_needs_anchors(recs):
    _, rec, _ = recs
    cfg = dataclasses.replace(rec.model.config, prior_category=None, category_dim=0)
    model = MultiModalVAE(cfg)
    with pytest.raises(ValueError, match="prior_means required"):
        AnytimeReconstructor(model)
    anchors = torch.zeros(3, Z)
    assert AnytimeReconstructor(model, prior_means=anchors).classify(GaussianBelief.uninformative(
        (2, Z), device="cpu")).tolist() == [0, 0]
