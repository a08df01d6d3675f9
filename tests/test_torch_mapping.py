"""PyTorch port, the mapping geometry (``geometry/ba.py``, ``posegraph.py``,
``twoview.py``, ``features.py``) against the JAX package, on the CPU.

Mirrors ``tests/test_{ba,posegraph,twoview,features}.py``: their problems
(``make_problem``, ``odometry_graph``, ``_synthetic_pair``, ``_checker``)
go through both packages. Tolerances:

- float32 pieces of one step (residuals, Jacobians, the reduced system, the
  pose-graph update) to 1e-4 of each array's largest entry (``F32_REL``);
- float64 on both sides (``jax.enable_x64``) for the solvers' updates and
  histories, to 1e-9 (``F64``). In float32 the bundle adjustment's reduced
  system is nearly singular (the scene's scale is free and damping 1e-3
  holds it), so a solve turns ulps into 10% of the step: JAX's own float32
  step is that far from its float64 one, so the updates are compared where
  both libraries solve exactly;
- E up to sign (the null vector's sign is each library's); the pose and the
  points as the cheirality vote leaves them;
- keypoints, descriptors' validity and matches exactly; responses and
  descriptors to 1e-5 of the largest entry.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.geometry import ba as jba
from anytime3d_tpu.geometry import features as jft
from anytime3d_tpu.geometry import posegraph as jpg
from anytime3d_tpu.geometry import twoview as jtv
from anytime3d_tpu_torch.geometry import ba, features, posegraph, twoview
from tests.test_ba import make_problem
from tests.test_features import _checker
from tests.test_posegraph import odometry_graph
from tests.test_twoview import _synthetic_pair

F32_REL = 1e-4
F64 = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


def to_port(jax_obj, cls, dtype=None):
    """A JAX dataclass of arrays as the port's, each array a tensor (cast to ``dtype`` if floating)."""
    def t(a):
        x = torch.from_numpy(np.array(a))
        return x.to(dtype) if dtype is not None and x.is_floating_point() else x

    return cls(**{k: t(getattr(jax_obj, k)) for k in fields(jax_obj)})


def to_x64(jax_obj):
    return type(jax_obj)(**{k: jnp.asarray(np.asarray(getattr(jax_obj, k)),
                                           jnp.float64 if np.asarray(getattr(jax_obj, k)).dtype == np.float32 else None)
                            for k in fields(jax_obj)})


def assert_rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max()) + 1e-30
    assert float(np.abs(got - want).max()) <= rel * top, (what, float(np.abs(got - want).max()), top)


@contextlib.contextmanager
def x64():
    with jax.enable_x64(True):
        yield


# ---------------------------------------------------------------- bundle adjustment


def test_rodrigues_and_project_match_jax():
    """The identity, a quarter turn, random vectors (orthonormal), one at the
    small-angle switch; projections of random points."""
    rng = np.random.default_rng(0)
    vecs = [np.zeros(3), np.array([0.0, 0.0, np.pi / 2]), np.array([1e-7, 0.0, 0.0])] + [
        rng.normal(0, 1, 3) for _ in range(5)]
    for v in vecs:
        v = v.astype(np.float32)
        r = ba.rodrigues(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(r, np.asarray(jba.rodrigues(jnp.asarray(v))), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(ba.rodrigues(torch.tensor([0.0, 0.0, np.pi / 2])).numpy(),
                               [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)
    intr = np.float32([500, 500, 320, 240])
    for _ in range(5):
        pose = rng.normal(0, 0.1, 6).astype(np.float32)
        point = rng.normal([0, 0, 10], 1, 3).astype(np.float32)
        got = ba.project(*(torch.from_numpy(a) for a in (pose, point, intr))).numpy()
        np.testing.assert_allclose(got, np.asarray(jba.project(*(jnp.asarray(a) for a in (pose, point, intr)))),
                                   rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_one_ba_step_matches_jax(masked):
    """f32: residuals, both Jacobian blocks, the reduced system and its back-
    substitution blocks, the mse; f64: the step's poses and points (pose 0,
    the gauge, unmoved)."""
    problem, *_ = make_problem(p=4, l=32)
    if masked:
        mask = np.asarray(problem.mask).copy()
        mask[:, ::3] = 0.0
        mask[1, 1::4] = 0.0
        problem = dataclasses.replace(problem, mask=jnp.asarray(mask))
    port = to_port(problem, ba.BAProblem)
    args = (port.poses, port.points, port.observations, port.mask, port.intrinsics)
    got = ba._residual_and_jacobians(*args)
    want = jax.jit(jba._residual_and_jacobians)(problem.poses, problem.points, problem.observations, problem.mask,
                                                problem.intrinsics)
    for name, g, w in zip(("r", "jp", "jl"), got, want):
        assert_rel(g.numpy(), w, F32_REL, name)
    for name, g, w in zip(("S", "rhs", "Hll_inv", "bl", "W"), ba._schur_reduce(*got, 1e-3),
                          jax.jit(jba._schur_reduce, static_argnums=3)(*want, 1e-3)):
        assert_rel(g.numpy(), w, F32_REL, name)
    _, mse = ba.ba_step(port)
    _, jmse = jax.jit(jba.ba_step)(problem)
    np.testing.assert_allclose(float(mse), float(jmse), rtol=F32_REL)
    with x64():
        p64 = to_x64(problem)
        jnew, jmse = jax.jit(jba.ba_step)(p64)
        new, mse = ba.ba_step(to_port(p64, ba.BAProblem))
        assert new.poses.dtype == torch.float64
        np.testing.assert_allclose(new.poses.numpy(), np.asarray(jnew.poses), rtol=F64, atol=F64)
        np.testing.assert_allclose(new.points.numpy(), np.asarray(jnew.points), rtol=F64, atol=F64)
        np.testing.assert_allclose(float(mse), float(jmse), rtol=F64)
    np.testing.assert_array_equal(new.poses[0].numpy(), np.asarray(p64.poses)[0])


def test_ba_solve_history_matches_jax_and_converges():
    """10 steps in f64 on both sides to 1e-9; in f32 the port's run converges
    as JAX's test requires (the mse falls 20x, the geometry near the truth)."""
    problem, poses_gt, points_gt = make_problem(noise=0.5)
    with x64():
        p64 = to_x64(problem)
        jfinal, jhist = jax.jit(lambda p: jba.solve(p, iters=10))(p64)
        final, hist = ba.solve(to_port(p64, ba.BAProblem), iters=10)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=F64)
        np.testing.assert_allclose(final.points.numpy(), np.asarray(jfinal.points), rtol=1e-7, atol=1e-7)
    final, hist = ba.solve(to_port(problem, ba.BAProblem), iters=15)
    assert hist.shape == (15,) and hist.dtype == torch.float32
    assert float(hist[-1]) < float(hist[0]) * 0.05
    assert np.abs(final.poses.numpy()[:, 3:] - poses_gt[:, 3:]).mean() < 0.05
    assert np.abs(final.points.numpy() - points_gt).mean() < 0.1


# ---------------------------------------------------------------- pose graph


def test_se3_ops_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(6):
        rvec = rng.normal(0, 0.8, 3).astype(np.float32)
        r = ba.rodrigues(torch.from_numpy(rvec))
        back = posegraph.rotmat_to_rvec(r).numpy()
        np.testing.assert_allclose(back, rvec, atol=1e-4)
        np.testing.assert_allclose(back, np.asarray(jpg.rotmat_to_rvec(jnp.asarray(r.numpy()))), atol=1e-6)
        a, b = (rng.normal(0, 0.5, 6).astype(np.float32) for _ in range(2))
        ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
        for fn, jfn in ((posegraph.compose, jpg.compose), (posegraph.relative, jpg.relative)):
            np.testing.assert_allclose(fn(ta, tb).numpy(), np.asarray(jfn(ja, jb)), atol=1e-5)
        np.testing.assert_allclose(posegraph.inverse(ta).numpy(), np.asarray(jpg.inverse(ja)), atol=1e-5)
        np.testing.assert_allclose(posegraph.compose(ta, posegraph.inverse(ta)).numpy(), 0.0, atol=1e-4)
    np.testing.assert_array_equal(posegraph.rotmat_to_rvec(torch.eye(3)).numpy(), np.zeros(3))


def test_one_pgo_step_matches_jax():
    """The residuals, the step and its cost in f32 to 1e-4 of the largest
    entry; pose 0 unmoved."""
    graph, _ = odometry_graph(n=6, drift=0.15)
    port = to_port(graph, posegraph.PoseGraph)
    assert_rel(posegraph.graph_residuals(port).numpy(), jpg.graph_residuals(graph), F32_REL, "residuals")
    new, cost = posegraph.pgo_step(port)
    jnew, jcost = jax.jit(jpg.pgo_step)(graph)
    assert_rel(new.poses.numpy(), jnew.poses, F32_REL, "poses")
    np.testing.assert_allclose(float(cost), float(jcost), rtol=F32_REL)
    np.testing.assert_array_equal(new.poses[0].numpy(), np.asarray(graph.poses)[0])


def test_pose_graph_history_matches_jax_and_closes_the_loop():
    """10 steps in f64 on both sides to 1e-9; in f32 JAX's test's property
    (the loop closure halves the drift); a zero-weight edge counts nothing."""
    graph, poses_gt = odometry_graph(n=6, drift=0.15)
    with x64():
        g64 = to_x64(graph)
        jfinal, jhist = jax.jit(lambda g: jpg.solve_pose_graph(g, iters=10, damping=1e-4))(g64)
        final, hist = posegraph.solve_pose_graph(to_port(g64, posegraph.PoseGraph), iters=10, damping=1e-4)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=F64, atol=1e-15)
        np.testing.assert_allclose(final.poses.numpy(), np.asarray(jfinal.poses), rtol=F64, atol=F64)
    final, hist = posegraph.solve_pose_graph(to_port(graph, posegraph.PoseGraph), iters=10, damping=1e-4)
    before = np.abs(np.asarray(graph.poses)[-1] - poses_gt[-1]).sum()
    assert float(hist[-1]) < float(hist[0])
    assert np.abs(final.poses.numpy()[-1] - poses_gt[-1]).sum() < before * 0.5
    g4, _ = odometry_graph(n=4)
    w = np.asarray(g4.weights).copy()
    w[-1] = 0.0
    _, hist = posegraph.solve_pose_graph(dataclasses.replace(to_port(g4, posegraph.PoseGraph),
                                                             weights=torch.from_numpy(w)), iters=5)
    assert float(hist[0]) < 1e-6


# ---------------------------------------------------------------- two views


def test_essential_matches_jax_up_to_sign():
    """f64: E equal to JAX's up to sign (1e-9), and on the essential manifold;
    f32: the same up to sign to 1e-3 (the 9x9 eigh of A^T A in float32),
    with the epipolar residuals of the truth below 1e-4."""
    p1, p2, *_ = _synthetic_pair()
    w = np.ones(p1.shape[0])
    with x64():
        args64 = [np.asarray(a, np.float64) for a in (p1, p2, w)]
        e = twoview.estimate_essential(*(torch.from_numpy(a) for a in args64)).numpy()
        je = np.asarray(jax.jit(jtv.estimate_essential)(*(jnp.asarray(a) for a in args64)))
    sign = np.sign(np.sum(e * je))
    np.testing.assert_allclose(e * sign, je, rtol=0, atol=F64 * np.abs(je).max())
    s = np.linalg.svd(e, compute_uv=False)
    assert s[2] < 1e-9 * s[0] and abs(s[0] - s[1]) < 1e-9 * s[0]
    e32 = twoview.estimate_essential(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (p1, p2, w))).numpy()
    je32 = np.asarray(jtv.estimate_essential(p1, p2, jnp.asarray(w, jnp.float32)))
    assert_rel(e32 * np.sign(np.sum(e32 * je32)), je32, 1e-3, "E f32")
    x1 = np.concatenate([np.asarray(p1), np.ones((p1.shape[0], 1))], -1)
    x2 = np.concatenate([np.asarray(p2), np.ones((p2.shape[0], 1))], -1)
    assert np.abs(np.einsum("ni,ij,nj->n", x2, e32, x1)).max() < 1e-4


def test_decompose_and_triangulate_match_jax():
    p1, p2, r, t, pts = _synthetic_pair(seed=1)
    e = np.asarray(jtv.estimate_essential(p1, p2, jnp.ones(p1.shape[0])))
    jrs, jts = (np.asarray(a) for a in jtv.decompose_essential(jnp.asarray(e)))
    for sign in (1.0, -1.0):  # the same four candidates whatever E's sign; the SVD's signs may order them otherwise
        rs, ts = twoview.decompose_essential(torch.from_numpy(sign * e))
        for rc, tc in zip(rs.numpy(), ts.numpy()):
            assert min(np.abs(rc - jr).max() + np.abs(tc - jt).max() for jr, jt in zip(jrs, jts)) < 1e-5
        t_unit = t / np.linalg.norm(t)
        assert min(np.abs(rc.numpy() - r).max() for rc in rs) < 1e-3
        assert min(np.abs(tc.numpy() - t_unit).max() for tc in ts) < 1e-3
    p1, p2, r, t, pts = _synthetic_pair(seed=4)
    r32, t32 = (np.asarray(a, np.float32) for a in (r, t))
    got = twoview.triangulate(torch.from_numpy(np.asarray(p1)), torch.from_numpy(np.asarray(p2)),
                              torch.from_numpy(r32), torch.from_numpy(t32)).numpy()
    # a 2x2 solve of nearly parallel rays a point: float32 rounding, 1e-4 of the farthest point's depth
    assert_rel(got, jtv.triangulate(p1, p2, jnp.asarray(r32), jnp.asarray(t32)), 1e-4, "points")
    np.testing.assert_allclose(got, pts, atol=1e-2)


@pytest.mark.parametrize("case", ["clean", "noise_and_outliers"])
def test_two_view_pose_matches_jax(case):
    """f64 on both sides: rotation, translation and points equal to 1e-9
    (the vote picks the same candidate); f32: the truth within JAX's test's
    bounds. The outliers carry weight 0."""
    if case == "clean":
        p1, p2, r, t, pts = _synthetic_pair(seed=2)
        w = np.ones(p1.shape[0], np.float32)
        tol_r, tol_t = 1e-3, 1e-3
    else:
        p1, p2, r, t, _ = _synthetic_pair(n=128, seed=3, noise=1e-3)
        p2 = np.array(p2)
        p2[:20] += 0.5
        w = np.ones(128, np.float32)
        w[:20] = 0.0
        tol_r, tol_t = 0.08, 0.15
    with x64():
        args64 = [np.asarray(a, np.float64) for a in (p1, p2, w)]
        got = twoview.two_view_pose(*(torch.from_numpy(a) for a in args64))
        want = jax.jit(jtv.two_view_pose)(*(jnp.asarray(a) for a in args64))
        for name in ("rotation", "translation", "points"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-7,
                                       atol=1e-7, err_msg=name)
    res = twoview.two_view_pose(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (p1, p2, w)))
    t_unit = t / np.linalg.norm(t)
    assert np.abs(res.rotation.numpy() - r).max() < tol_r
    assert np.abs(res.translation.numpy() - t_unit).max() < tol_t
    np.testing.assert_array_equal(res.inlier_weight.numpy(), w)


# ---------------------------------------------------------------- features


@pytest.mark.parametrize("window", [5, 4], ids=["odd", "even_window"])
def test_harris_response_matches_jax(window):
    """The checkerboard and a random RGB frame; an even box pads one more
    below than above, as XLA's SAME does."""
    img = _checker()
    rgb = np.random.default_rng(0).uniform(size=(40, 56, 3)).astype(np.float32)
    for x in (img, rgb):
        got = features.harris_response(torch.from_numpy(x), window=window).numpy()
        assert_rel(got, jft.harris_response(jnp.asarray(x), window=window), 1e-5, "harris")


def tiled_frame(periods=5, seed=3):
    """A smoothed random 16 x 16 patch tiled ``periods`` x ``periods``: away
    from the frame's edge each response repeats every 16 pixels, exactly, in
    both packages (each sums every pixel's taps in one order), while the
    responses within a period differ by far more than an ulp."""
    from scipy.signal import convolve2d

    rng = np.random.default_rng(seed)
    patch = convolve2d(rng.uniform(size=(16, 16)), np.ones((2, 2)) / 4, mode="same", boundary="wrap")
    return np.tile(patch.astype(np.float32), (periods, periods))


def test_detect_keypoints_breaks_ties_as_jax():
    """Ties among the kept corners: the tiled frame's corners come in groups
    of 16 equal responses, and K = 8 and 24 cut inside a group, so which of
    the tied corners are kept, and their order, is the tie-break (the lower
    pixel index first). A flat frame has no corner (all K slots ``-inf``
    ties), and a random frame with a threshold leaves fewer than K. Row/col,
    validity and scores equal to JAX's; on the checkerboard of
    ``test_features.py`` every kept corner lies within 2 pixels of a lattice
    corner. (That checkerboard's responses also tie, but partly by rounding:
    JAX's convolution rounds some responses of different neighbourhoods to
    the same float32 and the port's does not, so its tie order is not held to
    JAX's.)"""
    rng = np.random.default_rng(1)
    tiled = tiled_frame()
    cases = [(tiled, dict(max_keypoints=8)), (tiled, dict(max_keypoints=24)), (tiled, dict(max_keypoints=64)),
             (np.full((48, 48), 0.3, np.float32), dict(max_keypoints=16)),
             (rng.uniform(size=(40, 40)).astype(np.float32), dict(max_keypoints=200, threshold=1e-3))]
    for img, kw in cases:
        got = features.detect_keypoints(torch.from_numpy(img), **kw)
        want = jax.jit(jft.detect_keypoints, static_argnames=tuple(kw))(jnp.asarray(img), **kw)
        np.testing.assert_array_equal(got.rowcol.numpy(), np.asarray(want.rowcol))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        v = got.valid.numpy()
        if v.any():
            assert_rel(got.score.numpy()[v], np.asarray(want.score)[v], 1e-5, "scores")
        assert np.all(np.isneginf(got.score.numpy()[~v]))
        assert got.rowcol.dtype == torch.int32
    ties = features.detect_keypoints(torch.from_numpy(tiled), max_keypoints=24)
    s = ties.score.numpy()
    assert ties.valid.all() and np.all(s[:16] == s[0]) and s[16] < s[15]  # K = 8 cut a group of 16 equal responses
    flat = features.detect_keypoints(torch.full((48, 48), 0.3), max_keypoints=16)
    assert not flat.valid.any() and not flat.rowcol.any()
    kps = features.detect_keypoints(torch.from_numpy(_checker()), max_keypoints=64, border=4)
    rc = kps.rowcol.numpy()[kps.valid.numpy()]
    assert len(rc) >= 10 and (np.minimum(rc % 16, 16 - rc % 16) <= 2).all()


def test_descriptors_and_matches_match_jax():
    """``test_features.py``'s shifted pair (a smoothed random frame, shift 5)
    with the ratio test at 0.95 and 0.8, and two unrelated frames: the
    descriptors to 1e-5, every match's index, validity and score as JAX's."""
    from scipy.signal import convolve2d

    rng = np.random.default_rng(1)
    base = convolve2d(rng.uniform(size=(140, 140)), np.ones((3, 3)) / 9.0, mode="same").astype(np.float32)
    pairs = [(base[:128, :128], base[5:133, 5:133]),
             (rng.uniform(size=(96, 96)).astype(np.float32), rng.uniform(size=(96, 96)).astype(np.float32))]
    n_valid = []
    for a, b in pairs:
        kw = dict(max_keypoints=128, border=10, threshold=-1e9)
        ka, kb = (features.detect_keypoints(torch.from_numpy(x), **kw) for x in (a, b))
        jka, jkb = (jft.detect_keypoints(jnp.asarray(x), **kw) for x in (a, b))
        da, db = (features.extract_descriptors(torch.from_numpy(x), k) for x, k in ((a, ka), (b, kb)))
        jda, jdb = jft.extract_descriptors(jnp.asarray(a), jka), jft.extract_descriptors(jnp.asarray(b), jkb)
        assert_rel(da.numpy(), jda, 1e-5, "descriptors")
        for min_score, ratio in ((0.9, 0.95), (0.7, 0.8)):
            m = features.match_descriptors(da, db, ka.valid, kb.valid, min_score=min_score, ratio=ratio)
            jm = jft.match_descriptors(jda, jdb, jka.valid, jkb.valid, min_score=min_score, ratio=ratio)
            for name in ("index_a", "index_b", "valid"):
                np.testing.assert_array_equal(getattr(m, name).numpy(), np.asarray(getattr(jm, name)), err_msg=name)
            np.testing.assert_allclose(m.score.numpy(), np.asarray(jm.score), rtol=0, atol=1e-5)
            n_valid.append(int(m.valid.sum()))
    assert n_valid[0] >= 10 and n_valid[2] <= 5  # the shifted pair matches, the unrelated one barely
    assert n_valid[1] <= n_valid[0] + 5


@pytest.mark.parametrize("rel", ["evaluation/viz.py", "geometry/ba.py", "geometry/posegraph.py", "geometry/twoview.py",
                                 "geometry/features.py", "parallel/__init__.py", "parallel/mesh.py",
                                 "parallel/multihost.py"])
def test_new_port_module_imports_no_jax(rel):
    """The modules of this slice name no ``jax``, ``flax`` or JAX-package
    import in their source (``tests/test_torch_kernels.py::test_port_imports_no_jax``
    imports every port module in a process without JAX)."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parent.parent / "anytime3d_tpu_torch" / rel).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|anytime3d_tpu)\b(?!_torch)", src, re.M), rel
