"""One rank of the 2-process gloo run of ``tests/test_torch_parallel.py``.

    COORDINATOR_ADDRESS=localhost:<port> NUM_PROCESSES=2 PROCESS_ID=<rank> \\
        python -m tests._torch_parallel_child <workdir>

Imports the port and never JAX. It joins the other rank through
``parallel.make_mesh(device="cpu")`` (the environment variables above, gloo),
reads the inputs the parent wrote (``<workdir>/inputs.pt``: configs, weights,
global batches and draws), runs every data-parallel path on its rows and
writes what the parent compares into ``<workdir>/rank<r>.npz``:

- ``voxel`` / ``classifier`` / ``detector``: the gradients the ``--mesh``
  step applies and its metrics (a stand-in optimizer records them), and a
  digest of the parameters after a real Adam step;
- ``dp``: the same of ``make_train_step_dp`` on this rank's own draws;
- ``fuse`` / ``observe``: ``fuse_sequence_sharded`` and
  ``AnytimeReconstructor.observe_stream(mesh=)``, and whether a ragged
  stream raised;
- ``ba32`` / ``ba64``: ``ba_step_sharded`` in float32 and float64;
- ``cli_train`` / ``cli_pretrain`` / ``cli_detector``: ``main --mesh`` for 2
  steps with ``--save-path`` (the detector CLI on the tiny detector): the
  last logged loss, the digest of the trained parameters and of a fresh
  model restored from rank 0's checkpoint.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import sys

import numpy as np
import torch

from anytime3d_tpu_torch.anytime import AnytimeReconstructor
from anytime3d_tpu_torch.anytime.engine import GaussianBelief, fuse_sequence_sharded
from anytime3d_tpu_torch.geometry.ba import BAProblem, ba_step_sharded
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.classifier import Classifier, ClassifierConfig
from anytime3d_tpu_torch.models.detector import DetectorReconstructor
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.parallel import data_rank_and_size, make_global_batch, make_mesh
from anytime3d_tpu_torch.train.checkpoint import restore_state
from anytime3d_tpu_torch.train.classifier_step import ClassifierLossConfig, make_classifier_train_step
from anytime3d_tpu_torch.train.detector_step import DetectorLossConfig, make_detector_train_step
from anytime3d_tpu_torch.train.state import TrainState, create_train_state
from anytime3d_tpu_torch.train.step import make_train_step, make_train_step_dp


class Capture(torch.optim.Optimizer):
    """An optimizer that records the gradients a step hands it and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for group in self.param_groups for p in group["params"]]


def digest(model) -> str:
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def tensors(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def run_step(out, tag, model, step_of, batch, draws=None, lr=1e-3):
    """The applied gradients and metrics of one step of ``step_of(model)``,
    then the digest of the parameters after a real Adam step from the same
    parameters."""
    kw = {} if draws is None else {"draws": draws}
    names = [n for n, _ in model.named_parameters()]
    opt = Capture(model.parameters())
    _, metrics = step_of(model)(TrainState(model, opt), batch, **kw)
    for name, g in zip(names, opt.grads):
        out[f"{tag}/grad/{name}"] = g.numpy()
    for k, v in metrics.items():
        out[f"{tag}/metric/{k}"] = np.float64(v)
    stepped = copy.deepcopy(model)
    step_of(stepped)(create_train_state(stepped, learning_rate=lr), batch, **kw)
    out[f"{tag}/digest"] = np.asarray(digest(stepped))


def run_cli(out, tag, main, argv, save_path, fresh_model):
    result = main(argv)
    trainer = result[0] if isinstance(result, tuple) else result
    out[f"{tag}/loss"] = np.float64(trainer.history[-1]["loss_total"])
    out[f"{tag}/digest"] = np.asarray(digest(trainer.model))
    restored = restore_state(save_path, create_train_state(fresh_model))
    out[f"{tag}/restored"] = np.asarray(digest(restored.model))
    out[f"{tag}/step"] = np.int64(restored.step)


def main(workdir: str) -> None:
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    rank, n = data_rank_and_size(mesh)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"rank": np.int64(rank), "size": np.int64(n)}

    def rows(x):
        return make_global_batch({"x": x}, mesh)["x"]

    # the voxel model: the --mesh step on the global batch's draws, then the explicit DP step on its own
    v = inp["voxel"]
    voxel = MultiModalVAE(v["config"])
    voxel.load_state_dict(v["params"])
    loss_cfg = configs.loss_config("modelnet_nolbo")
    batch = tensors(make_global_batch(v["batch"], mesh))
    draws = tensors({k: rows(x) if np.ndim(x) else x for k, x in v["draws"].items()})
    run_step(out, "voxel", voxel, lambda m: make_train_step(m, loss_cfg, mesh=mesh), batch, draws)
    run_step(out, "dp", voxel, lambda m: make_train_step_dp(m, loss_cfg, mesh), batch,
             tensors(v["dp_draws"][rank]))

    c = inp["classifier"]
    classifier = Classifier(c["config"])
    classifier.load_state_dict(c["params"])
    run_step(out, "classifier", classifier, lambda m: make_classifier_train_step(m, ClassifierLossConfig(), mesh=mesh),
             tensors(make_global_batch(c["batch"], mesh)))

    d = inp["detector"]
    with torch.device("meta"):
        detector = DetectorReconstructor(d["config"])
    detector.load_state_dict(d["params"], assign=True)
    run_step(out, "detector", detector, lambda m: make_detector_train_step(m, DetectorLossConfig(), mesh=mesh),
             tensors(make_global_batch(d["batch"], mesh)), {"eps_z": torch.as_tensor(rows(d["eps_z"]))})

    f = tensors(inp["fuse"])
    prior = GaussianBelief(info=f["prior_info"], precision=f["prior_precision"])
    fused = fuse_sequence_sharded(mesh, f["means"], f["log_vars"], f["masks"], prior=prior)
    out["fuse/info"], out["fuse/precision"] = fused.info.numpy(), fused.precision.numpy()
    observed = AnytimeReconstructor(voxel).observe_stream(prior, f["means"], f["log_vars"], f["masks"], mesh=mesh)
    out["observe/info"], out["observe/precision"] = observed.info.numpy(), observed.precision.numpy()
    try:
        fuse_sequence_sharded(mesh, f["means"][:5], f["log_vars"][:5], f["masks"][:5])
        out["fuse/ragged_raised"] = np.int64(0)
    except ValueError:
        out["fuse/ragged_raised"] = np.int64(1)

    for dtype, tag in ((torch.float32, "ba32"), (torch.float64, "ba64")):
        problem = BAProblem(**{k: torch.as_tensor(x).to(dtype) for k, x in inp["ba"].items()})
        new, mse = ba_step_sharded(problem, mesh, damping=1e-3)
        out[f"{tag}/poses"], out[f"{tag}/points"] = new.poses.numpy(), new.points.numpy()
        out[f"{tag}/mse"] = mse.numpy()

    # the three CLIs under --mesh, 2 steps each, rank 0's checkpoint restored on every rank
    from anytime3d_tpu_torch.cli import pretrain as cli_pretrain
    from anytime3d_tpu_torch.cli import train as cli_train
    from anytime3d_tpu_torch.cli import train_detector as cli_detector

    configs.REGISTRY["modelnet_nolbo"] = lambda **kw: v["config"]
    save = os.path.join(workdir, "ckpt_train")
    run_cli(out, "cli_train", cli_train.main,
            ["--config", "modelnet_nolbo", "--batch-size", "4", "--steps", "2", "--eval-every", "2", "--packed",
             "--save-path", save, "--mesh", "--device", "cpu"], save, MultiModalVAE(v["config"]))
    save = os.path.join(workdir, "ckpt_pretrain")
    run_cli(out, "cli_pretrain", cli_pretrain.main,
            ["--backbone", "darknet53tiny", "--num-classes", "4", "--image-size", "32", "--batch-size", "4",
             "--steps", "2", "--eval-every", "2", "--save-path", save, "--mesh", "--device", "cpu"], save,
            Classifier(ClassifierConfig(num_classes=4, backbone="darknet53tiny")))
    # the tiny detector (16^3) with the loaders' 5 predictors a cell
    tiny = dataclasses.replace(d["config"], predictor_num=5)
    cli_detector.detector_config = lambda voxel_dim, max_detections=16: dataclasses.replace(
        tiny, max_detections=max_detections)
    save = os.path.join(workdir, "ckpt_detector")
    run_cli(out, "cli_detector", cli_detector.main,
            ["--image-size", "64", "64", "--grid-size", "2", "2", "--voxel-dim", "16", "--max-detections", "4",
             "--steps", "2", "--batch-size", "2", "--save-path", save, "--mesh", "--device", "cpu"], save,
            DetectorReconstructor(dataclasses.replace(tiny, max_detections=4)))

    assert "jax" not in sys.modules and "anytime3d_tpu" not in sys.modules, "the port reached for JAX"
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])
