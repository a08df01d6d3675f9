"""One rank of the 4-process gloo run of ``tests/test_torch_tensor_parallel.py``.

    COORDINATOR_ADDRESS=localhost:<port> NUM_PROCESSES=4 PROCESS_ID=<rank> \\
        python -m tests._torch_tensor_parallel_child <workdir>

Imports the port and never JAX. It joins the other ranks through
``parallel.make_mesh(data=2, model=2, device="cpu")`` (gloo), reads the
inputs the parent wrote (``<workdir>/inputs.pt``: configs, whole weights,
global batches and draws, the layer cases), shards each model over "model"
(``parallel.tensor.parallelize``), runs it on its rows and writes what the
parent compares into ``<workdir>/rank<r>.npz``, every sharded tensor gathered
over "model" first:

- ``flagship`` / ``equiv``: the gradients of the tensor-parallel
  ``make_train_step`` (before Adam) and its metrics, then the parameters after
  one real Adam step and their digest;
- ``dp`` / ``dp_ref``: the gradients that ``make_train_step_dp`` (bfloat16
  all-reduce over "data") and ``make_train_step`` apply on the flagship
  without the prior repulsion, and their metrics;
- ``poison``: a NaN planted in one entry of global rank 1's slice of a
  sharded gradient before the "data" all-reduce: the finite flag and the
  parameters' digest before and after the guarded Adam update;
- ``layer/<kind>``: each column-parallel layer kind's output, input gradient
  and weight gradient (and the bias's) for a given output gradient.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import sys

import numpy as np
import torch

from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn import blocks, priornet
from anytime3d_tpu_torch.parallel import all_reduce_grads, gather_params, make_global_batch, make_mesh, parallelize
from anytime3d_tpu_torch.parallel.mesh import gather_along
from anytime3d_tpu_torch.train.state import TrainState, create_train_state
from anytime3d_tpu_torch.train.step import apply_gradients_if_finite, compute_losses, make_train_step, make_train_step_dp


class Capture(torch.optim.Optimizer):
    """An optimizer that records the gradients a step hands it and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for group in self.param_groups for p in group["params"]]


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for name, p in state.items():
        h.update(name.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def tensors(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def whole(model, grads) -> dict:
    """Gradients in the order of the parameters, each sharded one gathered over "model"."""
    out = {}
    for (name, p), g in zip(model.named_parameters(), grads):
        axis = getattr(p, "model_axis", None)
        out[name] = g if axis is None else gather_along(g, axis, p.model_group)
    return out


def sharded(config, params, mesh) -> MultiModalVAE:
    model = MultiModalVAE(config)
    model.load_state_dict(params)
    return parallelize(model, mesh)


def applied(out, tag, model, step_of, batch, draws):
    """The gradients one step of ``step_of(model)`` applies, and its metrics."""
    opt = Capture(model.parameters())
    _, metrics = step_of(model)(TrainState(model, opt), batch, draws=draws)
    for name, g in whole(model, opt.grads).items():
        out[f"{tag}/grad/{name}"] = g.numpy()
    for k, v in metrics.items():
        out[f"{tag}/metric/{k}"] = np.float64(v)


def rows(x, mesh):
    return make_global_batch({"x": x}, mesh)["x"]


def train_case(out, tag, case, mesh):
    """The tensor-parallel step's gradients and metrics, then the gathered
    parameters after a real Adam step. The prior net's dropout masks (the
    parent's ``prior_masks``, JAX's) are this rank's rows of them, in the
    order the prior net draws them at every step."""
    loss_cfg = case["loss_cfg"]
    batch = tensors(make_global_batch(case["batch"], mesh))
    draws = tensors({k: rows(x, mesh) if np.ndim(x) else x for k, x in case["draws"].items()})
    masks = itertools.cycle([torch.from_numpy(rows(m, mesh)) for m in case["prior_masks"]])
    priornet.uniform = lambda shape, generator, device: next(masks)
    model = sharded(case["config"], case["params"], mesh)
    applied(out, tag, model, lambda m: make_train_step(m, loss_cfg, mesh=mesh), batch, draws)
    make_train_step(model, loss_cfg, mesh=mesh)(create_train_state(model), batch, draws=draws)
    params = gather_params(model, mesh)
    for name, p in params.items():
        out[f"{tag}/param/{name}"] = p.numpy()
    out[f"{tag}/digest"] = np.asarray(digest(params))
    return batch, draws


def layer_case(out, kind, case, mesh):
    """A column-parallel ``kind`` layer's output and gradients for the output gradient ``dy``."""
    holder = torch.nn.Module()
    holder.add_module(case["name"], getattr(blocks, kind)(*case["args"]))
    holder.load_state_dict(tensors(case["params"]))
    rules = tuple((r"weight$", p.dim()) for n, p in holder.named_parameters() if n.endswith("weight"))
    parallelize(holder, mesh, rules)
    layer = getattr(holder, case["name"])
    assert type(layer).__name__ == f"ColumnParallel{kind}", type(layer)
    x = torch.as_tensor(case["x"]).requires_grad_(True)
    y = layer(x)
    y.backward(torch.as_tensor(case["dy"]))
    out[f"layer/{kind}/y"] = y.detach().numpy()
    out[f"layer/{kind}/dx"] = x.grad.numpy()
    for name, g in whole(holder, [p.grad for p in holder.parameters()]).items():
        out[f"layer/{kind}/grad/{name}"] = g.numpy()


def main(workdir: str) -> None:
    torch.set_num_threads(1)
    mesh = make_mesh(data=2, model=2, device="cpu")
    rank = torch.distributed.get_rank()
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"rank": np.int64(rank)}

    batch, draws = train_case(out, "flagship", inp["flagship"], mesh)
    train_case(out, "equiv", inp["equiv"], mesh)

    # the explicit data-parallel step on the model axis against the tensor-parallel step: without the prior
    # repulsion (which pairs rows within a shard in the one and across the batch in the other) the two are one
    # function of the same rows and draws, the gradients summed over "data" in bfloat16 against float32
    f = inp["flagship"]
    no_reg = dataclasses.replace(f["loss_cfg"], reg_weight=0.0)
    applied(out, "dp", sharded(f["config"], f["params"], mesh), lambda m: make_train_step_dp(m, no_reg, mesh),
            batch, draws)
    applied(out, "dp_ref", sharded(f["config"], f["params"], mesh), lambda m: make_train_step(m, no_reg, mesh=mesh),
            batch, draws)

    # a NaN in global rank 1's slice of a sharded gradient, before the all-reduce over "data"
    model = sharded(f["config"], f["params"], mesh)
    state = create_train_state(model)
    total, metrics = compute_losses(model, f["loss_cfg"], batch, draws=draws, mesh=mesh)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    target = next(n for n, p in zip(names, params) if getattr(p, "model_axis", None) is not None)
    if rank == 1:
        grads[target].view(-1)[0] = float("nan")
    out["poison/target"] = np.asarray(target)
    out["poison/before"] = np.asarray(digest(gather_params(model, mesh)))
    _, metrics = apply_gradients_if_finite(state, all_reduce_grads(grads, mesh), metrics, mesh)
    out["poison/grads_finite"] = np.float64(metrics["grads_finite"])
    out["poison/after"] = np.asarray(digest(gather_params(model, mesh)))

    for kind, case in inp["layers"].items():
        layer_case(out, kind, case, mesh)

    assert "jax" not in sys.modules and "anytime3d_tpu" not in sys.modules, "the port reached for JAX"
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])
