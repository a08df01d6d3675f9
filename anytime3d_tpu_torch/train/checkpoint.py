"""Checkpoints of the train state: parameters, Adam state and step.

Counterpart of ``anytime3d_tpu/train/checkpoint.py``, without Orbax. A
checkpoint is a directory holding one ``torch.save`` file, ``checkpoint.pt``:
``{"params": state_dict, "opt_state": optimizer.state_dict(), "step": int}``
(``save_params`` writes ``params`` alone), every tensor on the CPU. A save
writes a temporary file in that directory and renames it over the old file
with ``os.replace``, so a reader finds the old checkpoint or the new one,
never a part of either.

``save_state(..., wait=False)`` copies the state to host memory on the
caller's thread and writes it on a background thread, so training goes on
while the file is written; the next save, every restore and
:func:`wait_for_saves` wait for that write first.

Submodules are ``state_dict`` prefixes, the flax names of the JAX package
(``encoder3d.``, ``decoder.``, ``prior_category.``): :func:`graft_submodule`
moves one between experiments.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Dict, Mapping, Optional

import torch

from anytime3d_tpu_torch.train.state import TrainState

CHECKPOINT_FILE = "checkpoint.pt"

_writer: Optional[threading.Thread] = None
_failure: list = []  # the background write's exception, raised by the next wait


def _host_copy(obj: Any) -> Any:
    """``obj`` with every tensor copied to host memory (the state goes on changing in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, CHECKPOINT_FILE)
    tmp = os.path.join(path, f".{CHECKPOINT_FILE}.{os.getpid()}.tmp")
    with open(tmp, "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)


def _background_write(path: str, payload: Dict[str, Any]) -> None:
    try:
        _write(path, payload)
    except Exception as e:  # noqa: BLE001 — raised on the caller's thread by wait_for_saves
        _failure.append(e)


def _load(path: str) -> Dict[str, Any]:
    wait_for_saves()  # the checkpoint may still be being written
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu", weights_only=True)


def wait_for_saves() -> None:
    """Block until the background save, if any, is on disk; raise its error if it failed."""
    global _writer
    if _writer is not None:
        _writer.join()
        _writer = None
    if _failure:
        raise RuntimeError("a background checkpoint save failed") from _failure.pop()


def save_state(path: str, state: TrainState, *, wait: bool = True) -> None:
    """Save the full train state (parameters, Adam state, step) into the
    directory ``path``, atomically. ``wait=False`` returns after the copy to
    host memory; the file is written on a background thread."""
    global _writer
    wait_for_saves()  # one write at a time, in the order of the saves
    payload = _host_copy({"params": state.model.state_dict(), "opt_state": state.optimizer.state_dict(),
                          "step": int(state.step)})
    if wait:
        _write(path, payload)
    else:
        _writer = threading.Thread(target=_background_write, args=(path, payload), name="checkpoint-writer")
        _writer.start()


def restore_state(path: str, state: TrainState) -> TrainState:
    """Restore a full train state into ``state`` (its module and optimizer,
    in place, on their device) and return it."""
    ckpt = _load(path)
    state.model.load_state_dict(ckpt["params"])
    state.optimizer.load_state_dict(ckpt["opt_state"])
    state.step = int(ckpt["step"])
    return state


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Save bare parameters (a ``state_dict``), for inference and export."""
    wait_for_saves()
    _write(path, {"params": _host_copy(dict(params))})


def restore_params(path: str, params_template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters of a checkpoint (of ``save_params`` or ``save_state``),
    each on the device and in the dtype of its namesake in
    ``params_template``; the names and shapes must be the template's."""
    params = _load(path)["params"]
    if set(params) != set(params_template):
        raise KeyError(f"{path}: parameters {sorted(set(params) ^ set(params_template))[:8]} are in only one of "
                       "the checkpoint and the model")
    out = {}
    for name, t in params_template.items():
        if params[name].shape != t.shape:
            raise ValueError(f"shape mismatch at {name}: {tuple(t.shape)} vs checkpoint {tuple(params[name].shape)}")
        out[name] = params[name].to(t.device, t.dtype)
    return out


def _submodule_names(params: Mapping[str, Any]) -> list:
    return sorted({name.split(".", 1)[0] for name in params})


def graft_submodule(state: TrainState, donor_path: str, submodule: str, donor_submodule: Optional[str] = None,
                    reset_opt_state: bool = True) -> TrainState:
    """Load one submodule's parameters from another experiment's checkpoint.

    ``submodule`` is a top-level submodule of this model (``decoder``, say),
    ``donor_submodule`` its name in the donor checkpoint (default the same).
    The donor's submodule must hold the same parameters with the same
    shapes; a mismatch raises with the offending name. The optimizer's state
    is reset by default (its moments refer to the old parameters)."""
    donor_submodule = donor_submodule or submodule
    params = state.model.state_dict()
    own = {name[len(submodule) + 1:]: p for name, p in params.items() if name.startswith(submodule + ".")}
    if not own:
        raise KeyError(f"model has no submodule {submodule!r}; has {_submodule_names(params)}")
    donor_params = _load(donor_path)["params"]
    prefix = donor_submodule + "."
    donor = {name[len(prefix):]: t for name, t in donor_params.items() if name.startswith(prefix)}
    if not donor:
        raise KeyError(f"donor checkpoint has no submodule {donor_submodule!r}; has {_submodule_names(donor_params)}")
    if set(donor) != set(own):
        raise KeyError(f"donor {donor_submodule!r} and {submodule!r} differ in {sorted(set(donor) ^ set(own))[:8]}")
    for rest, p in own.items():
        if donor[rest].shape != p.shape:
            raise ValueError(f"shape mismatch at {submodule}.{rest}: {tuple(p.shape)} "
                             f"vs donor {tuple(donor[rest].shape)}")
    with torch.no_grad():
        for rest, p in own.items():
            p.copy_(donor[rest])
    if reset_opt_state:
        state.optimizer.state = collections.defaultdict(dict)
    return state
