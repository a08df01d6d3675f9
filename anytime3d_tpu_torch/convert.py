"""Flax parameters -> the port's ``state_dict``.

A flax param tree (nested dicts of arrays, keyed as flax keys it) maps to
the port by name: each auto-named flax module ``Class_i`` is the port's
submodule ``class_i`` (``_ResBlock_3`` is ``_resblock_3``; explicit names
such as ``encoder3d``, ``backbone``, ``head`` or ``decoder`` stay: the
detector's ``head/Conv_0`` is ``head.conv_0``, its decoder's pixel-shuffle
``decoder/Conv_0`` is ``decoder.conv_0``, the classifier's ``backbone/...``
and ``head/...`` are ``backbone.`` and ``head.`` for each of the three
backbones; a ``mid_blocked`` decoder's middle ``decoder/Conv_i`` and
``decoder/GroupNorm_i``, numbered per class with the blocked tail's, are
``decoder.conv_i`` and ``decoder.groupnorm_i``, its encoder's folded stages
``encoder3d/ConvBlock3D_i`` as any stage; a learned prior log-variance's
``prior_category/log_var_tower/...`` is ``prior_category.log_var_tower.``),
and each leaf is renamed and laid out as the port holds it:

- ``Conv_*/kernel`` of a 2-D conv: HWIO -> OIHW (``F.conv2d``);
- ``Conv_*/kernel`` of a 3-D conv: DHWIO -> OIDHW (``F.conv3d``), except the
  2x2x2 kernels, which stay (2, 2, 2, C, N) as the ``conv_k2`` kernel takes them;
- ``ConvTranspose_*/kernel`` and ``ConvTransposeEquiv3D_*/kernel``: flipped
  in D, H and W and permuted to (Cin, Cout, k, k, k) (``F.conv_transpose3d``;
  see ``nn.blocks.ConvTranspose3d``; ``ConvTransposeEquiv3D`` keeps that
  layout and embeds its k=3 phase kernel from it at each call);
- ``Dense_*/kernel``: (in, out) -> (out, in);
- ``scale`` -> ``weight``; ``bias`` stays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaf(module: str, name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    kind = module.rsplit("_", 1)[0]
    if name == "scale":
        return "weight", value
    if name == "bias":
        return "bias", value
    if name != "kernel":
        raise KeyError(f"unknown flax leaf {module}/{name}")
    if kind == "Conv" and value.ndim == 4:
        return "weight", value.transpose(3, 2, 0, 1)
    if kind == "Conv":
        return "weight", value if value.shape[:3] == (2, 2, 2) else value.transpose(4, 3, 0, 1, 2)
    if kind in ("ConvTranspose", "ConvTransposeEquiv3D"):
        return "weight", value[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    if kind == "Dense":
        return "weight", value.T
    raise KeyError(f"no port layout for the kernel of {module}")


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays keyed as the flax param tree -> ``state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple[str, ...], module: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key.lower(),), key)
            else:
                name, array = _leaf(module, key, np.asarray(value))
                out[".".join(path + (name,))] = torch.from_numpy(np.array(array, np.float32, order="C"))

    walk(tree, (), "")
    return out


def load_flax_npz(path) -> dict[str, torch.Tensor]:
    """A flat ``.npz`` keyed by '/'-joined flax paths (e.g.
    ``encoder3d/ConvBlock3D_0/Conv_0/kernel``) -> ``state_dict``."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params_from_flax(tree)
