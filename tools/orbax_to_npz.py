"""Turn a JAX train-state checkpoint into the flat ``.npz`` that the PyTorch
port reads.

    python tools/orbax_to_npz.py <orbax checkpoint dir> <out.npz>

The checkpoint is a directory written by ``anytime3d_tpu.train.checkpoint``
(``save_state`` or ``save_params``). The output holds its parameters only
(no optimizer state, no step), keyed by '/'-joined flax paths
(``encoder3d/ConvBlock3D_0/Conv_0/kernel``), the form that
``anytime3d_tpu_torch.convert.load_flax_npz``, ``cli.serve --weights`` and
``cli.evaluate --weights`` take. The checkpoint is read through the JAX
package, so this script needs JAX and Orbax; the port needs neither.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping

import numpy as np


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> ``{'a/b/c': array}``."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def read_params(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """The parameters of a JAX checkpoint directory, flattened."""
    from anytime3d_tpu.train import checkpoint

    checkpoint.wait_for_saves()
    # no template: the tree as saved (graft_submodule reads donors the same way)
    restored = checkpoint._checkpointer().restore(os.path.abspath(ckpt_dir))
    return flatten(restored["params"])


def main(argv=None) -> Dict[str, np.ndarray]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt", help="checkpoint directory of anytime3d_tpu.train.checkpoint")
    p.add_argument("out", help="the .npz to write")
    args = p.parse_args(argv)
    params = read_params(args.ckpt)
    np.savez(args.out, **params)
    print(f"wrote {args.out}: {len(params)} arrays, {sum(a.size for a in params.values())} parameters")
    return params


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo root
    main()
