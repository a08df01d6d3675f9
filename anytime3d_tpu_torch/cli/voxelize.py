"""Voxelize a directory of CAD meshes into .npy occupancy grids.

    python -m anytime3d_tpu_torch.cli.voxelize --mesh-root CAD_off --out-root CAD [--dim 64]
        [--surface-only] [--threads N]

Reads ``<mesh-root>/<class>/<model>.off`` and writes
``<out-root>/<class>/<model>.npy``, a (dim, dim, dim) uint8 grid, the layout
the Pascal3D loader reads. Counterpart of ``anytime3d_tpu/cli/voxelize.py``,
with its flags. It voxelizes with the native voxelizer (``data/csrc/voxelizer.cpp``,
built with ``g++`` on first use) where it builds, else with the NumPy path,
whose grids differ, and prints which one it runs.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh-root", required=True, help="directory of <class>/<model>.off")
    p.add_argument("--out-root", required=True)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--surface-only", action="store_true")
    p.add_argument("--threads", type=int, default=0, help="native worker threads; 0 is one a core")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Voxelize every mesh; returns the number written."""
    import numpy as np

    from anytime3d_tpu_torch.data.voxelize import load_off, native_available, voxelize

    args = parse_args(argv)
    native = native_available()
    print(f"voxelizer: {'native (data/csrc/voxelizer.cpp)' if native else 'NumPy (the native library did not build)'}",
          flush=True)
    n_done = 0
    t0 = time.time()
    for cls in sorted(os.listdir(args.mesh_root)):
        cdir = os.path.join(args.mesh_root, cls)
        if not os.path.isdir(cdir):
            continue
        out_dir = os.path.join(args.out_root, cls)
        os.makedirs(out_dir, exist_ok=True)
        for f in sorted(os.listdir(cdir)):
            if not f.lower().endswith(".off"):
                continue
            verts, tris = load_off(os.path.join(cdir, f))
            grid = voxelize(verts, tris, dim=args.dim, solid=not args.surface_only, threads=args.threads,
                            native=native)
            np.save(os.path.join(out_dir, f[:-4] + ".npy"), grid.astype(np.uint8))
            n_done += 1
            if n_done % 50 == 0:
                print(f"{n_done} meshes, {(time.time() - t0) / n_done:.2f} s each", flush=True)
    print(f"done: {n_done} meshes in {time.time() - t0:.1f} s")
    return n_done


if __name__ == "__main__":
    main()
