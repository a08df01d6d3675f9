"""Build the package's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with a
plain C interface, for ``sm_90a`` (Hopper). The library lands in
``kernels/_build/<name>-<hash>/lib<name>.so``, where the hash covers the
sources and the compiler flags, so an edited source is rebuilt and an
unchanged one is reused. ``_build/`` is not committed. :func:`build_host`
does the same for a host C++ source with ``g++`` (the native voxel packer,
``data/csrc/pack.cpp``).

``EXTRA_DEFINES`` (names, or ``NAME=value``) are passed as ``-D`` and are part
of the hash; set them before the first kernel is used. The default build has
none. ``CONV_K2_WAIT_TRAP_NS=<ns>`` makes the tensor-core kernels trap when a
wait on a barrier lasts that long, for bring-up and the card tests;
``CONV_K2_NARROW_PROBE=<1..3>`` leaves a part out of the float32 narrow
kernels and of those that walk C in chunks (``cli/probe_narrow.py``, which
builds those libraries beside the port's with :func:`build`'s ``defines``).

There is no fallback: without ``nvcc`` (on ``PATH``, under ``$CUDA_HOME`` or
in ``/usr/local/cuda``) the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to build.log
)
EXTRA_DEFINES: tuple[str, ...] = ()
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
GXX_LIBS = ("-lpthread",)


def _flags(defines: tuple[str, ...] | None = None) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in (EXTRA_DEFINES if defines is None else defines))


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when there is none."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def _keyed_path(name: str, sources, flags) -> Path:
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def library_path(name: str, defines: tuple[str, ...] | None = None) -> Path:
    """Where ``lib<name>.so`` is built, keyed by a hash of sources and flags."""
    return _keyed_path(name, sorted(CSRC.iterdir()), _flags(defines))


def _compile(lib: Path, argv: list[str], what: str) -> Path:
    """Run the compiler ``argv`` with ``-o`` a temporary path, then move the
    library to ``lib``; the compiler's output goes to ``build.log`` beside it."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*argv, "-o", str(tmp)], capture_output=True, text=True, check=False)
    (lib.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees no half-written file
    return lib


def build(name: str, defines: tuple[str, ...] | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists, with
    ``defines`` in place of ``EXTRA_DEFINES`` where given."""
    lib = library_path(name, defines)
    if lib.exists():
        return lib
    return _compile(lib, [find_nvcc(), *_flags(defines), str(CSRC / f"{name}.cu")], f"nvcc failed to build {name}")


def build_host(src: Path) -> Path:
    """Compile the host C++ source ``src`` with ``g++`` into
    ``_build/<stem>-<hash>/lib<stem>.so`` unless an up-to-date library exists.
    ``-march=native``: the library is built on the machine that loads it.
    Raises RuntimeError without ``g++`` or when it fails."""
    lib = _keyed_path(src.stem, [src], GXX_FLAGS + GXX_LIBS)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src.name} cannot be built")
    return _compile(lib, [gxx, *GXX_FLAGS, str(src), *GXX_LIBS], f"g++ failed to build {src.name}")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``."""
    return ctypes.CDLL(str(build(name)))
