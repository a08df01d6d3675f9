"""What every run of the benchmark shares: finding a cell and its files by
name, the checkout's cache directories, the result line and the check that
no JAX module was loaded.

Everything of one cell is found by name from ``BENCHMARK.json``: the
configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json`` (whose ``kind`` names the window driver
``drivers/<kind>.py``), the limits of the comparison ``cells/<workload>.json``
and each per-layer metric's reader ``metrics/<metric>.py`` (or, for a name
with a suffix, the reader of the name without it). A new cell,
mix, configuration or metric is a new file and a new entry; no file that is
there changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "anytime3d_tpu")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, workload: str, bench_dir: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``bench`` with its files read; KeyError for an unknown name."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits_path = bench_dir / "cells" / f"{workload}.json"
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        config=read_json(bench_dir.parent / config["file"]),
        traffic_name=entry["traffic"],
        traffic=read_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(limits_path)["limits"] if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def driver_class(kind: str):
    """The window driver of a traffic kind: ``drivers/<kind>.py``'s ``Driver``."""
    return importlib.import_module(f"perfbench.drivers.{kind}").Driver


def metric_reader(name: str, bench_dir: Path = BENCH) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``, loaded by path (names hold
    dots). A name with a suffix that has no file of its own, such as
    ``mfu_pct.serve`` (one quantity split by the rate it moves), is read by
    the file of the name without it: ``metrics/mfu_pct.py``."""
    stem = name
    while not (bench_dir / "metrics" / f"{stem}.py").exists() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    path = bench_dir / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for every compiler the
    program may call, so that only a checkout's first run builds. The port's
    own kernels build into ``anytime3d_tpu_torch/kernels/_build`` there."""
    return {
        "TRITON_CACHE_DIR": str(root / ".bench_cache" / "triton"),
        "TORCH_EXTENSIONS_DIR": str(root / ".bench_cache" / "torch_extensions"),
        "TORCHINDUCTOR_CACHE_DIR": str(root / ".bench_cache" / "inductor"),
        "CUDA_CACHE_PATH": str(root / ".bench_cache" / "nv"),
        "USE_FLAX": "0",
    }


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card(torch) -> Dict[str, object]:
    """The card's description for the result line."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None where it cannot say."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: List[list]) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)


def units(metrics: List[dict]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in metrics}


def port_model_config(model: dict):
    """The port's ``MMVAEConfig`` of a configuration file's ``model``."""
    from anytime3d_tpu_torch.models.mmvae import MMVAEConfig
    from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
    from anytime3d_tpu_torch.nn.heads import Head2DConfig
    from anytime3d_tpu_torch.nn.priornet import PriorNetConfig

    nested = {"encoder3d": Encoder3DConfig, "decoder": Decoder3DConfig, "head": Head2DConfig,
              "prior_category": PriorNetConfig, "prior_inst": PriorNetConfig}
    kw = {}
    for key, value in model.items():
        if key in nested and value is not None:
            value = nested[key](**{k: tuple(v) if isinstance(v, list) else v for k, v in value.items()})
        kw[key] = value
    return MMVAEConfig(**kw)


def port_configs(config: dict):
    """(MMVAEConfig, LossConfig) of a configuration file. Where the file
    names a ``registry`` entry of the port, the port's own must equal the
    file's, field by field: the file holds the configuration as it is run."""
    from anytime3d_tpu_torch.train.step import LossConfig

    mcfg, lcfg = port_model_config(config["model"]), LossConfig(**config["loss"])
    if config.get("registry"):
        from anytime3d_tpu_torch.models.configs import variant

        want = variant(config["registry"])
        if (mcfg, lcfg) != want:
            raise ValueError(f"{config['registry']}: the configuration file differs from the port's REGISTRY entry")
    return mcfg, lcfg
