"""Cells at a size that a CPU test run holds: the configurations' layouts at
narrow widths and small grids, the mixes at small batches."""

from __future__ import annotations

import copy
from pathlib import Path

from perfbench import harness

BENCH = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    """The configuration file ``name`` cut to a 32^3 grid and narrow widths (Darknet19 stays whole)."""
    cfg = copy.deepcopy(harness.read_json(BENCH / "configs" / f"{name}.json"))
    cfg.pop("registry")
    m = cfg["model"]
    m["decoder"].update(output_shape=[32, 32, 32, 1], filter_nums=[16, 8, 8, 4, 1])
    if m["encoder"] == "voxel":
        z = 8
        m.update(z_category_dim=z, category_dim=5)
        m["encoder3d"].update(filter_nums=[4, 8, 16, 32], output_dim=2 * z)
        m["prior_category"].update(input_dim=5, unit_nums=[8, z])
    else:
        m.update(z_category_dim=4, z_inst_dim=4, category_dim=3, inst_dim=2)
        m["head"]["output_dim"] = 16
        m["prior_category"].update(input_dim=3, unit_nums=[8, 4])
        m["prior_inst"].update(input_dim=5, unit_nums=[8, 4])
    m["decoder"]["input_dim"] = m["z_category_dim"] + m["z_inst_dim"]
    return cfg


def traffic(name: str, **changes) -> dict:
    mix = dict(harness.read_json(BENCH / "traffic" / f"{name}.json"))
    if mix["kind"] == "train":
        mix.update(batch=4, samples=16, warm_steps=4 if mix.get("multi_scale") else 3, checked_steps=2)
        if mix.get("image_sizes"):
            mix["image_sizes"] = [32, 64]
    else:
        mix.update(batch=4, pool=16, outstanding=8, warm_requests=8, keep_share=1.0, checked_requests=12)
    mix.update(changes)
    return mix


def cell(workload: str, limits=None, **changes) -> harness.Cell:
    bench = harness.load_benchmark(BENCH.parent)
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    return harness.Cell(name=workload, chips=1, config_name=entry["config"], config=config(entry["config"]),
                        traffic_name=entry["traffic"], traffic=traffic(entry["traffic"], **changes),
                        limits=dict(limits or harness.read_json(BENCH / "cells" / f"{workload}.json")["limits"]),
                        end_to_end=[], per_layer=[])
