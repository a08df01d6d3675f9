"""Readings that the limits of a cell's comparison are set from, on the card
at the cell's own size, in one process:

- the program's compared numbers on ``--seeds`` seeds (the lower reading is
  their largest): set-up drives the first steps of a train cell; a serve cell
  also runs a window of ``--seconds`` at its own load;
- the control on the first ``--control`` of those seeds: the plain reference
  put in the program's place and computed one precision below the
  configuration's (the mix's ``control``: float8 under bfloat16, bfloat16
  under float32 whose cuDNN convolutions may run in TF32);
- with ``--witness <precision>``, on the same seeds, the reference put in
  the program's place at that precision (``tf32``: every convolution, the
  k=2 ones too, in TF32), which a limit has to fail where the
  configuration's own precision is to be held;
- for a train cell, on the same seeds, the fault of half of the batch left
  out (the mean taken over the rest), planted in the reference put in the
  program's place. A step that returns its state unchanged reads 1 by the
  measure and needs no run.

    python3 perfbench/calibrate.py --workload <name> [--seeds 12] [--control 3] [--seconds 4] [--witness tf32]
        [--out file.jsonl]

One JSON line per reading goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--out", default=None)
    p.add_argument("--compute", default=None, help="override the mix's compute dtype (a witness run)")
    p.add_argument("--leaves", type=int, default=0, help="also print a train cell's worst leaves")
    p.add_argument("--witness", default=None, help="also read a train cell's reference at this precision")
    args = p.parse_args(argv)

    from perfbench import harness, judge

    os.environ.update(harness.cache_env())
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    if args.compute:
        cell.traffic = dict(cell.traffic, compute=args.compute)
    driver_class = harness.driver_class(cell.traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload, card=harness.power_limit()))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    train = cell.traffic["kind"] == "train"
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        drv = driver_class(cell, seed, "cuda")
        drv.setup()
        if not train:
            drv.window(args.seconds)
        drv.release()
        numbers, ref = drv.check()
        rec = {"seed": seed, "side": "program" if not args.compute else f"program_{args.compute}", "numbers": numbers}
        if train and args.leaves:
            prog = dataclasses.asdict(drv.snap)
            for key in ("grad_norms", "change_norms"):
                gaps = judge.leaf_gaps(prog[key], ref[key])
                worst = sorted(gaps, key=gaps.get, reverse=True)[:args.leaves]
                rec[key] = [[n, gaps[n], prog[key][n], ref[key][n]] for n in worst]
            rec["median_grad"] = statistics.median(ref["grad_norms"].values())
        emit(rec)
        if i >= args.control:
            continue
        low = cell.traffic["control"]
        if train:
            emit({"seed": seed, "side": f"control_{low}",
                  "numbers": judge.train_numbers(drv.reference(low), ref)})
            if args.witness:
                emit({"seed": seed, "side": f"witness_{args.witness}",
                      "numbers": judge.train_numbers(drv.reference(args.witness), ref)})
            half = drv.reference("f32", skip_rows=drv.batch // 2)
            emit({"seed": seed, "side": "fault_half_batch", "numbers": judge.train_numbers(half, ref)})
        else:
            ids = drv.sample()
            emit({"seed": seed, "side": f"control_{low}",
                  "numbers": drv.judge_answers(ids, drv.control_answers(ids, low))})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
