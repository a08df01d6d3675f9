"""What the split-depth kernels and the persistent tensor-core dw buy on the
card (``kernels/conv_k2.py::wgmma_plan``, ``ffma_split``, ``narrow_dw_plan``;
``kernels/csrc/conv_k2.cu``, ``conv_k2_wgmma.cuh``, ``conv_k2_narrow.cuh``).

    python -m anytime3d_tpu_torch.cli.probe_split [--label NAME] [--end-to-end] [--parts 1234]

1. ``modelnet_nolbo`` with ``mid_blocked`` at full width from seeded
   weights: a served batch of 8 and a train step at B=32, in bf16 and in
   float32, and the default layout's in bf16, each by CUDA events over 10
   calls, on the card alone over 5 and by the profiler's busy time a call;
   then the ``conv_k2``, ``conv_k2_dx`` and ``conv_k2_dw`` ops at the
   mid_blocked shapes whose plans split or take the persistent dw (4^3 and
   8^3 at B=8, 4^3 at B=32; bf16 and float32): the host's time to enqueue
   one, CUDA events and the card alone. This part calls only what a tree
   without those plans has too: run it from a checkout of each (the same
   file copied in, with ``utils/timing.py``), in turns, to hold the change
   against the tree before it on one card.
2. Unless ``--end-to-end``: the stem's bf16 dw (32^3, 8 -> 64) at B=8 and 32
   on the dw-only plan's box and splits, other boxes, and 2 and 4 times fewer
   splits, on the card alone.
3. Unless ``--end-to-end``: what holds the tensor-core dw back at the five
   mid_blocked shapes (4^3 2048 <-> 512 at B=8 and 32, 8^3 1024 -> 256 at
   B=8; also at B=32) and the flagship's four 16^3 stages at B=8 and 32: the
   persistent and the grid kernel, each whole, without its store and without
   its loads of g (the library built five times at once, with
   ``CONV_K2_DW_PROBE`` = 1 and 2 and ``CONV_K2_DW_STORE_BUFS`` = 4 and 8),
   the persistent one also with 4 and 8 chunk buffers a warp for the store
   (3 and 2 ring stages) and with its rows in 1, 2 or 4 splits, beside
   cuDNN's weight gradient, all on the card alone.
4. Unless ``--end-to-end``: the flagship's bf16 ``wgmma`` forward at 16^3,
   B=8 (its four stages summed) beside cuDNN's k=2 call, on the card alone
   over 200 calls a stage, three rounds in turns.

Every line carries ``--label`` and the card's name and power limit. Needs a
CUDA card and ``nvcc``. The port calls none of this.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
from concurrent.futures import ThreadPoolExecutor

from anytime3d_tpu_torch.utils.timing import busy_ms, card_line, cuda_ms, device_ms, host_enqueue_ms

# (kernel, B, grid, C, N, dtype) of the mid_blocked ops whose plans split their depth or take the persistent dw:
# the served batch's three split forwards and the dx that shares 2048 -> 512's plan, the train step's split
# forward and dx at B=32 (bf16 and float32), and the bf16 dw of the five shapes of the record
SPLIT_OPS = [(k, b, g, c, n, t) for t in ("bf16", "f32") for k, b, g, c, n in (
    ("conv_k2", 8, 4, 2048, 512), ("conv_k2", 8, 4, 512, 2048), ("conv_k2", 8, 8, 1024, 256),
    ("conv_k2_dx", 8, 4, 2048, 512), ("conv_k2_dx", 8, 4, 512, 2048), ("conv_k2", 32, 4, 2048, 512),
    ("conv_k2_dx", 32, 4, 512, 2048))]
DW_SHAPES = [(8, 4, 2048, 512), (8, 4, 512, 2048), (32, 4, 2048, 512), (32, 4, 512, 2048), (8, 8, 1024, 256)]
SPLIT_OPS += [("conv_k2_dw", b, g, c, n, "bf16") for b, g, c, n in DW_SHAPES]
FLAGSHIP_K2 = [(64, 512), (512, 128), (128, 512), (512, 64)]  # (C, N) of the 16^3 stages
# the tensor-core dw's builds: (what, defines, the persistent kernel's chunk buffers a warp or None for the port's);
# the first three time both kernels, the last two the persistent one
DW_BUILDS = [("whole", (), None), ("without its store", ("CONV_K2_DW_PROBE=1",), None),
             ("without its loads of g", ("CONV_K2_DW_PROBE=2",), None),
             ("with 4 chunk buffers a warp", ("CONV_K2_DW_STORE_BUFS=4",), 4),
             ("with 8 chunk buffers a warp (the whole tile)", ("CONV_K2_DW_STORE_BUFS=8",), 8)]


def main(argv=None) -> None:
    import torch

    from anytime3d_tpu_torch.cli import train as cli_train
    from anytime3d_tpu_torch.data.modelnet import SyntheticVoxelLoader
    from anytime3d_tpu_torch.data.packing import pack_voxels
    from anytime3d_tpu_torch.data.prefetch import to_device
    from anytime3d_tpu_torch.kernels import conv_k2 as k2
    from anytime3d_tpu_torch.models import configs
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
    from anytime3d_tpu_torch.serving.export import make_packed_infer
    from anytime3d_tpu_torch.train.state import create_train_state
    from anytime3d_tpu_torch.train.step import make_train_step

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--label", default="this tree", help="printed on every line: which checkout ran")
    p.add_argument("--end-to-end", action="store_true", help="part 1 alone")
    p.add_argument("--parts", default="1234", help="the parts to run, by number (default all)")
    args = p.parse_args(argv)
    parts = "1" if args.end_to_end else args.parts
    if not torch.cuda.is_available():
        raise SystemExit("probe_split: needs a CUDA GPU")
    card, dev = card_line(), torch.device("cuda")
    tag = f"[{args.label}] [{card}]"
    # float32 as the port computes it, and cuDNN's float32 beside it in true f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    types = {"bf16": torch.bfloat16, "f32": torch.float32}

    def timed(what: str, fn) -> None:
        print(f"{what}: events {cuda_ms(fn, 10):.3f} ms, alone {device_ms(fn, 5):.3f} ms, device busy "
              f"{busy_ms(fn):.3f} ms a call {tag}", flush=True)

    # 1. the mid_blocked (and the default layout's) train step at B=32 and served batch of 8; then the ops alone
    base, loss_cfg = configs.variant("modelnet_nolbo")
    mid = dataclasses.replace(base, encoder3d=dataclasses.replace(base.encoder3d, mid_blocked=True),
                              decoder=dataclasses.replace(base.decoder, mid_blocked=True))
    rng = torch.Generator().manual_seed(1)
    packed = torch.from_numpy(pack_voxels((torch.rand(8, 64, 64, 64, 1, generator=rng) > 0.7).float().numpy()))
    packed, mask = packed.to(dev), (torch.rand(8, mid.z_category_dim, generator=rng) < 0.5).float().to(dev)
    for layout, cfg, dtype in (("mid_blocked", mid, "bf16"), ("mid_blocked", mid, "f32"), ("default", base, "bf16"))[
            :3 if "1" in parts else 0]:
        model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0), dtype=types[dtype]).to(dev)
        state, step = create_train_state(model), make_train_step(model, loss_cfg)
        loader = SyntheticVoxelLoader(num_samples=32, dim=64, num_classes=cfg.category_dim)
        batch = to_device(cli_train.build_batch_fn(loader, cfg, 32, packed=True, native=True)(0), dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        timed(f"{layout} {dtype} train step, B=32", lambda: step(state, batch, gen))
        del state, step, batch
        model.eval()
        infer = make_packed_infer(model, (64, 64, 64, 1))
        with torch.inference_mode():
            timed(f"{layout} {dtype} served batch of 8", lambda: infer(packed, mask))
        del model, infer
        torch.cuda.empty_cache()
    with torch.inference_mode():
        for kernel, b, grid, c, n, dtype in SPLIT_OPS if "1" in parts else ():
            t = types[dtype]
            x = torch.randn(b, grid, grid, grid, c, generator=rng).to(dev, t)
            g = torch.randn(b, grid, grid, grid, n, generator=rng).to(dev, t)
            w = (torch.randn(2, 2, 2, c, n, generator=rng) / (8 * c) ** 0.5).to(dev, t)
            op = {"conv_k2": lambda: k2.conv_k2(x, w), "conv_k2_dx": lambda: k2.conv_k2_dx(g, w),
                  "conv_k2_dw": lambda: k2.conv_k2_dw(x, g)}[kernel]
            print(f"{kernel} {dtype} {grid}^3 {c}->{n}, B={b}: host enqueue {host_enqueue_ms(op, 50):.4f} ms, events "
                  f"{cuda_ms(op, 50):.4f} ms, alone {device_ms(op, 50):.4f} ms {tag}", flush=True)
        # 2. the stem's dw on the dw-only narrow plan, other boxes and fewer splits
        lib = k2._lib()
        for b in (8, 32) if "2" in parts else ():
            x = torch.randn(b, 32, 32, 32, 8, generator=rng).to(dev, torch.bfloat16)
            g = torch.randn(b, 32, 32, 32, 64, generator=rng).to(dev, torch.bfloat16)
            plan, ref = k2.narrow_dw_plan(b, 32, 32, 32, 8, 64), k2.conv_k2_dw(x, g)
            for box in ((16, 8, 4), (16, 4, 4), (32, 4, 4), (16, 16, 2)):
                boxes, smem = k2._boxes(b, 32, 32, 32, box), k2._narrow_smem(box, 8, 64, True, 2, 2, 0)
                for per in (-(-boxes // 132), -(-boxes // 66), -(-boxes // 33)):
                    splits, dw = -(-boxes // per), torch.empty(2, 2, 2, 8, 64, device=dev)
                    part = torch.empty(splits, 512, 64, device=dev)

                    def run():
                        k2._check_launch("probe_split dw", lib.conv_k2_backward_weight_narrow(
                            x.data_ptr(), g.data_ptr(), dw.data_ptr(), part.data_ptr(), splits, per, b, 32, 32, 32,
                            8, 64, *box, smem, 2, 1, dev.index or 0, k2._stream(x)))

                    run()
                    torch.cuda.synchronize()
                    rel = float((dw - ref).abs().max()) / float(ref.abs().max())
                    mark = " (the plan)" if (box, per) == (plan.dw_box, plan.dw_boxes_per_split) else ""
                    print(f"stem bf16 dw B={b} box {box}, {splits} splits of {per} boxes{mark}: alone "
                          f"{device_ms(run, 50):.4f} ms, {rel:.1e} of the largest entry off the plan's {tag}",
                          flush=True)

        # 3. the tensor-core dw whole, without its store, without its loads of g: persistent and grid kernels,
        # the persistent one also with its rows in other numbers of splits; 4. K0c
        if "3" in parts:
            dw_routes(k2, rng, tag)
        if "4" in parts:
            forward_k0c(k2, rng, tag)


def dw_routes(k2, rng, tag: str) -> None:
    """Part 3: the tensor-core dw's routes at the mid_blocked and flagship shapes, whole and with a part left out."""
    import torch

    from anytime3d_tpu_torch.kernels import build

    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(DW_BUILDS)) as pool:  # one nvcc a build, all at once
        paths = list(pool.map(lambda b: build.build("conv_k2", b[1]), DW_BUILDS))
    libs = [k2.bind(ctypes.CDLL(str(path))) for path in paths]
    port_lib = k2._lib
    shapes = [(b, g, c, n) for b, g, c, n in DW_SHAPES] + [(32, 8, 1024, 256)] + [
        (b, 16, c, n) for b in (8, 32) for c, n in FLAGSHIP_K2]

    def resplit(plan, splits: int, total: int):
        """``plan`` with its persistent dw's rows in ``splits`` runs (as many as whole runs give)."""
        per = -(-total // splits)
        walk = dataclasses.replace(plan.dw_persistent, splits=-(-total // per), stages_per_split=per,
                                   grid=min(plan.dw_persistent.tiles * -(-total // per), 132))
        return dataclasses.replace(plan, dw_persistent=walk)

    try:
        for b, grid, c, n in shapes:
            x = torch.randn(b, grid, grid, grid, c, generator=rng).to(dev, torch.bfloat16)
            g = torch.randn(b, grid, grid, grid, n, generator=rng).to(dev, torch.bfloat16)
            out = torch.empty(2, 2, 2, c, n, device=dev)
            ref = k2.conv_k2_dw(x, g)
            x_pad = torch.nn.functional.pad(x.permute(0, 4, 1, 2, 3), (0, 1) * 3)
            library = lambda: torch.nn.grad.conv3d_weight(x_pad, (n, c, 2, 2, 2), g.permute(0, 4, 1, 2, 3))
            persistent = k2.wgmma_plan(b, grid, grid, grid, c, n, persistent_dw=True)
            runs = [("grid", k2.wgmma_plan(b, grid, grid, grid, c, n, persistent_dw=False), range(3))]
            if persistent.dw_persistent is not None:
                total = b * grid**3 // 64
                runs.insert(0, ("persistent", persistent, range(len(DW_BUILDS))))
                runs += [("persistent", resplit(persistent, z, total), (0,)) for z in (1, 2, 4)
                         if -(-total // -(-total // z)) != persistent.dw_persistent.splits]
            line = []
            for route, plan, builds in runs:
                walk = plan.dw_persistent
                shape = (f"{walk.tiles} tiles, {walk.splits} splits of {walk.stages_per_split}" if walk else
                         f"grid {plan.dw_grid}, {plan.dw_stages_per_split} stages a split")
                for i in builds:
                    what, _, bufs = DW_BUILDS[i]
                    if bufs is not None:  # the ring of that build: fewer stages beside more chunk buffers
                        stages, smem = k2.persistent_dw_ring(bufs)
                        plan = dataclasses.replace(plan, dw_persistent=dataclasses.replace(
                            walk, stages=stages, smem_bytes=smem))
                    k2._lib = lambda i=i: libs[i]
                    run = lambda plan=plan: k2.dw_wgmma(x, g, out, plan)
                    run()
                    torch.cuda.synchronize()
                    off = float((out - ref).abs().max()) / float(ref.abs().max())
                    err = "" if what.startswith("without") else f" ({off:.1e} of the largest entry off the op's)"
                    line.append(f"{route} ({shape}) {what} {device_ms(run, 50):.4f} ms{err}")
            k2._lib = port_lib
            a1, a2 = device_ms(library, 50), device_ms(library, 50)
            print(f"bf16 dw {grid}^3 {c}->{n}, B={b}, on the card alone: {'; '.join(line)}; cuDNN "
                  f"{(a1 + a2) / 2:.4f} ms ({a1:.4f}, {a2:.4f}) {tag}", flush=True)
    finally:
        k2._lib = port_lib


def forward_k0c(k2, rng, tag: str) -> None:
    """Part 4: the flagship's bf16 forward at 16^3, B=8, its four stages, 200 calls a stage, three rounds."""
    import torch

    dev = torch.device("cuda")
    ops = []
    for c, n in FLAGSHIP_K2:
        x = torch.randn(8, 16, 16, 16, c, generator=rng).to(dev, torch.bfloat16)
        w = (torch.randn(2, 2, 2, c, n, generator=rng) / (8 * c) ** 0.5).to(dev, torch.bfloat16)
        x_pad = torch.nn.functional.pad(x.permute(0, 4, 1, 2, 3), (0, 1) * 3)
        w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
        ops.append(((lambda x=x, w=w: k2.conv_k2(x, w)),
                    (lambda x_pad=x_pad, w_oidhw=w_oidhw: torch.nn.functional.conv3d(x_pad, w_oidhw))))
    rounds = []
    for _ in range(3):
        kernel = sum(device_ms(op, 200) for op, _ in ops)
        library = sum(device_ms(lib_op, 200) for _, lib_op in ops)
        rounds.append((kernel, library))
    print("flagship bf16 wgmma forward, 16^3 B=8, four stages summed, on the card alone over 200 calls a stage: "
          + "; ".join(f"round {i + 1} kernel {k:.4f} ms cuDNN {c:.4f} ms ({k / c:.2f}x)"
                      for i, (k, c) in enumerate(rounds)) + f" {tag}", flush=True)


if __name__ == "__main__":
    main()
