"""What the split-depth tensor-core forward and dx and the s2d(2) stem's
dw-only narrow dw buy on the card (``kernels/conv_k2.py::wgmma_plan``,
``narrow_dw_plan``; ``kernels/csrc/conv_k2_wgmma.cuh``, ``conv_k2_narrow.cuh``).

    python -m anytime3d_tpu_torch.cli.probe_split [--label NAME] [--end-to-end]

1. ``modelnet_nolbo`` with ``mid_blocked`` at full width from seeded
   weights, bf16: a served batch of 8 and a train step at B=32, each by CUDA
   events over 10 calls, on the card alone over 5 and by the profiler's busy
   time a call; then the ``conv_k2`` and ``conv_k2_dx`` ops at the shapes
   whose plans split (4^3 and 8^3 at B=8, 4^3 at B=32): the host's time to
   enqueue one, CUDA events and the card alone. This part calls only what a
   tree without the split has too: run it from a checkout of each (the same
   file copied in, with ``utils/timing.py``), in turns, to hold the split
   against the tree before it on one card.
2. Unless ``--end-to-end``: the stem's bf16 dw (32^3, 8 -> 64) at B=8 and 32
   on the dw-only plan's box and splits, other boxes, and 2 and 4 times fewer
   splits, on the card alone.

Every line carries ``--label`` and the card's name and power limit. Needs a
CUDA card and ``nvcc``. The port calls none of this.
"""

from __future__ import annotations

import argparse
import dataclasses

from anytime3d_tpu_torch.utils.timing import busy_ms, card_line, cuda_ms, device_ms, host_enqueue_ms

# (kernel, B, grid, C, N) of the ops whose plans split their depth: the served batch's three forwards and the
# dx that shares 2048 -> 512's plan, and the train step's split forward and dx at B=32
SPLIT_OPS = [("conv_k2", 8, 4, 2048, 512), ("conv_k2", 8, 4, 512, 2048), ("conv_k2", 8, 8, 1024, 256),
             ("conv_k2_dx", 8, 4, 2048, 512), ("conv_k2_dx", 8, 4, 512, 2048), ("conv_k2", 32, 4, 2048, 512),
             ("conv_k2_dx", 32, 4, 512, 2048)]


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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_split: needs a CUDA GPU")
    card, dev = card_line(), torch.device("cuda")
    tag = f"[{args.label}] [{card}]"

    # 1. the mid_blocked train step at B=32 and served batch of 8, bf16; then the split ops alone
    base, loss_cfg = configs.variant("modelnet_nolbo")
    cfg = dataclasses.replace(base, encoder3d=dataclasses.replace(base.encoder3d, mid_blocked=True),
                              decoder=dataclasses.replace(base.decoder, mid_blocked=True))
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16).to(dev)
    state, step = create_train_state(model), make_train_step(model, loss_cfg)
    loader = SyntheticVoxelLoader(num_samples=32, dim=64, num_classes=cfg.category_dim)
    batch = to_device(cli_train.build_batch_fn(loader, cfg, 32, packed=True, native=True)(0), dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(what: str, fn) -> None:
        print(f"{what}: events {cuda_ms(fn, 10):.3f} ms, alone {device_ms(fn, 5):.3f} ms, device busy "
              f"{busy_ms(fn):.3f} ms a call {tag}", flush=True)

    timed("mid_blocked bf16 train step, B=32", lambda: step(state, batch, gen))
    del state, step, batch
    model.eval()
    infer = make_packed_infer(model, (64, 64, 64, 1))
    rng = torch.Generator().manual_seed(1)
    packed = torch.from_numpy(pack_voxels((torch.rand(8, 64, 64, 64, 1, generator=rng) > 0.7).float().numpy()))
    packed, mask = packed.to(dev), (torch.rand(8, cfg.z_category_dim, generator=rng) < 0.5).float().to(dev)
    with torch.inference_mode():
        timed("mid_blocked bf16 served batch of 8", lambda: infer(packed, mask))
        for kernel, b, grid, c, n in SPLIT_OPS:
            x = torch.randn(b, grid, grid, grid, c if kernel == "conv_k2" else n, generator=rng).to(dev, torch.bfloat16)
            w = (torch.randn(2, 2, 2, c, n, generator=rng) / (8 * c) ** 0.5).to(dev, torch.bfloat16)
            op = (lambda: k2.conv_k2(x, w)) if kernel == "conv_k2" else (lambda: k2.conv_k2_dx(x, w))
            print(f"{kernel} {grid}^3 {c}->{n}, B={b}: host enqueue {host_enqueue_ms(op, 50):.4f} ms, events "
                  f"{cuda_ms(op, 50):.4f} ms, alone {device_ms(op, 50):.4f} ms {tag}", flush=True)
        if args.end_to_end:
            return

        # 2. the stem's dw on the dw-only narrow plan, other boxes and fewer splits
        lib = k2._lib()
        for b in (8, 32):
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


if __name__ == "__main__":
    main()
