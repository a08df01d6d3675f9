"""Two lowerings of the stride-2 k=4 SAME transposed conv, timed side by side:
the yardstick behind ``nn.blocks.ConvTransposeEquiv3D``'s choice.

    python -m anytime3d_tpu_torch.cli.probe_transpose [--batch 32] [--grid 32] [--cin 64] [--cout 1]

At the last decoder stage of ``modelnet_nolbo_acc`` (B=32, 64 -> 1 channel,
32^3 -> 64^3 by default) it times, in float32 with cuDNN's TF32 off, in
float32 with it on (PyTorch's default, what ``cli/train.py`` and
``cli/serve.py`` run without ``--bf16``) and in bfloat16:

- ``transpose``: ``F.conv_transpose3d`` on the flipped kernel, cropped to the
  SAME window (``nn.blocks.ConvTranspose3d``);
- ``phase_k3``: ``nn.blocks.ConvTransposeEquiv3D`` on the same weight: the
  kernel embedded at call time into the zero-structured (3, 3, 3, Cin,
  8 Cout) kernel of its phase decomposition, one k=3 SAME ``F.conv3d`` at the
  coarse grid, then depth-to-space(2), as the JAX package computes it.

Each form is timed forward alone and forward + backward (the gradients of the
input and the kernel), by CUDA events over 20 calls after 3, in the order
transpose, phase, phase, transpose; the two forms are first held to each other.
Every line carries the card's name and power limit. ``--device cpu`` runs the
comparison alone, at whatever size is given.
"""

from __future__ import annotations

import argparse

import torch

from anytime3d_tpu_torch.nn.blocks import ConvTranspose3d, ConvTransposeEquiv3D
from anytime3d_tpu_torch.utils.timing import card_line, cuda_ms


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--grid", type=int, default=32, help="the coarse grid; the output is twice as wide")
    p.add_argument("--cin", type=int, default=64)
    p.add_argument("--cout", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_transpose: --device cuda but CUDA is not available")
    card = "cpu"
    if device.type == "cuda":
        card = card_line()
    gen = torch.Generator().manual_seed(0)
    conv = ConvTranspose3d(args.cin, args.cout, 4, 2, generator=gen).to(device)
    equiv = ConvTransposeEquiv3D(args.cin, args.cout).to(device)
    equiv.weight = conv.weight  # one parameter, two lowerings
    shape = (args.batch, args.grid, args.grid, args.grid, args.cin)
    x32 = torch.randn(shape, generator=gen).to(device)
    g32 = torch.randn((args.batch, *(2 * args.grid,) * 3, args.cout), generator=gen).to(device)
    results = {}
    for name, dtype, tf32 in (("float32", torch.float32, False), ("tf32", torch.float32, True),
                              ("bfloat16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        x, g = x32.to(dtype), g32.to(dtype)
        forms = {"transpose": conv, "phase_k3": equiv}
        with torch.no_grad():
            a, b = forms["transpose"](x).float(), forms["phase_k3"](x).float()
        err = float((a - b).abs().max())
        # float32: summation order; TF32 and bfloat16 keep 10 and 7 bits of mantissa (two ulps)
        tol = {"float32": 1e-5, "tf32": 2.0**-9, "bfloat16": 2.0**-7}[name] * max(1.0, float(a.abs().max()))
        print(f"probe_transpose {name}: the two forms differ by {err:.3e} (tol {tol:.3e}) [{card}]", flush=True)
        if not err <= tol:
            raise AssertionError(f"probe_transpose {name}: the two forms disagree")
        results[name] = {"max_abs_err": err}
        if device.type != "cuda":
            continue

        def fwd(form):
            def run():
                with torch.no_grad():
                    forms[form](x)
            return run

        def train(form):
            xr = x.detach().requires_grad_(True)

            def run():
                y = forms[form](xr)
                torch.autograd.grad(y, (xr, conv.weight), g)
            return run

        for what, make in (("forward", fwd), ("forward+backward", train)):
            t1, p1, p2, t2 = (cuda_ms(make(f)) for f in ("transpose", "phase_k3", "phase_k3", "transpose"))
            t, ph = (t1 + t2) / 2, (p1 + p2) / 2
            results[name][what] = {"transpose_ms": t, "phase_k3_ms": ph}
            print(f"probe_transpose {name} {what} B={args.batch} {args.grid}^3 {args.cin}->{args.cout}: "
                  f"transpose {t:.4f} ms ({t1:.4f}, {t2:.4f}), phase_k3 {ph:.4f} ms ({p1:.4f}, {p2:.4f}) "
                  f"[{card}]", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return results


if __name__ == "__main__":
    main()
