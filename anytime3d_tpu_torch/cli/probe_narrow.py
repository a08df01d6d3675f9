"""What holds the float32 narrow kernels back: each timed whole and with a
part left out, at the detector decoder's last conv (32 decodes of 32^3,
C = 32 -> N = 8; ``kernels/csrc/conv_k2_narrow.cuh``).

    python -m anytime3d_tpu_torch.cli.probe_narrow

Builds ``csrc/conv_k2.cu`` four times at once, with
``CONV_K2_NARROW_PROBE`` = 0 (the port's kernels), 1, 2 and 3, and times by
CUDA events (mean of 20 calls after 3; two rounds) the forward (32 -> 8), dx
(the forward from 8 to 32 over g) and dw (with its reduce of the splits) of
each build at the shapes of their plans:

- the forward and dx: whole; without the store of y; without the products;
  without both (the copies, tables and walk alone). dx also with its rows
  stored from registers, as where its plan has no output chunk;
- dw: whole; without each row's loads; with 8 FFMA a row for 64; without the
  loop over rows. Also with two stages for the plan's three.

Every line carries the card's name and power limit, and the whole kernels'
and the variants' max abs error against the plain version. Needs a CUDA card
and ``nvcc``. The port calls none of this.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

from anytime3d_tpu_torch.utils.timing import card_line, cuda_ms

PROBES = {0: "whole", 1: "without the store", 2: "without the products", 3: "without both"}
DW_PROBES = {0: "whole", 1: "without each row's loads", 2: "8 FFMA a row for 64", 3: "without the loop over rows"}
B, G, C, N = 32, 32, 32, 8  # decodes, grid, channels in and out


def main() -> None:
    import torch

    from anytime3d_tpu_torch.kernels import build
    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    if not torch.cuda.is_available():
        raise SystemExit("probe_narrow: needs a CUDA GPU")
    card = card_line()
    with ThreadPoolExecutor(len(PROBES)) as pool:  # one nvcc a build, all at once
        paths = list(pool.map(lambda m: build.build("conv_k2", (f"CONV_K2_NARROW_PROBE={m}",) if m else ()), PROBES))
    libs = {m: k2.bind(ctypes.CDLL(str(p))) for m, p in zip(PROBES, paths)}

    torch.backends.cudnn.allow_tf32 = False
    f32, dev = torch.float32, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, G, G, G, C, generator=gen, device=dev)
    g = torch.randn(B, G, G, G, N, generator=gen, device=dev)
    w = torch.randn(2, 2, 2, C, N, generator=gen, device=dev) / 16
    wm = w.flip(0, 1, 2).transpose(3, 4).contiguous()  # w'[s] = w[7 - s]^T
    fplan = k2.narrow_plan(B, G, G, G, C, N, dtype=f32)
    xplan = k2.narrow_plan(B, G, G, G, N, C, dtype=f32)
    y = torch.empty(B, G, G, G, N, device=dev)
    dx = torch.empty(B, G, G, G, C, device=dev)
    dw = torch.empty(2, 2, 2, C, N, device=dev)
    workspace = torch.empty(fplan.dw_splits, 8 * C, N, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def check(what: str, rc: int) -> None:
        if rc:
            raise RuntimeError(f"{what}: {libs[0].conv_k2_error_string(rc).decode()} (code {rc})")

    def forward(lib):
        return lambda: check("forward", lib.conv_k2_forward_narrow(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, G, G, G, C, N, *fplan.box, fplan.grid, fplan.smem_bytes,
            fplan.chunk_d, 0, 0, stream))

    def backward_input(lib, chunk_d, smem):
        return lambda: check("dx", lib.conv_k2_backward_input_narrow(
            g.data_ptr(), wm.data_ptr(), dx.data_ptr(), B, G, G, G, C, N, *xplan.box, xplan.grid, smem, chunk_d, 0,
            0, stream))

    def backward_weight(lib, stages, smem):
        return lambda: check("dw", lib.conv_k2_backward_weight_narrow(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), fplan.dw_splits,
            fplan.dw_boxes_per_split, B, G, G, G, C, N, *fplan.dw_box, smem, stages, 0, 0, stream))

    dx_registers = k2._narrow_smem(xplan.box, N, C, False, 4, 2, 0)
    dw_two_stages = k2._narrow_smem(fplan.dw_box, C, N, True, 4, 2, 0)
    runs = {f"forward {PROBES[m]}": forward(libs[m]) for m in PROBES}
    runs |= {f"dx {PROBES[m]}": backward_input(libs[m], xplan.chunk_d, xplan.smem_bytes) for m in PROBES}
    runs["dx whole, rows stored from registers"] = backward_input(libs[0], 0, dx_registers)
    runs |= {f"dw {DW_PROBES[m]}": backward_weight(libs[m], fplan.dw_stages, fplan.dw_smem_bytes) for m in PROBES}
    runs["dw whole, two stages"] = backward_weight(libs[0], 2, dw_two_stages)

    # the whole kernels and the variants that compute the same function, against the plain version
    checked = {"forward whole": (y, lambda: k2.conv_k2_reference(x, w)),
               "dx whole": (dx, lambda: k2.conv_k2_dx_reference(g, w)),
               "dx whole, rows stored from registers": (dx, lambda: k2.conv_k2_dx_reference(g, w)),
               "dw whole": (dw, lambda: k2.conv_k2_dw_reference(x, g)),
               "dw whole, two stages": (dw, lambda: k2.conv_k2_dw_reference(x, g))}
    err = {}
    for name, (out, ref) in checked.items():
        out.zero_()
        runs[name]()
        err[name] = (out - ref()).abs().max().item()
    times = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(cuda_ms(fn))
    for name, (a, b) in times.items():
        extra = f", max_abs_err {err[name]:.3e}" if name in err else ""
        print(f"float32 narrow {name}, {B} decodes of {G}^3, {C} -> {N}: {a:.4f} / {b:.4f} ms by events{extra} "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
