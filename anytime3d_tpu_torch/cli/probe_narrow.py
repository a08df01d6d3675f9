"""What holds the narrow kernels back (``kernels/csrc/conv_k2_narrow.cuh``,
``conv_k2_chunked_dx.cuh``): each timed whole and with a part left out, in
five parts.

    python -m anytime3d_tpu_torch.cli.probe_narrow [--parts 123456]

Builds ``csrc/conv_k2.cu`` four times at once, with
``CONV_K2_NARROW_PROBE`` = 0 (the port's kernels), 1, 2 and 3 (parts 3 and 5
need only the first).

The float32 kernels at the detector decoder's last conv (32 decodes of
32^3, C = 32 -> N = 8), timed by CUDA events (mean of 20 calls after 3; two
rounds): the forward (32 -> 8), dx (the forward from 8 to 32 over g) and dw
(with its reduce of the splits) of each build at the shapes of their plans:

- the forward and dx: whole; without the store of y; without the products;
  without both (the copies, tables and walk alone). dx also with its rows
  stored from registers, as where its plan has no output chunk;
- dw: whole; without each row's loads; with 8 FFMA a row for 64; without the
  loop over rows. Also with two stages for the plan's three.

The bfloat16 kernels that walk C in chunks of 64, at the tensor-parallel
shards of the flagship's last 16^3 stage, B=32: 512 -> 32 (a model axis of
2), 512 -> 16 and 512 -> 8 (of 4). Timed on the card alone (``device_ms``:
mean of 50 calls after 3, the card held busy while the host enqueues them;
two rounds, in turns) at each shape: the chunked forward and dw (with its
reduce) on their plan (``narrow_plan``) and dx on the chunked dx's
(``chunked_dx_plan``), each beside the bfloat16 FFMA GEMM that took these
shapes before (launched straight through the library, as the op did) and
cuDNN's k=2 call. Then, at 512 -> 32, each build's three kernels on their
plans: the forward and dx without the store (of y, of dx), without the
products (no ``ldmatrix``, no ``mma`` or ``wgmma``), without both (the
copies, tables and walk alone); dw with each k-step's products added by the
tensor cores' own accumulation (no rounded adds), without the loop over
k-steps (the copies, the partials' store and the reduce).

The float32 forward that walks C in chunks of 16, on the card alone as the
second part: at the shards 512 -> 32, -> 16, -> 8 (B=32, 16^3) and at the
default ``DetectorConfig``'s 64 -> 8 (32 decodes of 32^3), beside the FFMA
GEMM that took them before (with its depth split where ``ffma_split`` has
one) and cuDNN's call.

The wide forward, the fourth part (the chunked dx's kernel run forward), on
the card alone at the s2d(2) stem's 8 -> 64 on 32^3, B=32 and B=8, bfloat16:
on its plan (``wide_plan``), and with two blocks an SM, beside the bfloat16
FFMA GEMM that took the stem before (launched straight through the library)
and cuDNN's call; at B=32 each build's kernel, without the store of y,
without the products, without both. Then the chunked dx at C = 64 (the
default ``DetectorConfig``'s 64 -> 8, B=32 at 32^3), which its plan refuses
(C above 64 only), beside the FFMA dx that takes that shape and cuDNN.

The FFMA dw (``conv_k2_backward_weight``), the fifth part, on the card
alone in float32 at the tensor-parallel shard 512 -> 32 (B=32, 16^3), the
s2d(2) stem's 8 -> 64 (32^3, B=32 and B=8) and the default
``DetectorConfig``'s 64 -> 8 (B=32 at 32^3), with ``ffma_dw_split``'s splits
and with half and a quarter as many, each split deeper: the part calls only
what the kernels had before the tiles fitted to a narrow side, so a copy of
this file in a checkout of that tree times the tile it had, in turns with
this one. The sixth part times each build's FFMA dw at those shapes on the
plan's splits: whole, without its loads, without its products, without
both.

Every line carries the card's name and power limit, and the whole kernels'
and the variants' max abs error against the plain version (the bfloat16
part: of the largest entry, beside the bytes bound). Needs a CUDA card and
``nvcc``. The port calls none of this.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

from anytime3d_tpu_torch.utils.timing import card_line, cuda_ms, device_ms

PROBES = {0: "whole", 1: "without the store", 2: "without the products", 3: "without both"}
DW_PROBES = {0: "whole", 1: "without each row's loads", 2: "8 FFMA a row for 64", 3: "without the loop over rows"}
CHUNKED_DW_PROBES = {0: "whole", 1: "the tensor cores' own accumulation", 3: "without the loop over k-steps"}
B, G, C, N = 32, 32, 32, 8  # decodes, grid, channels in and out
TP_B, TP_G, TP_C = 32, 16, 512  # the chunked part: batch, grid, channels in
TP_SHARDS = (32, 16, 8)  # N: the last stage's 64 output channels over a model axis of 2, 4 and 8
PEAK_BYTES_PER_S = 3.35e12  # an H100 SXM's device memory (the data sheet)


def main(argv: list[str] | None = None) -> None:
    import argparse

    import torch

    from anytime3d_tpu_torch.kernels import build
    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    if not torch.cuda.is_available():
        raise SystemExit("probe_narrow: needs a CUDA GPU")
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default="123456", help="the parts to run, by number")
    parts = parser.parse_args(argv).parts
    card = card_line()
    modes = PROBES if set(parts) & set("1246") else {0: PROBES[0]}
    with ThreadPoolExecutor(len(modes)) as pool:  # one nvcc a build, all at once
        paths = list(pool.map(lambda m: build.build("conv_k2", (f"CONV_K2_NARROW_PROBE={m}",) if m else ()), modes))
    libs = {m: k2.bind(ctypes.CDLL(str(p))) for m, p in zip(modes, paths)}
    if "1" in parts:
        float32_part(libs, card)
    if "2" in parts:
        chunked_part(libs, card)
    if "3" in parts:
        chunked_f32_part(libs[0], card)
    if "4" in parts:
        wide_part(libs, card)
    if "5" in parts:
        ffma_dw_part(libs[0], card)
    if "6" in parts:
        ffma_dw_parts_part(libs, card)


def float32_part(libs: dict, card: str) -> None:
    import torch

    from anytime3d_tpu_torch.kernels import conv_k2 as k2

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



def chunked_part(libs: dict, card: str) -> None:
    import torch
    import torch.nn.functional as F

    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    B, G, C = TP_B, TP_G, TP_C
    dev = torch.device("cuda", torch.cuda.current_device())
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    lib = libs[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, G, G, G, C, generator=gen, device=dev).to(bf16)
    x_pad = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1) * 3)
    rows = B * G**3

    for N in TP_SHARDS:
        w = (torch.randn(2, 2, 2, C, N, generator=gen, device=dev) / (8 * C) ** 0.5).to(bf16)
        g = torch.randn(B, G, G, G, N, generator=gen, device=dev).to(bf16)
        w_oidhw, g_ncdhw = w.permute(4, 3, 0, 1, 2).contiguous(), g.permute(0, 4, 1, 2, 3)
        plan = k2.narrow_plan(B, G, G, G, C, N, sms=sms)
        y, dw = torch.empty(B, G, G, G, N, device=dev, dtype=bf16), torch.empty(2, 2, 2, C, N, device=dev)
        dx = torch.empty_like(x)
        splits, per_split = k2.ffma_dw_split(rows, C, N, sms=sms, dtype=bf16)
        workspace = torch.empty(splits, 8 * C, N, device=dev)
        ws = torch.empty(plan.dw_splits, 8 * C, N, device=dev)
        wt = w.transpose(3, 4).contiguous()
        dx_plan = k2.chunked_dx_plan(B, G, G, G, C, N, sms=sms)
        wm = w.reshape(8, C, N).permute(1, 0, 2).contiguous()  # w as [C, 8N], as the wrapper lays it out

        def ffma_forward():
            k2._check_launch("FFMA forward", lib.conv_k2_forward(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), 0, 1, 8 * C // 16, B, G, G, G, C, N, 1, dev.index, stream))

        def ffma_dw():
            k2._check_launch("FFMA dw", lib.conv_k2_backward_weight(
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), splits, per_split, B, G, G, G, C, N,
                1, dev.index, stream))

        def ffma_dx():
            k2._check_launch("FFMA dx", lib.conv_k2_backward_input(
                g.data_ptr(), wt.data_ptr(), dx.data_ptr(), 0, 1, 8 * N // 16, B, G, G, G, C, N, 1, dev.index,
                stream))

        def forward(lib):  # each build's chunked forward on the plan
            return lambda: k2._check_launch("forward", lib.conv_k2_forward_chunked(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), B, G, G, G, C, N, *plan.box, plan.grid, plan.smem_bytes, 1,
                dev.index, stream))

        def backward_input(lib):  # each build's chunked dx on its plan
            return lambda: k2._check_launch("dx", lib.conv_k2_backward_input_chunked(
                g.data_ptr(), wm.data_ptr(), dx.data_ptr(), B, G, G, G, C, N, *dx_plan.box, dx_plan.bn,
                dx_plan.stages, dx_plan.grid, dx_plan.smem_bytes, dev.index, stream))

        def backward_weight(lib):  # each build's chunked dw on the plan, with its reduce
            return lambda: k2._check_launch("dw", lib.conv_k2_backward_weight_narrow(
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), ws.data_ptr(), plan.dw_splits, plan.dw_boxes_per_split,
                B, G, G, G, C, N, *plan.dw_box, plan.dw_smem_bytes, plan.dw_stages, 1, dev.index, stream))

        runs = {
            f"forward, chunked, box {plan.box}": (forward(lib), y),
            "forward, bf16 FFMA GEMM (the route before)": (ffma_forward, y),
            "forward, cuDNN": (lambda: F.conv3d(x_pad, w_oidhw), None),
            f"dw, chunked, {plan.dw_stages} stages, box {plan.dw_box}, {plan.dw_splits} splits x {plan.c_chunks} "
            "chunks": (backward_weight(lib), dw),
            "dw, bf16 FFMA (the route before)": (ffma_dw, dw),
            "dw, cuDNN": (lambda: torch.nn.grad.conv3d_weight(x_pad, w_oidhw.shape, g_ncdhw), None),
            f"dx, chunked on the tensor cores, box {dx_plan.box}, {dx_plan.chunks} chunks of {dx_plan.bn}, "
            f"{dx_plan.stages} stages": (backward_input(lib), dx),
            "dx, bf16 FFMA GEMM (the route before)": (ffma_dx, dx),
            "dx, cuDNN": (lambda: torch.nn.grad.conv3d_input(x_pad.shape, w_oidhw, g_ncdhw), None),
        }
        with torch.no_grad():
            ref = {"forward": k2.conv_k2_reference(x, w), "dw": k2.conv_k2_dw_reference(x, g),
                   "dx": k2.conv_k2_dx_reference(g, w)}
        err = {}
        for name, (fn, out) in runs.items():
            if out is not None:
                out.zero_()
                fn()
                want = ref[name.split(",")[0]]
                err[name] = float((out.float() - want.float()).abs().max()) / float(want.float().abs().max())
        times = {name: [] for name in runs}
        for _ in range(2):
            for name, (fn, _) in runs.items():
                times[name].append(device_ms(fn, iters=50))
        # each input read once, each output written once: x and y (dx: g and dx) and w in bf16, dw in f32
        io = rows * (C + N) * 2
        bound = {"forward": io + 8 * C * N * 2, "dx": io + 8 * C * N * 2, "dw": io + 8 * C * N * 4}
        for name, (a, b) in times.items():
            extra = f", max abs err {err[name]:.2e} of the largest entry" if name in err else ""
            bound_ms = bound[name.split(",")[0]] / PEAK_BYTES_PER_S * 1e3
            print(f"chunked probe B={B} {G}^3 {C} -> {N} bf16, {name}: on the card alone {a:.4f} / {b:.4f} ms "
                  f"(bytes bound {bound_ms:.4f} ms){extra} [{card}]", flush=True)
        if N != 32:
            continue
        parts = {f"forward {PROBES[m]}": forward(libs[m]) for m in PROBES}
        parts |= {f"dx {PROBES[m]}": backward_input(libs[m]) for m in PROBES}
        parts |= {f"dw {CHUNKED_DW_PROBES[m]}": backward_weight(libs[m]) for m in CHUNKED_DW_PROBES}
        times = {name: [device_ms(fn, iters=50) for _ in range(2)] for name, fn in parts.items()}
        for name, (a, b) in times.items():
            print(f"chunked probe parts B={B} {G}^3 {C} -> {N} bf16, {name}: on the card alone {a:.4f} / {b:.4f} ms "
                  f"[{card}]", flush=True)


def chunked_f32_part(lib, card: str) -> None:
    import torch
    import torch.nn.functional as F

    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, G, C, N in [(TP_B, TP_G, TP_C, n) for n in TP_SHARDS] + [(32, 32, 64, 8)]:
        x = torch.randn(B, G, G, G, C, generator=gen, device=dev)
        w = torch.randn(2, 2, 2, C, N, generator=gen, device=dev) / (8 * C) ** 0.5
        plan = k2.narrow_plan(B, G, G, G, C, N, sms=sms, dtype=torch.float32)
        splits, per_split = k2.ffma_split(B, G, G, G, C, N, sms=sms)
        y = torch.empty(B, G, G, G, N, device=dev)
        part = k2._split_workspace(splits, y)
        x_pad, w_oidhw = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1) * 3), w.permute(4, 3, 0, 1, 2).contiguous()

        def chunked():
            k2._check_launch("forward", lib.conv_k2_forward_chunked(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), B, G, G, G, C, N, *plan.box, plan.grid, plan.smem_bytes, 0,
                dev.index, stream))

        def ffma():
            k2._check_launch("FFMA forward", lib.conv_k2_forward(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), 0 if part is None else part.data_ptr(), splits, per_split,
                B, G, G, G, C, N, 0, dev.index, stream))

        runs = {f"chunked, box {plan.box}, {plan.c_chunks} chunks of {C // plan.c_chunks}": chunked,
                f"FFMA GEMM, {splits} split(s) (the route before)": ffma,
                "cuDNN": lambda: F.conv3d(x_pad, w_oidhw)}
        with torch.no_grad():
            ref = k2.conv_k2_reference(x, w)
        err = {}
        for name in list(runs)[:2]:
            y.zero_()
            runs[name]()
            err[name] = float((y - ref).abs().max())
        times = {name: [] for name in runs}
        for _ in range(2):
            for name, fn in runs.items():
                times[name].append(device_ms(fn, iters=20))
        # operations on the grid (a tap past the edge is no work) at the card's f32 peak, beside bytes
        flops = 2.0 * B * (2 * G - 1) ** 3 * C * N
        bound_ms = max(flops / 67e12, (B * G**3 * (C + N) + 8 * C * N) * 4 / PEAK_BYTES_PER_S) * 1e3
        for name, (a, b) in times.items():
            extra = f", max abs err {err[name]:.2e}" if name in err else ""
            print(f"float32 chunked probe B={B} {G}^3 {C} -> {N}, {name}: on the card alone {a:.4f} / {b:.4f} ms "
                  f"(bound {bound_ms:.4f} ms){extra} [{card}]", flush=True)
        del x, w, y, part, x_pad, w_oidhw, ref


def wide_part(libs: dict, card: str) -> None:
    import dataclasses

    import torch
    import torch.nn.functional as F

    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    dev = torch.device("cuda", torch.cuda.current_device())
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(2)
    G, C, N = 32, 8, 64
    for B in (32, 8):
        x = torch.randn(B, G, G, G, C, generator=gen, device=dev).to(bf16)
        w = (torch.randn(2, 2, 2, C, N, generator=gen, device=dev) / (8 * C) ** 0.5).to(bf16)
        y = torch.empty(B, G, G, G, N, device=dev, dtype=bf16)
        plan = k2.wide_plan(B, G, G, G, C, N, sms=sms)
        two = dataclasses.replace(plan, grid=min(plan.boxes, 2 * sms) // plan.chunks * plan.chunks)
        wt = w.reshape(8, C, N).permute(2, 0, 1).contiguous()  # [N, 8C], as the wrapper lays it out
        x_pad, w_oidhw = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1) * 3), w.permute(4, 3, 0, 1, 2).contiguous()

        def wide(lib, p):
            return lambda: k2._check_launch("wide forward", lib.conv_k2_forward_wide(
                x.data_ptr(), wt.data_ptr(), y.data_ptr(), B, G, G, G, C, N, *p.box, p.bn, p.stages, p.grid,
                p.smem_bytes, dev.index, stream))

        def ffma():
            k2._check_launch("FFMA forward", libs[0].conv_k2_forward(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), 0, 1, 8 * C // 16, B, G, G, G, C, N, 1, dev.index, stream))

        runs = {f"wide, box {plan.box}, {plan.chunks} chunk of {plan.bn}, {plan.stages} stages, {plan.grid} blocks":
                wide(libs[0], plan),
                f"wide, {two.grid} blocks (two an SM)": wide(libs[0], two),
                "bf16 FFMA GEMM (the route before)": ffma,
                "cuDNN": lambda: F.conv3d(x_pad, w_oidhw)}
        with torch.no_grad():
            ref = k2.conv_k2_reference(x, w).float()
        err = {}
        for name in list(runs)[:3]:
            y.zero_()
            runs[name]()
            err[name] = float((y.float() - ref).abs().max()) / float(ref.abs().max())
        times = {name: [] for name in runs}
        for _ in range(2):
            for name, fn in runs.items():
                times[name].append(device_ms(fn, iters=50))
        bound_ms = (B * G**3 * (C + N) + 8 * C * N) * 2 / PEAK_BYTES_PER_S * 1e3
        for name, (a, b) in times.items():
            extra = f", max abs err {err[name]:.2e} of the largest entry" if name in err else ""
            print(f"wide probe B={B} {G}^3 {C} -> {N} bf16, {name}: on the card alone {a:.4f} / {b:.4f} ms (bytes "
                  f"bound {bound_ms:.4f} ms){extra} [{card}]", flush=True)
        if B == 32:
            parts = {f"wide {PROBES[m]}": wide(libs[m], plan) for m in PROBES}
            for name, fn in parts.items():
                a, b = (device_ms(fn, iters=50) for _ in range(2))
                print(f"wide probe parts B={B} {G}^3 {C} -> {N} bf16, {name}: on the card alone {a:.4f} / {b:.4f} ms "
                      f"[{card}]", flush=True)
        del x, y, x_pad, ref

    # the chunked dx at C = 64 (dx of 64 -> 8, g narrow): its plan's cut, which chunked_dx_plan refuses there
    B, C, N = 32, 64, 8
    g = torch.randn(B, G, G, G, N, generator=gen, device=dev).to(bf16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen, device=dev) / (8 * C) ** 0.5).to(bf16)
    dx = torch.empty(B, G, G, G, C, device=dev, dtype=bf16)
    plan = k2._chunked_wide_plan(B, G, G, G, N, C, sms)
    wm = w.reshape(8, C, N).permute(1, 0, 2).contiguous()  # [C, 8N]
    wt = w.transpose(3, 4).contiguous()  # the FFMA dx's (2, 2, 2, N, C)
    g_ncdhw, w_oidhw = g.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
    x_shape = (B, C, G + 1, G + 1, G + 1)
    runs = {f"chunked dx at C = 64, box {plan.box}, {plan.chunks} chunk of {plan.bn}, {plan.grid} blocks":
            lambda: k2._check_launch("dx", libs[0].conv_k2_backward_input_chunked(
                g.data_ptr(), wm.data_ptr(), dx.data_ptr(), B, G, G, G, C, N, *plan.box, plan.bn, plan.stages,
                plan.grid, plan.smem_bytes, dev.index, stream)),
            "bf16 FFMA dx (the route)": lambda: k2._check_launch("FFMA dx", libs[0].conv_k2_backward_input(
                g.data_ptr(), wt.data_ptr(), dx.data_ptr(), 0, 1, 8 * N // 16, B, G, G, G, C, N, 1, dev.index,
                stream)),
            "cuDNN": lambda: torch.nn.grad.conv3d_input(x_shape, w_oidhw, g_ncdhw)}
    with torch.no_grad():
        ref = k2.conv_k2_dx_reference(g, w).float()
    err = {}
    for name in list(runs)[:2]:
        dx.zero_()
        runs[name]()
        err[name] = float((dx.float() - ref).abs().max()) / float(ref.abs().max())
    times = {name: [device_ms(fn, iters=50) for _ in range(2)] for name, fn in runs.items()}
    bound_ms = (B * G**3 * (C + N) + 8 * C * N) * 2 / PEAK_BYTES_PER_S * 1e3
    for name, (a, b) in times.items():
        extra = f", max abs err {err[name]:.2e} of the largest entry" if name in err else ""
        print(f"wide probe dx B={B} {G}^3 {C} -> {N} bf16, {name}: on the card alone {a:.4f} / {b:.4f} ms (bytes "
              f"bound {bound_ms:.4f} ms){extra} [{card}]", flush=True)


def ffma_dw_part(lib, card: str) -> None:
    import torch

    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(3)
    for B, G, C, N in ((TP_B, TP_G, TP_C, 32), (32, 32, 8, 64), (8, 32, 8, 64), (32, 32, 64, 8)):
        rows = B * G**3
        x = torch.randn(B, G, G, G, C, generator=gen, device=dev)
        g = torch.randn(B, G, G, G, N, generator=gen, device=dev)
        dw = torch.empty(2, 2, 2, C, N, device=dev)
        splits, per_split = k2.ffma_dw_split(rows, C, N, sms=sms)  # float32, as the tree before had it
        stages = -(-rows // 16)
        variants = {}
        for k in (1, 2, 4):  # the plan's splits, then half and a quarter as many, each split deeper
            per = per_split * k
            variants[f"{-(-stages // per)} splits of {per} stages" + (" (the plan)" if k == 1 else "")] = per
        workspace = torch.empty(splits, 8 * C, N, device=dev)

        def launch(per):
            n = -(-stages // per)
            return lambda: k2._check_launch("FFMA dw", lib.conv_k2_backward_weight(
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), n, per, B, G, G, G, C, N, 0,
                dev.index, stream))

        with torch.no_grad():
            ref = k2.conv_k2_dw_reference(x, g)
        flops = 2.0 * B * (2 * G - 1) ** 3 * C * N
        bound_ms = max(flops / 67e12, (rows * (C + N) + 8 * C * N) * 4 / PEAK_BYTES_PER_S) * 1e3
        for name, per in variants.items():
            fn = launch(per)
            dw.zero_()
            fn()
            err = float((dw - ref).abs().max()) / float(ref.abs().max())
            a, b = (device_ms(fn, iters=20) for _ in range(2))
            print(f"FFMA dw probe B={B} {G}^3 {C} -> {N} f32, {name}: on the card alone {a:.4f} / {b:.4f} ms (bound "
                  f"{bound_ms:.4f} ms), max abs err {err:.2e} of the largest entry [{card}]", flush=True)
        del x, g, workspace, ref


def ffma_dw_parts_part(libs: dict, card: str) -> None:
    import torch

    from anytime3d_tpu_torch.kernels import conv_k2 as k2

    names = {0: "whole", 1: "without its loads", 2: "without its products", 3: "without both"}
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(4)
    for B, G, C, N in ((TP_B, TP_G, TP_C, 32), (32, 32, 8, 64), (8, 32, 8, 64)):
        x = torch.randn(B, G, G, G, C, generator=gen, device=dev)
        g = torch.randn(B, G, G, G, N, generator=gen, device=dev)
        dw = torch.empty(2, 2, 2, C, N, device=dev)
        splits, per_split = k2.ffma_dw_split(B * G**3, C, N, sms=sms)
        bm, bn, per_sm = k2._ffma_dw_tile(C, N)
        workspace = torch.empty(splits, 8 * C, N, device=dev)
        for m, name in names.items():
            fn = lambda lib=libs[m]: k2._check_launch("FFMA dw", lib.conv_k2_backward_weight(  # noqa: E731
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), splits, per_split, B, G, G, G, C, N,
                0, dev.index, stream))
            a, b = (device_ms(fn, iters=20) for _ in range(2))
            print(f"FFMA dw probe parts B={B} {G}^3 {C} -> {N} f32, {bm} x {bn} tiles, {per_sm} blocks an SM, {splits} "
                  f"splits of {per_split} stages, {name}: on the card alone {a:.4f} / {b:.4f} ms [{card}]", flush=True)
        del x, g, workspace


if __name__ == "__main__":
    main()
