"""Operations, bytes and peaks: the roofline arithmetic of the benchmark.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the card's full 700 W: 989 TFLOP/s in bfloat16, 494.5 TFLOP/s in
TF32 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of
HBM. A mix whose float32 work may run in TF32 (cuDNN's default) names the
TF32 peak as its ``peak``, so that its ``mfu_pct`` is not taken against a
peak lower than the card has for that work. A share of a roofline
is the least time the chip could take for the work (operations over the
peak of the work's dtype or bytes over the bandwidth, the larger) over the
time its kernels took.

A k=2 s=1 SAME conv (``conv_k2``: x (B, D, H, W, C), w (2, 2, 2, C, N))
needs 2 B C N (2D - 1)(2H - 1)(2W - 1) operations: the taps that fall on
the high pad multiply zeros, and no output needs them. Its dx and dw need
as many. Bytes count each input once and the output once, in the dtypes the
call was given.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "tf32": 494.5e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}  # the profiler's names of the input types
COMPUTE = {"c10::BFloat16": "bf16", "c10::Half": "f16", "float": "f32"}
CONV_K2_OPS = ("anytime3d_torch::conv_k2", "anytime3d_torch::conv_k2_dx", "anytime3d_torch::conv_k2_dw")


def conv_k2_ops(B: int, D: int, H: int, W: int, C: int, N: int) -> int:
    return 2 * B * C * N * (2 * D - 1) * (2 * H - 1) * (2 * W - 1)


def conv_k2_work(op: str, dims: Sequence[Sequence[int]], types: Sequence[str]) -> Optional[Tuple[int, int, str]]:
    """(operations, bytes, compute dtype) of one call of ``op`` with the
    profiler's input dims and types, or None for a call it cannot read."""
    if len(dims) < 2 or len(types) < 2 or any(t not in ITEMSIZE for t in types[:2]):
        return None
    a, b = list(dims[0]), list(dims[1])
    sa, sb = ITEMSIZE[types[0]], ITEMSIZE[types[1]]
    if op == CONV_K2_OPS[0]:  # x, w -> y in x's dtype
        B, D, H, W, C = a
        N = b[4]
        out = B * D * H * W * N * sa
    elif op == CONV_K2_OPS[1]:  # g, w -> dx in g's dtype
        B, D, H, W, N = a
        C = b[3]
        out = B * D * H * W * C * sa
    elif op == CONV_K2_OPS[2]:  # x, g -> dw in float32
        B, D, H, W, C = a
        N = b[4]
        out = 8 * C * N * 4
    else:
        return None
    return conv_k2_ops(B, D, H, W, C, N), math.prod(a) * sa + math.prod(b) * sb + out, COMPUTE[types[0]]


def bound_s(ops: float, nbytes: float, compute: str) -> float:
    """The least seconds the chip could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS[compute], nbytes / PEAK_BYTES)


def model_flops(fn) -> int:
    """Operations of the matmuls and convolutions that ``fn()`` runs
    (``torch.utils.flop_counter``), forward and whatever backward it calls;
    run it on the meta device to count without computing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def train_step_flops(cfg: dict, batch: int, image_size: Optional[int] = None) -> int:
    """Forward and backward operations of one train step of ``cfg`` at
    ``batch``, counted on the plain reference on the meta device (the
    gradient of every parameter, none of the input)."""
    import torch

    from perfbench.reference import model as ref
    from perfbench.reference import train as ref_train

    m = cfg["model"]
    dev = torch.device("meta")
    spec = ref.param_spec(m)
    params = {n: torch.empty(s, device=dev, requires_grad=True) for n, (s, _, _) in spec.items()}
    grid = m["decoder"]["output_shape"][:3]
    batch_in = {"vox": torch.empty((batch, 1, *grid), device=dev)}
    if m["encoder"] == "image":
        batch_in["images"] = torch.empty((batch, image_size, image_size, 3), device=dev)
    if m["category_dim"]:
        batch_in["category_onehot"] = torch.zeros((batch, m["category_dim"]), device=dev)
    if m["inst_dim"]:
        batch_in["inst_onehot"] = torch.zeros((batch, m["inst_dim"]), device=dev)
    zc, zi = m["z_category_dim"], m["z_inst_dim"]
    widths = ({"eps_cat": zc, "eps_inst": zi, "eps_prior_cat": zc, "eps_prior_inst": zi} if zc and zi
              else {"eps_inst": zc + zi, "eps_prior_cat": zc + zi, "eps_prior_inst": zc + zi})
    draws = {k: torch.zeros((batch, w), device=dev) for k, w in widths.items()}
    draws["coin"] = torch.ones((), dtype=torch.bool, device=dev)
    draws["take_prior"] = torch.zeros((batch, zc + zi), dtype=torch.bool, device=dev)

    def step():
        total = ref_train.loss(params, cfg, batch_in, draws, {})
        torch.autograd.grad(total, list(params.values()))

    return model_flops(step)


def serve_batch_flops(cfg: dict, batch: int) -> int:
    """Forward operations of one served batch of a voxel ``cfg``, on the reference."""
    import torch

    from perfbench.reference import model as ref

    m = cfg["model"]
    dev = torch.device("meta")
    params = {n: torch.empty(s, device=dev) for n, (s, _, _) in ref.param_spec(m).items()}
    grid = m["decoder"]["output_shape"][:3]

    def forward():
        out = ref.encode_voxels(params, m, torch.empty((batch, 1, *grid), device=dev))
        ref.decode_logits(params, m, ref.split_posterior(m, out)[0])

    return model_flops(forward)
