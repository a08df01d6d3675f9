"""The plain reference of the benchmark's configurations: the MultiModalVAE
forward in float32 PyTorch, written from the configuration file alone.

Parameters are a dict keyed by the port's ``state_dict`` names, which the
benchmark makes from the seed and hands to both sides; nothing here imports
the port. Tensors are channels-first (NCDHW, NCHW). The layouts are the ones
the configurations name:

- voxel encoder, blocked head: space-to-depth(4) of the 64^3 grid (channels
  ordered (bd, bh, bw, c)), two k=2 s=1 SAME convs (pad 0 low, 1 high), then
  k=4 s=2 SAME convs, each with GroupNorm (the largest divisor of C up to 32
  groups of contiguous channels, eps 1e-5) and ELU; a final SAME conv and a
  mean over the grid;
- image encoder: Darknet19 (3x3 and 1x1 SAME convs, GroupNorm, ELU, 2x2
  stride-2 max-pools padded with -inf), a 1x1 conv and a max over the map;
- decoder, blocked tail: dense + LayerNorm (eps 1e-6) + ELU to a 4^3 x 8
  grid, transposed convs with flax's SAME window (the kernel stored flipped,
  as (Cin, Cout, k, k, k)) with GroupNorm and ELU, then two k=2 convs emitting
  the 64 phases of a 4^3 block each, GroupNorm and ELU between them; the
  output stays in the blocked layout (channels (bd, bh, bw)) until
  :func:`depth_to_space`;
- prior nets: dense, LayerNorm, dropout (keep where U >= rate, scaled by
  1 / (1 - rate)), ELU, dense; the log-variance the constant of the file.

``precision`` "f32" computes every product in float32 (the caller turns
TF32 off); "fp8" rounds both operands of every convolution and dense layer
to float8 e4m3 with a per-tensor scale, and their gradients to e5m2: the
control of a bfloat16 configuration, the reference one precision below it;
"bf16" rounds them, and their gradients, to bfloat16: the control of a
float32 configuration whose cuDNN convolutions may run in TF32; "tf32"
leaves the operands as they are and the caller lets cuDNN run every
convolution, the k=2 ones too, in TF32 (dense layers stay float32): the
witness of a program that would move ``conv_k2`` onto TF32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

DARKNET19 = ((32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M", (256, 3), (128, 1), (256, 3), "M",
             (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
             (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3))


class _RoundFp8(torch.autograd.Function):
    """Forward: round to e4m3 at a per-tensor scale; backward: the gradient rounded to e5m2 alike."""

    @staticmethod
    def forward(ctx, x):
        return _fake(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fake(g, torch.float8_e5m2, 57344.0)


class _RoundBf16(torch.autograd.Function):
    """Forward and backward: round to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _fake(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _RoundFp8.apply(x)
    return _RoundBf16.apply(x) if precision == "bf16" else x


def groups(c: int, max_groups: int = 32) -> int:
    g = min(max_groups, c)
    while c % g:
        g -= 1
    return g


def same_pads(k: int, s: int, size: int) -> Tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_list(x: torch.Tensor, k: int, s: int) -> list:
    pads = []
    for size in reversed(x.shape[2:]):
        pads += same_pads(k, s, size)
    return pads


def conv(x: torch.Tensor, w: torch.Tensor, s: int, precision: str) -> torch.Tensor:
    """SAME conv of channels-first ``x`` with an OI(k..) weight."""
    k = w.shape[-1]
    xp = F.pad(x, _pad_list(x, k, s))
    fn = F.conv3d if x.dim() == 5 else F.conv2d
    return fn(_q(xp, precision), _q(w, precision), stride=s)


def conv_k2(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """k=2 s=1 SAME conv of NCDHW ``x`` with a (2, 2, 2, C, N) weight."""
    xp = F.pad(x, (0, 1, 0, 1, 0, 1))
    return F.conv3d(_q(xp, precision), _q(w.permute(4, 3, 0, 1, 2), precision))


def conv_transpose(x: torch.Tensor, w: torch.Tensor, s: int, precision: str) -> torch.Tensor:
    """flax SAME ConvTranspose of NCDHW ``x``; ``w`` is flax's kernel flipped, (Cin, Cout, k, k, k)."""
    k = w.shape[-1]
    pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    pad_b = k + s - 2 - pad_a
    y = F.conv_transpose3d(_q(x, precision), _q(w, precision), stride=s)
    start = k - 1 - pad_a
    ln = [(n - 1) * s + 1 + pad_a + pad_b - k + 1 for n in x.shape[2:]]
    return y[:, :, start:start + ln[0], start:start + ln[1], start:start + ln[2]]


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return F.linear(_q(x, precision), _q(w, precision), b)


def gn_elu(x: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    c = x.shape[1]
    return F.elu(F.group_norm(x, groups(c), P[f"{name}.weight"], P[f"{name}.bias"], eps=1e-5))


def space_to_depth(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, b^3 C, D/b, H/b, W/b), channels (bd, bh, bw, c)."""
    B, C, D, H, W = x.shape
    x = x.reshape(B, C, D // b, b, H // b, b, W // b, b).permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(B, b**3 * C, D // b, H // b, W // b)


def depth_to_space(x: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    B, Cb, D, H, W = x.shape
    C = Cb // b**3
    x = x.reshape(B, b, b, b, C, D, H, W).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(B, C, D * b, H * b, W * b)


def _check_layout(cfg: dict) -> None:
    dec = cfg["decoder"]
    if not (dec["tail_blocked"] and dec["final_mode"] == "pixel_shuffle" and dec["strides"][-2:] == [2, 2]
            and not dec["mid_blocked"] and not dec["mid_equiv"] and not dec["tail_phase_norm"]):
        raise NotImplementedError("the reference has the blocked-tail decoder alone")
    if cfg["encoder"] == "voxel":
        enc = cfg["encoder3d"]
        if not (enc["head_blocked"] and enc["strides"][:2] == [2, 2] and not enc["mid_blocked"]
                and enc["final_pool"] == "average" and enc["final_act"] == "none"):
            raise NotImplementedError("the reference has the blocked-head voxel encoder alone")
    elif not (cfg["backbone"] == "darknet19" and cfg["head"]["filter_nums"] == []
              and cfg["head"]["last_pooling"] == "max"):
        raise NotImplementedError("the reference has Darknet19 with a bare 1x1 max head alone")
    for prior in ("prior_category", "prior_inst"):
        if cfg.get(prior) and cfg[prior]["const_log_var"] is None:
            raise NotImplementedError("the reference has constant prior log-variances alone")


def _encoder_stages(enc: dict):
    filters = list(enc["filter_nums"]) + [enc["output_dim"]]
    stages = [(filters[0] * 8, 2, 1), (filters[1], 2, 1)]
    stages += list(zip(filters[2:-1], enc["filter_sizes"][2:-1], enc["strides"][2:-1]))
    return stages, filters[-1]


def _decoder_geometry(dec: dict):
    spatial = dec["output_shape"][0] // math.prod(dec["strides"])
    channels = max(dec["filter_nums"][0] // 64, 8)
    return spatial, channels


def param_spec(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """name -> (shape, kind, fan_in) of every parameter, in the port's
    ``state_dict`` names and order; kind is 'kernel', 'ones' or 'zeros'."""
    _check_layout(cfg)
    spec: Dict[str, Tuple[Tuple[int, ...], str, int]] = {}

    def norm(name, c):
        spec[f"{name}.weight"] = ((c,), "ones", 0)
        spec[f"{name}.bias"] = ((c,), "zeros", 0)

    if cfg["encoder"] == "voxel":
        enc = cfg["encoder3d"]
        stages, out_dim = _encoder_stages(enc)
        cin = cfg["decoder"]["output_shape"][-1] * 64
        for i, (f, k, s) in enumerate(stages):
            name = f"encoder3d.convblock3d_{i}"
            if (k, s) == (2, 1):
                spec[f"{name}.conv_0.weight"] = ((2, 2, 2, cin, f), "kernel", 8 * cin)
            else:
                spec[f"{name}.conv_0.weight"] = ((f, cin, k, k, k), "kernel", cin * k**3)
            norm(f"{name}.groupnorm_0", f)
            cin = f
        k = enc["filter_sizes"][-1]
        spec["encoder3d.conv_0.weight"] = ((out_dim, cin, k, k, k), "kernel", cin * k**3)
    else:
        cin, i = 3, 0
        for item in DARKNET19:
            if item == "M":
                continue
            f, k = item
            spec[f"backbone.convblock2d_{i}.conv_0.weight"] = ((f, cin, k, k), "kernel", cin * k * k)
            norm(f"backbone.convblock2d_{i}.groupnorm_0", f)
            cin, i = f, i + 1
        spec["head.conv_0.weight"] = ((cfg["head"]["output_dim"], cin, 1, 1), "kernel", cin)

    dec = cfg["decoder"]
    spatial, channels = _decoder_geometry(dec)
    width = spatial**3 * channels
    spec["decoder.denseblock_0.dense_0.weight"] = ((width, dec["input_dim"]), "kernel", dec["input_dim"])
    spec["decoder.denseblock_0.dense_0.bias"] = ((width,), "zeros", 0)
    norm("decoder.denseblock_0.layernorm_0", width)
    cin = channels
    fn = dec["filter_nums"]
    for i, (f, k) in enumerate(zip(fn[:-2], dec["filter_sizes"][:-2])):
        spec[f"decoder.deconvblock3d_{i}.convtranspose_0.weight"] = ((cin, f, k, k, k), "kernel", cin * k**3)
        norm(f"decoder.deconvblock3d_{i}.groupnorm_0", f)
        cin = f
    f4, f = fn[-2], fn[-1]
    spec["decoder.conv_0.weight"] = ((2, 2, 2, cin, 8 * f4), "kernel", 8 * cin)
    norm("decoder.groupnorm_0", 8 * f4)
    spec["decoder.conv_1.weight"] = ((2, 2, 2, 8 * f4, 64 * f), "kernel", 64 * f4)

    for prior in ("prior_category", "prior_inst"):
        pc = cfg.get(prior)
        if not pc:
            continue
        widths = [pc["input_dim"], *pc["unit_nums"]]
        for j in range(len(pc["unit_nums"])):
            base = f"{prior}.mean_tower"
            spec[f"{base}.dense_{j}.weight"] = ((widths[j + 1], widths[j]), "kernel", widths[j])
            spec[f"{base}.dense_{j}.bias"] = ((widths[j + 1],), "zeros", 0)
            if j < len(pc["unit_nums"]) - 1:
                norm(f"{base}.layernorm_{j}", widths[j + 1])
    return spec


def encode_voxels(P: Params, cfg: dict, vox: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(B, 1, D, H, W) occupancy -> the flat encoder output (B, 2 z)."""
    enc = cfg["encoder3d"]
    stages, _ = _encoder_stages(enc)
    x = space_to_depth(vox.float(), 4)
    for i, (_, k, s) in enumerate(stages):
        w = P[f"encoder3d.convblock3d_{i}.conv_0.weight"]
        x = conv_k2(x, w, precision) if (k, s) == (2, 1) else conv(x, w, s, precision)
        x = gn_elu(x, P, f"encoder3d.convblock3d_{i}.groupnorm_0")
    x = conv(x, P["encoder3d.conv_0.weight"], enc["strides"][-1], precision)
    return x.mean(dim=(2, 3, 4))


def maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(F.pad(x, _pad_list(x, 2, 2), value=float("-inf")), 2, 2)


def encode_images(P: Params, cfg: dict, images: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> the flat encoder output."""
    x = images.float().permute(0, 3, 1, 2)
    i = 0
    for item in DARKNET19:
        if item == "M":
            x = maxpool(x)
            continue
        x = conv(x, P[f"backbone.convblock2d_{i}.conv_0.weight"], 1, precision)
        x = gn_elu(x, P, f"backbone.convblock2d_{i}.groupnorm_0")
        i += 1
    x = conv(x, P["head.conv_0.weight"], 1, precision)
    return x.amax(dim=(2, 3))


def split_posterior(cfg: dict, out: torch.Tensor):
    """(mean_cat, lv_cat, mean_inst, lv_inst) of the flat encoder output; a
    one-block latent gives its block as the category one and empty instance ones."""
    clip = cfg["log_var_clip"]
    zc, zi = cfg["z_category_dim"], cfg["z_inst_dim"]
    if zc and zi:
        return (out[:, :zc], out[:, zc:2 * zc].clamp(-clip, clip), out[:, 2 * zc:2 * zc + zi],
                out[:, 2 * zc + zi:].clamp(-clip, clip))
    z = zc + zi
    return out[:, :z], out[:, z:].clamp(-clip, clip), None, None


def decode_logits(P: Params, cfg: dict, z: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(B, z) -> the decoder's pre-sigmoid output in the blocked layout,
    (B, 64 C, D/4, H/4, W/4), channels (bd, bh, bw, c)."""
    dec = cfg["decoder"]
    spatial, channels = _decoder_geometry(dec)
    x = linear(z.float(), P["decoder.denseblock_0.dense_0.weight"], P["decoder.denseblock_0.dense_0.bias"], precision)
    x = F.elu(F.layer_norm(x, x.shape[-1:], P["decoder.denseblock_0.layernorm_0.weight"],
                           P["decoder.denseblock_0.layernorm_0.bias"], eps=1e-6))
    x = x.reshape(-1, spatial, spatial, spatial, channels).permute(0, 4, 1, 2, 3)
    for i, s in enumerate(dec["strides"][:-2]):
        x = conv_transpose(x, P[f"decoder.deconvblock3d_{i}.convtranspose_0.weight"], s, precision)
        x = gn_elu(x, P, f"decoder.deconvblock3d_{i}.groupnorm_0")
    x = gn_elu(conv_k2(x, P["decoder.conv_0.weight"], precision), P, "decoder.groupnorm_0")
    return conv_k2(x, P["decoder.conv_1.weight"], precision)


def prior(P: Params, cfg: dict, name: str, onehot: torch.Tensor, keep: Optional[list] = None,
          precision: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, log_var) of prior net ``name``; ``keep`` holds one dropout keep
    mask a hidden layer (train mode), None for eval mode."""
    pc = cfg[name]
    depth = len(pc["unit_nums"])
    base = f"{name}.mean_tower"
    x = 2.0 * onehot.float() - 1.0
    for j in range(depth - 1):
        x = linear(x, P[f"{base}.dense_{j}.weight"], P[f"{base}.dense_{j}.bias"], precision)
        x = F.layer_norm(x, x.shape[-1:], P[f"{base}.layernorm_{j}.weight"], P[f"{base}.layernorm_{j}.bias"],
                         eps=1e-6)
        if keep is not None and pc["dropout_rate"] > 0.0:
            x = torch.where(keep[j], x / (1.0 - pc["dropout_rate"]), torch.zeros_like(x))
        x = F.elu(x)
    mean = linear(x, P[f"{base}.dense_{depth - 1}.weight"], P[f"{base}.dense_{depth - 1}.bias"], precision)
    return mean, torch.full_like(mean, float(pc["const_log_var"]))


def dropout_keeps(cfg: dict, batch: int, generator: torch.Generator, device) -> Dict[str, list]:
    """The prior nets' dropout keep masks of one train step, drawn from
    ``generator`` in the order the prior nets draw them: the category
    prior's hidden layers, then the instance prior's, one U[0, 1) draw of
    (batch, width) each."""
    out = {}
    for name in ("prior_category", "prior_inst"):
        pc = cfg.get(name)
        if not pc:
            continue
        out[name] = [torch.rand((batch, w), generator=generator, device=device) >= pc["dropout_rate"]
                     for w in pc["unit_nums"][:-1]]
    return out
