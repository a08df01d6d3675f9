"""2x2x2 stride-1 SAME 3-D convolution (no bias): the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of ``anytime3d_tpu/kernels/conv_k2.py``. The four heaviest
convolutions of the flagship model (the blocked encoder head and decoder
tail at 16^3) are this operation. ``csrc/conv_k2.cu`` says how the kernels
are formed and what bounds them. There are three designs: bfloat16 operands
whose shape has a plan (:func:`wgmma_plan`) take the tensor-core kernels of
``csrc/conv_k2_wgmma.cuh`` in the forward, in dx and in dw (the forward and dx
split their depth over blocks where their tiles leave the card idle, and a
reduce adds the splits; on grids of at most 8^3 an item dw runs on persistent
blocks whose stores overlap their products); else operands of
a narrow output (N = 8, 16 or 32) whose shape has a narrow plan
(:func:`narrow_plan`) take the halo-box kernels of ``csrc/conv_k2_narrow.cuh``
in the forward, dw and dx (dx where the forward from N to C channels has a
plan): on ``mma.sync`` in bfloat16, on FFMA in float32; where C is a
multiple of 64 above 64 (bfloat16: the tensor-parallel shard 512 -> 32) the
plan walks C in chunks of 64 (:func:`chunked_plan`), the forward on its own
kernel, dw by blocks of one chunk each; where a float32 C is a multiple of 32
above 32 (that shard in float32) the forward alone walks it in chunks of 16;
the bfloat16 dx of a narrow g and a wide dx (that shard's) takes the chunked
dx on the tensor cores (:func:`chunked_dx_plan`,
``csrc/conv_k2_chunked_dx.cuh``: halo boxes of g, a column chunk of w a
block); the bfloat16 forward of a narrow input and a wide output (the
s2d(2) stem's 8 -> 64) takes that kernel run forward (:func:`wide_plan`: the
halo box of x at the box, the taps unmirrored); a bfloat16 dw of a narrow
input and N = 64 (the s2d(2) stem's) whose shape has a dw-only plan
(:func:`narrow_dw_plan`) takes the halo-box dw on ``mma.sync``; the rest take
the FFMA kernels (in float32 the forward and dx split their depth where
:func:`ffma_split` says so; dw takes a tile fitted to a narrow side where N <=
32 or 8C <= 64, :func:`ffma_dw_fitted`). The choice is made from shape and
dtype before the launch, never by catching a failure.

The forward, dx and dw are the custom operators ``anytime3d_torch::conv_k2``,
``::conv_k2_dx`` and ``::conv_k2_dw`` (``torch.library``): a CUDA
implementation that launches the kernels, a CPU one that is the plain
version, a fake one that gives the output's shape and dtype and touches no
data (so ``torch.export`` traces through the forward, and an exported program
calls the op), and the forward's backward, which calls the dx and dw ops.
Importing this module registers them; a process that loads an exported
program must import it first. The launch counts are kept in the CUDA
implementations, so an exported program counts its launches too.

Layouts are the JAX package's: ``x`` is NDHWC ``(B, D, H, W, C)``, ``w`` is
``(2, 2, 2, C, N)``, the result is ``(B, D, H, W, N)`` in ``x``'s dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from anytime3d_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = [(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def conv_k2_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on ``x`` padded (0, 1) on every spatial axis."""
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1) * 3)
    y = F.conv3d(xc, w.to(x.dtype).permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv_k2_dx_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain dx, as the JAX package's ``_conv_k2_bwd_impl`` writes it: the k=2
    conv of ``g`` padded (1, 0) with ``w`` reversed and each tap transposed."""
    gc = F.pad(g.permute(0, 4, 1, 2, 3), (1, 0) * 3)
    # F.conv3d wants (out=C, in=N, kd, kh, kw) of the reversed kernel
    dx = F.conv3d(gc, w.to(g.dtype).flip(0, 1, 2).permute(3, 4, 0, 1, 2))
    return dx.permute(0, 2, 3, 4, 1).contiguous()


def _dw_dtype(dtype: torch.dtype) -> torch.dtype:
    """dw's dtype: float32, or float64 for float64 operands."""
    return torch.promote_types(dtype, torch.float32)


def conv_k2_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain dw (float32; float64 for float64 operands), as
    ``_conv_k2_bwd_impl`` writes it: 8 shifted contractions of ``x`` padded
    (0, 1) with ``g``, summed in float32."""
    _, D, H, W, _ = x.shape
    dtype = _dw_dtype(x.dtype)
    xp = F.pad(x, (0, 0) + (0, 1) * 3).to(dtype)
    gf = g.to(dtype)
    dw = torch.stack([
        torch.einsum("bdhwc,bdhwn->cn", xp[:, dz:dz + D, dy:dy + H, dx:dx + W], gf) for dz, dy, dx in _TAPS
    ])
    return dw.reshape(2, 2, 2, *dw.shape[1:])


def conv_k2_backward_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the gradient: ``(dx, dw)``, dx in ``x``'s dtype, dw in float32."""
    g = g.to(x.dtype)
    return conv_k2_dx_reference(g, w), conv_k2_dw_reference(x, g)


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("conv_k2"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/conv_k2.cu``, with the argument and result
    types of its entry points set."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv_k2_forward.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
    lib.conv_k2_backward_input.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
    lib.conv_k2_backward_weight.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
    lib.conv_k2_forward_wgmma.argtypes = [ptr] * 4 + [i32] * 19 + [ptr]
    lib.conv_k2_backward_input_wgmma.argtypes = [ptr] * 4 + [i32] * 19 + [ptr]
    lib.conv_k2_backward_weight_wgmma.argtypes = [ptr] * 4 + [i32] * 16 + [ptr]
    lib.conv_k2_backward_weight_persistent.argtypes = [ptr] * 4 + [i32] * 18 + [ptr]
    lib.conv_k2_forward_narrow.argtypes = [ptr] * 3 + [i32] * 14 + [ptr]
    lib.conv_k2_backward_input_narrow.argtypes = [ptr] * 3 + [i32] * 14 + [ptr]
    lib.conv_k2_backward_weight_narrow.argtypes = [ptr] * 4 + [i32] * 15 + [ptr]
    lib.conv_k2_forward_chunked.argtypes = [ptr] * 3 + [i32] * 13 + [ptr]
    lib.conv_k2_backward_input_chunked.argtypes = [ptr] * 3 + [i32] * 14 + [ptr]
    lib.conv_k2_forward_wide.argtypes = [ptr] * 3 + [i32] * 14 + [ptr]
    # the lowered stride-2 k=4 conv (kernels/conv_k4s2.py)
    lib.conv_k4s2_forward_wgmma.argtypes = [ptr] * 4 + [i32] * 19 + [ptr]
    lib.conv_k4s2_backward_input_wgmma.argtypes = [ptr] * 3 + [i32] * 17 + [ptr]
    lib.conv_k4s2_backward_weight_wgmma.argtypes = [ptr] * 4 + [i32] * 16 + [ptr]
    lib.conv_k4s2_backward_weight_persistent.argtypes = [ptr] * 4 + [i32] * 18 + [ptr]
    for fn in (lib.conv_k2_forward, lib.conv_k2_backward_input, lib.conv_k2_backward_weight,
               lib.conv_k2_forward_wgmma, lib.conv_k2_backward_input_wgmma, lib.conv_k2_backward_weight_wgmma,
               lib.conv_k2_backward_weight_persistent, lib.conv_k2_forward_narrow, lib.conv_k2_backward_input_narrow,
               lib.conv_k2_backward_weight_narrow, lib.conv_k2_forward_chunked, lib.conv_k2_backward_input_chunked,
               lib.conv_k2_forward_wide, lib.conv_k4s2_forward_wgmma, lib.conv_k4s2_backward_input_wgmma,
               lib.conv_k4s2_backward_weight_wgmma, lib.conv_k4s2_backward_weight_persistent):
        fn.restype = i32
    lib.conv_k2_error_string.argtypes = [i32]
    lib.conv_k2_error_string.restype = ctypes.c_char_p
    return lib


# The tensor-core kernels' tiling (csrc/conv_k2_wgmma.cuh): 128 or 256 output
# rows a block, 64 deep a stage, tiles of 64 x 64 bf16 (8 KB) in shared memory.
_WG_ROWS = 128
_WG_DEPTH = 64
_WG_TILE_BYTES = 64 * 64 * 2
_WG_SMEM_MAX = 232_448  # what one block may have on an H100
_WG_DW_MIN_STAGES = 16  # a split of dw's row reduction, or of the forward's depth, is at least this deep
_WG_SPLIT_MAX_VOXELS = 8**3  # the forward's depth splits only on grids of at most 8^3 an item (the mid_blocked stages)
_DW_PERSISTENT_MAX_VOXELS = 4**3  # dw takes the persistent kernel only on grids of at most 4^3 an item
_DW_PERSISTENT_BN = 256  # its tiles' columns (csrc's DW_PERSISTENT_BN)
_DW_STORE_BUFS = 2  # the persistent dw's chunk buffers (16 rows x 128 bytes) a consumer warp, csrc's DW_STORE_BUFS


@dataclasses.dataclass(frozen=True)
class PersistentDwPlan:
    """How the persistent tensor-core dw (``conv_k2_dw_persistent_kernel``) cuts
    one shape: output tiles of 128 rows (tap, c) by ``bn`` = 256 columns,
    ``tiles`` of them; the M/64 stages of the row reduction
    in ``splits`` runs of ``stages_per_split`` (the last may be shorter; more
    than one only where the tiles fill at most half the SMs, then as many as
    fill them, each at least 16 stages deep); ``grid`` blocks, one an SM, walk
    the ``tiles`` x ``splits`` work items (split fastest, then row tiles, then
    column tiles), block i taking items i, i + grid, ...; a ring of ``stages``
    slots and the store's chunk buffers in ``smem_bytes``, which the launcher
    holds to its own arithmetic, as it does ``tiles``. The stage boxes are the
    plan's ``dw_box`` by ``dw_box_items``."""

    bn: int
    stages: int
    smem_bytes: int
    tiles: int
    splits: int
    stages_per_split: int
    grid: int


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """How the tensor-core kernels cut one bfloat16 ``conv_k2`` shape.

    Forward: an output tile is ``bm`` rows (128 or 256) by ``bn`` columns (64
    or 128); ``box`` is the (w, h, d) extents of the TMA box of ``x`` that
    holds a tile's rows, 64 channels (128 bytes) wide, and ``box_items`` its
    extent in the batch: 1 where the box lies inside one batch item, else the
    number of whole items it spans (a grid of fewer rows than the box, such
    as 4^3; ``box`` is then the whole grid and each tap's shift stays inside
    each item, the TMA filling zeros per axis).
    The ring has ``stages`` slots and the block ``smem_bytes`` of dynamic
    shared memory (ring, alignment room, barriers), which the launcher holds
    to its own arithmetic, as it does ``tiles``. The depth's 8C/64 stages are
    cut into ``splits`` runs of ``stages_per_split`` (the last may be shorter;
    one split of all stages unless the grid has at most 8^3 voxels an item
    and the tiles fill at most half a wave of blocks: then as many as fill one
    wave, each at least 16 stages deep). The ``tiles`` x ``splits`` work items
    (tile, split), column tiles fastest, then splits, are walked by ``grid``
    blocks, block i taking items i, i + grid, ...; with splits > 1 each item's
    f32 partial goes to a workspace, which the launcher's reduce adds into the
    output.

    dx has no fields of its own: it is cut by the plan of the forward from N
    to C channels, ``wgmma_plan(B, D, H, W, N, C)``, whose tiles are ``bm``
    rows by ``bn`` columns of dx and whose box holds those rows of ``g``.

    dw: an output tile is 128 rows of (tap, c) by ``bn`` columns and a stage
    64 rows m, whose box is ``dw_box`` by ``dw_box_items``; the ring has ``dw_stages`` slots in
    ``dw_smem_bytes``. ``dw_grid`` is (column tiles, row tiles, splits); a
    split reduces ``dw_stages_per_split`` stages, the last one the rest. Where
    ``dw_persistent`` is set (grids of at most 4^3 an item and N % 256 == 0:
    the mid_blocked stages at 4^3, whose reductions are short and outputs large) dw
    takes the persistent kernel on that plan instead, over the same stage
    boxes; the grid kernel's fields stay, to launch it for comparison.
    """

    bm: int
    bn: int
    box: tuple[int, int, int]
    stages: int
    smem_bytes: int
    tiles: int
    grid: int
    dw_box: tuple[int, int, int]
    dw_stages: int
    dw_smem_bytes: int
    dw_grid: tuple[int, int, int]
    dw_stages_per_split: int
    splits: int
    stages_per_split: int
    box_items: int = 1
    dw_box_items: int = 1
    dw_persistent: PersistentDwPlan | None = None


def _row_box(rows: int, B: int, D: int, H: int, W: int) -> tuple[int, int, int, int] | None:
    """(w, h, d, b) extents of a box of ``rows`` consecutive rows such that
    consecutive boxes tile the (B, D, H, W) grid, or None: whole w-lines
    before a second h, whole (h, w) planes before a second d, and whole batch
    items before a second b (a box spans items only where an item has fewer
    rows than the box, and then a whole number of them)."""
    extents = []
    whole = True  # every faster axis is covered whole
    for size in (W, H, D, B):
        take = min(size, rows) if whole else 1
        if rows % take or size % take:
            return None
        extents.append(take)
        rows //= take
        whole = whole and take == size
    return tuple(extents) if rows == 1 else None


def _ring(a_tiles: int, bn: int, blocks_per_sm: int) -> tuple[int, int]:
    """(stages, dynamic shared memory) of a ring whose stage holds ``a_tiles``
    tiles of A and bn/64 of B, for ``blocks_per_sm`` blocks on an SM: 96 KB of
    stages a block where two share an SM, 192 KB where one has it."""
    stage_bytes = (a_tiles + bn // 64) * _WG_TILE_BYTES
    stages = (192 * 1024 // blocks_per_sm) // stage_bytes
    smem_bytes = 1024 + stages * stage_bytes + 2 * 8 * 8
    assert 3 <= stages <= 8 and blocks_per_sm * smem_bytes <= _WG_SMEM_MAX
    return stages, smem_bytes


def persistent_dw_ring(store_bufs: int = _DW_STORE_BUFS) -> tuple[int, int]:
    """(stages, dynamic shared memory) of the persistent dw with ``store_bufs``
    chunk buffers a consumer warp: as many stages of 48 KB as fit beside them,
    the barriers' swizzle period and the room to align the ring."""
    stage_bytes, staging = (2 + _DW_PERSISTENT_BN // 64) * _WG_TILE_BYTES, 8 * store_bufs * 16 * 128
    stages = min(8, (_WG_SMEM_MAX - 2 * 1024 - staging) // stage_bytes)
    return stages, 2 * 1024 + stages * stage_bytes + staging


def _persistent_dw(B: int, D: int, H: int, W: int, C: int, N: int, sms: int,
                   anywhere: bool = False) -> PersistentDwPlan | None:
    """The persistent dw's plan on grids of at most 4^3 voxels an item (or,
    ``anywhere``, on any grid) with N a multiple of 256 (the mid_blocked
    stages at 4^3: 8 to 32 stages of 64 rows a tile, 33.5 MB of f32 output),
    or None: every other shape keeps the grid kernel (the flagship's 16^3 dw
    and the mid_blocked 8^3 stages among them)."""
    bn = _DW_PERSISTENT_BN
    if N % bn or (D * H * W > _DW_PERSISTENT_MAX_VOXELS and not anywhere):
        return None
    stages, smem_bytes = persistent_dw_ring()
    assert 3 <= stages and smem_bytes <= _WG_SMEM_MAX
    tiles, total = (8 * C // _WG_ROWS) * (N // bn), B * D * H * W // _WG_DEPTH
    # as many splits as fill the SMs where the tiles fill at most half of them, each at least 16 stages deep
    splits = 1
    if 2 * tiles <= sms:
        splits = max(1, min(sms // tiles, total // _WG_DW_MIN_STAGES))
    per_split = -(-total // splits)
    splits = -(-total // per_split)
    return PersistentDwPlan(bn=bn, stages=stages, smem_bytes=smem_bytes, tiles=tiles, splits=splits,
                            stages_per_split=per_split, grid=min(tiles * splits, sms))


@functools.lru_cache(maxsize=256)  # a model asks for the same few shapes at every step
def wgmma_plan(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132,
               bm: int | None = None, split: bool = True, persistent_dw: bool | None = None) -> WgmmaPlan | None:
    """The tensor-core kernels' plan for bfloat16 ``x`` (B,D,H,W,C) and ``w``
    (2,2,2,C,N), or None where they do not apply: C and N multiples of 64 and
    a grid whose rows tile into boxes of 128 and of 64 (16^3, 8^3, 32^3, ...;
    at 4^3, boxes of whole items, so B even). Pure arithmetic; ``sms`` is
    the card's count of multiprocessors; ``bm`` forces the forward's tile rows
    (128 or 256) where the grid allows them, ``split=False`` the plan
    without the depth split (the one before it), ``persistent_dw=False`` dw
    on the grid kernel and ``persistent_dw=True`` dw on the persistent kernel
    on any grid where N allows it, to measure one against the other."""
    if min(B, D, H, W, C, N) < 1 or C % _WG_DEPTH or N % 64 or B * D * H * W >= 2**31:
        return None
    box, dw_box = _row_box(_WG_ROWS, B, D, H, W), _row_box(_WG_DEPTH, B, D, H, W)
    if box is None or dw_box is None:
        return None
    rows = B * D * H * W
    bn = 128 if N % 128 == 0 else 64
    # forward: tiles of 256 rows (one block an SM, the B tile fetched half as often) where the rows
    # tile so and a tile is at least 16 stages deep: its store then hides without a second block. Where
    # a box spans batch items (a small grid such as 4^3) only if those tiles still fill 7/8 of the SMs,
    # or if 128-row tiles would fill at most half a wave and split their depth (below): unsplit, 128-row
    # tiles won on an H100, the kernels alone (PERF.md section 6: 0.097 against 0.153 ms at B=32, 2048 ->
    # 512, 32 tiles of 256 rows; 256 rows 0.049 against 0.062 at 512 -> 2048, 128 tiles); split, 256 rows
    # won at every such shape (0.0551 against 0.0665 ms at B=32, 2048 -> 512; 0.0270 against 0.0288 at B=8)
    depth = 8 * C // _WG_DEPTH
    split = split and D * H * W <= _WG_SPLIT_MAX_VOXELS
    fills = 8 * (rows // 256) * (N // bn) >= 7 * sms
    splits_128 = split and rows // _WG_ROWS * (N // bn) <= sms and depth >= 2 * _WG_DW_MIN_STAGES
    want_256 = (C >= 128 and (box[3] == 1 or fills or splits_128)) if bm is None else bm == 256
    box_256 = _row_box(256, B, D, H, W) if want_256 else None
    if bm == 256 and box_256 is None:
        return None
    bm, box = (_WG_ROWS, box) if box_256 is None else (256, box_256)
    blocks_per_sm = 2 if bm == _WG_ROWS else 1
    stages, smem_bytes = _ring(2 * bm // _WG_ROWS, bn, blocks_per_sm)
    fwd_tiles = (rows // bm) * (N // bn)
    # the forward's depth split where its tiles fill at most half a wave (the 4^3 stages at B=8: 8 tiles of 256
    # rows on 132 SMs), as many splits as fill one wave, each at least 16 stages deep; else one split, the walk
    # over tiles alone. Only on grids of at most 8^3 an item, where it was measured: the 16^3 convs keep their
    # path at every batch
    fwd_splits = 1
    if split and 2 * fwd_tiles <= blocks_per_sm * sms:
        fwd_splits = max(1, min(blocks_per_sm * sms // fwd_tiles, depth // _WG_DW_MIN_STAGES))
    fwd_per_split = -(-depth // fwd_splits)
    fwd_splits = -(-depth // fwd_per_split)
    # dw: one wave of blocks, two an SM, each split a whole number of stages
    dw_stages, dw_smem_bytes = _ring(2, bn, 2)
    total = rows // _WG_DEPTH
    tiles = (8 * C // _WG_ROWS) * (N // bn)
    splits = max(1, min(2 * sms // tiles, total // _WG_DW_MIN_STAGES))
    per_split = -(-total // splits)
    splits = -(-total // per_split)
    return WgmmaPlan(bm=bm, bn=bn, box=box[:3], stages=stages, smem_bytes=smem_bytes, tiles=fwd_tiles,
                     grid=min(fwd_tiles * fwd_splits, blocks_per_sm * sms), dw_box=dw_box[:3], dw_stages=dw_stages,
                     dw_smem_bytes=dw_smem_bytes, dw_grid=(N // bn, 8 * C // _WG_ROWS, splits),
                     dw_stages_per_split=per_split, splits=fwd_splits, stages_per_split=fwd_per_split,
                     box_items=box[3], dw_box_items=dw_box[3],
                     dw_persistent=None if persistent_dw is False else _persistent_dw(B, D, H, W, C, N, sms,
                                                                                        bool(persistent_dw)))


# The narrow kernels' tiling (csrc/conv_k2_narrow.cuh): a box of at most 1024
# output rows a block, each extent at most 255 (its halo's one more, within the
# TMA's 256); stages aligned to 1024 bytes; one block an SM.
_NR_ROWS = 1024
_NR_EXTENT = 255
_NR_ALIGN = 1024
_NR_CHANNELS = (8, 16, 32, 64)  # C: one TMA box of all channels
_NR_ROW_BYTES = 128  # a voxel's channels in at most 128 bytes (float32: C <= 32)
_NR_OUTPUTS = (8, 16, 32)  # N: 1, 2 or 4 mma n8 tiles
_NR_DW_WIDE = 64  # N of the bfloat16 dw-only plan: 8 n8 tiles, in units of 4, one unit a warp
_NR_DW_ACCUMULATORS = 4096  # 8C x N of that dw: the 8 warps' units of 16 x 32 (so C = 8)
_NR_ESIZE = {torch.bfloat16: 2, torch.float32: 4}
_NR_CHUNK = 256  # rows of the float32 forward's output chunk: one a thread
_NR_C_CHUNK = 64  # channels of a chunk where a bfloat16 walk takes C in chunks (csrc's chunked kernels)
_NR_C_CHUNK_F32 = 16  # and where a float32 forward does


def _c_chunk(C: int, esize: int) -> int | None:
    """The channels of a chunk where the narrow walk takes C in chunks: a bfloat16 C that is a multiple of 64
    above 64 in chunks of 64 (128-byte rows, as C = 64's); a float32 C that is a multiple of 32 above 32 in
    chunks of 16 (64-byte rows: a 1024-row box's halo of 128-byte rows would leave room for one stage of the
    two). Else None: C is one box's."""
    if esize == 2 and C > _NR_C_CHUNK and C % _NR_C_CHUNK == 0:
        return _NR_C_CHUNK
    if esize == 4 and C > 32 and C % 32 == 0:
        return _NR_C_CHUNK_F32
    return None


def _chunked_rows(N: int, esize: int) -> int:
    """The chunked forward's largest box, whose accumulators stay in registers across the chunks: in
    bfloat16 8 warps of ``nr::chunked_mw`` m-tiles (2 at N = 32, 4 at N = 8 and 16); in float32 the
    kernel's 4 rows a thread, 1024."""
    return 16 * 8 * (4 if N == 8 else 64 // N) if esize == 2 else _NR_ROWS


@dataclasses.dataclass(frozen=True)
class NarrowPlan:
    """How the narrow kernels cut one ``conv_k2`` shape.

    Forward: a block computes boxes of ``box`` (w, h, d) output voxels of one
    batch item, reading each box grown by one voxel along w, h and d (its halo)
    in one TMA copy; the grid's ``boxes`` (w fastest, the last along each axis
    ragged) are walked by ``grid`` blocks, block i taking boxes i, i + grid,
    .... ``smem_bytes`` is its dynamic shared memory (two stages of the halo,
    w, the row table, barriers; in float32 the output chunks or the partial
    sums), which the launcher holds to its own arithmetic. ``chunk_d``: the
    d-planes of the box in each 256-row output chunk that the float32 kernel
    stores through shared memory and the TMA, or 0 where it stores from
    registers (:func:`_narrow_chunk_d`). dx is cut by the forward plan of the
    shape as a forward from N to C channels, ``narrow_plan(B, D, H, W, N, C,
    dtype=...)``.

    dw: boxes of ``dw_box``, ``dw_boxes`` of them, each a halo box of x and a
    box of g, walked through ``dw_stages`` copies a block
    (:func:`_narrow_stages`); ``dw_splits`` blocks reduce runs of
    ``dw_boxes_per_split`` consecutive boxes (the last may be shorter, none is
    empty) in ``dw_smem_bytes`` (float32: with the block's [8C, N] sum of its
    groups' tiles).

    ``c_chunks``: where the walk takes C in chunks (:func:`chunked_plan`: of
    64 in bfloat16, of 16 in float32), C over the chunk, else 1. The forward
    then walks (box, chunk) steps through two stages, each a chunk's halo box
    and its w; dw's blocks are (split, chunk), each a chunk's rows of its
    split's partial. A float32 plan that walks C in chunks is the forward's
    alone: its dw fields are None (that dw keeps the FFMA kernel).
    """

    box: tuple[int, int, int]
    boxes: int
    grid: int
    smem_bytes: int
    chunk_d: int
    dw_box: tuple[int, int, int] | None = None
    dw_boxes: int | None = None
    dw_splits: int | None = None
    dw_boxes_per_split: int | None = None
    dw_smem_bytes: int | None = None
    dw_stages: int | None = None
    c_chunks: int = 1


@dataclasses.dataclass(frozen=True)
class NarrowDwPlan:
    """The dw part of a :class:`NarrowPlan` alone (its fields, their meaning):
    the plan of :func:`narrow_dw_plan`, a bfloat16 dw whose forward and dx keep
    their routes."""

    dw_box: tuple[int, int, int]
    dw_boxes: int
    dw_splits: int
    dw_boxes_per_split: int
    dw_smem_bytes: int
    dw_stages: int
    c_chunks: int = 1


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _narrow_stages(dw: bool, esize: int) -> int:
    """Copies of the operands a block holds: three for the float32 dw, two
    for the rest."""
    return 3 if dw and esize == 4 else 2


def _narrow_chunk_d(box: tuple[int, int, int], dw: bool, esize: int) -> int:
    """The d-planes of ``box`` in each 256-row output chunk of the float32
    forward, which stores through two chunk buffers and the TMA where the box
    does not split its taps (more than 512 rows) and is whole chunks of whole
    d-planes; else 0, each row stored from registers."""
    bw, bh, bd = box
    rows = bw * bh * bd
    if dw or esize != 4 or rows <= _NR_ROWS // 2 or rows % _NR_CHUNK or _NR_CHUNK % (bw * bh):
        return 0
    return _NR_CHUNK // (bw * bh)


def _narrow_smem(box: tuple[int, int, int], C: int, N: int, dw: bool, esize: int, stages: int, chunk_d: int,
                 chunked: bool = False) -> int:
    """Dynamic shared memory of a narrow launch (``nr::smem_bytes``) with
    elements of ``esize`` bytes: alignment room, ``stages`` stages (the halo
    box of x; for dw also the box of g, its rows rounded up to 16; for the
    ``chunked`` forward, C a chunk's channels, also the chunk's w, 8C x N),
    the forward's w (8C x N, but in the chunked forward's stages) and table of
    output rows, the table of halo rows, a barrier a stage (in a multiple of
    16 bytes); the float32 forward's two
    chunk buffers of 256 rows (4N bytes each) where ``chunk_d`` is set; and
    the float32 kernels' partial sums: where the forward splits the taps over
    two halves of the block (a box of at most 512 rows; not the chunked
    forward), the second half's (rows x N); dw's sum of its groups' tiles (8C
    x N)."""
    bw, bh, bd = box
    rows = bw * bh * bd
    rows16 = _round_up(rows, 16)
    stage = _round_up((bw + 1) * (bh + 1) * (bd + 1) * esize * C, _NR_ALIGN)
    if dw:
        stage += _round_up(rows16 * esize * N, _NR_ALIGN)
    elif chunked:
        stage += 8 * C * N * esize
    sums = 0
    if esize == 4:
        sums = 32 * C * N if dw else 4 * rows * N if rows <= _NR_ROWS // 2 and not chunked else 0
    chunks = 2 * _round_up(_NR_CHUNK * 4 * N, _NR_ALIGN) if chunk_d else 0
    w_bytes = 0 if dw or chunked else 8 * C * N * esize
    return (_NR_ALIGN + stages * stage + chunks + w_bytes + (0 if dw else 4 * rows16) + 4 * rows16
            + _round_up(8 * stages, 16) + sums)


def _narrow_box(D: int, H: int, W: int, C: int, N: int, dw: bool, esize: int = 2,
                chunked: bool = False) -> tuple[int, int, int] | None:
    """The (w, h, d) extents of the box that reads the fewest halo voxels a
    row (ties: more rows), among boxes of at most 1024 rows whose extents are
    at most 255 and the grid's, w a multiple of 16 (an m-tile's 16 rows on
    one line) or all of W, h and d powers of two or all of H and D, whose
    launch fits one block's shared memory; or None. The ``chunked`` forward
    (C a chunk's channels) also holds a box's accumulators in registers
    (at most :func:`_chunked_rows` rows), stores its rows from registers and
    reads the chunk's w once a box: it takes the box of the fewest L2 bytes a
    row, its halo's and its share of w's."""
    def extents(size: int, step: int) -> list[int]:
        top = min(size, _NR_EXTENT)
        out = {size} if size <= _NR_EXTENT else set()
        out |= set(range(step, top + 1, step)) if step > 1 else {1 << i for i in range(top.bit_length())}
        return sorted(out)

    w_bytes = 8 * C * N * esize if chunked and not dw else 0
    best, best_key = None, None
    for bd in extents(D, 1):
        for bh in extents(H, 1):
            for bw in extents(W, 16):
                rows = bw * bh * bd
                if rows > _NR_ROWS or (w_bytes and _round_up(rows, 16) > _chunked_rows(N, esize)):
                    continue
                chunk_d = 0 if w_bytes else _narrow_chunk_d((bw, bh, bd), dw, esize)
                smem = _narrow_smem((bw, bh, bd), C, N, dw, esize, _narrow_stages(dw, esize), chunk_d, chunked)
                if smem > _WG_SMEM_MAX:
                    continue
                halo = (bw + 1) * (bh + 1) * (bd + 1)
                key = ((halo * esize * C + w_bytes) / rows if w_bytes else halo / rows, -rows)
                if best_key is None or key < best_key:
                    best, best_key = (bw, bh, bd), key
    return best


def _boxes(B: int, D: int, H: int, W: int, box: tuple[int, int, int]) -> int:
    bw, bh, bd = box
    return B * -(-D // bd) * -(-H // bh) * -(-W // bw)


@functools.lru_cache(maxsize=256)  # a model asks for the same few shapes at every step
def narrow_plan(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132,
                dtype: torch.dtype = torch.bfloat16) -> NarrowPlan | None:
    """The narrow kernels' plan for ``x`` (B,D,H,W,C) of ``dtype`` (bfloat16
    or float32) and ``w`` (2,2,2,C,N), or None where they do not apply: N of
    8, 16 or 32, C of 8, 16, 32 or 64 (a multiple of 8, one TMA box of all
    channels in rows of at most 128 bytes, so float32 C <= 32; at most 4 m16
    tiles of dw's accumulators a warp), or a C walked in chunks
    (:func:`chunked_plan`: a bfloat16 C that is a multiple of 64 above 64, a
    float32 C that is a multiple of 32 above 32, the latter the forward's
    alone), and never where :func:`wgmma_plan` applies. Pure arithmetic;
    ``sms`` is the card's count of multiprocessors."""
    esize = _NR_ESIZE.get(dtype)
    if (esize is None or N not in _NR_OUTPUTS or min(B, D, H, W) < 1 or B * D * H * W >= 2**31
            or wgmma_plan(B, D, H, W, C, N, sms=sms) is not None):
        return None
    if _c_chunk(C, esize) is not None:
        return chunked_plan(B, D, H, W, C, N, sms=sms, dtype=dtype)
    if C not in _NR_CHANNELS or esize * C > _NR_ROW_BYTES:
        return None
    box, dw = _narrow_box(D, H, W, C, N, False, esize), _narrow_dw(B, D, H, W, C, N, sms, esize)
    if box is None or dw is None:
        return None
    boxes, chunk_d = _boxes(B, D, H, W, box), _narrow_chunk_d(box, False, esize)
    return NarrowPlan(box=box, boxes=boxes, grid=min(boxes, sms),
                      smem_bytes=_narrow_smem(box, C, N, False, esize, 2, chunk_d), chunk_d=chunk_d,
                      **dataclasses.asdict(dw))


@functools.lru_cache(maxsize=256)
def chunked_plan(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132,
                 dtype: torch.dtype = torch.bfloat16) -> NarrowPlan | None:
    """The narrow plan of ``x`` (B,D,H,W,C) and ``w`` (2,2,2,C,N), N of 8, 16
    or 32, whose C the walk takes in ``c_chunks`` chunks (:func:`_c_chunk`):
    a bfloat16 C that is a multiple of 64 above 64 in chunks of 64 (128-byte
    rows, as C = 64's), a float32 C that is a multiple of 32 above 32 in
    chunks of 16 (64-byte rows); or None. The forward's box reads the fewest
    L2 bytes a row (its halo and its share of the chunk's w, read once a box)
    among those whose accumulators fit the warps' registers (bfloat16: at
    most 256 rows at N = 32, 512 at N = 8 and 16; float32: 1024, 4 rows a
    thread) and whose two stages of halo and w fit one block. bfloat16 also
    has a dw part: dw's box, as C = 64's, with a third stage where that box
    has room for one, and (split, chunk) blocks that make one wave on ``sms``
    multiprocessors, each split a run of whole boxes. A float32 plan has none
    (its dw keeps the FFMA kernel, as its dx). Pure arithmetic."""
    esize = _NR_ESIZE.get(dtype)
    chunk = None if esize is None else _c_chunk(C, esize)
    if chunk is None or N not in _NR_OUTPUTS or min(B, D, H, W) < 1 or B * D * H * W >= 2**31:
        return None
    box = _narrow_box(D, H, W, chunk, N, False, esize, True)
    if box is None:
        return None
    chunks, boxes = C // chunk, _boxes(B, D, H, W, box)
    forward = dict(box=box, boxes=boxes, grid=min(boxes, sms), chunk_d=0, c_chunks=chunks,
                   smem_bytes=_narrow_smem(box, chunk, N, False, esize, 2, 0, True))
    if esize == 4:
        return NarrowPlan(**forward)
    dw_box = _narrow_box(D, H, W, chunk, N, True)
    if dw_box is None:
        return None
    # dw's third stage where its best box of two has room for it: more boxes in flight at the same bytes a row
    dw_stages = 3 if _narrow_smem(dw_box, chunk, N, True, 2, 3, 0) <= _WG_SMEM_MAX else 2
    dw_boxes = _boxes(B, D, H, W, dw_box)
    per_split = -(-dw_boxes // min(dw_boxes, max(1, sms // chunks)))
    return NarrowPlan(**forward, dw_box=dw_box, dw_boxes=dw_boxes, dw_splits=-(-dw_boxes // per_split),
                      dw_boxes_per_split=per_split, dw_smem_bytes=_narrow_smem(dw_box, chunk, N, True, 2, dw_stages, 0),
                      dw_stages=dw_stages)


def _narrow_dw(B: int, D: int, H: int, W: int, C: int, N: int, sms: int, esize: int) -> NarrowDwPlan | None:
    """The narrow dw's box, walk and shared memory: one wave of blocks, one an
    SM, each a run of whole boxes; or None where no box fits."""
    dw_box = _narrow_box(D, H, W, C, N, True, esize)
    if dw_box is None:
        return None
    dw_boxes, dw_stages = _boxes(B, D, H, W, dw_box), _narrow_stages(True, esize)
    per_split = -(-dw_boxes // min(dw_boxes, sms))
    return NarrowDwPlan(dw_box=dw_box, dw_boxes=dw_boxes, dw_splits=-(-dw_boxes // per_split),
                        dw_boxes_per_split=per_split,
                        dw_smem_bytes=_narrow_smem(dw_box, C, N, True, esize, dw_stages, 0), dw_stages=dw_stages)


@functools.lru_cache(maxsize=256)
def narrow_dw_plan(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132,
                   dtype: torch.dtype = torch.bfloat16) -> NarrowDwPlan | None:
    """The narrow dw's plan for a bfloat16 ``x`` (B,D,H,W,C) and ``g``
    (B,D,H,W,N) of a narrow input and a wide output, whose forward and dx keep
    their routes: N = 64 and 8C x N <= 4096 accumulators (C = 8: the s2d(2)
    stem's 8 -> 64), g's rows of 128 bytes in the box beside x's halo; or None:
    float32 (its FFMA dw wins there), other shapes, and wherever
    :func:`wgmma_plan` or :func:`narrow_plan` applies. Pure arithmetic; ``sms``
    is the card's count of multiprocessors."""
    if (dtype != torch.bfloat16 or C not in _NR_CHANNELS or N != _NR_DW_WIDE or 8 * C * N > _NR_DW_ACCUMULATORS
            or min(B, D, H, W) < 1 or B * D * H * W >= 2**31 or wgmma_plan(B, D, H, W, C, N, sms=sms) is not None
            or narrow_plan(B, D, H, W, C, N, sms=sms, dtype=dtype) is not None):
        return None
    return _narrow_dw(B, D, H, W, C, N, sms, _NR_ESIZE[dtype])


# The chunked dx's tiling (csrc/conv_k2_chunked_dx.cuh): a box of 128 output voxels, 64 of them each of two
# consumer warpgroups; a column chunk of 128 (or 64) channels a block; up to 4 halo stages. Its forward instance
# (the wide forward) cuts the same way.
_DX_BOX_ROWS = 128
_DX_MAX_STAGES = 4
_DX_BARRIER_BYTES = 128


@dataclasses.dataclass(frozen=True)
class ChunkedDxPlan:
    """How ``conv_k2_chunked_dx_kernel`` cuts a product of a narrow operand
    (8, 16 or 32 channels) and a wide result (a multiple of 64 channels),
    bfloat16: the dx of a narrow g and a wide dx (:func:`chunked_dx_plan`),
    or, run forward, the forward of a narrow x and a wide y
    (:func:`wide_plan`). Boxes of ``box`` (w, h, d), 128 output voxels of one
    batch item, ``boxes`` of them (w fastest, the last along each axis ragged),
    each read as one halo box of the narrow operand (g one voxel lower; x at
    the box); ``sub_box``, the first 64 rows of a box (the first consumer
    warpgroup's; the second's the next 64); column chunks of ``bn`` channels
    of the result, ``chunks`` of them; ``grid`` blocks, a multiple of
    ``chunks``: block i holds chunk i % chunks of w in shared memory and walks
    boxes i / chunks, + grid / chunks, ...; a ring of ``stages`` halo stages,
    and ``smem_bytes`` of dynamic shared memory, which the launcher holds to
    its own arithmetic."""

    box: tuple[int, int, int]
    sub_box: tuple[int, int, int]
    boxes: int
    bn: int
    chunks: int
    grid: int
    stages: int
    smem_bytes: int


def _chunked_dx_smem(box: tuple[int, int, int], N: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of the chunked dx (``cdx::smem_bytes``): alignment room, the chunk's w (8N/64
    tiles of bn rows x 128 bytes), two staging buffers of 64 rows x bn bf16 for each warpgroup, ``stages``
    halo stages of 2N-byte rows (each in whole KiB), the barriers. N is the narrow operand's channels."""
    bw, bh, bd = box
    halo = _round_up((bw + 1) * (bh + 1) * (bd + 1) * 2 * N, _NR_ALIGN)
    return _NR_ALIGN + (8 * N // 64) * bn * 128 + 2 * 2 * bn * 128 + stages * halo + _DX_BARRIER_BYTES


def _chunked_wide_plan(B: int, D: int, H: int, W: int, narrow: int, wide: int, sms: int) -> ChunkedDxPlan | None:
    """The plan of ``conv_k2_chunked_dx_kernel`` for a narrow operand of ``narrow`` channels (8, 16 or 32) and
    a result of ``wide`` (a multiple of 64) on the (B, D, H, W) grid, whichever instance runs it, or None. The
    box: 128 voxels whose extents are powers of two, w at least 8 (an ldmatrix phase's 8 rows on one line) and
    each at most 128, whose first 64 rows tile it as a sub-box; of those, the fewest boxes (the products and
    the store), then the fewest halo voxels (L2 bytes). Chunks of 128 columns (64 where ``wide`` is an odd
    multiple of 64); as many blocks of a chunk as fill ``sms`` multiprocessors, one block each; as many halo
    stages as fit beside the chunk's w and the staging buffers, at most 4."""
    if wide < 64 or wide % 64 or narrow not in _NR_OUTPUTS or min(B, D, H, W) < 1 or B * D * H * W >= 2**31:
        return None
    best, best_key = None, None
    for bd in (1 << i for i in range(8)):
        for bh in (1 << i for i in range(8)):
            bw = _DX_BOX_ROWS // (bd * bh)
            if bw < 8 or bw * bh * bd != _DX_BOX_ROWS:
                continue
            sub = _row_box(_DX_BOX_ROWS // 2, 1, bd, bh, bw)
            if sub is None:
                continue
            key = (_boxes(B, D, H, W, (bw, bh, bd)), (bw + 1) * (bh + 1) * (bd + 1))
            if best_key is None or key < best_key:
                best, best_key = ((bw, bh, bd), sub[:3]), key
    box, sub = best
    bn = 128 if wide % 128 == 0 else 64
    fixed = _chunked_dx_smem(box, narrow, bn, 0)
    stages = min(_DX_MAX_STAGES, (_WG_SMEM_MAX - fixed) // (_chunked_dx_smem(box, narrow, bn, 1) - fixed))
    if stages < 2:
        return None
    boxes, chunks = best_key[0], wide // bn
    per_chunk = max(1, min(boxes, sms // chunks))
    return ChunkedDxPlan(box=box, sub_box=sub, boxes=boxes, bn=bn, chunks=chunks, grid=chunks * per_chunk,
                         stages=stages, smem_bytes=_chunked_dx_smem(box, narrow, bn, stages))


@functools.lru_cache(maxsize=256)
def chunked_dx_plan(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132) -> ChunkedDxPlan | None:
    """The chunked dx's plan for the bfloat16 dx of ``conv_k2`` from C to N
    channels (g (B,D,H,W,N), dx (B,D,H,W,C)), or None where it does not apply:
    N of 8, 16 or 32 and C a multiple of 64 above 64 (the tensor-parallel
    shards 512 -> 32, -> 16, -> 8), whose dx neither plan of the forward from
    N to C takes; and C = 64 (64 -> 8, the default ``DetectorConfig``'s: on
    an H100 0.0591 ms alone against the FFMA dx's 0.2905). The cut is
    :func:`_chunked_wide_plan`'s. Pure arithmetic."""
    if C < 64:
        return None
    return _chunked_wide_plan(B, D, H, W, N, C, sms)


@functools.lru_cache(maxsize=256)
def wide_plan(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132,
              dtype: torch.dtype = torch.bfloat16) -> ChunkedDxPlan | None:
    """The wide forward's plan (the chunked dx's kernel run forward) for a
    bfloat16 ``x`` (B,D,H,W,C) of a narrow input, C of 8, 16 or 32, and ``w``
    (2,2,2,C,N) of a wide output, N a multiple of 64 (the s2d(2) stem's 8 ->
    64: one chunk of 64 columns, all of w in every block), or None: another
    dtype, other shapes, and wherever :func:`wgmma_plan` or
    :func:`narrow_plan` applies. The cut is :func:`_chunked_wide_plan`'s, the
    halo box of x at the box's origin. Pure arithmetic; ``sms`` is the card's
    count of multiprocessors."""
    if (dtype != torch.bfloat16 or wgmma_plan(B, D, H, W, C, N, sms=sms) is not None
            or narrow_plan(B, D, H, W, C, N, sms=sms, dtype=dtype) is not None):
        return None
    return _chunked_wide_plan(B, D, H, W, C, N, sms)


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _plan_for(x: torch.Tensor, N: int) -> WgmmaPlan | None:
    """The plan of a CUDA operand, or None: bfloat16 only."""
    if x.dtype != torch.bfloat16:
        return None
    return wgmma_plan(*x.shape, N, sms=_sms(x))


def _narrow_for(x: torch.Tensor, N: int) -> NarrowPlan | None:
    """The narrow plan of a CUDA operand (bfloat16 or float32), or None."""
    if x.dtype not in _NR_ESIZE:
        return None
    return narrow_plan(*x.shape, N, sms=_sms(x), dtype=x.dtype)


def _chunked_dx_for(g: torch.Tensor, C: int) -> ChunkedDxPlan | None:
    """The chunked dx plan of a CUDA g (bfloat16 only) and C channels of dx, or None."""
    if g.dtype != torch.bfloat16:
        return None
    return chunked_dx_plan(*g.shape[:4], C, g.shape[-1], sms=_sms(g))


def _wide_for(x: torch.Tensor, N: int) -> ChunkedDxPlan | None:
    """The wide forward's plan of a CUDA x (bfloat16 only) and N output channels, or None."""
    if x.dtype != torch.bfloat16:
        return None
    return wide_plan(*x.shape, N, sms=_sms(x))


def _check_launch(what: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: {_lib().conv_k2_error_string(rc).decode()} (cudaError {rc})")


def _check_operands(what: str, C: int, N: int, *tensors: torch.Tensor, depth_is_n: bool = False) -> None:
    """What the kernels need of their operands: the depth's channel count a
    multiple of 8 and the output's column count of 4 (C and N for the forward
    and dw; N and C for dx, ``depth_is_n``), and 16-byte aligned storage."""
    depth, cols = (("N", N), ("C", C)) if depth_is_n else (("C", C), ("N", N))
    if depth[1] % 8 or cols[1] % 4:
        raise ValueError(f"{what} kernel needs {depth[0]} % 8 == 0 and {cols[0]} % 4 == 0; got C={C}, N={N}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} kernel needs 16-byte aligned tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda_operand(what: str, name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not {t.dtype}")
    if t.dim() != 5 or min(t.shape) < 1 or not t.is_contiguous():
        raise ValueError(f"{what} kernel takes a non-empty contiguous NDHWC {name}; got {tuple(t.shape)}")


def _split_workspace(splits: int, out: torch.Tensor) -> torch.Tensor | None:
    """The f32 partials [splits, *out.shape] of a split launch into ``out``
    (the tensor-core forward or dx, or the float32 FFMA ones), or None with
    one split (the library is given a null pointer)."""
    if splits == 1:
        return None
    return torch.empty((splits, *out.shape), dtype=torch.float32, device=out.device)


def dw_wgmma(x: torch.Tensor, g: torch.Tensor, dw: torch.Tensor, plan: WgmmaPlan) -> None:
    """Launch the tensor-core dw into ``dw`` (2,2,2,C,N) float32 on ``plan``:
    the persistent kernel where ``plan.dw_persistent`` is set, else the grid
    kernel, each with the reduce of its splits (one call into the library).
    Counts nothing, as :func:`forward_wgmma`."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    walk = plan.dw_persistent
    splits = plan.dw_grid[2] if walk is None else walk.splits
    workspace = torch.empty((splits if splits > 1 else 0, 8 * C, N), dtype=torch.float32, device=x.device)
    _check_operands("conv_k2 dw", C, N, x, g, dw, workspace)
    if walk is None:
        _check_launch("conv_k2 dw (wgmma)", _lib().conv_k2_backward_weight_wgmma(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), splits, plan.dw_stages_per_split,
            B, D, H, W, C, N, *plan.dw_box, plan.dw_box_items, plan.bn, plan.dw_stages, plan.dw_smem_bytes,
            x.device.index, _stream(x)))
    else:
        _check_launch("conv_k2 dw (persistent wgmma)", _lib().conv_k2_backward_weight_persistent(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), B, D, H, W, C, N, *plan.dw_box,
            plan.dw_box_items, walk.bn, walk.stages, walk.grid, walk.smem_bytes, walk.tiles, walk.splits,
            walk.stages_per_split, x.device.index, _stream(x)))


def forward_wgmma(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, plan: WgmmaPlan) -> None:
    """Launch the tensor-core forward into ``y`` on the tiles of ``plan``
    (the wrapper's, or one of :func:`wgmma_plan`'s ``bm`` or ``split``
    choices, to time one against the other); with ``plan.splits > 1`` into a
    workspace of f32 partials, then the reduce that sums them into ``y``, both
    launched by one call into the library. Counts nothing: the op's CUDA
    implementation counts its launches."""
    B, D, H, W, C = x.shape
    N = y.shape[-1]
    w = w.to(x.dtype).contiguous()
    _check_operands("conv_k2", C, N, x, w, y)
    part = _split_workspace(plan.splits, y)
    _check_launch("conv_k2 (wgmma)", _lib().conv_k2_forward_wgmma(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), 0 if part is None else part.data_ptr(), B, D, H, W, C, N, *plan.box,
        plan.box_items, plan.bm, plan.bn, plan.stages, plan.grid, plan.smem_bytes, plan.tiles, plan.splits,
        plan.stages_per_split, x.device.index, _stream(x)))


def dx_wgmma(g: torch.Tensor, w: torch.Tensor, dx: torch.Tensor, plan: WgmmaPlan) -> None:
    """Launch the tensor-core dx into ``dx`` on the tiles of ``plan``, the
    plan of the forward from N to C channels (its splits and reduce too).
    Counts nothing, as :func:`forward_wgmma`."""
    B, D, H, W, N = g.shape
    C = dx.shape[-1]
    # w as it lies: its (c, n) boxes are the K-major B tiles of dx
    wc = w.to(g.dtype).contiguous()
    _check_operands("conv_k2 dx", C, N, g, wc, dx, depth_is_n=True)
    part = _split_workspace(plan.splits, dx)
    _check_launch("conv_k2 dx (wgmma)", _lib().conv_k2_backward_input_wgmma(
        g.data_ptr(), wc.data_ptr(), dx.data_ptr(), 0 if part is None else part.data_ptr(), B, D, H, W, C, N, *plan.box,
        plan.box_items, plan.bm, plan.bn, plan.stages, plan.grid, plan.smem_bytes, plan.tiles, plan.splits,
        plan.stages_per_split, g.device.index, _stream(g)))


def forward_chunked(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, plan: NarrowPlan) -> None:
    """Launch the chunked forward (bfloat16 on ``mma.sync``, float32 on FFMA)
    into ``y`` on ``plan`` (:func:`chunked_plan`), ``w`` as it lies (each
    stage's TMA copy takes a chunk's rows). Counts nothing, as
    :func:`forward_wgmma`."""
    B, D, H, W, C = x.shape
    N = y.shape[-1]
    w = w.to(x.dtype).contiguous()
    _check_operands("conv_k2", C, N, x, w, y)
    _check_launch("conv_k2 (chunked)", _lib().conv_k2_forward_chunked(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), B, D, H, W, C, N, *plan.box, plan.grid, plan.smem_bytes,
        _DTYPE_CODES[x.dtype], x.device.index, _stream(x)))


def dx_chunked(g: torch.Tensor, w: torch.Tensor, dx: torch.Tensor, plan: ChunkedDxPlan) -> None:
    """Launch the chunked dx into ``dx`` (bfloat16, on the tensor cores) on
    ``plan`` (:func:`chunked_dx_plan`), w laid out as [C, 8N], the K-major
    rows of the products' B operand (the kernel pairs w's tap t with g's
    mirrored tap). Counts nothing, as :func:`forward_wgmma`."""
    B, D, H, W, N = g.shape
    C = dx.shape[-1]
    # wt[c, t N + n] = w[t, c, n], each column's depth contiguous: one copy (and cast) of <= 256 KB
    wt = torch.empty((C, 8, N), dtype=g.dtype, device=g.device)
    wt.copy_(w.reshape(8, C, N).permute(1, 0, 2))
    _check_operands("conv_k2 dx", C, N, g, wt, dx, depth_is_n=True)
    _check_launch("conv_k2 dx (chunked)", _lib().conv_k2_backward_input_chunked(
        g.data_ptr(), wt.data_ptr(), dx.data_ptr(), B, D, H, W, C, N, *plan.box, plan.bn, plan.stages, plan.grid,
        plan.smem_bytes, g.device.index, _stream(g)))


def forward_wide(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, plan: ChunkedDxPlan) -> None:
    """Launch the wide forward into ``y`` (bfloat16, on the tensor cores: the
    chunked dx's kernel run forward) on ``plan`` (:func:`wide_plan`), w laid
    out as [N, 8C], the K-major rows of the products' B operand. Counts
    nothing, as :func:`forward_wgmma`."""
    B, D, H, W, C = x.shape
    N = y.shape[-1]
    # wt[n, t C + c] = w[t, c, n], each column's depth contiguous: one copy (and cast), 8 KB at the stem
    wt = torch.empty((N, 8, C), dtype=x.dtype, device=x.device)
    wt.copy_(w.reshape(8, C, N).permute(2, 0, 1))
    _check_operands("conv_k2", C, N, x, wt, y)
    _check_launch("conv_k2 (wide)", _lib().conv_k2_forward_wide(
        x.data_ptr(), wt.data_ptr(), y.data_ptr(), B, D, H, W, C, N, *plan.box, plan.bn, plan.stages, plan.grid,
        plan.smem_bytes, x.device.index, _stream(x)))


def dw_narrow(x: torch.Tensor, g: torch.Tensor, dw: torch.Tensor, plan: NarrowPlan | NarrowDwPlan) -> None:
    """Launch the narrow dw into ``dw`` (2,2,2,C,N) float32 on ``plan``'s dw
    fields (a :class:`NarrowPlan`, chunked or not, or a :class:`NarrowDwPlan`),
    with the reduce of its splits (one call into the library). Counts
    nothing, as :func:`forward_wgmma`."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    splits = plan.dw_splits
    workspace = torch.empty((splits if splits > 1 else 0, 8 * C, N), dtype=torch.float32, device=x.device)
    _check_operands("conv_k2 dw", C, N, x, g, dw, workspace)
    _check_launch("conv_k2 dw (narrow)", _lib().conv_k2_backward_weight_narrow(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), splits, plan.dw_boxes_per_split,
        B, D, H, W, C, N, *plan.dw_box, plan.dw_smem_bytes, plan.dw_stages, _DTYPE_CODES[x.dtype],
        x.device.index, _stream(x)))


# The FFMA GEMM's tiling (csrc/conv_k2.cu, gemm::Tile): output tiles of 128
# rows by 128 columns, two blocks an SM, or by 64 columns where N <= 64, four
# blocks an SM (gemm::Tile::MIN_BLOCKS); stages of 16 (the forward's depth, dw's
# rows m). dw's tiles (gemm::DwTile), its rows (tap, c), are the forward's, but
# where a side is narrow: 128 x 32 where N <= 32, 64 x 64 where 8C <= 64.
_FFMA_ROWS = 128
_FFMA_DEPTH = 16
_FFMA_MIN_STAGES = 16  # a split of the forward's depth or of dw's row reduction is at least this deep
_FFMA_STAGES = 3  # stages in flight (gemm::STAGES)
_SM_SMEM = 233_472  # shared memory of an H100 SM, of which each resident block also takes 1 KB
_FFMA_DW_FIT_MAX_SPLITS = 512  # splits of the FFMA dw on a tile fitted to a narrow side, at most


def _ffma_tile(N: int) -> tuple[int, int]:
    """(columns of a tile, blocks an SM) of the FFMA kernels for N output columns."""
    return (64, 4) if N <= 64 else (128, 2)


def ffma_split(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132) -> tuple[int, int]:
    """``(splits, stages_per_split)`` of the float32 FFMA forward's depth for x
    (B,D,H,W,C) and w (2,2,2,C,N) (dx: called with C and N swapped, the
    forward from N to C): its 8C/16 stages cut into ``splits`` runs of
    ``stages_per_split`` (the last may be shorter, none is empty). More than
    one only on grids of at most 8^3 voxels an item whose output tiles fill at
    most half a wave of blocks on ``sms`` multiprocessors (the mid_blocked
    stages: 4^3 2048 -> 512 at B=8 is 16 tiles, each 1024 stages deep); then
    as many as fill one wave, each at least 16 stages deep. Every 16^3 and
    larger grid keeps one split. Pure arithmetic."""
    bn, per_sm = _ffma_tile(N)
    tiles = -(-B * D * H * W // _FFMA_ROWS) * -(-N // bn)
    stages = -(-8 * C // _FFMA_DEPTH)
    splits = 1
    if D * H * W <= _WG_SPLIT_MAX_VOXELS and 2 * tiles <= per_sm * sms:
        splits = max(1, min(per_sm * sms // tiles, stages // _FFMA_MIN_STAGES))
    per_split = -(-stages // splits)
    return -(-stages // per_split), per_split


def _ffma_splits(src: torch.Tensor, C: int, N: int) -> tuple[int, int]:
    """The split of an FFMA launch over ``src`` from C to N channels: float32's plan; bfloat16 keeps one."""
    if src.dtype != torch.float32:
        return 1, -(-8 * C // _FFMA_DEPTH)
    return ffma_split(*src.shape[:4], C, N, sms=_sms(src))


@torch.library.custom_op("anytime3d_torch::conv_k2", mutates_args=(), device_types="cpu")
def _conv_k2_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward: the plain version on the CPU, the kernel on CUDA (``w`` cast to ``x``'s dtype)."""
    return conv_k2_reference(x, w)


@_conv_k2_op.register_kernel("cuda")
def _launch_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous (B,D,H,W,C) on the card, ``w`` (2,2,2,C,N)."""
    _check_cuda_operand("conv_k2", "x", x)
    B, D, H, W, C = x.shape
    N = w.shape[-1]
    w = w.to(x.dtype).contiguous()
    y = torch.empty((B, D, H, W, N), dtype=x.dtype, device=x.device)
    _check_operands("conv_k2", C, N, x, w, y)
    plan = _plan_for(x, N)
    narrow = None if plan is not None else _narrow_for(x, N)
    wide = None if plan is not None or narrow is not None else _wide_for(x, N)
    if plan is not None:
        forward_wgmma(x, w, y, plan)
        conv_k2.launches_wgmma += 1
        conv_k2.launches_split += plan.splits > 1
    elif narrow is not None and narrow.c_chunks > 1:
        forward_chunked(x, w, y, narrow)
        conv_k2.launches_narrow += 1
        conv_k2.launches_chunked += 1
        conv_k2.launches_chunked_f32 += x.dtype == torch.float32
    elif narrow is not None:
        _check_launch("conv_k2 (narrow)", _lib().conv_k2_forward_narrow(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, D, H, W, C, N, *narrow.box, narrow.grid,
            narrow.smem_bytes, narrow.chunk_d, _DTYPE_CODES[x.dtype], x.device.index, _stream(x)))
        conv_k2.launches_narrow += 1
    elif wide is not None:
        forward_wide(x, w, y, wide)
        conv_k2.launches_wide += 1
    else:
        splits, per_split = _ffma_splits(x, C, N)
        part = _split_workspace(splits, y)
        _check_launch("conv_k2", _lib().conv_k2_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 0 if part is None else part.data_ptr(), splits, per_split,
            B, D, H, W, C, N, _DTYPE_CODES[x.dtype], x.device.index, _stream(x)))
        conv_k2.launches_ffma_split += splits > 1
    conv_k2.launches += 1
    return y


@_conv_k2_op.register_fake
def _(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty((*x.shape[:4], w.shape[-1]))


@torch.library.custom_op("anytime3d_torch::conv_k2_dx", mutates_args=(), device_types="cpu")
def _conv_k2_dx_op(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx: the plain version on the CPU, the kernel on CUDA."""
    return conv_k2_dx_reference(g, w)


@_conv_k2_dx_op.register_kernel("cuda")
def _launch_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_cuda_operand("conv_k2 dx", "g", g)
    B, D, H, W, N = g.shape
    C = w.shape[3]
    dx = torch.empty((B, D, H, W, C), dtype=g.dtype, device=g.device)
    # both plans are those of the forward from N to C channels; a narrow plan that walks N in chunks is not
    # dx's (the chunked forward has no instance over g one voxel lower): that dx keeps the FFMA kernel. Where
    # neither applies, a narrow g and a wide dx (bfloat16) take the chunked dx
    plan = _plan_for(g, C)
    narrow = None if plan is not None else _narrow_for(g, C)
    if narrow is not None and narrow.c_chunks > 1:
        narrow = None
    wide = None if plan is not None or narrow is not None else _chunked_dx_for(g, C)
    if plan is not None:
        dx_wgmma(g, w, dx, plan)
        conv_k2.launches_dx_wgmma += 1
        conv_k2.launches_dx_split += plan.splits > 1
    elif narrow is not None:
        # (2,2,2,N,C), w'[s] = w[7 - s]^T: the forward's weights over g read one voxel lower.
        # Plumbing on <= 2K elements
        wm = w.to(g.dtype).flip(0, 1, 2).transpose(3, 4).contiguous()
        _check_operands("conv_k2 dx", C, N, g, wm, dx, depth_is_n=True)
        _check_launch("conv_k2 dx (narrow)", _lib().conv_k2_backward_input_narrow(
            g.data_ptr(), wm.data_ptr(), dx.data_ptr(), B, D, H, W, C, N, *narrow.box, narrow.grid,
            narrow.smem_bytes, narrow.chunk_d, _DTYPE_CODES[g.dtype], g.device.index, _stream(g)))
        conv_k2.launches_dx_narrow += 1
    elif wide is not None:
        dx_chunked(g, w, dx, wide)
        conv_k2.launches_dx_narrow += 1
        conv_k2.launches_dx_chunked += 1
    else:
        # (2,2,2,N,C): the depth of dx is (tap, n). Plumbing on <= 2.1 M elements; no
        # flip, the kernel's mirrored shift already pairs tap t with w[t]
        wt = w.to(g.dtype).transpose(3, 4).contiguous()
        _check_operands("conv_k2 dx", C, N, g, wt, dx, depth_is_n=True)
        splits, per_split = _ffma_splits(g, N, C)  # the forward from N to C's
        part = _split_workspace(splits, dx)
        _check_launch("conv_k2 dx", _lib().conv_k2_backward_input(
            g.data_ptr(), wt.data_ptr(), dx.data_ptr(), 0 if part is None else part.data_ptr(), splits, per_split,
            B, D, H, W, C, N, _DTYPE_CODES[g.dtype], g.device.index, _stream(g)))
        conv_k2.launches_dx_ffma_split += splits > 1
    conv_k2.launches_dx += 1
    return dx


@_conv_k2_dx_op.register_fake
def _(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return g.new_empty((*g.shape[:4], w.shape[3]))


def conv_k2_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (B,D,H,W,C), in ``g``'s dtype, of ``conv_k2`` from the output
    gradient ``g`` (B,D,H,W,N) and ``w`` (2,2,2,C,N): the op
    ``anytime3d_torch::conv_k2_dx``. CUDA tensors go through a kernel (adding
    one to ``conv_k2.launches_dx``, and to ``conv_k2.launches_dx_wgmma`` or
    ``conv_k2.launches_dx_narrow`` where it is the tensor-core or the narrow
    kernel: bfloat16 whose shape, as a forward from N to C, has a wgmma plan,
    or either type whose shape so has a narrow plan, or bfloat16 with a
    chunked dx plan (:func:`chunked_dx_plan`), which adds one to
    ``launches_dx_chunked`` too; to ``launches_dx_ffma_split`` where a float32
    FFMA dx splits its depth) or the call raises; CPU tensors through
    :func:`conv_k2_dx_reference`."""
    return _conv_k2_dx_op(g, w)


def ffma_dw_fitted(C: int, N: int) -> bool:
    """Whether the FFMA dw of x with C and g with N channels takes a tile
    fitted to a narrow side (N <= 32, or 8C <= 64)."""
    return N <= 32 or 8 * C <= 64


def _ffma_dw_tile(C: int, N: int, esize: int = 4) -> tuple[int, int, int]:
    """(rows, columns, blocks an SM) of the FFMA dw's tile (``csrc/conv_k2.cu::launch_dw``) for x with C and g
    with N channels of ``esize`` bytes: 128 x 32 where N <= 32 and 64 x 64 where 8C <= 64, each on 64
    threads of 8 x 8 outputs (8 blocks an SM by registers, fewer where three stages of a block's shared
    memory allow fewer: 7 for the float32 128 x 32); else the forward's tiles."""
    if ffma_dw_fitted(C, N):
        bm, bn = (128, 32) if N <= 32 else (64, 64)
        stage_bytes = _FFMA_DEPTH * (bm + bn) * esize
        return bm, bn, min(8, _SM_SMEM // (_FFMA_STAGES * stage_bytes + 1024))
    return (_FFMA_ROWS, *_ffma_tile(N))


def ffma_dw_split(rows: int, C: int, N: int, sms: int = 132, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """``(splits, stages_per_split)`` of the FFMA dw's row reduction over
    ``rows`` = B*D*H*W rows for x with C and g with N channels of ``dtype``:
    its ceil(rows / 16) stages of 16 rows cut into ``splits`` parts of
    ``stages_per_split`` (the last may be shorter, none is empty), so that the
    output tiles (:func:`_ffma_dw_tile`) times the splits make one wave of
    blocks on ``sms`` multiprocessors and each split is at least 16 stages
    deep; on a tile fitted to a narrow side, at most 512 splits: the reduce
    adds each entry's splits one after another, and at the s2d(2) stem
    (one tile of 64 x 64, 1041 splits in a wave at B=32) 1024 splits took
    0.042 ms more than 512 on an H100, 256 0.021 ms more. Pure arithmetic."""
    bm, bn, per_sm = _ffma_dw_tile(C, N, torch.empty((), dtype=dtype).element_size())
    tiles = -(-8 * C // bm) * -(-N // bn)
    stages = -(-rows // _FFMA_DEPTH)
    splits = max(1, min(per_sm * sms // tiles, stages // _FFMA_MIN_STAGES))
    if ffma_dw_fitted(C, N):
        splits = min(splits, _FFMA_DW_FIT_MAX_SPLITS)
    per_split = -(-stages // splits)
    return -(-stages // per_split), per_split


@torch.library.custom_op("anytime3d_torch::conv_k2_dw", mutates_args=(), device_types="cpu")
def _conv_k2_dw_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw: the plain version on the CPU, the kernel on CUDA."""
    return conv_k2_dw_reference(x, g)


@_conv_k2_dw_op.register_kernel("cuda")
def _launch_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _check_cuda_operand("conv_k2 dw", "x", x)
    _check_cuda_operand("conv_k2 dw", "g", g)
    if g.dtype != x.dtype or g.shape[:4] != x.shape[:4]:
        raise ValueError(f"conv_k2 dw takes x and g of one dtype and grid; got {tuple(x.shape)} {x.dtype}, "
                         f"{tuple(g.shape)} {g.dtype}")
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    dw = torch.empty((2, 2, 2, C, N), dtype=torch.float32, device=x.device)
    plan = _plan_for(x, N)
    if plan is not None:
        dw_wgmma(x, g, dw, plan)
        conv_k2.launches_dw_wgmma += 1
        conv_k2.launches_dw_persistent += plan.dw_persistent is not None
        conv_k2.launches_dw += 1
        return dw
    # the narrow plan (chunked or not) where it has a dw part (the float32 walk in chunks is the forward's
    # alone), else (bfloat16, N = 64) the dw-only one: their dw fields are the same
    narrow = _narrow_for(x, N)
    if narrow is not None and narrow.dw_box is None:
        narrow = None
    narrow = narrow or narrow_dw_plan(*x.shape, N, sms=_sms(x), dtype=x.dtype)
    if narrow is not None:
        dw_narrow(x, g, dw, narrow)
        conv_k2.launches_dw_narrow += 1
        conv_k2.launches_dw_wide += isinstance(narrow, NarrowDwPlan)
        conv_k2.launches_dw_chunked += narrow.c_chunks > 1
    else:
        splits, per_split = ffma_dw_split(B * D * H * W, C, N, sms=_sms(x), dtype=x.dtype)
        workspace = torch.empty((splits if splits > 1 else 0, 8 * C, N), dtype=torch.float32, device=x.device)
        _check_operands("conv_k2 dw", C, N, x, g, dw, workspace)
        _check_launch("conv_k2 dw", _lib().conv_k2_backward_weight(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), workspace.data_ptr(), splits, per_split, B, D, H, W, C, N,
            _DTYPE_CODES[x.dtype], x.device.index, _stream(x)))
        conv_k2.launches_dw_ffma_fit += ffma_dw_fitted(C, N)
    conv_k2.launches_dw += 1
    return dw


@_conv_k2_dw_op.register_fake
def _(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x.new_empty((2, 2, 2, x.shape[-1], g.shape[-1]), dtype=_dw_dtype(x.dtype))


def conv_k2_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw (2,2,2,C,N), float32, of ``conv_k2`` from its input ``x``
    (B,D,H,W,C) and the output gradient ``g`` (B,D,H,W,N) of the same dtype:
    the op ``anytime3d_torch::conv_k2_dw``. CUDA tensors go through a kernel
    (adding one to ``conv_k2.launches_dw``, and to ``launches_dw_wgmma`` or
    ``launches_dw_narrow`` where the shape has that plan, the former also to
    ``launches_dw_persistent`` where the plan's dw is the persistent kernel,
    the latter also where it has a dw-only plan (:func:`narrow_dw_plan`),
    which adds one to ``launches_dw_wide`` too, or a plan that walks C in
    chunks, ``launches_dw_chunked``; an FFMA dw on a tile fitted to a narrow
    side adds one to ``launches_dw_ffma_fit``) or the call raises; CPU
    tensors through :func:`conv_k2_dw_reference`. The result is the same
    from run to run."""
    return _conv_k2_dw_op(x, g)


def _setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _backward(ctx, g: torch.Tensor):
    """dx and dw through their ops, each only where a gradient is asked for;
    dw in the parameter's dtype straight from the op's float32 sum."""
    x, w = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()  # autograd hands over permuted views more often than not
    dx = _conv_k2_dx_op(g, w) if ctx.needs_input_grad[0] else None
    dw = _conv_k2_dw_op(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
    return dx, dw


_conv_k2_op.register_autograd(_backward, setup_context=_setup_context)


def conv_k2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k=2 s=1 SAME conv, differentiable in ``x`` and ``w``: the op
    ``anytime3d_torch::conv_k2``. A CUDA tensor goes through the CUDA
    kernels, forward and backward, or the call raises; a CPU tensor through
    :func:`conv_k2_reference` and the plain dx and dw.

    ``w`` may be a float32 parameter beside a bfloat16 ``x``: it is cast to
    ``x``'s dtype inside the op and its gradient comes back in float32. Every
    kernel launch adds one to ``conv_k2.launches`` (forward),
    ``conv_k2.launches_dx`` or ``conv_k2.launches_dw``; a launch of a
    tensor-core kernel also to ``conv_k2.launches_wgmma`` (forward),
    ``conv_k2.launches_dx_wgmma`` or ``conv_k2.launches_dw_wgmma``, and of a
    narrow kernel (bfloat16 or float32) to ``conv_k2.launches_narrow``
    (forward), ``conv_k2.launches_dx_narrow`` or
    ``conv_k2.launches_dw_narrow`` (and ``launches_dw_wide`` on the dw-only
    plan; a forward or dw whose plan walks C in chunks, also
    ``launches_chunked`` or ``launches_dw_chunked``, a float32 such forward
    ``launches_chunked_f32`` too; a dx on the chunked dx plan
    ``launches_dx_chunked``); a forward on the wide plan (:func:`wide_plan`,
    the chunked dx's kernel run forward) adds one to ``launches_wide``, and
    an FFMA dw on a tile fitted to a narrow side (:func:`ffma_dw_fitted`) to
    ``launches_dw_ffma_fit``. A tensor-core forward or dx whose plan splits its depth (and then
    launches the reduce of its partials) adds one to
    ``conv_k2.launches_split`` or ``launches_dx_split``; a float32 FFMA
    forward or dx that splits its depth (:func:`ffma_split`), to
    ``launches_ffma_split`` or ``launches_dx_ffma_split``; a persistent
    tensor-core dw, to ``launches_dw_persistent``."""
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:4]) != (2, 2, 2, x.shape[-1]):
        raise ValueError(f"conv_k2 takes x (B,D,H,W,C) and w (2,2,2,C,N); got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.device.type != "cpu":
        _check_cuda_operand("conv_k2", "x", x)
        # checked here, not first in backward
        _check_operands("conv_k2", x.shape[-1], w.shape[-1])
        if torch.is_grad_enabled() and x.requires_grad:
            _check_operands("conv_k2 dx", x.shape[-1], w.shape[-1], depth_is_n=True)
    return _conv_k2_op(x, w)


conv_k2.launches = 0
conv_k2.launches_dx = 0
conv_k2.launches_dw = 0
conv_k2.launches_wgmma = 0
conv_k2.launches_dx_wgmma = 0
conv_k2.launches_dw_wgmma = 0
conv_k2.launches_narrow = 0
conv_k2.launches_dx_narrow = 0
conv_k2.launches_dw_narrow = 0
conv_k2.launches_split = 0
conv_k2.launches_dx_split = 0
conv_k2.launches_dw_wide = 0
conv_k2.launches_ffma_split = 0
conv_k2.launches_dx_ffma_split = 0
conv_k2.launches_dw_persistent = 0
conv_k2.launches_chunked = 0
conv_k2.launches_dw_chunked = 0
conv_k2.launches_dx_chunked = 0
conv_k2.launches_chunked_f32 = 0
conv_k2.launches_wide = 0
conv_k2.launches_dw_ffma_fit = 0
