"""The instance norm (`csrc/instance_norm.cu`, plain version
`instance_norm_plain`): InstanceNorm2d(affine=False) of a (B, C, H, W)
tensor, statistics in f32, the result in the input's dtype, and the ReLU
after it where the caller applies one (`models/raft.InstanceNorm` calls it
where no gradient is needed). It ports no TPU kernel: the JAX package leaves
the norm to XLA, and in PyTorch ops it is a chain of eight kernels and the
ReLU's. The note at the top of the source says what bounds it and what its
design does.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CSRC, check_device, check_launch, entry, sm_count

SOURCE = CSRC / "instance_norm.cu"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = (_P, _P, _I, _I, _I, _L, _I, _L, _L, _L) + (_I,) * 5 + (_F, _F, _I, _P)
NORM_VECTOR_BYTES = 16       # the widest access a thread makes
NORM_MAX_LANES = 4           # vectors an item holds at most: 64 bytes of a position's channels
NORM_MAX_TILES = 16          # blocks a (sample, group) at most: one cluster, the H100's largest
NORM_TILE_BYTES = 64 * 1024  # a block's share of a group at most, where NORM_MAX_TILES allow
NORM_CACHE_BYTES = 128 * 1024  # a block's share kept on chip at most; past it, re-read
NORM_MAX_GRID = 65535        # groups and samples: the grid's y and z


def _layout(x: torch.Tensor):
    """"nhwc" for a channels-last (B, C, H, W) tensor, "nchw" for a
    contiguous one, None for any other layout."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    if x.is_contiguous():
        return "nchw"
    return None


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over H, W of x (B, C, H, W), float32 or
    bfloat16, channels-last or contiguous: the statistics in f32 (the
    population variance), (x - mean) * rsqrt(var + eps) cast to x's dtype,
    then F.relu with `relu`; the output in x's layout.

    Calls the operator `torch.ops.rnnpose.instance_norm`: a CUDA tensor
    launches the kernel and raises if it cannot; a CPU tensor runs
    `instance_norm_plain`. No gradient: `models/raft.InstanceNorm` calls it
    only where none is needed.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"x must hold elements, got {tuple(x.shape)}")
    if _layout(x) is None:
        raise ValueError(f"x must be channels-last or contiguous, got strides {x.stride()} "
                         f"for {tuple(x.shape)}")
    B, C = x.shape[:2]
    if B > NORM_MAX_GRID or C > NORM_MAX_GRID:
        raise ValueError(f"at most {NORM_MAX_GRID} samples and channels, got {tuple(x.shape)}")
    check_device(x)
    return torch.ops.rnnpose.instance_norm(x, float(eps), bool(relu))


def takes(x, eps, relu) -> bool:
    """Whether the kernel takes x's dtype (`kernels.dispatch`)."""
    return x.dtype in (torch.float32, torch.bfloat16)


def launch_params(x: torch.Tensor, sms: int) -> dict:
    """How `instance_norm_cuda` cuts x for a card of `sms` SMs: the
    elements of a vector (`vec`, the widest aligned access of at most
    NORM_VECTOR_BYTES along the run of elements next to each other), the
    vectors of an item (`lanes`: in channels-last, a position's next
    channels, up to NORM_MAX_LANES while the groups still give a cluster of
    NORM_MAX_TILES blocks to every two SMs), the items of a (sample, group)
    and their strides, the blocks of its cluster (`tiles`: the fewest that
    hold at most NORM_TILE_BYTES each and give the launch a block for every
    four SMs) and theirs (`per_block`), and whether
    a block's share is kept on chip (`cached`, up to NORM_CACHE_BYTES) or
    re-read (the second mode). Measured on an H100 at the cells' shapes:
    64-byte items read a position's channels in whole sectors, where 16-byte
    ones at a position's stride moved twice the bytes; past 128 KiB a block
    the re-reads, which the L2 cache serves, beat a full shared memory."""
    B, C, H, W = x.shape
    P, es = H * W, x.element_size()
    nhwc = _layout(x) == "nhwc"
    span = C if nhwc else P
    vec = NORM_VECTOR_BYTES // es
    while vec > 1 and (span % vec or x.data_ptr() % (vec * es)):
        vec //= 2
    lanes = 1
    if nhwc and vec * es == NORM_VECTOR_BYTES:
        while (lanes < NORM_MAX_LANES and (C // vec) % (2 * lanes) == 0
               and 2 * B * (C // (vec * 2 * lanes)) * NORM_MAX_TILES >= sms):
            lanes *= 2
    if nhwc:   # a group: `lanes` x `vec` channels, an item a position
        n_items, item_stride, group_stride = P, C, lanes * vec
        groups = C // (lanes * vec)
    else:      # a group: one channel, an item `vec` positions
        n_items, item_stride, group_stride, groups = P // vec, vec, P, C
    item_bytes = lanes * vec * es
    tiles = 1
    while tiles < NORM_MAX_TILES and (-(-n_items // tiles) * item_bytes > NORM_TILE_BYTES
                                      or 4 * B * groups * tiles < sms):
        tiles *= 2
    per_block = -(-n_items // tiles)
    return dict(vec=vec, lanes=lanes, n_items=n_items, per_block=per_block,
                item_stride=item_stride, group_stride=group_stride, batch_stride=C * P,
                groups=groups, B=B, tiles=tiles, combine=int(not nhwc),
                cached=int(per_block * item_bytes <= NORM_CACHE_BYTES), count=float(P))


def instance_norm_cuda(x, eps, relu):
    """The operator's CUDA implementation, one launch of
    `csrc/instance_norm.cu` on the current stream: the norm in x's dtype and
    layout, allocated here."""
    p = launch_params(x, sm_count(x.device.index))
    out = torch.empty_like(x)   # x's strides: a dense layout is kept
    dev = x.device
    with torch.cuda.device(dev):
        err = entry(SOURCE, "rnnpose_instance_norm", _ARGS)(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), p["vec"], p["lanes"],
            p["n_items"], p["per_block"], p["item_stride"], p["group_stride"],
            p["batch_stride"], p["groups"], p["B"], p["tiles"], p["combine"], p["cached"],
            p["count"], eps, int(relu), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "instance norm")
    return out


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """`instance_norm`'s contract in plain PyTorch, on any device and under
    autograd: the chain of ops `models/raft.InstanceNorm` ran before the
    operator, then F.relu with `relu`."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return F.relu(y) if relu else y
