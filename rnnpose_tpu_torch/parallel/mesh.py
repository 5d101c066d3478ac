"""The process layer of data parallelism (port of
`rnnpose_tpu/parallel/mesh.py`).

The JAX package drives every chip of a host from one process through a
device mesh, and XLA inserts the gradient psum. In torch each card takes
its own process, so the layer here is `torch.distributed`: one process
per card (the reference's DDP layout), the batch split over the processes,
the parameters broadcast from rank 0, and the gradients averaged in one
flat all-reduce (`all_reduce_mean_`, called by `train/loop.py`).

`batch_size` in a config is the batch of one process, JAX's multi-host
rule: a run of N processes trains on N x batch_size samples per step.

Without a process group every function here is the one-process identity:
`process_index()` 0, `process_count()` 1, no collective.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

__all__ = [
    "TIMEOUT_S",
    "init_distributed",
    "process_index",
    "process_count",
    "rank_device",
    "barrier",
    "broadcast_object",
    "all_gather_object",
    "map_tensors",
    "shard_batch",
    "replicate_params",
    "all_reduce_mean_",
    "launch_local",
]

# The process group's timeout: a collective that waits longer raises. It
# covers the startup skew of a rank that builds its dataset or kernels
# while the others wait at a barrier.
TIMEOUT_S = 1800.0

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "nccl",
                     timeout_s: float = TIMEOUT_S, device: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    With `coordinator_address` ("host:port", rank 0 listens there) the
    group forms over `tcp://` from `num_processes` and `process_id`;
    without it from torchrun's environment (`MASTER_ADDR`, `MASTER_PORT`,
    `RANK`, `WORLD_SIZE`, `env://`). Neither raises ValueError. `backend`
    is used as given: "nccl" needs a CUDA device, "gloo" takes either. The
    device is `rank_device(device)`; under NCCL it becomes the current CUDA
    device before the group forms."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is outside a world of {num_processes}")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init = dict(init_method="env://")
        process_id = int(os.environ["RANK"])
    else:
        raise ValueError(
            "no rendezvous: pass coordinator_address, num_processes and process_id "
            f"(the CLIs' --coordinator_address, --num_processes, --process_id), or launch "
            f"with torchrun, which sets {', '.join(_TORCHRUN_ENV)}")
    dev = rank_device(device, process_id)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **init)
    return dev


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: Optional[str] = None, rank: Optional[int] = None) -> torch.device:
    """The device of this rank: `device` when it names an index (or is not
    CUDA); else `cuda:<LOCAL_RANK>`, LOCAL_RANK from torchrun's environment
    or, launched with the flags, the rank itself (processes 0..N-1 of one
    host on cards 0..N-1)."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else
                        (process_index() if rank is None else rank))


def barrier():
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order ([obj] without a process group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def map_tensors(fn, x):
    """`fn` over every tensor of a batch (tensors, named tuples, lists,
    `PointPyramid`), the structure kept."""
    from ..models.kpconv_net import PointPyramid

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, PointPyramid):
        return PointPyramid(*(map_tensors(fn, ts) for ts in (
            x.points, x.masks, x.neighbors, x.pools, x.upsamples)))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_tensors(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(map_tensors(fn, v) for v in x)
    return x


def shard_batch(batch, batch_size: int, rank: Optional[int] = None,
                world: Optional[int] = None):
    """This rank's part of a batch (JAX's `shard_batch` contract): a
    tensor whose leading dimension is `batch_size` gives rank r its
    contiguous rows [r * b, (r + 1) * b), b = batch_size / world; every
    other tensor (the class's mesh) stays whole; a batch that does not
    split evenly over the ranks stays whole."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if world == 1 or batch_size <= 0 or batch_size % world:
        return batch
    b = batch_size // world

    def part(t):
        return t[rank * b:(rank + 1) * b] if t.dim() >= 1 and t.shape[0] == batch_size else t

    return map_tensors(part, batch)


def replicate_params(module: torch.nn.Module):
    """Broadcast `module`'s parameters and buffers from rank 0 (one
    collective per dtype), so every rank starts from rank 0's values
    whatever it initialised or restored."""
    if not dist.is_initialized():
        return module
    groups = {}
    for t in list(module.parameters()) + list(module.buffers()):
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            _unflatten_into(flat, group)
    return module


def _unflatten_into(flat: torch.Tensor, tensors: Iterable[torch.Tensor]):
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def all_reduce_mean_(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Average `tensors` over the ranks in place: one flat buffer, one
    all-reduce (sum), one division by the world size. The tensors must
    share a dtype and a device. Without a process group nothing happens;
    in a world of one the collective runs and every value comes back
    bit for bit."""
    if not dist.is_initialized() or not tensors:
        return tensors
    if len({(t.dtype, t.device) for t in tensors}) != 1:
        raise ValueError("all_reduce_mean_ takes tensors of one dtype on one device")
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())
        _unflatten_into(flat, tensors)
    return tensors


def launch_local(argv_of: Callable[[int, str], List[str]], n: int, log_dir: str,
                 timeout_s: float, env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run n processes of one process group on this host and return their
    outputs. Process r runs `argv_of(r, addr)`, `addr` a free 127.0.0.1
    port where rank 0 listens, from the directory above the package with
    the package importable, torchrun's variables (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK) out of its environment and `env` in it;
    its output goes to `log_dir/rank<r>.log` (a full pipe would stall a
    rank inside a collective and hang its peers). All are started together
    and waited for under one limit of `timeout_s`; whatever is still
    running then is killed. Raises RuntimeError naming the ranks that failed or ran past
    the limit, with the end of their output."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    penv = {k: v for k, v in os.environ.items() if k not in _TORCHRUN_ENV + ("LOCAL_RANK",)}
    penv.update(env or {})
    penv["PYTHONPATH"] = os.pathsep.join([root] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [os.path.join(log_dir, f"rank{r}.log") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(argv_of(r, addr), cwd=root, env=penv, stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} of {n} failed or ran past {timeout_s} s\n" + "\n".join(
            f"--- rank {r} (exit {procs[r].returncode}):\n{outs[r][-4000:]}" for r in failed))
    return outs
