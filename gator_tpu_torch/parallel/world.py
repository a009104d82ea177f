"""Data parallelism over processes, one per card (counterpart of
gator_tpu/parallel/mesh.py).

The JAX package's one parallel axis is data parallelism: the batch is
sharded over the mesh, the state replicated, and GSPMD computes the same
function as a one-device step on the whole global batch. The port runs one
process per card, launched by `torchrun`
(`torchrun --standalone --nproc_per_node=N -m gator_tpu_torch.cli.train
...`), over NCCL on the card and gloo on the CPU. Each rank holds rows
[r*b, (r+1)*b) of every global batch (`local_rows`), the model is
broadcast from rank 0 once (`broadcast_module`), and the gradients are
summed over the ranks in one flat f32 bucket and divided by the world size
(`all_reduce_grads`): a plain all-reduce, because the train steps call the
model's submodules and the fused forward directly, so the
DistributedDataParallel wrapper's reducer, primed in its own `forward`,
would not see them.

Without torchrun's variables (no WORLD_SIZE) `init_world` returns world 1
with no process group, and every collective here is the identity: the
one-device path. There is no fallback: a rank without its card, or a
world on more ranks than cards, raises.

Not ported: the scan dispatch's `superbatch_sharding` and `stack_batches`,
`EpochDeviceStream`, and the multi-slice mesh (`n_slices > 1`); ROADMAP.md
says why.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import os.path as osp
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises
DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the data-parallel ranks. `backend` is
    None where there is no process group (world 1 without torchrun);
    `host_group` is a gloo group for host-side flags (the SIGTERM flag),
    so that reading one never waits for the card."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    host_group: Any = None

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def single(device="cpu") -> World:
    """World 1 on `device`, no process group."""
    return World(device=torch.device(device))


def join_world(rank: int, size: int, device, backend: str,
               init_method: str, timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> World:
    """Join a process group (`init_method` as torch.distributed takes it,
    e.g. "file:///tmp/x") as `rank` of `size` on `device`."""
    device = torch.device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, timeout=timeout)
    host = (dist.new_group(backend="gloo", timeout=timeout)
            if backend != "gloo" else dist.group.WORLD)
    return World(rank, size, device, backend, host)


def init_world(device="cuda") -> World:
    """The world torchrun's variables describe (WORLD_SIZE, RANK,
    LOCAL_RANK; the rendezvous at MASTER_ADDR:MASTER_PORT). On the card
    each rank takes cuda:LOCAL_RANK and NCCL; with device "cpu", the CPU
    and gloo. Without WORLD_SIZE: world 1 on `device`, no process group
    (the one-device path)."""
    env = os.environ
    device = torch.device(device)
    if "WORLD_SIZE" not in env:
        return single(device)
    size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        local_size = int(env.get("LOCAL_WORLD_SIZE", size))
        if local >= cards or local_size > cards:
            raise RuntimeError(
                f"rank {rank} (local rank {local} of {local_size}) needs "
                f"a card of its own; this host has {cards}")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no data-parallel backend for {device}")
    return join_world(rank, size, device, backend, "env://")


def close_world(world: World) -> None:
    if world.grouped and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def launched(device="cuda"):
    """`init_world(device)` for the length of a CLI run, the process group
    destroyed after it."""
    world = init_world(device)
    try:
        yield world
    finally:
        close_world(world)


def main_print(world: Optional[World]) -> Callable:
    """print on rank 0; a no-op on the others."""
    if world is None or world.is_main:
        return print
    return lambda *args, **kwargs: None


# --- the batch ------------------------------------------------------------

def _leading(batch) -> int:
    if isinstance(batch, dict):
        sizes = {k: len(v) for k, v in batch.items()}
        n = next(iter(sizes.values()))
        bad = {k: s for k, s in sizes.items() if s != n}
        if bad:
            raise ValueError(
                f"every leaf must share the leading batch dim {n}; got "
                f"{dict(list(bad.items())[:3])}")
        return n
    return len(batch)


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def local_rows(batch, world: Optional[World]):
    """Rank r's rows [r*b, (r+1)*b) of a global batch (a dict of host
    arrays or tensors, or one of them), b = B / world size (the
    counterpart of `shard_batch` on `batch_sharding`). A batch that does
    not divide by the world size raises, as JAX's sharding does."""
    if world is None or world.size == 1:
        return batch
    n = _leading(batch)
    if n % world.size:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{world.size} ranks")
    b = n // world.size
    lo = world.rank * b
    return _map(batch, lambda x: x[lo:lo + b])


def pad_to_multiple(batch, multiple: int):
    """Pad the leading dim up to a multiple (repeating the last element) so
    a ragged last batch still divides over the ranks -> (padded batch,
    original size). Every leaf must share the leading dim."""
    n = _leading(batch)
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def _pad(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

    return _map(batch, _pad), n


# --- collectives ------------------------------------------------------------

def broadcast_module(module: torch.nn.Module,
                     world: Optional[World]) -> torch.nn.Module:
    """Every parameter and buffer from rank 0 (the counterpart of
    `replicate`), in place."""
    if world is None or not world.grouped:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_reduce_grads(params: Sequence[torch.Tensor],
                     world: Optional[World]) -> None:
    """The mean over the ranks of every parameter's gradient: one flat f32
    bucket, summed, divided by the world size, copied back. Every rank
    must hold gradients for the same parameters."""
    if world is None or not world.grouped:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat /= world.size
    # back in multi-tensor launches, not a copy_ launch a parameter
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(parts, grads)])


def all_reduce_mean(values: Dict[str, torch.Tensor],
                    world: Optional[World]) -> Dict[str, torch.Tensor]:
    """Scalars averaged over the ranks, in one all-reduce."""
    if world is None or not world.grouped or not values:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in
                        values.values()])
    dist.all_reduce(flat)
    flat /= world.size
    return dict(zip(values, flat.unbind()))


def all_reduce_sum_(t: torch.Tensor, world: Optional[World]
                    ) -> torch.Tensor:
    """t summed over the ranks, in place."""
    if world is not None and world.grouped:
        dist.all_reduce(t)
    return t


def any_rank(flag: bool, world: Optional[World]) -> bool:
    """True on every rank when `flag` is on any (an all-reduce with max on
    the host group: no wait for the card)."""
    if world is None or not world.grouped:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.host_group)
    return bool(t.item())


def broadcast_object(obj, world: Optional[World]):
    """Rank 0's `obj` (picklable) on every rank."""
    if world is None or not world.grouped:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=world.host_group)
    return box[0]


def barrier(world: Optional[World]) -> None:
    if world is not None and world.grouped:
        dist.barrier(group=world.host_group)


def all_gather_rows(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """Every rank's x (equal shapes) joined along dim 0 in rank order, on
    every rank. gloo gathers host tensors only, so a CUDA tensor goes
    through the host there."""
    if world is None or not world.grouped:
        return x
    src = x.detach().contiguous()
    if world.backend == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world.size)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


class SumOverRanks(torch.autograd.Function):
    """x summed over the ranks, differentiable: the backward sums the
    incoming gradient over the ranks as well (each rank's x feeds every
    rank's loss)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def sum_over_ranks(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    if world is None or not world.grouped:
        return x
    return SumOverRanks.apply(x)


# --- processes on one host (tests, checks, the dryrun) ----------------------

def _to_host(out):
    if isinstance(out, torch.Tensor):
        t = out.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(v) for v in out)
    return out


def _rank_main(fn, rank, size, backend, init_file, device, args, results,
               timeout_s):
    world = None
    try:
        device = torch.device(device)
        if device.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        world = join_world(rank, size, device, backend,
                           f"file://{init_file}", timeout_s)
        results.put((rank, True, _to_host(fn(world, *args))))
    except Exception:   # relayed to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if world is not None:
            close_world(world)


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          devices: Sequence[str] | str = "cpu", args: tuple = (),
          timeout: float = 120.0) -> List[Any]:
    """Run `fn(world, *args)` in `world_size` new processes (the spawn
    method; `fn` must be importable by its module's name), joined by a
    `file://` rendezvous -> each rank's return value, tensors as numpy
    arrays, in rank order. `devices`: one device for every rank, or one
    per rank. A rank that raises fails the call with its traceback; once
    `timeout` seconds have passed every child is killed and the call
    raises TimeoutError. Nothing is left running when it returns."""
    if isinstance(devices, str):
        devices = [devices] * world_size
    tmp = tempfile.mkdtemp(prefix="gator_rdzv_")
    init_file = osp.join(tmp, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, init_file,
                               devices[r], args, results, timeout))
             for r in range(world_size)]
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world_size - len(got)} of {world_size} ranks "
                    f"did not finish in {timeout:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world_size)]
