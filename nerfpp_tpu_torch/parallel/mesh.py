"""Ray-batch data parallelism over ``torch.distributed`` (port of
nerfpp_tpu/parallel/mesh.py).

The JAX package is one process over a 1-D device mesh under SPMD: the
parameters are replicated, the ray batch is sharded over the "data" axis
and XLA inserts the gradient all-reduce. PyTorch's idiom is one process per
device in a process group (NCCL on ``cuda:<rank>``, gloo on the CPU), so
here a ``Mesh`` is a rank's view of that group: its world size, rank,
device and group. The train step (executor.py) gives each rank its rows
(``shard_rays``), sums the gradients in ONE all-reduce whose dtype it owns
(``all_reduce_grads``), and every rank applies the same update; parameters,
Adam moments and the occupancy grid start equal (``replicate``) and stay
equal. ``launch`` starts the ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# a collective that waits longer fails its rank (a peer died or hung)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D data-parallel mesh (the ``DATA_AXIS``)."""
    world: int
    rank: int
    device: torch.device
    group: Any = None          # the process group; None only in tests

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, group=self.group)
        return x

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def all_gather_rows(self, x: torch.Tensor, counts) -> torch.Tensor:
        """Every rank's ``x`` ([counts[rank], ...]) concatenated in rank
        order; ranks may hold different row counts (padded to the largest
        for the collective)."""
        m = max(counts)
        pad = x.new_zeros((m, *x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in range(self.world)]
        dist.all_gather(parts, pad, group=self.group)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (same shape on every rank), in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the initialised default process group. ``n_devices``,
    when given, must be its world size. ``device``: this rank's device
    (default: ``cuda:<current>`` under NCCL, the CPU otherwise)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel.mesh.launch)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a {n_devices}-device mesh needs a process group "
                         f"of {n_devices} ranks, not {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(world, dist.get_rank(), torch.device(device),
                dist.group.WORLD)


def rank_rows(n: int, world: int, rank: int, unit: int = 1) -> tuple:
    """Rank ``rank``'s rows [lo, hi) of ``n`` among ``world``: contiguous
    runs of whole ``unit``-row tiles in rank order, the tiles dealt out as
    evenly as they go."""
    tiles = n // unit
    return (rank * tiles // world * unit,
            (rank + 1) * tiles // world * unit)


def _check_rows(k: str, n: int, world: int) -> None:
    if n % world:
        # fail loudly: uneven row sharding would leave ragged per-device
        # batches (the CLI pre-checks NRand; this guards every other entry
        # point with the same clear message)
        raise ValueError(
            f"batch array '{k}' has leading dim {n}, not divisible by the "
            f"{world}-device data-parallel mesh; pick NRand as a multiple of "
            f"the device count")


def shard_rays(batch: dict, mesh: Optional[Mesh], unit: int = 1) -> dict:
    """This rank's rows of every per-ray array of ``batch`` (rank_rows,
    whole ``unit``-row tiles); scalars (cone_angle) are kept. Raises when a
    leading dimension does not divide by the world size. No-op without a
    mesh."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v) and v.ndim >= 1:
            _check_rows(k, v.shape[0], mesh.world)
            lo, hi = rank_rows(v.shape[0], mesh.world, mesh.rank, unit)
            out[k] = v[lo:hi]
        else:
            out[k] = v
    return out


def replicate(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Broadcast each tensor from rank 0, in place (parameters, Adam
    moments and count, the occupancy grid)."""
    if mesh is None:
        return
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)


def all_reduce_grads(params: Dict[str, torch.Tensor], mode: str,
                     mesh: Optional[Mesh]) -> None:
    """Sum every parameter's ``.grad`` over the ranks in ONE all-reduce:
    the gradients packed into a flat f32 buffer in sorted name order (a
    missing gradient packs as zeros), cast to bf16 for ``mode="bf16"`` (half
    the bytes; the f32 Adam update is unchanged) or kept f32, reduced, cast
    back and unpacked into ``.grad``."""
    if mesh is None or mesh.world == 1:
        return
    if mode not in ("bf16", "f32"):
        raise ValueError(f"unknown all-reduce dtype {mode!r}")
    names = sorted(params)
    flat = torch.cat([(params[k].grad if params[k].grad is not None
                       else torch.zeros_like(params[k])).reshape(-1).float()
                      for k in names])
    buf = flat.to(torch.bfloat16) if mode == "bf16" else flat
    mesh.all_reduce(buf)
    flat = buf.float()
    o = 0
    for k in names:
        p = params[k]
        n = p.numel()
        p.grad = flat[o:o + n].view(p.shape).to(p.dtype)
        o += n


# --------------------------------------------------------------- launcher

@contextlib.contextmanager
def one_rank(device="cuda"):
    """A process group of this process alone (world 1; NCCL on the card,
    gloo on the CPU) and its mesh, for the ``with`` block; the group is
    destroyed after it."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="nerfpp_mesh_") as tmp:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=1, rank=0, timeout=COLLECTIVE_TIMEOUT)
        try:
            yield make_mesh(device=dev)
        finally:
            dist.destroy_process_group()


def _host(x):
    """Tensors to numpy (bf16 as f32) through lists, tuples and dicts."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _worker(fn, rank, world, init, backend, device, args, results,
            threads):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=COLLECTIVE_TIMEOUT)
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, _host(out)))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))


def launch(fn: Callable, n: int, device="cuda", *args,
           backend: Optional[str] = None,
           timeout: Optional[float] = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, each its own spawned process
    in a fresh process group, and return each rank's result (tensors as
    numpy) in rank order. ``device``: ``"cuda"`` puts rank r on ``cuda:r``,
    ``"cuda:i"`` every rank on card i, ``"cpu"`` the CPU (the caller's
    torch threads split between the ranks). ``backend``: NCCL on the card,
    gloo on the CPU by default. The ranks meet at a file store in a fresh
    temporary directory, so launches never share a rendezvous. A
    collective that waits longer than COLLECTIVE_TIMEOUT fails its rank; a
    rank that fails or dies stops the others; past ``timeout`` seconds
    (None: no limit) every rank is stopped and TimeoutError raised. ``fn``
    and ``args`` must pickle (``fn`` a module-level function)."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="nerfpp_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, args=(
            fn, r, n, init, backend, str(device), args, results,
            max(1, torch.get_num_threads() // n)))
            for r in range(n)]
        for pr in procs:
            pr.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        done = False
        try:
            while len(out) + len(errors) < n and not errors:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {fn.__name__} did not "
                                       f"finish within {timeout} s")
                try:
                    kind, rank, val = results.get(timeout=0.2)
                except queue.Empty:
                    for r, pr in enumerate(procs):
                        if (pr.exitcode not in (None, 0)
                                and r not in out and r not in errors):
                            errors[r] = f"exited with code {pr.exitcode}"
                    continue
                (out if kind == "ok" else errors)[rank] = val
            done = not errors
        finally:
            # a finished rank exits by itself; after a failure or the
            # deadline the others are stopped at once
            for pr in procs:
                pr.join(timeout=10.0 if done else 0.0)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
            results.close()
    if errors:
        raise RuntimeError(f"rank(s) {sorted(errors)} of {fn.__name__} "
                           "failed:\n" + "\n".join(
                               f"[rank {r}] {e}"
                               for r, e in sorted(errors.items())))
    return [out[r] for r in range(n)]
