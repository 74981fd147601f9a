"""A group of N local ranks: torch.distributed processes on one host.

Counterpart of the JAX package's meshes (photo_slam_tpu/parallel/
sharding.py::make_mesh, make_gp_mesh): where JAX lays a Mesh over the
devices of one process, the port runs one process per rank and a
torch.distributed process group joins them. spawn_local starts exactly
the ranks a run needs, so the group of a run is the world
(`dist.group.WORLD`), where JAX takes the first n of its devices.

  * `spawn_local(fn, world_size, backend=..., device=...)` starts
    `world_size` processes with the spawn start method (CUDA cannot be
    forked once initialized, and a parent may hold threads), joins them in
    a process group at a free localhost port, runs fn(rank, world_size,
    *args) in each and returns the ranks' results, tensors as numpy. A
    rank that raises, dies or outlasts `timeout` makes it raise in the
    parent with that rank's traceback; the other ranks are stopped.

`device` is explicit: "cuda:<local rank>" where each rank has a card
("cuda:{rank}" is formatted per rank), "cuda:0" for every rank on one card
(gloo only: NCCL needs a card per rank), or "cpu". A child sets it as its
current CUDA device; on the CPU it runs torch with one intra-op thread.
`fn` is pickled by reference, so it lives in an importable module: a
child imports nothing but what fn's module imports.
"""
from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from photo_slam_tpu_torch.parallel.collectives import map_tensors

# How often the parent looks at its children while it waits.
POLL_S = 0.2
# Seconds a child that has reported gets to exit, and a terminated child
# gets before it is killed.
STOP_GRACE_S = 5.0


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(tree):
    """Tensors (nested in tuples, lists, NamedTuples and dicts) as numpy
    arrays; other leaves as they are."""
    return map_tensors(lambda t: t.detach().cpu().numpy(), tree)


def rank_device(device: str, rank: int) -> torch.device:
    """The device of `rank`: `device` with "{rank}" formatted."""
    return torch.device(device.format(rank=rank))


def _worker(rank, world_size, fn, args, backend, device, port, timeout,
            results):
    """One rank: join the group, run fn, report ("ok", rank, result) or
    ("error", rank, traceback)."""
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = to_numpy(fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException:  # reported to the parent, which raises
        results.put(("error", rank, traceback.format_exc()))


def _stop(procs, grace: float) -> None:
    """End every child: let each exit within `grace` seconds, then
    terminate it, then kill it if it has not exited STOP_GRACE_S later."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(STOP_GRACE_S)
        if p.is_alive():
            p.kill()
            p.join()


def spawn_local(fn, world_size: int, *, backend: str, device: str,
                args: tuple = (), timeout: float = 300.0) -> list:
    """Run fn(rank, world_size, *args) in `world_size` spawned processes
    joined in a `backend` process group ("gloo" or "nccl"), each on
    `device` (see the module docstring). Returns [result of rank 0, ...]
    with tensors as numpy. Raises RuntimeError with the rank's traceback if
    a rank raises or dies, TimeoutError if the ranks have not all reported
    within `timeout` seconds (also each collective's timeout); every child
    has exited when it returns or raises."""
    if backend == "nccl" and len({str(rank_device(device, r))
                                  for r in range(world_size)}) < world_size:
        raise ValueError(f"spawn_local: NCCL needs a card per rank; "
                         f"device {device!r} for {world_size} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        r, world_size, fn, args, backend, device, port, timeout, results))
        for r in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size:
            try:
                status, rank, out = results.get(timeout=POLL_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spawn_local: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world_size)) - set(got))
                    raise TimeoutError(f"spawn_local: ranks {late} did not "
                                       f"finish within {timeout} s")
                continue
            if status == "error":
                raise RuntimeError(f"spawn_local: rank {rank} of "
                                   f"{world_size} failed:\n{out}")
            got[rank] = out
    finally:
        _stop(procs, STOP_GRACE_S if len(got) == world_size else 0.0)
        results.close()
    return [got[r] for r in range(world_size)]
