"""Process groups and multi-process launches (port of
``parallel/multihost.py``).

- :func:`initialize` starts the default process group: from the ``env://``
  variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) when they are there, else a group of one
  process over an in-memory store.  NCCL on ``cuda:{LOCAL_RANK}`` unless the
  CPU is asked for (gloo); a timeout is always passed.
- :func:`global_mesh` and :func:`global_batch`: the mesh over every rank, and
  the process-local rows of a batch assembled in process order.
- :func:`launch` runs a function on N fresh processes, one rank each, with a
  ``file://`` rendezvous in a temporary directory (no port is picked, so
  parallel launches never collide), a timeout on every wait, every child
  killed on a failure, and each rank's result or its traceback returned.
  Tests, ``chip_smoke.py`` and ``parallel/dryrun.py`` share it.

NCCL cannot put two ranks on one card ("Duplicate GPU detected"), so a
launch on the card takes at most one rank per card.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.parallel.mesh import gather_rows, make_mesh
from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 300.0


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def local_device(device: DeviceLike = None) -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK}`` on the card, else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize(device: DeviceLike = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group unless one is running; returns
    whether this call started it."""
    if dist.is_initialized():
        return False
    dev = local_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    if "WORLD_SIZE" in os.environ:  # torchrun
        dist.init_process_group(_backend(dev), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=timeout, **kwargs)
    else:
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout, **kwargs)
    return True


@contextlib.contextmanager
def process_group(device: DeviceLike = None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """:func:`initialize` for the duration of the block; a group this block
    started is destroyed on exit."""
    started = initialize(device, timeout_s)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def global_mesh(axis_names=("data",), shape=None, device: DeviceLike = None):
    """Mesh over every rank of every host."""
    return make_mesh(shape=shape, axis_names=axis_names, device=device)


def global_batch(local_batch: np.ndarray, mesh, axis: str = "data",
                 device: DeviceLike = None) -> torch.Tensor:
    """The global batch from each process's rows (every process passes its
    own rows, all of one shape; the global batch is their concatenation in
    process order); one process is a plain upload."""
    local = torch.from_numpy(np.ascontiguousarray(local_batch)).to(local_device(device))
    group = mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return local
    return gather_rows(local, group)


# ------------------------------------------------------------------ launch --


def _child(call_path, rank, world, init_method, device_type, timeout_s, results):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
            backend, kwargs = "gloo", {}
        else:
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            backend, kwargs = "nccl", {"device_id": dev}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, n: int, args: Sequence = (), device: DeviceLike = "cpu",
           timeout_s: float = DEFAULT_TIMEOUT_S) -> List[object]:
    """Run ``fn(*args)`` on ``n`` new processes, rank ``r`` of a world of
    ``n`` each, and return their results in rank order.  ``fn`` and
    ``args`` are pickled (``fn`` by import path) to a file the ranks read.
    Raises ``RuntimeError`` with every failed rank's traceback, or when the
    launch outlives ``timeout_s``; every child is gone when this returns or
    raises.  CPU ranks run one intra-op thread each."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards, {torch.cuda.device_count()} present: "
                         "NCCL cannot put two ranks on one card")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="dmm_launch_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    # the call goes through a file: a process's spawn arguments go through a
    # pipe, and arguments past the pipe's buffer would make each start wait
    # for its child's interpreter, one child after another
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_child, args=(call_path, r, n, init_method, dev.type,
                                              timeout_s, results))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    got, failures = {}, []
    try:
        for p in procs:
            p.start()
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    failures.append(f"ranks {dead} died (exit codes "
                                    f"{[procs[r].exitcode for r in dead]})")
                    break
                if time.monotonic() > deadline:
                    failures.append(f"launch of {n} ranks timed out after {timeout_s} s")
                    break
                continue
            got[rank] = value
            if not ok:
                failures.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            if failures:  # the others may wait in a collective until their timeout
                p.kill()
            p.join(timeout=max(1.0, min(30.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise RuntimeError("launch failed: " + "\n".join(failures))
    return [got[r] for r in range(n)]
