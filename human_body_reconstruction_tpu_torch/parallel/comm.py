"""Process groups and collectives of the parallel paths: the port's
counterpart of the JAX meshes and of the collectives that ``shard_map``
bodies call.

A run is a world of processes, one per device, joined by
``torch.distributed``: NCCL for CUDA tensors, ``gloo`` for CPU tensors (the
tests).  There is no fallback: a CUDA run whose NCCL group fails to form
raises.  ``init`` joins the world from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from
explicit arguments; ``spawn`` starts a world of processes on this host with
the spawn start method and a ``file://`` rendezvous in a fresh temporary
directory (so concurrent runs never share a TCP port).

``Mesh`` is this process's place in a 2-D (data, inner) layout of the world,
rank = data_index * n_inner + inner_index, as JAX reshapes its devices to
(n_data, n_inner), with the two sub-groups it belongs to: ``data_group``
(the ranks of its inner index, over which rays and gradients are reduced)
and ``inner_group`` (the ranks of its data index: the "level" or "sample"
axis).

The two autograd collectives give the gradients that JAX's transposes
give in the level-parallel step.  ``gather_cols`` joins the column blocks
of the ranks (JAX's tiled ``all_gather``, whose transpose is a
``psum_scatter``): its backward hands each rank the group's sum of its
column block of the cotangent.  The MLP after the gather runs replicated
across the group, so those cotangents are the same on every rank and the
sum is the group's size k times the rank's own block; the backward scales
by k and needs no collective.  ``psum_replicated`` (JAX's ``psum``, whose
transpose is a ``psum``) does the same.  So the sharded group's gradient
(the table's level slices, the lines' rank columns) is k times the
single-device gradient, as JAX's is; Adam's scale invariance takes its
steps back to the single-device ones.

A window of steps captured as a CUDA graph holds these collectives (NCCL
records them into the capture): ``reseed_`` sets a graph's registered
generator to a step's folded stream before each replay, and ``mesh_any``
lets every rank take one decision to capture again.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TIMEOUT = timedelta(minutes=10)


def torchrun_env() -> bool:
    """Did a launcher (torchrun) set this process's rank and world size?"""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device_type: str, *, rank: Optional[int] = None,
         world_size: Optional[int] = None,
         init_method: Optional[str] = None) -> torch.device:
    """Join the world and return this process's device: ``cuda:LOCAL_RANK``
    (or ``cuda:rank`` when spawned) for "cuda", the CPU otherwise.  Without
    ``rank`` the rank, world size and rendezvous come from torchrun's
    environment."""
    if rank is None:
        rank, world_size = (int(os.environ["RANK"]),
                            int(os.environ["WORLD_SIZE"]))
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    else:
        local = rank
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA world needs a CUDA device; none is "
                               "available")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return device


def _worker(rank, world_size, init_method, device_type, fn, args, queue):
    try:
        device = init(device_type, rank=rank, world_size=world_size,
                      init_method=init_method)
        try:
            queue.put((rank, True, fn(device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, args=(), device_type: str = "cpu",
          timeout: Optional[float] = None) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` new processes (spawn
    start method), joined in one world on ``device_type``; returns their
    results in rank order.  ``fn`` and ``args`` are pickled (a module-level
    function).  Raises with the failed ranks' tracebacks, when a rank dies
    without one, or when ``timeout`` seconds pass first; the processes are
    then terminated."""
    ctx = torch.multiprocessing.get_context("spawn")
    results_q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="hbr_rdzv_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    procs = [ctx.Process(target=_worker, args=(r, world_size, init_method,
                                               device_type, fn, args,
                                               results_q))
             for r in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        while len(results) < world_size and not errors:   # drain, then join
            try:
                rank, ok, value = results_q.get(timeout=1.0)
                (results if ok else errors)[rank] = value
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    errors.update({r: f"exited with code {procs[r].exitcode}"
                                   for r in dead})
                elif deadline is not None and time.monotonic() > deadline:
                    errors[-1] = f"no result within {timeout} s"
        for p in procs:
            p.join(timeout=None if not errors else 30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("parallel run failed:\n" + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [results[r] for r in range(world_size)]


@dataclasses.dataclass
class Mesh:
    """This process's place in the (data, inner) layout of the world."""

    shape: tuple            # (n_data, n_inner)
    axis: str               # the inner axis' name: "level" or "sample"
    data_index: int
    inner_index: int
    data_group: object      # ranks sharing this inner index
    inner_group: object     # ranks sharing this data index

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_inner(self) -> int:
        return self.shape[1]


def layout(world: int, data_parallel: bool, level_parallel: int,
           batch: Optional[int] = None) -> tuple:
    """(n_data, n_level) of a run over ``world`` ranks (JAX: a mesh over the
    visible devices): k = max(level_parallel, 1) level ranks, and with
    ``data_parallel`` as many data ranks as the world holds level groups,
    else one.  Raises ValueError when the world cannot hold it or ``batch``
    does not divide by n_data (JAX's message)."""
    n_level = max(level_parallel, 1)
    n_data = world // n_level if data_parallel else 1
    if n_data < 1 or n_data * n_level > world:
        raise ValueError(f"mesh {max(n_data, 1)}x{n_level} needs more than "
                         f"the {world} ranks")
    if batch is not None and batch % n_data:
        raise ValueError(f"batch_size {batch} not divisible by the "
                         f"data-axis extent {n_data}")
    return n_data, n_level


def make_mesh(n_data: int, n_inner: int = 1,
              axis: str = "level") -> Optional[Mesh]:
    """The (n_data, n_inner) layout over the world's first n_data * n_inner
    ranks (JAX: the first devices); None on a rank outside it.  Every rank
    calls it (each sub-group is made by every rank, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data < 1 or n_inner < 1 or n_data * n_inner > world:
        raise ValueError(f"mesh {n_data}x{n_inner} needs more than the "
                         f"{world} ranks")
    data_groups = [dist.new_group([d * n_inner + i for d in range(n_data)])
                   for i in range(n_inner)]
    inner_groups = [dist.new_group([d * n_inner + i for i in range(n_inner)])
                    for d in range(n_data)]
    if rank >= n_data * n_inner:
        return None
    d, i = divmod(rank, n_inner)
    return Mesh((n_data, n_inner), axis, d, i, data_groups[i],
                inner_groups[d])


def _folded_seed(*words: int) -> int:
    seed = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(seed) >> 1


def fold_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from the words (seed, step, axis
    indices, ...): the port's ``fold_in``.  Distinct words give unrelated
    streams; the same words the same stream on every rank."""
    return torch.Generator(device).manual_seed(_folded_seed(*words))


def reseed_(generator: torch.Generator, *words: int) -> torch.Generator:
    """Set ``generator``, in place, to the stream ``fold_generator`` gives
    for the words.  A generator registered with a captured graph keeps its
    identity, and a replay reads the seed and offset set here when it
    starts, so it draws what a step on a fresh folded generator draws."""
    return generator.manual_seed(_folded_seed(*words))


def all_gather_stack(x, group):
    """(n, *x.shape): every rank's ``x`` in group-rank order (no gradient),
    gathered into one new buffer (inside a capture, from the graph's
    pool)."""
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
    return out.view(n, *x.shape)


def mesh_any(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank of the mesh when ``flag`` is true on any: one
    all-reduce (max) on each of the mesh's groups.  It also has NCCL create
    both groups' communicators, which it makes at a group's first
    collective, and which must not be made inside a capture."""
    t = torch.tensor([int(flag)], device=device)
    for group in (mesh.inner_group, mesh.data_group):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.index, ctx.width = dist.get_rank(group), x.shape[1]
        ctx.k = dist.get_world_size(group)
        return torch.cat(list(all_gather_stack(x, group)), dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[:, lo:lo + ctx.width] * ctx.k, None


def gather_cols(x, group):
    """(N, c) on each of the group's n ranks -> (N, n * c), the ranks' column
    blocks in group-rank order; the backward gives each rank the group's sum
    of its block of the (replicated) cotangent, n times its own block."""
    return _GatherCols.apply(x, group)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.k = dist.get_world_size(group)
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.k, None


def psum_replicated(x, group):
    """The group's sum of ``x``; its backward gives the group's sum of the
    cotangent (the same on every rank of a replicated computation), n times
    the rank's own."""
    return _PsumReplicated.apply(x, group)


def all_reduce_mean_(tensors, group, n: int):
    """Replace each tensor by its mean over the group's n ranks, in place,
    through one flat buffer: one all-reduce (sum) then a division by n, as
    JAX's pmean."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_(tensors, src: int = 0, group=None):
    """Overwrite each tensor with global rank ``src``'s, in place."""
    for t in tensors:
        dist.broadcast(t, src, group=group)
