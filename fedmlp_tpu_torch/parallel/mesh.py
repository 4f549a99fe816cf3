"""The process mesh: the JAX package's ``Mesh(('client', 'data'))``
(``fedmlp_tpu/parallel/mesh.py``) on ``torch.distributed``, one process a
shard.

A world of C·D processes is a C×D mesh: rank r is client shard c = r // D
and data shard d = r % D, as JAX lays ``devices.reshape(C, D)`` out. Client
shard c trains its block of the client axis padded to a multiple of C
(``client_block``); the D data shards of one client block split each step's
batch. The ranks of one data shard form a client group (the gather of a
round's outputs), the ranks of one client shard a data group (the means of
a data-parallel step).

Backends (``pick_backend``): gloo on the CPU; NCCL on the card when every
rank has a card of its own; gloo when ranks share a card, since NCCL refuses
two ranks on one GPU. Gloo takes CUDA tensors for ``all_gather``, the one
tensor collective used here (on the H100 with torch 2.11: ``chip_smoke.py``'s
``slice_mesh``). The rule is printed when a group
starts, and nothing switches backend after a failure.

``launch`` runs a function in N spawned processes that form one group; a
rank that raises takes the group down (``rank_guard``), and the launcher
raises.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# seconds a collective (and a launch) may wait before the group gives up
DEFAULT_TIMEOUT_S = 900


def world_size() -> int:
    """Processes in the default group; 1 outside one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_rank() -> int:
    """This process's rank in the default group; 0 outside one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def pad_clients(n_clients: int, n_shards: int) -> int:
    """Smallest client count >= ``n_clients`` divisible by the shard count."""
    return -(-n_clients // n_shards) * n_shards


def pick_backend(device, local_world: int) -> str:
    """gloo on the CPU and when the ``local_world`` ranks of a host
    outnumber its cards (they share one); NCCL when each has its own."""
    device = torch.device(device)
    if device.type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _start_group(backend: str, device, timeout_s: float, **kw) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    if dist.get_rank() == 0:
        print(f"mesh: {dist.get_world_size()} processes, backend {backend} (gloo on the "
              "CPU or when ranks share a card, NCCL with a card a rank)", flush=True)


def init_from_env(device, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default group from a launcher's environment (``torchrun``:
    RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when it
    names more than one process and none is started; returns whether a
    group of more than one process is up."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        _start_group(pick_backend(device, local), device, timeout_s, init_method="env://")
    return world_size() > 1


@contextlib.contextmanager
def rank_guard():
    """In a group of more than one process, a rank that raises prints its
    traceback and leaves at once with code 1: its launcher (``launch``,
    ``torchrun``) then stops the others, which would otherwise wait in their
    next collective until the timeout."""
    try:
        yield
    except Exception:
        if world_size() > 1:
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        raise


class Mesh:
    """This process's place in a ``client_shards`` × ``data_shards`` mesh
    and the collectives the engines need. A mesh of one rank has no group:
    its collectives are the identity, and an engine given it runs as under
    any mesh (per-client generators), so a sharded run can be held to it."""

    def __init__(self, client_shards: int = 1, data_shards: int = 1, rank: int = 0,
                 device="cpu"):
        self.client_shards, self.data_shards = int(client_shards), int(data_shards)
        self.size = self.client_shards * self.data_shards
        self.rank = int(rank)
        self.client_rank, self.data_rank = divmod(self.rank, self.data_shards)
        self.device = torch.device(device)
        # the default group serves an axis that spans the world; else every
        # rank takes part in making every group (new_group is collective)
        C, D = self.client_shards, self.data_shards
        self.client_group = self.data_group = None
        if C > 1 and D > 1:
            self.client_group = [dist.new_group([c * D + d for c in range(C)])
                                 for d in range(D)][self.data_rank]
            self.data_group = [dist.new_group([c * D + d for d in range(D)])
                               for c in range(C)][self.client_rank]

    def __repr__(self) -> str:
        return (f"Mesh(client={self.client_shards}, data={self.data_shards}, "
                f"rank={self.rank}, device={self.device})")

    # -------------------------------------------------------------- layout
    def block_size(self, n_clients: int) -> int:
        """Clients a client shard holds, dummies included."""
        return pad_clients(n_clients, self.client_shards) // self.client_shards

    def client_block(self, n_clients: int) -> range:
        """The real clients of this rank's block of the padded client axis
        (empty or short on the last ranks when C does not divide K)."""
        n = self.block_size(n_clients)
        lo = self.client_rank * n
        return range(min(lo, n_clients), min(lo + n, n_clients))

    def data_rows(self, batch_size: int) -> slice:
        """This rank's rows of a step's batch."""
        if batch_size % self.data_shards:
            raise ValueError(f"batch_size={batch_size} does not split over "
                             f"{self.data_shards} data shards")
        b = batch_size // self.data_shards
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    # --------------------------------------------------------- collectives
    @staticmethod
    def _all_gather(t: torch.Tensor, group, n: int) -> list:
        """``n`` tensors like ``t``, one from each rank of ``group``, in
        rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return parts

    def _over_data(self, tensors: list, reduce: str) -> None:
        """``tensors`` in place ← their sum, or mean, over the data group,
        summed in data-rank order (every rank gets the same bits)."""
        if self.data_shards == 1 or not tensors:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            parts = self._all_gather(flat, self.data_group, self.data_shards)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            if reduce == "mean":
                total = total / self.data_shards
            off = 0
            for t in ts:
                t.copy_(total[off:off + t.numel()].view(t.shape))
                off += t.numel()

    def data_mean(self, tensors: list) -> None:
        """JAX's ``pmean`` over the data axis, in place."""
        self._over_data(tensors, "mean")

    def data_sum(self, tensors: list) -> None:
        """JAX's ``psum`` over the data axis, in place."""
        self._over_data(tensors, "sum")

    def gather_clients(self, tree: dict, n_clients: int) -> dict:
        """{name: [n_block, ...]} of this rank's real clients → {name: [K,
        ...]} of all clients, on every rank: each block padded to the block
        size, one gather over the client group a dtype, padding rows dropped."""
        if self.client_shards == 1 or not tree:
            return tree
        n = self.block_size(n_clients)
        by_dtype = {}
        for name, t in tree.items():
            by_dtype.setdefault(t.dtype, []).append(name)
        out = {}
        for dtype, names in by_dtype.items():
            rows = [tree[nm].reshape(tree[nm].shape[0], math.prod(tree[nm].shape[1:]))
                    for nm in names]  # (a block may hold no client: no -1)
            flat = torch.cat(rows, 1) if len(rows) > 1 else rows[0]
            if flat.dtype == torch.bool:
                flat = flat.view(torch.uint8)
            block = flat.new_zeros((n, flat.shape[1]))
            block[:flat.shape[0]] = flat
            full = torch.cat(self._all_gather(block, self.client_group,
                                              self.client_shards))[:n_clients]
            if dtype == torch.bool:
                full = full.view(torch.bool)
            off = 0
            for nm, r in zip(names, rows):
                out[nm] = full[:, off:off + r.shape[1]].reshape(
                    (n_clients,) + tree[nm].shape[1:])
                off += r.shape[1]
        return out

    def gather_client_dicts(self, tree: dict, n_clients: int) -> dict:
        """``gather_clients`` for a dict whose names a rank without clients
        may lack (the aux sums): through pickled copies."""
        if self.client_shards == 1:
            return tree
        mine = (len(self.client_block(n_clients)), {n: t.cpu() for n, t in tree.items()})
        parts = [None] * self.client_shards
        dist.all_gather_object(parts, mine, group=self.client_group)
        template = next((d for _, d in parts if d), {})
        return {nm: torch.cat([d[nm] if d else t.new_zeros((cnt,) + t.shape[1:])
                               for cnt, d in parts]).to(self.device)
                for nm, t in template.items()}


def make_mesh(n_client_shards: int | None = None, data_shards: int = 1,
              device="cpu") -> Mesh:
    """This process's ``Mesh`` over the default group (a world of one
    outside a group). ``n_client_shards`` defaults to world // data_shards;
    the mesh must hold every process of the world."""
    world = world_size()
    if n_client_shards is None or n_client_shards <= 0:
        n_client_shards = max(1, world // data_shards)
    if n_client_shards * data_shards != world:
        raise ValueError(f"a {n_client_shards}x{data_shards} mesh needs "
                         f"{n_client_shards * data_shards} processes, the world has {world}")
    return Mesh(n_client_shards, data_shards, process_rank(), device)


# ----------------------------------------------------------------------
# Launching a group of processes
# ----------------------------------------------------------------------

def _rank_main(rank: int, target, world: int, tmp: str, device: str, timeout_s: float,
               args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    _start_group(pick_backend(device, world), device, timeout_s, store=store, rank=rank,
                 world_size=world)
    with rank_guard():
        out = target(*args)
        dist.barrier()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def launch(target, world: int, args: tuple = (), device: str = "cpu",
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``target(*args)`` in ``world`` spawned processes that form one
    group (a ``FileStore`` in a temporary directory), rank r on ``device``
    (``'cuda'``: card r modulo the cards) with RANK/LOCAL_RANK/WORLD_SIZE
    set; returns each rank's return value (saved with ``torch.save``), in
    rank order. ``target`` must be importable in a new process. Raises if a
    rank raises or dies, stopping the others, and ``TimeoutError`` (the
    processes killed) after ``timeout_s``."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="fedmlp_mesh_")
    ctx = mp.start_processes(_rank_main, args=(target, world, tmp, str(device), timeout_s,
                                               args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a group of {world} did not finish in {timeout_s} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
