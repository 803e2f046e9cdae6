"""Sequence parallelism across ranks (the port's counterpart of
``craft_tpu.parallel.sp``): the query rows of the O(U^2) attention and
correlation tensors are split across ranks, one process per rank, joined by
``torch.distributed``.  Its group also joins the ranks of data-parallel
training (``parallel/data_parallel.py``, the one other module of the port
that calls ``torch.distributed``).

A run has one ``SeqParallel`` group per process: ``init`` makes it from
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, ...), or
as one rank over an in-memory store when there is none, or from a store the
caller gives (the CPU tests: a FileStore).  A rank runs on
``cuda:(LOCAL_RANK % device_count)`` unless the caller asks for the CPU.
The backend follows from where the ranks run, which every rank learns from
the store (``placement_backend``): NCCL when every rank has a card that no
other rank shares, gloo when ranks share a card or run on the CPU.  That is
a choice of transport; the work stays on the rank's device either way.

Per forward, ``SeqParallel.shard(H8, W8)`` gives this rank's ``RowShard``
of the H8 x W8 token grid: whole grid rows, split as evenly as they go (the
first H8 % n ranks take one row more), with the collectives the model
needs:
  all_max      the clamp predicate: the shards' raw score maxima;
  all_sum      the volume moments, fp64: B9's sums, and the two passes of
               layer_norm_moments, the (mean, centred second moment) per
               (batch, plane) of a row-sharded fp32 volume that
               ``build_pyramid``'s global norm takes;
  gather       a row-sharded [B, U_local, C] tensor to every rank as
               [B, U, C]: each rank writes its rows into a zero-filled
               buffer, then one all-reduce SUM (x + 0 is exact, so the
               result is every rank's rows as computed).
"""

from __future__ import annotations

import atexit
import os
from typing import Optional

import torch
import torch.distributed as dist

from craft_tpu_torch import resolve_device

# Elements of a volume summed in fp64 at a time by layer_norm_moments: the
# fp64 copy of a chunk is 128 MB, however large the shard's volume.
MOMENT_CHUNK = 1 << 24


def row_split(H8: int, world: int, rank: int) -> tuple:
    """Grid rows [h0, h1) of `rank` when H8 rows are split over `world`
    ranks: the first H8 % world ranks take one row more."""
    base, extra = divmod(H8, world)
    h0 = rank * base + min(rank, extra)
    return h0, h0 + base + (rank < extra)


class RowShard:
    """This rank's rows of one H8 x W8 token grid and the collectives over
    the group.  Token tensors are [B, U, ...] (U = H8 * W8 row-major)."""

    def __init__(self, group: "SeqParallel", H8: int, W8: int):
        if H8 < group.world:
            raise ValueError(f"sequence parallelism: {H8} grid rows over "
                             f"{group.world} ranks leaves a rank none")
        self.group, self.H8, self.W8 = group, H8, W8
        self.h0, self.h1 = row_split(H8, group.world, group.rank)
        self.u0, self.u1 = self.h0 * W8, self.h1 * W8

    @property
    def rows(self) -> int:
        return self.h1 - self.h0

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tokens of x [B, U, ...]."""
        return x[:, self.u0:self.u1]

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """x reduced in place over every rank by `op` (a dist.ReduceOp)."""
        dist.all_reduce(x, op=op)
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max of a 0-d tensor over every rank."""
        return self._all_reduce(x.reshape(1).clone(), dist.ReduceOp.MAX)[0]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank (in fp64)."""
        return self._all_reduce(x.double().clone(), dist.ReduceOp.SUM)

    def layer_norm_moments(self, vol: torch.Tensor) -> tuple:
        """(mean, var) [B, D, 1] fp32 of a row-sharded volume vol
        [B, D, N_local], the shard's rows against every key, over every
        rank's elements (``ops/corr.py:global_layer_norm``'s two passes):
        the mean from fp64 sums, then the mean square of vol - mean, each
        summed in fp64 a chunk of MOMENT_CHUNK elements at a time and over
        the ranks by all_sum."""
        def total(fn):
            return self.all_sum(sum(fn(c).sum(-1, dtype=torch.float64)
                                    for c in vol.split(MOMENT_CHUNK, -1)))

        count = vol.shape[-1] // self.rows * self.H8
        mean = (total(lambda c: c.double()) / count).float()[..., None]
        var = total(lambda c: (c - mean).double().square()) / count
        return mean, var.float()[..., None]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole grid's tokens [B, U, ...] from every rank's x
        [B, U_local, ...]."""
        full = x.new_zeros((x.shape[0], self.H8 * self.W8, *x.shape[2:]))
        full[:, self.u0:self.u1] = x
        return self._all_reduce(full, dist.ReduceOp.SUM)


class SeqParallel:
    """One process's place in the group: rank, world, device, backend."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard(self, H8: int, W8: int) -> RowShard:
        return RowShard(self, H8, W8)

    def __repr__(self) -> str:
        return (f"SeqParallel(rank {self.rank} of {self.world}, "
                f"{self.backend}, {self.device})")


_GROUP: Optional[SeqParallel] = None


def rank_device(device=None) -> torch.device:
    """The rank's device: the CPU when asked for, else
    cuda:(LOCAL_RANK % device_count) (raises without CUDA)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def placement_backend(store, rank: int, world: int, card: str) -> str:
    """The transport for where the ranks run: each rank posts the id of its
    card (its UUID; "" on the CPU) to `store` and reads every rank's.
    NCCL when every rank has a card that no other rank shares, else gloo.
    Every rank reads the same ids, so every rank picks the same backend."""
    store.set(f"sp_card/{rank}", card)
    cards = [store.get(f"sp_card/{r}").decode() for r in range(world)]
    own = all(cards) and len(set(cards)) == world
    return "nccl" if own else "gloo"


def init(device=None, store=None, rank: Optional[int] = None,
         world: Optional[int] = None) -> SeqParallel:
    """This process's group, made on first call and returned as it is
    after.  Without a store: torchrun's environment when it is there, else
    one rank over an in-memory store; with a store, `rank` and `world` are
    the caller's.  Prints the group from rank 0."""
    global _GROUP
    if _GROUP is not None:
        return _GROUP
    dev = rank_device(device)
    if store is None and "MASTER_ADDR" in os.environ:
        store, rank, world = next(dist.rendezvous("env://"))
    elif store is None:
        store, rank, world = dist.HashStore(), 0, 1
    card = (str(torch.cuda.get_device_properties(dev).uuid)
            if dev.type == "cuda" else "")
    backend = placement_backend(store, rank, world, card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    atexit.register(shutdown)
    _GROUP = SeqParallel(rank, world, dev, backend)
    if rank == 0:
        print(f"distributed: {world} rank(s), backend {backend}, rank 0 on "
              f"{dev}", flush=True)
    return _GROUP


def is_main_rank() -> bool:
    """True outside sequence parallelism and on rank 0: the rank that
    prints and writes files."""
    return _GROUP is None or _GROUP.is_main


def shutdown() -> None:
    """Tear the group down (at exit, or before another init)."""
    global _GROUP
    if _GROUP is not None and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None
