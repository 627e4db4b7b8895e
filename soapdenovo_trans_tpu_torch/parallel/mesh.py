"""A single-process mesh of per-shard tensors.

This module has no counterpart in the JAX package: it stands in for
what that package takes from JAX itself — ``jax.sharding.Mesh``,
``shard_map`` and ``jax.lax.all_to_all``.  The shape of the program is
kept: ONE process drives D shards, the host reads a batch and hands
each shard its part.

* ``Mesh(devices)`` — D = ``len(devices)`` shards, shard ``s`` on
  ``devices[s]``.  Entries may repeat: ``[cuda:0] * 4`` is four logical
  shards on one card, ``[cpu] * 8`` eight shards on the host,
  ``[cuda:0, cuda:1, cuda:2, cuda:3]`` four cards.  One code path
  serves all three.
* A sharded array is a ``list`` of D tensors, shard ``s`` on
  ``devices[s]``; the JAX package's leading ``(D, ...)`` axis is the
  list.  ``mesh.map(fn, *sharded)`` calls ``fn(s, *shards)`` for every
  shard with that shard's device current (``shard_map``;
  ``jax.lax.axis_index`` is the argument ``s``).
* ``mesh.all_to_all(send)`` — ``send[j][s]`` is what shard ``j`` sends
  to shard ``s``; returns ``recv[s][j]``.  The exchange is RAGGED:
  every piece has its exact length, so there is no bucket capacity, no
  overflow counter and no retry with a doubled bucket.  The JAX package
  has all three only because XLA needs static shapes, and its results
  never depend on the capacity.  The price is that the piece lengths
  are read on the host (``to_host``) before the pieces are cut: one
  host read for each distinct device and exchange.

A piece moves with ``Tensor.to(device)``: nothing is copied where
source and target are the same device, and a copy between two cards is
asynchronous and ordered by torch on the current streams of both.  A
copy to the host waits for its data.

What the mesh does is in the run's record (``utils/profiling``): the
spans ``mesh.route`` (``route``: the bucketing and the blocking host
read of the sizes) and ``mesh.exchange`` (``all_to_all``: the enqueue of
the pieces), and the counters ``mesh.exchanges``, ``mesh.exchange_bytes``
(the pieces moved between different shards), ``mesh.peer_bytes`` (every
byte a method of the mesh copies from one card to another: exchanged
pieces, ``to_shard``, ``gather_rows``, ``replicate``; 0 on logical
shards of one card) and ``mesh.shards`` (the largest mesh that
exchanged).  Nothing of it synchronizes a device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from ..utils import profiling

Sharded = List[torch.Tensor]


def _move(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``; asynchronous only towards a card (the host
    must not read a copy that is still in flight)."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


def _peer_bytes(x: torch.Tensor, device) -> int:
    """Bytes that moving ``x`` to ``device`` copies from one card to
    another: 0 where either end is the host or both are one card."""
    device = torch.device(device)
    if x.device.type != "cuda" or device.type != "cuda" or \
            x.device.index == (device.index if device.index is not None
                               else torch.cuda.current_device()):
        return 0
    return x.numel() * x.element_size()


class Route(NamedTuple):
    """The bucketing of every shard's records by owner shard."""

    order: Sharded           # per shard: the stable sort's permutation
    sizes: List[List[int]]   # sizes[j][s]: records of shard j owned by s


def bucket_by_owner(owner: torch.Tensor, n_dest: int):
    """One stable sort by owner.  owner: (m,) in [0, n_dest], n_dest
    meaning "to no shard".  Returns (order (m,), start (n_dest + 1,)):
    the records of destination t are ``order[start[t]:start[t + 1]]``,
    in their input order.  The order inside a bucket decides nothing
    for a caller that puts answers back by ``order``."""
    srt = torch.sort(owner.to(torch.int16), stable=True)
    start = torch.searchsorted(srt.values, torch.arange(
        n_dest + 1, dtype=torch.int16, device=owner.device))
    return srt.indices, start


class Mesh:
    """D shards over ``devices`` (entries may repeat)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(x) for x in devices]
        if not 0 < len(self.devices) < 2 ** 15:  # owners sort as int16
            raise ValueError("a mesh needs 1 to 32767 devices")
        self.d = len(self.devices)
        # what the exchanges of this mesh moved between different
        # shards so far (pieces a shard keeps for itself not counted)
        self.exchanges = 0
        self.exchange_bytes = 0

    def __repr__(self) -> str:
        return f"Mesh({[str(x) for x in self.devices]})"

    def on(self, s: int):
        """Context in which shard ``s``'s device is the current one."""
        dev = self.devices[s]
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def map(self, fn: Callable, *sharded) -> list:
        """[fn(s, *(x[s] for x in sharded)) for every shard s]."""
        out = []
        for s in range(self.d):
            with self.on(s):
                out.append(fn(s, *(x[s] for x in sharded)))
        return out

    def all_to_all(self, send: List[list]) -> List[list]:
        """send[j][s] -> recv[s][j], each piece moved to shard s's
        device."""
        recv = [[None] * self.d for _ in range(self.d)]
        moved = peer = 0
        with profiling.span("mesh.exchange"):
            for j in range(self.d):
                for s in range(self.d):
                    piece = send[j][s]
                    if j != s:
                        moved += piece.numel() * piece.element_size()
                        peer += _peer_bytes(piece, self.devices[s])
                    recv[s][j] = _move(piece, self.devices[s])
        self.exchanges += 1
        self.exchange_bytes += moved
        profiling.counter("mesh.exchanges", 1)
        profiling.counter("mesh.exchange_bytes", moved)
        profiling.counter("mesh.peer_bytes", peer)
        profiling.counter_max("mesh.shards", self.d)
        return recv

    def route(self, owner: Sharded) -> Route:
        """Bucket every shard's records by ``owner`` ((m,) in [0, D], D
        for "to no shard") and read the bucket sizes on the host."""
        with profiling.span("mesh.route"):
            plans = self.map(lambda s, o: bucket_by_owner(o, self.d),
                             owner)
            starts = self.to_host([p[1] for p in plans])
            sizes = [[int(st[t + 1] - st[t]) for t in range(self.d)]
                     for st in starts]
        return Route([p[0] for p in plans], sizes)

    def send(self, route: Route, payload: Sharded) -> List[list]:
        """Cut every shard's payload ((m, ...) beside its owners) into
        its per-owner pieces and exchange them: returns recv[s][j], the
        records of shard j owned by shard s."""
        def cut(j, order, x):
            n = sum(route.sizes[j])
            return list(torch.split(x[order[:n]], route.sizes[j]))

        return self.all_to_all(self.map(cut, route.order, payload))

    def to_host(self, xs: Sharded) -> List[np.ndarray]:
        """Equal-shaped per-shard tensors -> numpy arrays, with one
        device read for each distinct device."""
        out = [None] * self.d
        for dev in dict.fromkeys(self.devices):
            mine = [s for s in range(self.d) if self.devices[s] == dev]
            host = torch.stack([xs[s] for s in mine]).cpu().numpy()
            for i, s in enumerate(mine):
                out[s] = host[i]
        return out

    def replicate(self, x: torch.Tensor) -> Sharded:
        """``x`` on every shard's device: one copy for each distinct
        device, shared by the shards that live there."""
        copies = {}
        for dev in dict.fromkeys(self.devices):
            profiling.counter("mesh.peer_bytes", _peer_bytes(x, dev))
            copies[dev] = x.to(dev)
        return [copies[dev] for dev in self.devices]

    def to_shard(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """``x`` on shard ``s``'s device."""
        profiling.counter("mesh.peer_bytes", _peer_bytes(x, self.devices[s]))
        return x.to(self.devices[s])

    def split_rows(self, x, fill=None) -> Sharded:
        """Host array (R, ...) -> D contiguous row blocks of
        ``ceil(R / D)`` rows, block ``s`` on shard ``s``'s device.  With
        ``fill`` the last blocks are padded to full length with it;
        without, they are short (or empty)."""
        x = np.asarray(x)
        per = -(-x.shape[0] // self.d)
        if fill is not None and per * self.d != x.shape[0]:
            pad = np.full((per * self.d - x.shape[0],) + x.shape[1:], fill,
                          x.dtype)
            x = np.concatenate([x, pad])
        return [torch.from_numpy(np.ascontiguousarray(
            x[s * per:(s + 1) * per])).to(self.devices[s])
            for s in range(self.d)]

    def gather_rows(self, xs: Sharded, device=None) -> torch.Tensor:
        """Shard-major concatenation on ``device`` (default: the first
        shard's)."""
        device = self.devices[0] if device is None else device
        profiling.counter("mesh.peer_bytes",
                          sum(_peer_bytes(x, device) for x in xs))
        return torch.cat([_move(x, device) for x in xs])

    def synchronize(self) -> None:
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
