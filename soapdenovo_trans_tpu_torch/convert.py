"""State conversion between the JAX package and the port.

``to_torch`` turns one of the JAX package's state NamedTuples —
``KmerTable``, ``SortedRun``, ``DBG``, ``EdgeGraph``, ``PatchTable``,
``ArcSet``, ``Contigs`` (with its nested ``ArcSet``), ``ContigIndex``,
``ReadPlacements``, ``ConnSet``, ``PackedTable``, ``LocalTables``, with
numpy (or any array-like) fields —
into the port's NamedTuple of the same name on a given device.
``to_numpy`` turns a port NamedTuple back into numpy arrays with the JAX
package's dtypes, optionally wrapped in a given class (e.g. the JAX
package's own).  ``gapfill_plain`` turns either package's
``GapFillResult`` into plain lists.

The mesh state — ``ShardedPacked``, ``ShardedTable``, ``ShardedDBG``,
``ShardedContigIndex`` — goes through ``sharded_to_torch`` and
``sharded_to_numpy``: the JAX package's ``(D, cap, ...)`` arrays against
the port's lists of per-shard tensors on a given ``Mesh``.  A
``ShardedPacked`` shard of the port holds its live rows ``[0, n[s])``
only; the other way pads every shard to a common capacity with
sentinel rows and zero counts, and fills the JAX package's ``dropped``
with zeros (the port's exchange cannot drop).

Dtype rules: uint32 k-mer/row lanes <-> int64 lanes; int32 counts and
coverages stay int32; every other int32 array (node, edge and arc ids,
lengths) becomes int64; bool and uint8 are unchanged.  Live counts
become Python ints, except ``SortedRun.n``, which stays a device scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import arcs, connections, contig_merge, dbg, gapfill, unitigs
from .ops import dictionary
from .parallel import sharded_count, sharded_map, sharded_pregraph
from .stages import map as map_stage

_TYPES = {cls.__name__: cls for cls in (
    dictionary.KmerTable, dictionary.SortedRun, dictionary.PackedTable,
    gapfill.LocalTables, dbg.DBG,
    unitigs.EdgeGraph, arcs.PatchTable, arcs.ArcSet,
    contig_merge.Contigs, map_stage.ContigIndex, map_stage.ReadPlacements,
    connections.ConnSet)}
_LANES = {"keys", "rows"}
_COUNTS = {("KmerTable", "count"), ("KmerTable", "l_cov"),
           ("KmerTable", "r_cov"), ("SortedRun", "count"),
           ("PackedTable", "count"), ("LocalTables", "count"),
           ("DBG", "out_cov")}
_SCALARS = {"n", "n_edges"}


def to_torch(nt, device):
    """JAX-package NamedTuple (numpy fields) -> port NamedTuple."""
    name = type(nt).__name__
    out = []
    for field, x in zip(nt._fields, nt):
        if hasattr(x, "_fields"):  # nested NamedTuple (Contigs.arcs)
            out.append(to_torch(x, device))
            continue
        x = np.asarray(x)
        if field in _SCALARS:
            out.append(torch.tensor(int(x), device=device)
                       if name == "SortedRun" else int(x))
            continue
        if field in _LANES:
            x = x.astype(np.int64)
        elif x.dtype.kind in "iu" and x.dtype != np.uint8:
            x = x.astype(np.int32 if (name, field) in _COUNTS else np.int64)
        out.append(torch.from_numpy(np.array(x)).to(device))
    return _TYPES[name](*out)


def to_numpy(nt, cls=None, nested=None):
    """Port NamedTuple -> numpy fields with the JAX package's dtypes,
    as ``cls`` (default: the port's own NamedTuple class).  A nested
    NamedTuple field becomes ``nested[field]`` (default: its port
    class)."""
    out = []
    for field, x in zip(nt._fields, nt):
        if hasattr(x, "_fields"):
            out.append(to_numpy(x, (nested or {}).get(field)))
            continue
        if field in _SCALARS:
            out.append(np.int32(int(x)))
            continue
        x = x.cpu().numpy()
        if field in _LANES:
            x = x.astype(np.uint32)
        elif x.dtype == np.int64:
            x = x.astype(np.int32)
        out.append(x)
    return (cls or type(nt))(*out)


_SHARDED = {cls.__name__: cls for cls in (
    sharded_count.ShardedPacked, sharded_count.ShardedTable,
    sharded_pregraph.ShardedDBG, sharded_map.ShardedContigIndex)}
_REPLICATED = {"ctg_len", "twin"}  # of ShardedContigIndex
_SHARD_COUNTS = _COUNTS | {
    ("ShardedPacked", "count"), ("ShardedTable", "count"),
    ("ShardedTable", "l_cov"), ("ShardedTable", "r_cov"),
    ("ShardedDBG", "out_cov")}
_BOOLS = {("ShardedContigIndex", "deleted")}  # int32 0/1 in JAX


def _port_dtype(name: str, field: str, x: np.ndarray) -> np.ndarray:
    if field in _LANES:
        return x.astype(np.int64)
    if (name, field) in _BOOLS:
        return x.astype(bool)
    if x.dtype.kind in "iu" and x.dtype != np.uint8:
        return x.astype(np.int32 if (name, field) in _SHARD_COUNTS
                        else np.int64)
    return x


def sharded_to_torch(nt, mesh):
    """JAX-package mesh NamedTuple (numpy ``(D, cap, ...)`` fields) ->
    the port's, shard ``s`` on ``mesh.devices[s]``.  A ``ShardedPacked``
    shard keeps its live prefix (at least one row)."""
    name = type(nt).__name__
    n = [int(x) for x in np.asarray(nt.n)] if "n" in nt._fields else None
    out = []
    for field, x in zip(nt._fields, nt):
        if field == "dropped":
            continue
        if field == "n":
            out.append(n)
            continue
        x = _port_dtype(name, field, np.asarray(x))
        if field in _REPLICATED:
            out.append(torch.from_numpy(np.array(x)).to(mesh.devices[0]))
            continue
        if x.shape[0] != mesh.d:
            raise ValueError(f"{name}.{field} has {x.shape[0]} shards, the "
                             f"mesh {mesh.d}")
        rows = [max(v, 1) for v in n] if name == "ShardedPacked" \
            else [x.shape[1]] * mesh.d
        out.append([torch.from_numpy(np.array(x[s, :rows[s]])).to(
            mesh.devices[s]) for s in range(mesh.d)])
    return _SHARDED[name](*out)


def sharded_to_numpy(nt, cls=None):
    """The port's mesh NamedTuple -> numpy ``(D, cap, ...)`` fields with
    the JAX package's dtypes, as ``cls`` (default: a plain dict by
    field).  Shards of unequal length are padded to the longest with
    sentinel lanes or zeros; ``dropped`` (a field of the JAX package's
    ``ShardedPacked``) is all zeros."""
    name = type(nt).__name__
    d = len(nt[0])
    out = {}
    for field, x in zip(nt._fields, nt):
        if field == "n":
            out[field] = np.asarray(x, np.int32)
            continue
        if field in _REPLICATED:
            out[field] = x.cpu().numpy().astype(np.int32)
            continue
        cap = max(v.shape[0] for v in x)
        fill = dictionary.SENTINEL if field in _LANES else 0
        rows = []
        for v in x:
            v = v.cpu().numpy()
            pad = np.full((cap - v.shape[0],) + v.shape[1:], fill, v.dtype)
            rows.append(np.concatenate([v, pad]))
        arr = np.stack(rows)
        if field in _LANES:
            arr = arr.astype(np.uint32)
        elif arr.dtype == np.int64 or (name, field) in _BOOLS:
            arr = arr.astype(np.int32)
        out[field] = arr
    if name == "ShardedPacked":
        out["dropped"] = np.zeros(d, np.int32)
    return cls(**out) if cls is not None else out


def gapfill_plain(res):
    """A ``GapFillResult`` of either package -> (filled, fill_seq,
    overlap) as lists of bool, str and int."""
    return ([bool(x) for x in res.filled], [str(x) for x in res.fill_seq],
            [int(x) for x in res.overlap])
