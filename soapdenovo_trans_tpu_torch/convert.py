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


def gapfill_plain(res):
    """A ``GapFillResult`` of either package -> (filled, fill_seq,
    overlap) as lists of bool, str and int."""
    return ([bool(x) for x in res.filled], [str(x) for x in res.fill_seq],
            [int(x) for x in res.overlap])
