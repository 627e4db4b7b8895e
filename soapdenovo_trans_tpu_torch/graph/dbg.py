"""De Bruijn graph over the canonical k-mer table: directed-node view.

Port of ``soapdenovo_trans_tpu/graph/dbg.py``.  Canonical k-mer row i
yields two directed nodes ``u = 2*i + s`` (s=0 canonical orientation,
s=1 reverse complement), ``twin(u) = u ^ 1``.  Arc-granular state is
flat: arc ``a = u*4 + b`` extends node u by base b on the right; the
twin node's arc is ``a ^ 4``.  Successors are resolved with batched
dictionary lookups in chunks of table rows, which bounds the lookup's
working memory on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bits, dictionary


class DBG(NamedTuple):
    """Directed-node graph state derived from a KmerTable."""

    out_cov: torch.Tensor     # (8*cap,) int32, arc-flat (u*4 + b)
    succ: torch.Tensor        # (8*cap,) int64 directed id or -1, arc-flat
    exists: torch.Tensor      # (8*cap,) bool, arc-flat
    out_deg: torch.Tensor     # (2*cap,) int64
    linear: torch.Tensor      # (2*cap,) bool — 1-in-1-out node
    first_base: torch.Tensor  # (2*cap,) uint8 first base of oriented kmer
    live: torch.Tensor        # (2*cap,) bool — row exists and not deleted


def twin(u):
    return u ^ 1


_CHUNK_ROWS = 1 << 20     # table rows per resolution chunk (x8 queries)


def _resolve_keys_chunk(keys_full, kchunk, k: int):
    """Successor candidates for one chunk of table rows: orient (fwd +
    revcomp), extend by every base, canonicalize, one batched lookup
    into the full key array."""
    w = kchunk.shape[-1]
    ori = torch.stack([kchunk, bits.reverse_complement(kchunk, k)],
                      1).reshape(-1, w)
    m = ori.shape[0]
    base4 = torch.arange(4, device=kchunk.device).expand(m, 4)
    ext = bits.next_kmer(ori[:, None, :].expand(m, 4, w), base4, k)
    can, use_rc = bits.canonical(ext.reshape(-1, w), k)
    return dictionary.lookup(keys_full, can), use_rc


def build_dbg(table: dictionary.KmerTable, k: int) -> DBG:
    """Resolve all successor candidates and mark linear nodes
    (reference per-node l_links/r_links + Mark1in1outNode).  Chunking by
    table row keeps global node order."""
    cap = table.capacity
    dev = table.keys.device
    parts = [_resolve_keys_chunk(table.keys,
                                 table.keys[off:off + _CHUNK_ROWS], k)
             for off in range(0, cap, _CHUNK_ROWS)]
    rows = torch.cat([r for r, _ in parts])
    use_rc = torch.cat([u for _, u in parts])

    keys = table.keys
    oriented = torch.stack([keys, bits.reverse_complement(keys, k)],
                           1).reshape(2 * cap, -1)
    live_row = (torch.arange(cap, device=dev) < table.n) & ~table.deleted
    live = live_row.repeat_interleave(2)
    # node-major flat coverage: slot 8i+b <- r_cov[i, b] (fwd node),
    # 8i+4+b <- l_cov[i, comp(b)] (rc node); comp(b) = b^2
    out_cov = torch.cat([table.r_cov, table.l_cov[:, [2, 3, 0, 1]]],
                        1).reshape(-1)

    succ = torch.where(rows >= 0, 2 * rows + use_rc.to(torch.int64), -1)
    succ_live = live[succ.clamp(min=0)] & (succ >= 0)
    exists = (out_cov > 0) & succ_live & live.repeat_interleave(4)
    out_deg = exists.view(-1, 4).sum(1)
    in_deg = out_deg.view(-1, 2).flip(1).reshape(-1)  # out_deg[twin(u)]
    linear = (out_deg == 1) & (in_deg == 1) & live
    return DBG(out_cov, succ, exists, out_deg, linear,
               bits.first_base(oriented, k), live)


def arc_id(u, b):
    """Dense arc index: arc (u, b) -> u*4 + b."""
    return (u << 2) | b


def twin_arc(dbg: DBG, a):
    """Twin of arc a = (u, b): twin(succ(u,b)) --comp(first_base(u))-->
    (the reference's bal_edge/bal_arc duality)."""
    v = dbg.succ[a]
    fb = dbg.first_base[a >> 2].to(torch.int64)
    return torch.where(v >= 0, arc_id(twin(v), fb ^ 2), -1)
