"""Command-line interface of the PyTorch port.

The five subcommands take the same flags, with the same defaults, as
``python -m soapdenovo_trans_tpu`` (reference main.c:49-106,
pregraph.c:118-185, contig.c:311, map.c:115, scaffold.c:108), and write
the same files.  The parser is this module's own: the port loads no
module of the JAX package.

The device comes from ``SOAPDENOVO_TORCH_DEVICE`` (default ``cuda``);
a missing device is an error, never a silent fallback to the CPU.  A
comma list (``cuda:0,cuda:0,cuda:0,cuda:0``, ``cpu,cpu``,
``cuda:0,cuda:1``) of more than one entry is a mesh with one shard an
entry (parallel/mesh.py): ``pregraph`` and ``map``, and so ``all``, then
take the mesh path, and the other stages run on the first entry.  With
the plain default ``cuda`` and more than one visible card, the mesh is
all the cards unless ``SOAPDENOVO_TORCH_NO_SHARD`` is set.

Usage:
    python -m soapdenovo_trans_tpu_torch all -s reads.config -K 23 -o out
    python -m soapdenovo_trans_tpu_torch pregraph -s reads.config -K 23 -o out
    python -m soapdenovo_trans_tpu_torch contig -g out
    python -m soapdenovo_trans_tpu_torch map -s reads.config -g out
    python -m soapdenovo_trans_tpu_torch scaff -g out
    python -m soapdenovo_trans_tpu_torch all -s reads.config -o out -F -f -R
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .utils import profiling

READ_BATCH = 131072  # reads per IO batch
MAP_BATCH = 131072   # reads per map batch (even: mates share a batch)
# map -f lists its gap reads block by block of this many rows of each
# read stream (the JAX package's map batch); under -f a map batch is a
# whole number of such blocks
GAP_READ_BLOCK = 4096


def _add_common(p) -> None:
    p.add_argument("-s", dest="config", required=True,
                   help="lib config file")
    p.add_argument("-o", "-g", dest="out", required=True,
                   help="output graph prefix")
    p.add_argument("-K", dest="k", type=int, default=23,
                   help="kmer size (odd, 13..127)")
    p.add_argument("-p", dest="ncpu", type=int, default=8,
                   help="accepted for compatibility")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="soapdenovo-trans-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pg = sub.add_parser("pregraph", help="reads -> kmer/edge graph")
    _add_common(pg)
    pg.add_argument("-d", dest="low_kmer", type=int, default=0,
                    help="delete kmers with frequency <= this")
    pg.add_argument("-i", dest="minor_pct", type=int, default=5,
                    help="accepted for compatibility, as in the JAX "
                         "package: minor-out removal runs at 5%%")
    pg.add_argument("-a", dest="init_mem", type=int, default=0,
                    help="accepted for compatibility (table capacity is "
                         "sized from the data)")
    pg.add_argument("-n", dest="n_kmer", action="store_true",
                    help="count N-containing kmer windows under one "
                         "sentinel entry (reference prlHashReads.c:207)")
    pg.add_argument("-R", dest="reps_tie", action="store_true",
                    help="record read paths: .path + .markOnEdge "
                         "(recordPathBin, prlRead2path.c:507; the "
                         "reference's own -R case is commented out, "
                         "pregraph.c:149-151)")

    cg = sub.add_parser("contig", help="edge graph -> contigs")
    cg.add_argument("-g", dest="out", required=True,
                    help="graph prefix (pregraph output)")
    cg.add_argument("-e", dest="edge_cov", type=int, default=2,
                    help="delete edges with coverage <= this")
    cg.add_argument("-M", dest="merge_level", type=int, default=1,
                    help="strength of kmer-graph bubble merging 0..3")
    cg.add_argument("-q", dest="light_out", type=int, default=5)
    cg.add_argument("-Q", dest="light_flow", type=int, default=2)
    cg.add_argument("-H", dest="high_arc", type=int, default=200)
    cg.add_argument("-R", dest="reps_tie", action="store_true",
                    help="splitReps: duplicate repeat edges whose "
                         "neighbor pairing is resolved by .path read paths")
    cg.add_argument("-S", dest="short_cutoff", type=int, default=48,
                    help="remove short-contig components below this "
                         "length (reference cut_length, contig.c:333)")

    mp = sub.add_parser("map", help="reads -> contig placements")
    _add_common(mp)
    mp.add_argument("-f", dest="gap_reads", action="store_true",
                    help="output gap related reads (.readInGap/"
                         ".PEreadOnContig.gz/.shortreadInGap.gz)")
    mp.add_argument("-r", dest="read_trace", action="store_true",
                    help="write .readInformation")
    mp.add_argument("-R", dest="rpkm", action="store_true",
                    help="write .readInformation")

    sc = sub.add_parser("scaff", help="links -> transcripts")
    sc.add_argument("-g", dest="out", required=True)
    sc.add_argument("-s", dest="config", default=None,
                    help="lib config (needed to re-stream reads for -F)")
    sc.add_argument("-L", dest="min_contig", type=int, default=100)
    sc.add_argument("-t", dest="max_transcripts", type=int, default=5)
    sc.add_argument("-G", dest="gap_len_diff", type=int, default=50,
                    help="allowed gap-size error for gap filling (-F)")
    sc.add_argument("-F", dest="fill_gaps", action="store_true",
                    help="fill gaps by local assembly of their reads")
    sc.add_argument("-S", dest="skip_scaffold", action="store_true",
                    help="reuse the transcript structure of .scaf_gap "
                         "(resume straight into gap closing)")
    sc.add_argument("-r", dest="read_trace", action="store_true",
                    help="write .readOnScaf")
    sc.add_argument("-R", dest="rpkm", action="store_true",
                    help="write .readOnScaf and .RPKM.Stat")
    sc.add_argument("-N", dest="genome_size", type=int, default=0,
                    help="known genome/transcriptome size for NG50 in "
                         ".scafStatistics (reference scaffold.c:124)")
    sc.add_argument("-u", dest="no_mask_rep", action="store_true",
                    help="accepted for compatibility (no effect on the "
                         "transcript flow, as in the reference)")
    sc.add_argument("-c", dest="max_cnt", type=int, default=0,
                    help="keep at most this many outgoing links per "
                         "non-unique contig (deleteUnlikelyCnt, "
                         "transcriptome.c:2202; 0 or >10 = off)")

    al = sub.add_parser("all", help="full pipeline")
    _add_common(al)
    al.add_argument("-d", dest="low_kmer", type=int, default=0)
    al.add_argument("-i", dest="minor_pct", type=int, default=5)
    al.add_argument("-e", dest="edge_cov", type=int, default=2)
    al.add_argument("-M", dest="merge_level", type=int, default=1)
    al.add_argument("-q", dest="light_out", type=int, default=5)
    al.add_argument("-Q", dest="light_flow", type=int, default=2)
    al.add_argument("-H", dest="high_arc", type=int, default=200)
    al.add_argument("-L", dest="min_contig", type=int, default=100,
                    help="minimum contig length for scaffolding")
    al.add_argument("-G", dest="gap_len_diff", type=int, default=50)
    al.add_argument("-F", dest="fill_gaps", action="store_true")
    al.add_argument("-f", dest="gap_reads", action="store_true")
    al.add_argument("-S", dest="skip_scaffold", action="store_true")
    al.add_argument("-t", dest="max_transcripts", type=int, default=5)
    al.add_argument("-r", dest="read_trace", action="store_true")
    al.add_argument("-R", dest="rpkm", action="store_true")
    al.add_argument("-a", dest="init_mem", type=int, default=0,
                    help="accepted for compatibility (see pregraph -a)")
    al.add_argument("-n", dest="n_kmer", action="store_true")
    al.add_argument("-c", dest="max_cnt", type=int, default=0)
    al.add_argument("-u", dest="no_mask_rep", action="store_true")
    al.add_argument("-D", dest="low_edge_cov", type=int, default=0,
                    help="accepted for compatibility: the reference "
                         "never forwards it to a stage (main.c:313-323)")
    al.add_argument("-k", dest="kmer_small", type=int, default=0,
                    help="accepted for compatibility: ignored by the "
                         "reference's map stage too (map.c:115)")
    # the stages' own flags that `all` does not take (its -R and -S
    # mean rpkm and skip_scaffold)
    al.set_defaults(reps_tie=False, short_cutoff=48, genome_size=0)
    return ap


def devices_from_env() -> list:
    """The devices named by SOAPDENOVO_TORCH_DEVICE (default cuda), one
    a shard; plain ``cuda`` on a machine with several cards names them
    all unless SOAPDENOVO_TORCH_NO_SHARD is set."""
    spec = os.environ.get("SOAPDENOVO_TORCH_DEVICE", "cuda")
    devs = [torch.device(x.strip()) for x in spec.split(",") if x.strip()]
    if not devs:
        raise RuntimeError("SOAPDENOVO_TORCH_DEVICE names no device")
    if any(d.type == "cuda" for d in devs) and \
            not torch.cuda.is_available():
        raise RuntimeError(
            "SOAPDENOVO_TORCH_DEVICE names a CUDA device but torch sees "
            "none; set SOAPDENOVO_TORCH_DEVICE=cpu to run on the CPU")
    if devs == [torch.device("cuda")] and torch.cuda.device_count() > 1 \
            and not os.environ.get("SOAPDENOVO_TORCH_NO_SHARD"):
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return devs


def device_from_env() -> torch.device:
    """The first device of ``devices_from_env``: the one the stages
    without a mesh path run on."""
    return devices_from_env()[0]


def mesh_from_env():
    """A ``Mesh`` over ``devices_from_env`` if it names more than one
    shard, else None."""
    from .parallel.mesh import Mesh

    devs = devices_from_env()
    return Mesh(devs) if len(devs) > 1 else None


class _CountingFactory:
    """Read-batch factory that tallies per-lib read counts on its first
    pass (for the .peGrads boundaries, reference
    prlHashReads.c:626-645)."""

    def __init__(self, cfg, batch_size: int = READ_BATCH, n_kmer_k=0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.lib_counts = None
        self.n_kmer_k = n_kmer_k  # if >0, tally N-containing windows
        self.n_windows = 0

    def __call__(self):
        from .io import fastx

        count = self.lib_counts is None
        if count:
            self.lib_counts = {}

        def gen():
            for codes, lens, li in fastx.config_read_batches(
                    self.cfg, self.batch_size):
                # a library's last batch is padded to batch_size with
                # length-0 reads; they hold no k-mer, so drop them
                live = np.flatnonzero(lens)
                if not live.size:
                    continue
                codes, lens = codes[:live[-1] + 1], lens[:live[-1] + 1]
                if count:
                    self.lib_counts[li] = self.lib_counts.get(li, 0) + \
                        int((lens > 0).sum())
                    if self.n_kmer_k:
                        self.n_windows += _count_n_windows(
                            codes, lens, self.n_kmer_k)
                yield codes, lens, li

        return gen()

    def pe_grads(self):
        """[(insertS, cumulative read bound, rank, pair_num_cut)] over
        PE libs in ascending insert order (reference lib sort,
        lib.c:97)."""
        counts = self.lib_counts or {}
        libs = sorted(enumerate(self.cfg.libs), key=lambda x: x[1].avg_ins)
        grads, bound = [], 0
        for li, lib in libs:
            bound += counts.get(li, 0)
            if lib.avg_ins > 0 and lib.has_pairs:
                grads.append((lib.avg_ins, bound, 0, lib.pair_num_cut or 3))
        return grads, bound


def _count_n_windows(codes, lens, k):
    """In-range k-mer windows containing an N (code >= 4) — the windows
    the reference's -n mode feeds to the hash as InvalidKmer
    (prlHashReads.c:175-213)."""
    r, l = codes.shape
    p = l - k + 1
    if p <= 0:
        return 0
    cs = np.zeros((r, l + 1), np.int32)
    np.cumsum(codes >= 4, axis=1, out=cs[:, 1:])
    has_n = (cs[:, k:] - cs[:, :p]) > 0
    in_range = (np.arange(p)[None, :] + k) <= lens[:, None]
    return int((has_n & in_range).sum())


def run_pregraph_cmd(args, device: torch.device, mesh=None):
    from .io import graph_files, libconfig, stagefiles
    from .stages import pregraph as pg_stage

    cfg = libconfig.parse_config(args.config)
    if args.k % 2 == 0 or not (13 <= args.k <= 127):
        sys.exit("K must be odd and within 13..127")
    if mesh is not None:
        print(f"[pregraph] sharding kmer space over {mesh}")
    factory = _CountingFactory(cfg, n_kmer_k=args.k if args.n_kmer else 0)
    recorders = []

    def recorder_factory(edges):
        file_id, _order, nxt = graph_files.edge_file_ids(edges)
        recorders.append((stagefiles.PathRecorder(
            args.out + ".path", file_id, nxt), nxt))
        return recorders[0][0]

    res = pg_stage.run_pregraph(
        factory, args.k, device, low_freq_cutoff=args.low_kmer,
        path_recorder_factory=recorder_factory if args.reps_tie else None,
        mesh=mesh)
    # every file of the stage: the span pregraph.write
    with profiling.span("pregraph.write"):
        if recorders:
            rec, nxt = recorders[0]
            stagefiles.write_mark_on_edge(
                args.out + ".markOnEdge", rec.close(), nxt - 1)
            res.path_reads = rec.n_reads
            print(f"[pregraph] wrote {args.out}.path/.markOnEdge")
        # a mesh run counts the histogram on the mesh (res.table is then
        # only the mini endpoint table)
        hist = res.freq_hist if res.freq_hist is not None \
            else pg_stage.kmer_freq_histogram(res.table)
        if factory.n_windows:
            # -n: the reference hashes every N-containing window as one
            # InvalidKmer node (prlHashReads.c:207-213); it surfaces in the
            # frequency histogram as a single key with that many hits
            hist[min(factory.n_windows, len(hist) - 1)] += 1
            print(f"[pregraph] -n: {factory.n_windows} N-containing "
                  f"windows counted as sentinel kmer")
        stagefiles.write_kmer_freq(args.out + ".kmerFreq", hist)
        grads, n_reads = factory.pe_grads()
        if grads:
            stagefiles.write_pe_grads(
                args.out + ".peGrads", grads, n_reads, cfg.max_rd_len)
        n_vt = graph_files.write_pregraph_files(
            args.out, res.table, res.edges, res.arcs, args.k)
        stagefiles.write_pregraph_basic(
            args.out + ".preGraphBasic", n_vertex=n_vt, k=args.k,
            n_edge=res.edges.n_edges, max_read_len=cfg.max_rd_len)
    print(f"[pregraph] wrote {args.out}.kmerFreq/.preGraphBasic/"
          f".vertex/.edge.gz/.preArc")
    return res


def run_contig_cmd(args, device: torch.device, res=None):
    """The contig stage, from the pregraph stage files (``res`` None) or
    in memory from a ``PregraphResult``, as ``all`` runs it.  Writes
    .contig/.ContigIndex/.updated.edge/.Arc; returns (ContigResult with
    the contigs, and its edge map, in file order; table; k)."""
    from .graph import contig_merge
    from .io import graph_files, stagefiles
    from .stages import contig as contig_stage

    if res is None:
        # resume from the reference-format stage files
        # (loadVertex/loadEdge/loadPreArcs, src/loadPreGraph.c:52-670)
        table, edges, aset, k = graph_files.load_pregraph_files(
            args.out, device)
        print(f"[contig] loaded {edges.n_edges} edges, {aset.n} preArcs "
              f"from {args.out}.vertex/.edge.gz/.preArc")
    else:
        k, table, edges, aset = res.k, res.table, res.edges, res.arcs

    n_split, split_s = None, {}
    if args.reps_tie and os.path.exists(args.out + ".path"):
        # solveReps superset (splitReps.c:456; never reached in the
        # reference Trans flow) — resolve repeats with read paths
        from .graph import split_reps

        with profiling.phase(split_s, "contig", "split"):
            file_id, _order, nxt = graph_files.edge_file_ids(edges)
            inv = np.full(nxt + 1, -1, np.int64)
            inv[file_id] = np.arange(file_id.shape[0])
            edges, aset, n_split = split_reps.solve_reps(
                edges, aset, split_reps.path_triples(
                    stagefiles.read_path_bin(args.out + ".path"), inv))
        print(f"[contig] splitReps: {n_split} repeat edges split "
              f"({split_s['split']:.1f}s)")

    params = contig_stage.ContigParams(
        weak_cvg=10 * args.edge_cov, merge_level=args.merge_level,
        light_out_pct=args.light_out, light_flow_pct=args.light_flow,
        high_arc_multi=args.high_arc, short_component=args.short_cutoff)
    result = contig_stage.run_contig(edges, aset, k, params, table=table)
    with profiling.span("contig.write"):
        # renumber rows into .contig/.ContigIndex file order once, so the
        # internal row ids downstream (map, scaff) == file ids - 1
        file_perm = contig_merge.contig_file_perm(result.contigs, k)
        ctg = contig_merge.reorder_contigs(result.contigs, file_perm)
        perm = stagefiles.write_contig_fasta(
            args.out + ".contig", ctg, table, k, arcs=ctg.arcs)
        if perm != list(range(ctg.n)):
            raise RuntimeError("contig file order is not the row order")
        stagefiles.write_contig_index(args.out + ".ContigIndex", ctg, k,
                                      perm)
        graph_files.write_contig_graph_files(args.out, ctg, table, k, perm)
    print(f"[contig] wrote {args.out}.contig/.ContigIndex/"
          f".updated.edge/.Arc")
    old2new = torch.full_like(ctg.length, -1)
    old2new[torch.as_tensor(file_perm, device=device)] = torch.arange(
        ctg.n, device=device)
    edge_contig = torch.where(result.edge_contig >= 0, old2new[
        result.edge_contig.clamp(min=0)], -1)
    return dataclasses.replace(
        result, contigs=ctg, edge_contig=edge_contig, reps_split=n_split,
        phase_seconds={**result.phase_seconds, **split_s}), table, k


@dataclasses.dataclass
class MapResult:
    """What the map stage counted, and its host seconds."""

    reads: int          # reads numbered (length > 0)
    mapped: int         # reads with a .readOnContig row
    groups: int         # qualifying (read, contig) groups: .ctg2Read rows
    index_kmers: int    # unique contig k-mers in the index
    phase_seconds: Dict[str, float]  # index, reads (vote: device part)
    gap_reads: Optional[int] = None  # -f: .readInGap records
    pe_rows: Optional[int] = None    # -f: .PEreadOnContig.gz rows
    # the mesh path: exchanges between shards and the bytes they moved
    exchanges: Optional[int] = None
    exchange_bytes: Optional[int] = None


def _gap_read_rows(pl_ctg, pl_pos, per_read, codes, lengths, row_no, ins):
    """The -f rows of one map batch.  Returns (GapReads, pe_rows):

    * a footprint read (qualifying groups on >= 2 contigs) that is
      placed goes into its contig's gap as it is — the gap-spanning
      evidence (recordAlldgn, prlRead2Ctg.c:593);
    * of a pair (``ins`` > 0 or not; None for an unpaired library) with
      one mate placed, the other is dropped into the gap at the placed
      mate's position + insert size - its own length;
    * a pair with both mates placed is a .PEreadOnContig row.

    The gap reads come block by block of GAP_READ_BLOCK rows: the
    footprint reads of a block, then the pairs whose second mate is
    unplaced, then those whose first is."""
    from .io import stagefiles

    real = lengths > 0
    fp = np.flatnonzero((per_read >= 2) & (pl_ctg >= 0) & real)
    # columns: order key row, class, source row, contig, position
    parts = [(fp, 0, fp, pl_ctg[fp], pl_pos[fp])]
    pe = np.zeros((0, 5), np.int64)
    if ins is not None:
        t1 = np.arange(0, lengths.shape[0] - 1, 2)
        t2 = t1 + 1
        alive = real[t1] | real[t2]
        c1, c2 = pl_ctg[t1], pl_ctg[t2]
        both = alive & (c1 >= 0) & (c2 >= 0)
        pe = np.stack([row_no[t1[both]] + 1, c1[both], pl_pos[t1[both]],
                       c2[both], pl_pos[t2[both]]], 1)
        for cls, placed, lost in ((1, t1, t2), (2, t2, t1)):
            m = alive & (pl_ctg[placed] >= 0) & (pl_ctg[lost] < 0) & \
                (lengths[lost] > 0)
            parts.append((t1[m], cls, lost[m], pl_ctg[placed[m]],
                          pl_pos[placed[m]] + ins - lengths[lost[m]]))
    key = np.concatenate([p[0] for p in parts])
    cls = np.concatenate([np.full(p[0].shape[0], p[1]) for p in parts])
    order = np.lexsort((key, cls, key // GAP_READ_BLOCK))
    src = np.concatenate([p[2] for p in parts])[order]
    return stagefiles.GapReads(
        row_no[src] + 1, np.concatenate([p[3] for p in parts])[order],
        np.concatenate([p[4] for p in parts])[order], codes[src],
        lengths[src]), pe


def run_map_cmd(args, device: torch.device, ctg=None, table=None,
                mesh=None):
    """The map stage, from the contig stage files (``ctg`` None) or in
    memory, as ``all`` runs it; writes .peGrads/.readOnContig/.ctg2Read
    (JAX ``cli.run_map_cmd``, reference prlRead2Ctg.c:656-1086).  With a
    mesh the contig index is sharded and the read pass runs on the mesh
    (the reference threads this pass too, prlRead2Ctg.c:656); the files
    are the same."""
    from .graph import connections
    from .io import fastx, graph_files, libconfig, stagefiles
    from .stages import map as map_stage

    cfg = libconfig.parse_config(args.config)
    if ctg is None:
        ctg, table, k = graph_files.load_contig_graph_files(
            args.out, device)
        print(f"[map] loaded {ctg.n} contigs from "
              f"{args.out}.updated.edge/.Arc/.contig")
    else:
        k = args.k
    phases = dict.fromkeys(("index", "reads", "vote", "write"), 0.0)
    with profiling.phase(phases, "map", "index"):
        index = map_stage.build_contig_index(ctg, table, k)
        full_len = ctg.length + k
        sidx = None
        if mesh is not None:
            from .parallel import sharded_map

            moved = (mesh.exchanges, mesh.exchange_bytes)
            sidx = sharded_map.shard_index(mesh, index, k)
            print(f"[map] sharding contig index over {mesh}")

    with profiling.phase(phases, "map", "reads"):
        # per batch: (read, ctg, ctg_off, read_off, same, align)
        group_rows = []
        gap_parts, pe_parts = [], []  # -f payloads, per batch
        batch = MAP_BATCH
        if args.gap_reads:
            batch = max(batch // GAP_READ_BLOCK, 1) * GAP_READ_BLOCK
        # global REAL-read counter: padded rows (length 0) are not
        # numbered, matching the reference's dense readno space
        # (readCounter, prlRead2Ctg.c:539)
        base = 0
        lib_reads: Dict[int, int] = {}  # lib index -> reads (for .peGrads)
        max_read_len = 0
        for codes, lengths, li in fastx.config_read_batches(
                cfg, batch, purpose=2):
            lib = cfg.libs[li]
            real = lengths > 0
            n_real = int(real.sum())
            lib_reads[li] = lib_reads.get(li, 0) + n_real
            if not n_real:
                continue
            # a library's last batch is padded with length-0 reads: drop
            # them, keeping an even row count so mates stay paired
            rows = int(np.flatnonzero(real)[-1]) + 1
            rows += rows & 1
            codes, lengths, real = codes[:rows], lengths[:rows], real[:rows]
            row_no = base + np.cumsum(real) - 1  # row -> 0-based read index
            max_read_len = max(max_read_len, int(lengths.max()))
            with profiling.phase(phases, "map", "vote"):
                if sidx is not None:
                    pl = sharded_map.map_reads_sharded(
                        mesh, sidx, codes, lengths, k,
                        map_len=lib.map_len or 32)
                else:
                    pl = map_stage.map_reads(
                        torch.from_numpy(codes).to(device),
                        torch.from_numpy(lengths).to(device), index, k,
                        map_len=lib.map_len or 32)
                q = pl.g_valid
                g = torch.stack([
                    pl.g_read[q], pl.g_ctg[q], pl.g_ctg_off[q],
                    pl.g_read_off[q], pl.g_same[q].to(torch.int64),
                    pl.g_align[q]]).cpu().numpy()
            if args.gap_reads:
                # qualifying groups on distinct contigs, per batch row
                pairs = np.unique(g[0] * (ctg.n + 1) + g[1])
                gaps, pe = _gap_read_rows(
                    pl.ctg.cpu().numpy(), pl.pos.cpu().numpy(),
                    np.bincount(pairs // (ctg.n + 1), minlength=rows),
                    codes, lengths.astype(np.int64), row_no,
                    lib.avg_ins if lib.has_pairs else None)
                gap_parts.append(gaps)
                pe_parts.append(pe)
            if lib.has_pairs and lib.avg_ins > 0:
                ins, n_obs = connections.estimate_insert_size(
                    pl.ctg, pl.pos, ctg.twin, full_len, lib.avg_ins)
                if ins != lib.avg_ins:
                    print(f"[map] lib {li}: insert size estimate "
                          f"{lib.avg_ins} -> {ins} ({n_obs} pairs)")
            # qualifying alignment groups in read-encounter order
            # (recordAlldgn, reference prlRead2Ctg.c:530-614)
            if g.shape[1]:
                g[0] = row_no[g[0]]
                group_rows.append(g[:, np.lexsort((g[3], g[0]))])
            base += n_real

    with profiling.phase(phases, "map", "write"):
        # .peGrads from the map pass's own library accounting, like the
        # reference's map-side writer (prlRead2Ctg.c:827-840): per-grad
        # cumulative read-number bounds; equal insert sizes merge; the raw
        # pair_num_cut, 0 when unset (prlRead2Ctg.c:842)
        grads = []
        bound = 0
        for li in sorted(lib_reads):
            lib = cfg.libs[li]
            bound += lib_reads[li]
            if not lib.has_pairs or lib.avg_ins <= 0:
                continue
            if grads and grads[-1][0] == lib.avg_ins:
                grads[-1] = (lib.avg_ins, bound, 0, lib.pair_num_cut)
            else:
                grads.append((lib.avg_ins, bound, 0, lib.pair_num_cut))
        stagefiles.write_pe_grads(
            args.out + ".peGrads", grads, base, max_read_len)
        g_read, g_ctg, g_off, g_roff, g_same, g_aln = (
            np.concatenate(group_rows, 1) if group_rows
            else np.zeros((6, 0), np.int64))
        # .readOnContig: one line per mapped read; odd readnos report the
        # LAST alignment group, even the FIRST (recordAlldgn,
        # prlRead2Ctg.c:565-568); pos = contigOffset - readOffset + 1
        new_read = g_read[1:] != g_read[:-1]
        first_of = np.concatenate([[True], new_read])[:g_read.size]
        last_of = np.concatenate([new_read, [True]])[:g_read.size]
        sel = np.flatnonzero(np.where((g_read + 1) % 2 == 1, last_of,
                                      first_of))
        orien_col = np.where(g_same == 1, "+", "-")
        stagefiles.write_placement_table(
            args.out + ".readOnContig", g_read[sel] + 1, g_ctg[sel] + 1,
            g_off[sel] - g_roff[sel] + 1, orien_col[sel])
        stagefiles.write_placement_table(
            args.out + ".ctg2Read", g_read + 1, g_ctg + 1, g_roff - g_off,
            orien_col)
        if args.read_trace or args.rpkm:
            # .readInformation (reference prlRead2Ctg.c:575-588, -r/-R):
            # readno readOffset-1 ctg ctgOffset alignLen+K-1 orien, with
            # '-' rows flipped back to the stored-orientation contig
            twin = ctg.twin.cpu().numpy()
            alen = g_aln + k - 1
            safe_ctg = np.clip(g_ctg, 0, twin.shape[0] - 1)
            plus = g_same == 1
            stagefiles.write_read_information(
                args.out + ".readInformation", g_read + 1, g_roff - 1,
                np.where(plus, g_ctg, twin[safe_ctg]) + 1,
                np.where(plus, g_off,
                         full_len.cpu().numpy()[safe_ctg] - g_off - alen),
                alen, orien_col)
            print(f"[map] wrote {args.out}.readInformation "
                  f"({g_read.size} alignments)")
        n_gap = n_pe = None
        if args.gap_reads:
            gaps = stagefiles.GapReads.concat(gap_parts, cfg.max_rd_len)
            pe = np.concatenate(pe_parts) if pe_parts \
                else np.zeros((0, 5), np.int64)
            stagefiles.write_read_in_gap(args.out + ".readInGap", gaps)
            stagefiles.write_pe_read_on_contig(
                args.out + ".PEreadOnContig.gz", pe)
            stagefiles.write_short_read_in_gap(
                args.out + ".shortreadInGap.gz", gaps)
            n_gap, n_pe = len(gaps), pe.shape[0]
            print(f"[map] wrote {n_gap} gap reads (.readInGap/"
                  f".shortreadInGap.gz), {n_pe} PE placements "
                  f"(.PEreadOnContig.gz)")
        print(f"[map] wrote {args.out}.readOnContig/.ctg2Read/.peGrads")
    return MapResult(
        base, int(sel.size), int(g_read.size), index.n, phases, n_gap, n_pe,
        mesh.exchanges - moved[0] if mesh else None,
        mesh.exchange_bytes - moved[1] if mesh else None)


def run_scaff_cmd(args, device: torch.device, ctg=None, table=None):
    """The scaff stage, from the contig stage files (``ctg`` None) or in
    memory, as ``all`` runs it.  Connections are always rebuilt from the
    map stage's files (.peGrads/.readOnContig/.ctg2Read), like the
    reference's PE2Links/Links2Scaf/singleRead2connection.  Writes
    .links/.scafSeq/.gapSeq/.scaf/.scaf_gap/.contigPosInscaff/.agp/
    .scafStatistics, with -r/-R .readOnScaf (from map -r's
    .readInformation) and with -R .RPKM.Stat; -F fills gaps from the
    reads of the -s config; -S takes the transcripts from an earlier
    run's .scaf_gap.  Returns the ScaffResult, with the seconds of the
    link build and the writers added to its phase_seconds."""
    from .io import fastx, graph_files, libconfig, stagefiles
    from .stages import pelinks
    from .stages import scaff as scaff_stage

    if ctg is None:
        ctg, table, k = graph_files.load_contig_graph_files(
            args.out, device)
        print(f"[scaff] loaded {ctg.n} contigs from "
              f"{args.out}.updated.edge/.Arc/.contig")
    else:
        k = args.k
    # links and write, added after run_scaff's own phases
    seconds: Dict[str, float] = {}
    with profiling.phase(seconds, "scaff", "links"):
        conn, extras = pelinks.build_connections(
            args.out, ctg, k, min_unique_len=args.min_contig)
        print(f"[scaff] {conn.n} contig connections from "
              f"{args.out}.readOnContig/.ctg2Read")
        params = scaff_stage.ScaffParams(
            min_unique_len=args.min_contig,
            max_transcripts=args.max_transcripts, max_cnt=args.max_cnt,
            ins_size_var=extras["ins_size_var"],
            gap_len_diff=args.gap_len_diff, fill_gaps=args.fill_gaps)
        read_ctg = extras["read_ctg"]
        gap_read_source = None
        if args.fill_gaps and args.config and read_ctg is not None:
            cfg = libconfig.parse_config(args.config)
            gap_read_source = (
                read_ctg, extras["read_pos"],
                lambda: fastx.config_read_batches(cfg, READ_BATCH, purpose=2),
                extras["read_ins"])
        preset = None
        if args.skip_scaffold:
            # .scaf_gap coordinates are in K-exclusive contig-length space
            # (reference outputOneTranscriptome, transcriptome.c:1210)
            preset = stagefiles.read_scaf_gap(
                args.out + ".scaf_gap", ctg.length.cpu().numpy(), k)
            print(f"[scaff] -S: reusing {len(preset)} transcript structures "
                  f"from {args.out}.scaf_gap")
    sres = scaff_stage.run_scaff(
        ctg, conn, k, table, params, ctg_arcs=ctg.arcs,
        gap_read_source=gap_read_source, preset_transcripts=preset)
    with profiling.phase(seconds, "scaff", "write"):
        recs = sres.recs
        fastx.write_fasta(args.out + ".scafSeq", recs)
        stagefiles.write_gap_seq(args.out + ".gapSeq", sres.gap_report)
        stagefiles.write_scaf_files(
            args.out, sres.transcripts, recs, ctg.length.cpu().numpy(),
            ctg.twin.cpu().numpy(), k, placements=sres.placements,
            routes=sres.routes, n_runs=sres.n_runs)
        stagefiles.write_scaf_statistics(
            args.out, known_genome_size=args.genome_size)
        if (args.read_trace or args.rpkm) and read_ctg is not None:
            _write_read_tables(args, sres, ctg, k, read_ctg)
        n_scaf = sum(1 for h, _ in recs if h.startswith("scaffold"))
        print(f"[scaff] {n_scaf} transcripts + {len(recs) - n_scaf} "
              f"singletons -> {args.out}.scafSeq "
              f"(N50={sres.stats.get('N50', 0)})")
    sres.phase_seconds.update(seconds)
    return sres


def _write_read_tables(args, sres, ctg, k: int, read_ctg) -> None:
    """scaff -r/-R: .readOnScaf, the join of map -r's .readInformation
    with .contigPosInscaff (getReadOnScaf, ReadTrace.c:41-160), and
    with -R .RPKM.Stat, in float64 on the host."""
    from .io import stagefiles
    from .stages import scaff as scaff_stage

    twin = ctg.twin.cpu().numpy()
    if os.path.exists(args.out + ".readInformation"):
        stagefiles.write_read_on_scaf(
            args.out, k, ctg.length.cpu().numpy() + k, twin)
        print(f"[scaff] wrote {args.out}.readOnScaf")
    else:
        print("[scaff] -r: no .readInformation (rerun map with -r) — "
              ".readOnScaf not written")
    if not args.rpkm:
        return
    owner = scaff_stage.record_membership(
        sres.recs, sres.transcripts, twin, ctg.n)
    _rec_of, hits = scaff_stage.reads_on_scaffolds(
        read_ctg, owner, len(sres.recs))
    with open(args.out + ".RPKM.Stat", "w") as fh:
        fh.write("# Notice:RPKM calculation base on K-mer mapping.\n")
        fh.write(f"# Total_unique_reads_num={int(hits.sum())}\n")
        fh.write("Transcript_ID\tLength\tUniq_reads_num\tRPKM\n")
        for name, ln, h, rp in scaff_stage.rpkm_table(sres.recs, hits):
            fh.write(f"{name}\t{ln}\t{h}\t{rp:f}\n")
    print(f"[scaff] wrote {args.out}.RPKM.Stat")


@dataclasses.dataclass
class AllResult:
    """The four stages of ``all``, with each stage's seconds (host
    clock, devices synchronized) and peak device memory (CUDA only; on
    a mesh, of its first card, where contig and scaff run), and the
    run's spans (name -> (seconds, calls)) and counters (name -> total).

    On a mesh of cards (four H100 of one host is the measured
    multi-card deployment) the counter ``mesh.peak_bytes`` is the
    largest peak of any card of the mesh in any stage, and
    ``mesh.peak_bytes.<card>`` each card's; ``peak_bytes`` stays the
    first card's."""

    pregraph: object
    contig: object
    map: MapResult
    scaff: object
    stage_seconds: Dict[str, float]
    peak_bytes: Dict[str, Optional[int]]
    spans: Dict[str, Tuple[float, int]]
    counters: Dict[str, float]


def run_all(args, device: torch.device, mesh=None,
            timings=None) -> AllResult:
    """pregraph -> contig in memory -> map in memory -> scaff (JAX
    ``cli.main``'s ``all``, cli.py:748-756); pregraph and map on the
    mesh if there is one.  ``timings`` (a ``profiling.StageTimings``,
    a fresh one when not given) is the active recorder for the run."""
    timings = timings or profiling.StageTimings()
    seconds: Dict[str, float] = {}
    peak: Dict[str, Optional[int]] = {}
    cuda = device.type == "cuda"
    # on a mesh, every card's peak is read at each stage
    cards = [] if mesh is None else [
        d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]

    def sync():
        if mesh is not None:
            mesh.synchronize()
        elif cuda:
            torch.cuda.synchronize(device)

    def stage(name, fn):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        for card in cards:
            if card != device:
                torch.cuda.reset_peak_memory_stats(card)
        with timings.stage_timer(name) as sp:
            out = fn()
            sync()
        seconds[name] = sp.seconds
        peak[name] = torch.cuda.max_memory_allocated(device) if cuda \
            else None
        for card in cards:
            top = torch.cuda.max_memory_allocated(card)
            timings.counter_max("mesh.peak_bytes", top)
            timings.counter_max(f"mesh.peak_bytes.{card}", top)
        return out

    with profiling.active(timings), timings.span("all"):
        res = stage("pregraph", lambda: run_pregraph_cmd(args, device, mesh))
        contig, table, _k = stage(
            "contig", lambda: run_contig_cmd(args, device, res))
        mres = stage("map", lambda: run_map_cmd(
            args, device, ctg=contig.contigs, table=table, mesh=mesh))
        sres = stage("scaff", lambda: run_scaff_cmd(
            args, device, ctg=contig.contigs, table=table))
    return AllResult(res, contig, mres, sres, seconds, peak,
                     timings.span_totals(), dict(timings.counters))


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its result: a
    ``PregraphResult``, ``run_contig_cmd``'s tuple, a ``MapResult``, a
    ``ScaffResult`` or, for ``all``, an ``AllResult``.  One
    ``profiling.StageTimings`` a run records its spans and counters."""
    args = build_parser().parse_args(argv)
    device, mesh = device_from_env(), mesh_from_env()
    timings = profiling.StageTimings()
    runs = {"pregraph": lambda: run_pregraph_cmd(args, device, mesh),
            "contig": lambda: run_contig_cmd(args, device),
            "map": lambda: run_map_cmd(args, device, mesh=mesh),
            "scaff": lambda: run_scaff_cmd(args, device)}
    with profiling.active(timings):
        if args.cmd == "all":  # times its four stages itself
            res = run_all(args, device, mesh, timings)
        else:
            with timings.stage_timer(args.cmd):
                res = runs[args.cmd]()
    print(timings.timing_table())
    print(f"[done] {args.cmd} on {mesh or device} "
          f"{sum(timings.seconds.values()):.1f}s")
    return res


if __name__ == "__main__":
    main()
