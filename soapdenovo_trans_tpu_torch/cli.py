"""Command-line interface of the PyTorch port.

``pregraph`` and ``contig`` take the same flags, with the same defaults,
as ``python -m soapdenovo_trans_tpu pregraph`` / ``contig`` (reference
pregraph.c:118-185, contig.c:311).  The other stages (``map``,
``scaff``, ``all``), ``pregraph -R`` and ``contig -R`` are not ported yet
and exit with a message.  The parser is this module's own: the port
loads no module of the JAX package.

The device comes from ``SOAPDENOVO_TORCH_DEVICE`` (default ``cuda``);
a missing device is an error, never a silent fallback to the CPU.

Usage:
    python -m soapdenovo_trans_tpu_torch pregraph -s reads.config -K 23 -o out
    python -m soapdenovo_trans_tpu_torch contig -g out
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

READ_BATCH = 131072  # reads per IO batch
NOT_PORTED = ("map", "scaff", "all")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="soapdenovo-trans-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pg = sub.add_parser("pregraph", help="reads -> kmer/edge graph")
    pg.add_argument("-s", dest="config", required=True,
                    help="lib config file")
    pg.add_argument("-o", "-g", dest="out", required=True,
                    help="output graph prefix")
    pg.add_argument("-K", dest="k", type=int, default=23,
                    help="kmer size (odd, 13..127)")
    pg.add_argument("-p", dest="ncpu", type=int, default=8,
                    help="accepted for compatibility")
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
                    help="record read paths (not ported yet)")

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
                    help="solve repeats by read paths (not ported yet)")
    cg.add_argument("-S", dest="short_cutoff", type=int, default=48,
                    help="remove short-contig components below this "
                         "length (reference cut_length, contig.c:333)")
    return ap


def device_from_env() -> torch.device:
    """The device named by SOAPDENOVO_TORCH_DEVICE (default cuda)."""
    dev = torch.device(os.environ.get("SOAPDENOVO_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SOAPDENOVO_TORCH_DEVICE names a CUDA device but torch sees "
            "none; set SOAPDENOVO_TORCH_DEVICE=cpu to run on the CPU")
    return dev


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


def run_pregraph_cmd(args, device: torch.device):
    from .io import graph_files, libconfig, stagefiles
    from .stages import pregraph as pg_stage

    if args.reps_tie:
        sys.exit("pregraph -R is not ported yet")
    cfg = libconfig.parse_config(args.config)
    if args.k % 2 == 0 or not (13 <= args.k <= 127):
        sys.exit("K must be odd and within 13..127")
    factory = _CountingFactory(cfg, n_kmer_k=args.k if args.n_kmer else 0)
    res = pg_stage.run_pregraph(factory, args.k, device,
                                low_freq_cutoff=args.low_kmer)
    hist = pg_stage.kmer_freq_histogram(res.table)
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
    import dataclasses

    from .graph import contig_merge
    from .io import graph_files, stagefiles
    from .stages import contig as contig_stage

    if args.reps_tie:
        sys.exit("contig -R is not ported yet")
    if res is None:
        # resume from the reference-format stage files
        # (loadVertex/loadEdge/loadPreArcs, src/loadPreGraph.c:52-670)
        table, edges, aset, k = graph_files.load_pregraph_files(
            args.out, device)
        print(f"[contig] loaded {edges.n_edges} edges, {aset.n} preArcs "
              f"from {args.out}.vertex/.edge.gz/.preArc")
    else:
        k, table, edges, aset = res.k, res.table, res.edges, res.arcs

    params = contig_stage.ContigParams(
        weak_cvg=10 * args.edge_cov, merge_level=args.merge_level,
        light_out_pct=args.light_out, light_flow_pct=args.light_flow,
        high_arc_multi=args.high_arc, short_component=args.short_cutoff)
    result = contig_stage.run_contig(edges, aset, k, params, table=table)
    # renumber rows into .contig/.ContigIndex file order once, so the
    # internal row ids downstream (map, scaff) == file ids - 1
    file_perm = contig_merge.contig_file_perm(result.contigs, k)
    ctg = contig_merge.reorder_contigs(result.contigs, file_perm)
    perm = stagefiles.write_contig_fasta(
        args.out + ".contig", ctg, table, k, arcs=ctg.arcs)
    if perm != list(range(ctg.n)):
        raise RuntimeError("contig file order is not the row order")
    stagefiles.write_contig_index(args.out + ".ContigIndex", ctg, k, perm)
    graph_files.write_contig_graph_files(args.out, ctg, table, k, perm)
    print(f"[contig] wrote {args.out}.contig/.ContigIndex/"
          f".updated.edge/.Arc")
    old2new = torch.full_like(ctg.length, -1)
    old2new[torch.as_tensor(file_perm, device=device)] = torch.arange(
        ctg.n, device=device)
    edge_contig = torch.where(result.edge_contig >= 0, old2new[
        result.edge_contig.clamp(min=0)], -1)
    return dataclasses.replace(result, contigs=ctg,
                               edge_contig=edge_contig), table, k


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its result (a
    ``PregraphResult``, or ``run_contig_cmd``'s tuple)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        sys.exit(f"{argv[0]} is not ported yet: only pregraph and contig "
                 f"run on the PyTorch port")
    args = build_parser().parse_args(argv)
    device = device_from_env()
    t0 = time.time()
    if args.cmd == "pregraph":
        res = run_pregraph_cmd(args, device)
    else:
        res = run_contig_cmd(args, device)
    print(f"[done] {args.cmd} on {device} {time.time() - t0:.1f}s")
    return res


if __name__ == "__main__":
    main()
