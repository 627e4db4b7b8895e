"""Readings that the limits of ``reference.LIMITS`` are set from.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 \\
        [--flags -M 1] [--controls [NAME ...]]

For each seed: one assembly of the cell's dataset at its full size, on
the card, through the same entry as the window
(``cli.main(["all", ...])``), then ``reference.check`` on its files (the
lower reading).  With ``--controls``, each control breaks one guarantee
that the configuration states, on a copy of those files, and is checked
again (the upper readings); names after ``--controls`` pick some.  ``--flags`` replaces the configuration's
flags, to read another path of the program on the same data.  One JSON
line a seed and reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + {65: b"C", 67: b"G", 71: b"T", 84: b"A"}.get(
        b[i], b"A") + b[i + 1:]


def _rewrite_fasta(path: str, every: int, opener=open) -> None:
    """Change the middle base of every ``every``-th record."""
    with opener(path, "rb") as fh:
        recs = fh.read().split(b">")
    for i in range(1, len(recs), every):
        head, _, body = recs[i].partition(b"\n")
        seq = body.replace(b"\n", b"")
        if seq:
            seq = _flip(seq, len(seq) // 2)
        recs[i] = head + b"\n" + seq + b"\n"
    with opener(path, "wb") as fh:
        fh.write(b">".join(recs))


def half_reads_kmerfreq(prefix, reads, k, device):
    """.kmerFreq from every second read: a count that leaves out half."""
    from port_bench import reference

    hist = reference.ReadKmers(reads[::2], k, device).histogram()
    with open(prefix + ".kmerFreq", "w") as fh:
        fh.write("".join(f"{int(x)}\n" for x in hist))


def edge_base(prefix, reads, k, device):
    """A base changed in every fiftieth edge record."""
    import gzip

    _rewrite_fasta(prefix + ".edge.gz", 50, gzip.open)


def duplicate_edges(prefix, reads, k, device):
    """Every fiftieth edge record written a second time, at the end: the
    same K-mers inside two edges."""
    import gzip

    with gzip.open(prefix + ".edge.gz", "rb") as fh:
        recs = fh.read().split(b">")
    extra = [r for r in recs[1::50] if r]
    with gzip.open(prefix + ".edge.gz", "wb") as fh:
        fh.write(b">".join(recs + extra))


def contig_base(prefix, reads, k, device):
    """A base changed in every fiftieth contig."""
    _rewrite_fasta(prefix + ".contig", 50)


def transcript_base(prefix, reads, k, device):
    """A base changed in every twentieth transcript record."""
    _rewrite_fasta(prefix + ".scafSeq", 20)


def drop_arcs(prefix, reads, k, device):
    """Every tenth line of .preArc left out."""
    with open(prefix + ".preArc") as fh:
        lines = fh.readlines()
    with open(prefix + ".preArc", "w") as fh:
        fh.writelines(l for i, l in enumerate(lines) if i % 10)


def shift_placements(prefix, reads, k, device):
    """Every tenth placement one base further along its contig."""
    with open(prefix + ".readOnContig") as fh:
        head, *rows = fh.readlines()
    for i in range(0, len(rows), 10):
        f = rows[i].split("\t")
        f[2] = str(int(f[2]) + 1)
        rows[i] = "\t".join(f)
    with open(prefix + ".readOnContig", "w") as fh:
        fh.writelines([head, *rows])


def _drop_records(path: str, every: int, opener=open) -> None:
    """Leave out every ``every``-th record of a FASTA file."""
    with opener(path, "rb") as fh:
        recs = fh.read().split(b">")
    with opener(path, "wb") as fh:
        fh.write(b">".join(recs[:1] + [r for i, r in enumerate(recs[1:])
                                       if i % every]))


def drop_edges(prefix, reads, k, device):
    """Every tenth edge record left out."""
    import gzip

    _drop_records(prefix + ".edge.gz", 10, gzip.open)


def drop_contigs(prefix, reads, k, device):
    """Every tenth contig record left out."""
    _drop_records(prefix + ".contig", 10)


def drop_placements(prefix, reads, k, device):
    """Every tenth placement left out."""
    with open(prefix + ".readOnContig") as fh:
        head, *rows = fh.readlines()
    with open(prefix + ".readOnContig", "w") as fh:
        fh.writelines([head] + [r for i, r in enumerate(rows) if i % 10])


def drop_transcripts(prefix, reads, k, device):
    """Every tenth transcript record left out."""
    _drop_records(prefix + ".scafSeq", 10)


CONTROLS = (half_reads_kmerfreq, edge_base, duplicate_edges, drop_arcs,
            contig_base, shift_placements, transcript_base, drop_edges,
            drop_contigs, drop_placements, drop_transcripts)
# the number each control that leaves output out has to fail
DROPS = {"drop_edges": "edge_kmers_missing_pct",
         "drop_contigs": "contig_kmers_missing_pct",
         "drop_placements": "reads_unplaced",
         "drop_transcripts": "contigs_unscaffolded"}


def readings(workload: str, seed: int, flags, controls,
             device_name: str = "cuda", pairs=None, transcripts=None,
             workroot=None):
    """Yield one dict a reading: the program's, then each control's
    (``controls``: true for all, or a list of names)."""
    import torch

    from port_bench import reference, run

    cell, config, mix, _, _ = run.cell_spec(workload)
    mix = {**mix, "transcripts": transcripts or mix["transcripts"]}
    if flags is not None:
        config = {**config, "flags": flags}
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = device_name
    os.environ["SOAPDENOVO_TORCH_NO_SHARD"] = "1"
    from port_bench import synth
    from soapdenovo_trans_tpu_torch import cli

    device = torch.device(device_name)
    pairs = pairs or synth.n_pairs(config, config["lib"]["max_rd_len"])
    workdir = tempfile.mkdtemp(prefix="port_bench_control_", dir=workroot)
    try:
        cfg, reads = run.make_dataset(os.path.join(workdir, "data"),
                                      config, mix, seed, pairs)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        asm = run.Assembler(cli, config, cfg, workdir, sync)
        t0 = time.time()
        res = asm.run()
        asm.close()
        seconds = time.time() - t0
        prefix = asm.prefix
        del res
        t0 = time.time()
        base = reference.check(prefix, reads, config["K"], device)
        yield {"seed": seed, "reading": "program", "flags": config["flags"],
               "assembly_s": seconds, "check_s": time.time() - t0, **base}
        if not controls:
            return
        for ctl in CONTROLS:
            if controls is not True and ctl.__name__ not in controls:
                continue
            copy = os.path.join(workdir, "ctl_" + ctl.__name__)
            shutil.copytree(os.path.dirname(prefix), copy)
            cprefix = os.path.join(copy, os.path.basename(prefix))
            ctl(cprefix, reads, config["K"], device)
            yield {"seed": seed, "reading": ctl.__name__,
                   **reference.check(cprefix, reads, config["K"], device)}
            shutil.rmtree(copy)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--flags", nargs=argparse.REMAINDER, default=None)
    ap.add_argument("--controls", nargs="*", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        ctl = args.controls is not None and (args.controls or True)
        for r in readings(args.workload, seed, args.flags, ctl):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
