"""Stage-file writers (reference-compatible formats).

A jax-free copy of ``write_kmer_freq``, ``write_pregraph_basic``,
``write_pe_grads``, ``write_contig_fasta``, ``write_contig_index``,
``write_placement_table``, ``write_gap_seq``, ``write_scaf_files`` and
``write_scaf_statistics`` from ``soapdenovo_trans_tpu/io/stagefiles.py``,
which imports the JAX package's ``ops/bits`` (and so ``jax``); the
machine that runs the port on the GPU has no jax.  The contig writers
take the port's tensors; the map and scaff writers take host arrays.

``_write_columns`` is numpy-only (the JAX package writes through pandas
when it can import it; the GPU machine has no pandas) and gives the
bytes that pandas' ``to_csv`` gives for integer and string columns.
"""

from __future__ import annotations

from typing import List

import numpy as np


def write_kmer_freq(path: str, histogram: np.ndarray) -> None:
    """.kmerFreq (reference freqStat, prlHashReads.c:994): one count
    per line for frequencies 1..255."""
    with open(path, "w") as fh:
        for i in range(1, len(histogram)):
            fh.write(f"{int(histogram[i])}\n")


def write_pregraph_basic(path: str, n_vertex: int, k: int, n_edge: int,
                         max_read_len: int, min_read_len: int = 0,
                         max_name_len: int = 256) -> None:
    """.preGraphBasic (reference output_vertex, output_pregraph.c:74)."""
    with open(path, "w") as fh:
        fh.write(f"VERTEX {n_vertex} K {k}\n")
        fh.write(f"\nEDGEs {n_edge}\n")
        fh.write(f"\nMaxReadLen {max_read_len} MinReadLen {min_read_len} "
                 f"MaxNameLen {max_name_len}\n")


def write_pe_grads(path: str, grads, n_reads: int,
                   max_read_len: int) -> None:
    """.peGrads (reference prlHashReads.c:635-644, parsed by
    loadPEgrads attachPEinfo.c:63): insert-size grads with cumulative
    read-count boundaries.  grads: [(insertS, pe_bound, rank,
    pair_num_cut)]."""
    with open(path, "w") as fh:
        fh.write(f"grads&num: {len(grads)}\t{n_reads}\t{max_read_len}\n")
        for ins, bound, rank, cut in grads:
            fh.write(f"{ins}\t{bound}\t{rank}\t{cut}\n")


def _wrap(seq: str, width: int = 100) -> str:
    return "\n".join(seq[i: i + width] for i in range(0, len(seq), width))


def write_contig_fasta(path: str, contigs, table, k: int,
                       arcs=None) -> List[int]:
    """.contig (reference output_contig, output_contig.c:120-240):
    contigs sorted by length ascending, ids assigned over the sorted
    order with twins sharing consecutive ids (only one of each twin
    pair printed), header '>id length L cvg_C.C_tip_T'.

    Returns the sorted-order permutation (new id - 1 -> contig row),
    the analogue of the reference's flag_array."""
    from ..graph import contig_merge

    n = contigs.n
    lengths = contigs.length[:n].cpu().numpy() + k
    twin = contigs.twin[:n].cpu().numpy()
    cvg = contigs.cvg[:n].cpu().numpy()
    seqs = contig_merge.contig_sequences(contigs, table, k)

    has_out = np.zeros(n, bool)
    if arcs is not None:
        f = arcs.from_ed[:arcs.n].cpu().numpy()
        has_out[f[(f >= 0) & (f < n)]] = True

    printed = np.zeros(n, bool)
    perm: List[int] = []
    out: List[str] = []
    cid = 0
    for row in np.argsort(lengths, kind="stable").tolist():
        if printed[row]:
            continue
        cid += 1
        perm.append(row)
        printed[row] = True
        t = int(twin[row])
        paired = 0 <= t < n
        if paired:
            printed[t] = True
        # a tip has arcs on at most one side (output_contig.c:232)
        tip = int(not (has_out[row] and paired and has_out[t]))
        out.append(f">{cid} length {lengths[row]} "
                   f"cvg_{cvg[row] / 10:.1f}_tip_{tip}\n")
        out.append(_wrap(seqs[row]) + "\n")
        if paired and t != row:
            cid += 1  # twin consumes an id, like the reference
            perm.append(t)
    with open(path, "w") as fh:
        fh.write("".join(out))
    return perm


def write_contig_index(path: str, contigs, k: int, perm) -> None:
    """.ContigIndex (reference output_contig.c:262-277)."""
    n = contigs.n
    lengths = contigs.length[:n].cpu().numpy() + k
    twin = contigs.twin[:n].cpu().numpy()
    out = [f"Edge_num {len(perm)} {len(perm)}\n",
           "index\tlength\treverseComplement\n"]
    i = 0
    while i < len(perm):
        row = perm[i]
        if twin[row] != row:
            out.append(f"{i + 1}\t{lengths[row]}\t1\n")
            i += 2
        else:
            out.append(f"{i + 1}\t{lengths[row]}\t0\n")
            i += 1
    with open(path, "w") as fh:
        fh.write("".join(out))


_ROWS_PER_WRITE = 1 << 20


def _write_columns(path: str, header, cols) -> None:
    """Tab-separated rows of equal-length 1-D columns behind an optional
    header line: each column is turned to text by numpy, the rows joined
    in C (about 1.5 s for 1.2M four-column rows on one CPU core)."""
    with open(path, "w") as fh:
        if header is not None:
            fh.write(header + "\n")
        n = len(cols[0])
        for lo in range(0, n, _ROWS_PER_WRITE):
            text = [np.asarray(c[lo:lo + _ROWS_PER_WRITE]).astype(str).tolist()
                    for c in cols]
            fh.write("\n".join(map("\t".join, zip(*text))) + "\n")


def write_placement_table(path: str, readno, ctg, pos, orien) -> None:
    """.readOnContig / .ctg2Read (reference recordAlldgn,
    prlRead2Ctg.c:565-574): 'readno contig pos orien' rows behind a
    'read\\tcontig\\tpos' header (prlRead2Ctg.c:734,739).
    .ctg2Read's pos column is readOffset-contigOffset — the transcript
    stage's single-read linking input (singleRead2connection,
    transcriptome.c:256)."""
    _write_columns(path, "read\tcontig\tpos", (readno, ctg, pos, orien))


def write_gap_seq(path: str, gap_report) -> None:
    """.gapSeq (reference outputSeqs/searchFgap, prlReadFillGap.c:1174,
    localAsm.c:739): one record per closed gap —
    '>scaffoldN_J method' + the sequence placed in the gap (empty for
    pure overlap merges)."""
    with open(path, "w") as fh:
        for scaf_idx, junc_idx, method, seq in gap_report:
            fh.write(f">scaffold{scaf_idx}_{junc_idx} {method}\n")
            if seq:
                fh.write(seq + "\n")


def write_scaf_files(prefix: str, transcripts, recs, ctg_len_excl,
                     twin, k: int, placements=None, routes=None,
                     n_runs=None) -> None:
    """.scaf / .scaf_gap / .contigPosInscaff / .agp in the reference
    formats (outputOneTranscriptome transcriptome.c:1158-1219,
    outputScafSeq prlReadFillGap.c:597-700).

    * .scaf / .scaf_gap coordinates are K-exclusive cumulative contig
      starts (start += length + gap); ids are 1-based, twin-resolved
      (smaller id + strand) in .scaf, raw directed in .scaf_gap.
    * GAP lines carry unique arc routes: 'GAP <route len> <seg> <ids>'
      (output1gap, orderContig.c:2313-2343).
    * .contigPosInscaff / .agp use RENDERED sequence coordinates from
      `placements` ([(ctg, out_start, out_len, strand)] per record).
    """
    routes = routes or {}
    n_runs = n_runs or {}
    scaf = open(prefix + ".scaf", "w")
    scaf_gap = open(prefix + ".scaf_gap", "w")
    cpis = open(prefix + ".contigPosInscaff", "w")
    agp = open(prefix + ".agp", "w")
    jid = 0
    for idx, tr in enumerate(transcripts, start=1):
        total = 0
        for i, c in enumerate(tr.contigs):
            total += int(ctg_len_excl[c])
            if i < len(tr.gaps):
                total += tr.gaps[i] + k  # CONNECT gap (K-exclusive)
        head = (f">scaffold{idx} {len(tr.contigs)} {total} "
                f"Locus_{tr.locus}_{tr.index} {tr.kind}\n")
        scaf.write(head)
        scaf_gap.write(head)
        pos = 0
        for i, c in enumerate(tr.contigs):
            fwd = c <= int(twin[c])
            rep = (c if fwd else int(twin[c])) + 1
            ln = int(ctg_len_excl[c])
            scaf.write(f"{rep:<10d} {pos:<10d} {'+' if fwd else '-'}   "
                       f"{ln + k} \n")
            if i > 0 and (jid + i - 1) in routes:
                r = routes[jid + i - 1]
                rlen = sum(int(ctg_len_excl[x]) for x in r)
                scaf_gap.write(
                    f"GAP {rlen} {len(r)}"
                    + "".join(f" {x + 1}" for x in r) + "\n")
            scaf_gap.write(f"{c + 1:<10d} {pos:<10d}\n")
            if i < len(tr.gaps):
                pos += ln + tr.gaps[i] + k
        jid += max(len(tr.contigs) - 1, 0)
        # .contigPosInscaff / .agp from rendered placements
        if placements is None or idx - 1 >= len(placements):
            continue
        cpis.write(f">scaffold{idx} Locus_{tr.locus}_{tr.index}\n")
        part = 0
        prev_end = 0
        for (c, start, out_len, strand) in placements[idx - 1]:
            rep = (c if strand == "+" else int(twin[c])) + 1
            full = int(ctg_len_excl[c]) + k
            if start > prev_end:  # N run before this contig
                part += 1
                agp.write(f"scaffold{idx}\t{prev_end + 1}\t{start}\t"
                          f"{part}\tN\t{start - prev_end}\tfragment\t"
                          f"yes\n")
            cpis.write(f"{rep}\t{start}\t{strand}\t{out_len}\n")
            part += 1
            agp.write(f"scaffold{idx}\t{start + 1}\t{start + out_len}\t"
                      f"{part}\tW\t{rep}\t{full - out_len + 1}\t{full}\t"
                      f"{strand}\n")
            prev_end = start + out_len
    for fh in (scaf, scaf_gap, cpis, agp):
        fh.close()


def _stat_section(fo, title, recs, len_cut=100, known_genome_size=0,
                  scaffold_word="scaffolds", count_key="Scaffold_Num",
                  singletons=False, n_break=False,
                  diff_word="scaffold"):
    """One section of the .scafStatistics report (ScafStat,
    reference src/orderContig.c:2421-3090): composition, size ladder,
    N10..N90 with counts, NG50.  recs: [(header, seq)]; records
    shorter than len_cut are excluded entirely (:2503-2519)."""
    fo.write(title + "\n\n")
    kept = [(h, s) for h, s in recs if len(s) >= len_cut]
    if not kept:
        fo.write("Size_includeN\t0\n\n")
        return 0, 0
    comp = {c: 0 for c in "ACGTN"}
    non_acgtn = 0
    sizes = []
    n_singleton = 0
    for h, s in kept:
        sizes.append(len(s))
        if h.startswith("C"):
            n_singleton += 1
        up = s.upper()
        for c in "ACGTN":
            comp[c] += up.count(c)
        non_acgtn += len(s) - sum(up.count(c) for c in "ACGTN")
    sizes.sort()  # ascending, like the reference qsort (:2620)
    n = len(sizes)
    total = sum(sizes)
    fo.write(f"Size_includeN\t{total}\n")
    fo.write(f"Size_withoutN\t{total - comp['N']}\n")
    fo.write(f"{count_key}\t{n}\n")
    fo.write(f"Mean_Size\t{total // n}\n")
    fo.write(f"Median_Size\t{sizes[(n + 1) // 2 - 1]}\n")
    fo.write(f"Longest_Seq\t{sizes[-1]}\n")
    fo.write(f"Shortest_Seq\t{sizes[0]}\n")
    if singletons:
        fo.write(f"Singleton_Num\t{n_singleton}\n")
        fo.write("Average_length_of_break(N)_in_scaffold\t"
                 f"{comp['N'] // n}\n")
        fo.write("\n")
        if known_genome_size:
            fo.write(f"Known_genome_size\t{known_genome_size}\n")
            fo.write("Total_scaffold_length_as_percentage_of_known_"
                     f"genome_size\t{100.0 * total / known_genome_size:.2f}%\n")
        else:
            fo.write("Known_genome_size\tNaN\n")
            fo.write("Total_scaffold_length_as_percentage_of_known_"
                     "genome_size\tNaN\n")
    fo.write("\n")
    for label, cut in ((">100 ", 100), (">500 ", 500), (">1K  ", 1000),
                       (">10K ", 10000), (">100K", 100000),
                       (">1M  ", 1000000)):
        cnt = sum(1 for x in sizes if x > cut)
        fo.write(f"{scaffold_word}{label}\t{cnt}\t{100.0 * cnt / n:.2f}%\n")
    fo.write("\n")
    for c in "ACGT":
        fo.write(f"Nucleotide_{c}\t{comp[c]}\t"
                 f"{100.0 * comp[c] / total:.2f}%\n")
    fo.write(f"GapContent_N\t{comp['N']}\t"
             f"{100.0 * comp['N'] / total:.2f}%\n")
    fo.write(f"Non_ACGTN\t{non_acgtn}\t{100.0 * non_acgtn / total:.2f}%\n")
    acgt = sum(comp[c] for c in "ACGT")
    gc = 100.0 * (comp['G'] + comp['C']) / acgt if acgt else 0.0
    fo.write(f"GC_Content\t{gc:.2f}%\t\t(G+C)/(A+C+G+T)\n")
    fo.write("\n")
    # NXX ladder — exact emulation of the descending else-if chain
    # (:2695-2725): a single record crossing several decade boundaries
    # leaves the skipped decades unprinted, matching the reference.
    flags = [False] * 10
    n50 = 0
    ng50 = num_ng50 = 0
    flag_known = False
    acc = 0
    for i in range(n - 1, -1, -1):
        acc += sizes[i]
        rank = n - i
        for d in range(1, 9):
            lo, hi = total * d / 10.0, total * (d + 1) / 10.0
            if lo <= acc < hi and not flags[d]:
                fo.write(f"N{d}0\t{sizes[i]}\t{rank}\n")
                flags[d] = True
                if d == 5:
                    n50 = sizes[i]
                break
        else:
            if acc >= total * 0.9 and not flags[9]:
                fo.write(f"N90\t{sizes[i]}\t{rank}\n")
                flags[9] = True
        if known_genome_size and not flag_known and \
                acc >= known_genome_size * 0.5:
            ng50, num_ng50 = sizes[i], rank
            flag_known = True
    if not flags[5]:  # fallback N50 recomputation (:2727-2740)
        acc = 0
        for i in range(n - 1, -1, -1):
            acc += sizes[i]
            if acc >= total * 0.5:
                fo.write(f"N50\t{sizes[i]}\t{n - i}\n")
                n50 = sizes[i]
                break
    fo.write("\n")
    w = diff_word
    if known_genome_size:
        fo.write(f"NG50\t{ng50}\t{num_ng50}\n")
        fo.write(f"N50_{w}-NG50_{w}_length_difference\t"
                 f"{abs(n50 - ng50)}\n")
    else:
        fo.write("NG50\tNaN\tNaN\n")
        fo.write(f"N50_{w}-NG50_{w}_length_difference\tNaN\n")
    fo.write("\n")
    return n, n_singleton


def write_scaf_statistics(prefix: str, known_genome_size: int = 0,
                          len_cut: int = 100) -> None:
    """.scafStatistics — the two-section assembly report of ScafStat
    (reference src/orderContig.c:2421, called ScafStat(100, ...) from
    scaffold.c:68): scaffold stats from .scafSeq, contig stats from
    .contig, each with composition/size-ladder/N10..N90/NG50."""
    def _recs(path):
        out, head, seq = [], None, []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line[0] == ">":
                    if head is not None:
                        out.append((head, "".join(seq)))
                    head, seq = line[1:], []
                else:
                    seq.append(line)
        if head is not None:
            out.append((head, "".join(seq)))
        return out

    scaf_recs = _recs(prefix + ".scafSeq")
    ctg_recs = _recs(prefix + ".contig")
    with open(prefix + ".scafStatistics", "w") as fo:
        n_scaf, n_single = _stat_section(
            fo, f"<-- Information for assembly Scaffold "
                f"'{prefix}.scafSeq'.(cut_off_length < {len_cut}bp) -->",
            scaf_recs, len_cut, known_genome_size,
            scaffold_word="scaffolds", count_key="Scaffold_Num",
            singletons=True)
        n_ctg, _ = _stat_section(
            fo, f"<-- Information for assembly Contig "
                f"'{prefix}.contig'.(cut_off_length < {len_cut}bp) -->",
            ctg_recs, len_cut, known_genome_size,
            scaffold_word="Contig", count_key="Contig_Num",
            diff_word="contig")
        # closing summary (ScafStat tail, orderContig.c:3079-3085):
        # singleton count from the SCAFFOLD section, contig count from
        # the contig section, average contigs per scaffold record
        fo.write("Number_of_contigs_in_scaffolds(Singleton)\t"
                 f"{n_single}\n")
        fo.write(f"Number_of_contigs_not_in_scaffolds\t"
                 f"{n_ctg - n_single}\n")
        avg = 1.0 * n_ctg / n_scaf if n_scaf else 0.0
        fo.write(f"Average_number_of_contigs_per_scaffold\t{avg:.1f}\n")
        fo.write("\n")
