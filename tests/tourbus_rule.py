"""The port's Tour-Bus apply, one candidate at a time in numpy, and the
JAX wave with the port's arc rule laid over it.

The port's wave (``kernels/wave.claim_apply``) keeps the JAX package's
claims, deletes, coverage and positional cover, and departs from it in
the arc rows: where the JAX wave remaps every row of a winner's minority
node onto the node's cover, the port drops the row where its other end
is an edge the same winner claims (the bubble's own arcs), where the node
has no cover, and where the remapped row would not join
(``to_node[from] != from_node[to]``).  ``apply_loop`` recomputes all of
it here without the port's code; ``jax_wave_with_rule`` gives the JAX
``_wave``'s outputs with exactly the rows the rule drops set to (-1, -1,
0), the oracle that the port's pinch and its files are held against at
-M 1 and above.
"""

import numpy as np

MAX_COV = 16000  # unitigs.MAX_EDGE_COV, the wave's clamp


def _get(x, i, fill):
    return int(x[i]) if 0 <= i < len(x) else fill


def _span_holds(nodes, length, y, scale) -> bool:
    """Whether node y's span along the path ``nodes`` holds ``scale``."""
    cum = 0
    for x in nodes:
        ln = _get(length, x, 0)
        if x == y:
            return cum <= scale < cum + ln
        cum += ln
    return False


def apply_loop(maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b, cvg,
               length, twin, deleted, from_ed, to_ed, mult, from_node,
               to_node, max_cov):
    """``claim_apply`` one candidate at a time: each edge's least (rank,
    candidate), the winners, each winner's apply, then each arc row.
    Returns its six outputs and what the cases check: the claims, ranks
    and winners, how many covers took the fallback, and ``rule``, the
    rows that the arc rule drops and that the JAX wave would have kept
    remapped."""
    c, m = maj.shape
    e = len(cvg)
    claims, rank = [], []
    for r in range(c):
        claims.append([x for row in (maj, tw_maj, mnr, tw_mnr, ends)
                       for x in row[r] if 0 <= x < e])
        rank.append(sum(_get(cvg, x, 0) for x in mnr[r] if x >= 0))
    least = {}
    for r in range(c):
        if ok[r]:
            for x in claims[r]:
                least[x] = min(least.get(x, (rank[r], r)), (rank[r], r))
    win = [bool(ok[r]) and all(least[x] == (rank[r], r) for x in claims[r])
           for r in range(c)]
    cvg2, deleted2 = cvg.copy(), deleted.copy()
    remap, owner = {}, {}
    fallbacks = 0
    for r in np.flatnonzero(win):
        cover, cum_b = [], 0
        live = [x for x in maj[r] if x >= 0]
        last = int(maj[r][max(len(live) - 1, 0)])
        for x in mnr[r]:
            lb = _get(length, x, 0)
            mid, cum_b = cum_b + lb // 2, cum_b + lb
            scale = mid * len_a[r] // len_b[r] if len_b[r] > 0 else 0
            cv, cum_a = last, 0
            for y in maj[r]:
                ln = _get(length, y, 0)
                if y >= 0 and cum_a <= scale < cum_a + ln:
                    cv = int(y)
                    break
                cum_a += ln
            cover.append(cv if x >= 0 else -1)
            fallbacks += x >= 0 and cv == last and not any(
                y >= 0 and y == last and _span_holds(maj[r], length, y, scale)
                for y in maj[r])
        for x, tx, cv in zip(mnr[r], tw_mnr[r], cover):
            for node in (x, tx):
                if 0 <= node < e:
                    deleted2[node] = True
            tcv = _get(twin, cv, -1)
            if 0 <= cv < e:
                cvg2[cv] += _get(cvg, x, 0)
            if 0 <= tcv < e:
                cvg2[tcv] += _get(cvg, tx, 0)
        for idx, cov in ((mnr[r], cover),
                         (tw_mnr[r], [_get(twin, cv, -1) for cv in cover])):
            for x, cv in zip(idx, cov):
                if 0 <= x < e:
                    remap[int(x)], owner[int(x)] = int(cv), int(r)
    a = len(from_ed)
    new_f, new_t = np.full(a, -1), np.full(a, -1)
    rule = np.zeros(a, bool)
    for i, (f, t) in enumerate(zip(from_ed, to_ed)):
        f, t = int(f), int(t)
        nf = remap.get(f, f if f < e else -1) if f >= 0 else -1
        nt = remap.get(t, t if t < e else -1) if t >= 0 else -1
        if nf == nt and f != t:  # a self-loop the remap makes
            continue
        moved_f, moved_t = f in owner, t in owner
        if moved_f or moved_t:
            rule[i] = (moved_f and t in claims[owner[f]]) or \
                (moved_t and f in claims[owner[t]]) or nf < 0 or nt < 0 or \
                _get(to_node, nf, -1) != _get(from_node, nt, -2)
            if rule[i]:
                continue
        new_f[i], new_t[i] = nf, nt
    new_mult = np.where(new_f >= 0, mult, 0)
    return (np.clip(cvg2, 0, max_cov), deleted2, new_f, new_t, new_mult,
            int(np.sum(win)), {"claims": claims, "rank": rank, "win": win,
                               "fallbacks": fallbacks, "rule": rule})


def wave_rule(eg, aset, failed, m_max: int, diff: int, seq_cap: int,
              cand_cap: int, max_cov: int):
    """``apply_loop``'s ``rule`` on one wave's state (numpy or JAX arrays,
    as the JAX ``_wave`` takes them): the candidates' paths and verdicts
    from the port's plain front and identity check (their candidate rows,
    counts and marks are held against the JAX wave elsewhere), then the
    loop.  Rows of multiplicity 0 (the JAX tables' padding) are never
    marked."""
    import torch

    from soapdenovo_trans_tpu_torch.kernels import lcs, wave

    def t(x):
        return torch.from_numpy(np.asarray(x).astype(
            bool if np.asarray(x).dtype == bool else np.int64))

    cvg, twin, length = t(eg.cvg), t(eg.twin), t(eg.length)
    deleted = t(eg.deleted)
    from_ed, to_ed, mult = t(aset.from_ed), t(aset.to_ed), t(aset.mult)
    (_cid, _cmask, _u, _t0, maj, mnr, tw_maj, tw_mnr, ends, found, _nb,
     _nc) = wave.front_plain(int(eg.n_edges), deleted, cvg, twin, from_ed,
                             to_ed, mult, t(failed), m_max, cand_cap)
    len_a, len_b, _cmp, ok, _ = lcs.identity_check(
        maj, mnr, found, length, t(eg.seq_off),
        torch.from_numpy(np.array(eg.seq_pool)), diff, seq_cap)
    xs = [x.numpy() for x in (maj, mnr, tw_maj, tw_mnr, ends, ok, len_a,
                              len_b, cvg, length, twin, deleted, from_ed,
                              to_ed, mult, t(eg.from_node), t(eg.to_node))]
    rule = apply_loop(*xs, max_cov)[6]["rule"]
    return rule & (xs[14] > 0)


def jax_wave_with_rule(jwave, max_cov: int):
    """The JAX ``_wave`` (``jwave``) with the rows the port's arc rule
    drops set to (-1, -1, 0) in a wave that merged; every other output as
    it gives them; ``wrapped.dropped`` counts the rows of multiplicity
    above 0 that its waves left as (-1, -1, 0).  ``rule_on`` puts it in
    place of ``soapdenovo_trans_tpu.graph.tourbus._wave``, so that the JAX
    pinch, and the JAX CLI, run under the rule."""
    import jax.numpy as jnp

    def wrapped(eg, aset, failed, m_max, diff, seq_cap, cand_cap):
        out = list(jwave(eg, aset, failed, m_max, diff, seq_cap, cand_cap))
        if int(out[7]) == 0:
            return tuple(out)
        drop = wave_rule(eg, aset, failed, m_max, diff, seq_cap, cand_cap,
                         max_cov)
        for i, fill in ((2, -1), (3, -1), (4, 0)):
            x = np.asarray(out[i])
            out[i] = jnp.asarray(np.where(drop, fill, x).astype(x.dtype))
        # the rows a wave drops, as the port's back counts them
        wrapped.dropped += int(((np.asarray(aset.from_ed) >= 0)
                                & (np.asarray(aset.mult) > 0)
                                & (np.asarray(out[2]) < 0)).sum())
        return tuple(out)
    wrapped.dropped = 0
    return wrapped


def rule_on(mp):
    """Run the JAX package's Tour-Bus under the port's arc rule while the
    ``pytest.MonkeyPatch`` ``mp`` holds; returns the wrapped wave."""
    from soapdenovo_trans_tpu.graph import tourbus as jtour

    ruled = jax_wave_with_rule(jtour._wave, MAX_COV)
    mp.setattr(jtour, "_wave", ruled)
    return ruled
