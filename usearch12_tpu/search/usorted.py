"""USORT candidate ranking and the u-sorted search loop.

Reference semantics (src/udbusortedsearcher.cpp):
  - SetU: U[target] = shared unique word count (query unique words x target
    unique words via postings).
  - SetTopBump(MinU=1, bump=50): scan targets in index order; dynamic MinU
    raise to 50% of a new max (src/udbusortedsearcher.cpp:230-267).
  - CountSortOrderDesc: stable descending order, dropping candidates below
    NextValue/2 where NextValue is the running second-max of the forward
    scan (src/countsort.cpp:6-108).
  - Candidates aligned in that order until the Terminator fires.

The U computation itself is delegated to UDBIndex (host bincount; the
device rankers are ops/csr_rank.py and parallel/mesh_search.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import options
from ..index.udb import UDBIndex


def set_top_bump(u: np.ndarray, min_u: int, bump_pct: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (top_u, top_target_indexes) in target-index order.

    Vectorized: cur_min only changes at new-running-max positions, so the
    scan loops over those few events and filters each segment with numpy
    (identical results to the reference's element loop)."""
    bump = bump_pct / 100.0
    n = len(u)
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    u64 = u.astype(np.int64, copy=False)
    run_max_excl = np.maximum.accumulate(
        np.concatenate([[0], u64[:-1]]))
    events = np.nonzero(u64 > run_max_excl)[0]
    keep = np.zeros(n, dtype=bool)
    cur_min = min_u
    for e, pos in enumerate(events.tolist()):
        nxt = int(events[e + 1]) if e + 1 < len(events) else n
        # event element itself is gated by the OLD cur_min
        max_before = int(run_max_excl[pos])
        val = int(u64[pos])
        if val >= cur_min:
            keep[pos] = True
            new_min = int(val * bump)
            if cur_min < new_min < max_before:
                cur_min = new_min
        seg = slice(pos + 1, nxt)
        keep[seg] = u64[seg] >= cur_min
    if len(events) == 0 or events[0] > 0:
        seg = slice(0, int(events[0]) if len(events) else n)
        keep[seg] = u64[seg] >= min_u
    tix = np.nonzero(keep)[0]
    return u[tix].astype(np.uint32), tix.astype(np.int64)


def set_top_no_bump(u: np.ndarray, min_u: int):
    mask = u >= min_u
    tix = np.nonzero(mask)[0]
    return u[tix].astype(np.uint32), tix.astype(np.int64)


def count_sort_order_desc(values: np.ndarray) -> np.ndarray:
    """Stable descending order of `values`, truncated at MinValue =
    NextValue/2 (src/countsort.cpp)."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # next_value = running max just before the FIRST occurrence of the
    # global max (the reference's sequential scan semantics)
    fa = int(np.argmax(values))
    next_value = int(values[:fa].max()) if fa > 0 else 0
    min_value = next_value // 2
    keep = values >= min_value
    idx = np.nonzero(keep)[0]
    order = idx[np.argsort(-values[idx].astype(np.int64), kind="stable")]
    return order.astype(np.int64)


def quick_sort_order_desc(values: np.ndarray) -> np.ndarray:
    return np.argsort(-values.astype(np.int64), kind="stable").astype(np.int64)


# CD-HIT minimum-word-fraction table (src/wordparams.cpp:60-112)
_AMINO_FRACT = [
    0.00, 0.00, 0.00, 0.00, 0.01, 0.01, 0.01, 0.02, 0.02, 0.02,
    0.03, 0.04, 0.04, 0.05, 0.06, 0.06, 0.08, 0.08, 0.10, 0.10,
    0.11, 0.14, 0.14, 0.14, 0.17, 0.17, 0.18, 0.20, 0.21, 0.21,
    0.27, 0.28, 0.31, 0.34, 0.36, 0.41, 0.43, 0.45, 0.48, 0.54,
    0.55, 0.56, 0.64, 0.69, 0.73, 0.75, 0.80, 0.85, 0.90, 0.95,
]


def big_query_step(nuw: int, fract_id: float, word_ones: int,
                   is_nucleo: bool, stepwords: int, db_step: int) -> int:
    """GetWordCountingParams' Step (src/wordparams.cpp:168-193; MinU is
    computed by the reference but unused by UDBSearchBig)."""
    nuw_eff = nuw // max(db_step, 1)
    f = float(np.float32(fract_id))    # m_MinFractId is a float
    if is_nucleo:
        wf = 1.0 - (1.0 - f) * word_ones
        if wf < 0.0:
            thresh = 1
        else:
            wf *= nuw_eff
            thresh = 1 if wf < 1.0 else int(wf)
    elif f < 0.5:
        thresh = 0
    else:
        i = min(int((f - 0.5) * 100), 49)
        thresh = int(_AMINO_FRACT[i] * nuw_eff)
    if stepwords == 0:
        return 1
    return max(thresh // stepwords, 1)


class USortedRanker:
    """SetTargetOrder: query words -> ranked candidate target list."""

    def __init__(self, index: UDBIndex) -> None:
        self.index = index
        self._native = None
        if not index.params.hashed:
            # the C ranker computes rolling alphabet words; hashed
            # dictionaries (legacy .udb) use the python path
            try:
                from ..native import NativeRanker
                self._native = NativeRanker(index)
            except Exception:
                pass

    def rank(self, query_seq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ordered_target_indexes, their word counts)."""
        o = options()
        bump = o.uns("bump")
        big = (o.filled("id")
               and self.index.seq_count > o.uns("big"))
        if self._native is not None and not (o.flag("quicksort")
                                             and not big):
            # big mode ignores -quicksort (UDBSearchBig always
            # CountSortSubsetDesc's); the scratch is armed in __init__
            return self._native.rank(query_seq, bump, 0)
        params = self.index.params
        uw = params.unique_words(query_seq)
        if big:
            return self._rank_big_py(uw)
        u = self.index.count_u(uw)
        if bump != 0:
            top_u, top_tix = set_top_bump(u, 1, bump)
        else:
            top_u, top_tix = set_top_no_bump(u, 1)
        if o.flag("quicksort"):
            order = quick_sort_order_desc(top_u)
        else:
            order = count_sort_order_desc(top_u)
        return top_tix[order], top_u[order]

    def _rank_big_py(self, uw: np.ndarray):
        """UDBSearchBig (src/udbusortedsearcherbig.cpp:31-142), numpy:
        stepped query words, count desc with FIRST-TOUCH tie order,
        truncation below NextValue/2 with the traversal-order NextValue
        quirk (src/countsort.cpp:110-192)."""
        o = options()
        ix = self.index
        params = ix.params
        step = big_query_step(len(uw), o.flt("id"), params.word_length,
                              params.is_nucleo, o.uns("stepwords"),
                              getattr(ix, "db_step", 1))
        ix._flatten()
        starts, post = ix._starts, ix._postings
        sel = uw[::step].tolist()
        rows = [post[starts[w]:starts[w + 1]] for w in sel]
        stream = (np.concatenate(rows) if rows
                  else np.empty(0, np.int32))
        stream = stream[(stream >= 0) & (stream < ix.seq_count)]
        if len(stream) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.uint32))
        counts = np.bincount(stream, minlength=ix.seq_count)
        # first-touch order of targets = order of first occurrence
        ft_t, ft_idx = np.unique(stream, return_index=True)
        order_ft = ft_t[np.argsort(ft_idx, kind="stable")]
        vals = counts[order_ft].astype(np.int64)
        run_max = np.maximum.accumulate(
            np.concatenate(([0], vals[:-1])))
        raises = np.nonzero(vals > run_max)[0]
        nextv = int(run_max[raises[-1]]) if len(raises) else 0
        minv = nextv // 2
        keep = vals >= minv
        kt, kv = order_ft[keep], vals[keep]
        o2 = np.argsort(-kv, kind="stable")
        return kt[o2].astype(np.int64), kv[o2].astype(np.uint32)

    def get_u_ranked(self, query_seq: np.ndarray, self_delete: bool = False,
                     query_label: str = "", labels=None):
        """GetU (src/udbusortedsearcher.cpp:489-532): no-bump top list,
        optionally deleting the query itself from the tied-top block."""
        if self._native is not None:
            tix, counts = self._native.rank(query_seq, 0, 1)
        else:
            params = self.index.params
            uw = params.unique_words(query_seq)
            u = self.index.count_u(uw)
            top_u, top_tix = set_top_no_bump(u, 1)
            order = count_sort_order_desc(top_u)
            tix = top_tix[order]
            counts = top_u[order]
        if self_delete and len(tix) > 0 and labels is not None:
            top_count = counts[0]
            for i in range(len(tix)):
                if counts[i] < top_count:
                    break
                if labels[tix[i]] == query_label:
                    tix = np.delete(tix, i)
                    counts = np.delete(counts, i)
                    break
        return tix, counts

    def get_hot(self, query_seq: np.ndarray, max_hot: int, max_drop: int
                ) -> np.ndarray:
        """GetHot (src/udbusortedsearcher.cpp:534-568)."""
        tix, counts = self.rank(query_seq)
        n = len(tix)
        if n == 0:
            return tix
        if n > max_hot:
            n = max_hot
        top_count = int(counts[0])
        out = [tix[0]]
        for i in range(1, n):
            if top_count - int(counts[i]) > max_drop:
                return np.array(out, dtype=np.int64)
            out.append(tix[i])
        return np.array(out, dtype=np.int64)
