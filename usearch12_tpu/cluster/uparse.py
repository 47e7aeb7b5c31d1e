"""UPARSE-REF OTU construction: cluster_otus.

Pipeline parity with the reference:
  - driver loop: src/clustersmallmem.cpp:49-149 (size-sorted streaming
    greedy loop, -minsize 2 default stops at the first small read)
  - searcher: src/chunksearcher.cpp (usorted search, then chunked hot-
    candidate gathering or align-all for small DBs)
  - model: src/uparsesink.cpp (candidate selection, star MSA, segmenting
    DP over MSA columns, chimera-model classification MOD_*)
  - DP: src/uparsedp.cpp (DP[j][col] = best segmentation path ending at
    column col in candidate j; switches = chimera breakpoints)
  - MSA: src/staralign.cpp (query-anchored star alignment from the
    pairwise global paths)
  - admission: src/upclustersink.cpp (MOD_other -> new OTU centroid;
    MOD_perfect_chimera -> admitted to the search DB but flagged chimeric
    and excluded from -otus output)

Device note: the per-query global alignments run through the shared
native banded-NW path (align_one below); the star-MSA segmenting DP is a
tiny dense problem (<=100 candidates x ~500 columns) kept on host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB, size_from_label
from ..io.fastx import write_fasta, write_fastq
from ..alpha import MATCH_MX_NUCLEO, TO_UPPER
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex, UDBParams
from ..search.accepter import Accepter
from ..search.terminator import Terminator
from ..search.hitmgr import HitMgr
from ..search.usorted import USortedRanker
from ..align.result import AlignResult

OTU_RADIUS_PCT = 3.0          # src/uparsesink.h:21
OTU_PCTID = 100.0 - OTU_RADIUS_PCT
OTU_PCTID1 = 95.0

_GAP = ord("-")
_DOT = ord(".")
_TU_C = None
_MU8_C = None


def _TO_UPPER_C():
    global _TU_C
    if _TU_C is None:
        _TU_C = np.ascontiguousarray(TO_UPPER)
    return _TU_C


def _MATCH_U8_C():
    global _MU8_C
    if _MU8_C is None:
        _MU8_C = np.ascontiguousarray(MATCH_MX_NUCLEO.astype(np.uint8))
    return _MU8_C

MOD_PERFECT = "perfect"
MOD_GOOD = "good"
MOD_NOISY = "noisy"
MOD_PERFECT_CHIMERA = "perfect_chimera"
MOD_NOISY_CHIMERA = "noisy_chimera"
MOD_OTHER = "other"


def get_chunk_info(L: int, chunks: int, minchunk: int
                   ) -> Tuple[int, List[int]]:
    """ChunkSearcher::GetChunkInfo (src/chunksearcher.cpp:11-38), including
    the reference's last-chunk offset quirk (Lo = L - Length - 1)."""
    if L <= minchunk:
        return L, [0]
    length = (L - 1) // chunks + 1
    if length < minchunk:
        length = minchunk
    los: List[int] = []
    lo = 0
    while True:
        if lo + length >= L:
            los.append(L - length - 1)
            return length, los
        los.append(lo)
        lo += length


# ---------------------------------------------------------------------------
# Star MSA (src/staralign.cpp)
# ---------------------------------------------------------------------------

def _inc_insert_counts(path: str, ql: int, insert_counts: List[int]) -> None:
    """IncInsertCounts (src/staralign.cpp:15-41)."""
    i = 0
    n = 0
    for c in path:
        if c in "MD":
            if n > insert_counts[i]:
                insert_counts[i] = n
            n = 0
            i += 1
        elif c == "I":
            n += 1
        else:
            raise AssertionError(f"bad path op {c}")
    assert i == ql
    if n > insert_counts[ql]:
        insert_counts[ql] = n


def _make_target_row(path: str, t: np.ndarray, insert_counts: List[int],
                     row: np.ndarray) -> None:
    """MakeTargetRow (src/staralign.cpp:43-111)."""
    col = 0
    i = 0
    j = 0
    n = 0
    for c in path:
        if c in "MD":
            while n < insert_counts[i]:
                row[col] = _GAP
                col += 1
                n += 1
            n = 0
        if c == "M":
            row[col] = t[j]
            col += 1
            i += 1
            j += 1
        elif c == "D":
            row[col] = _GAP
            col += 1
            i += 1
        else:  # I
            row[col] = t[j]
            col += 1
            j += 1
            n += 1
    ql = len(insert_counts) - 1
    while n < insert_counts[ql]:
        row[col] = _GAP
        col += 1
        n += 1
    assert col == len(row)


def star_align(query_seq: np.ndarray, cand_seqs: List[np.ndarray],
               paths: List[str]) -> np.ndarray:
    """StarAlign (src/staralign.cpp:185-247): returns the MSA as a 2D uint8
    array with rows = candidates in order, then the query as the last row."""
    ql = len(query_seq)
    insert_counts = [0] * (ql + 1)
    for path in paths:
        _inc_insert_counts(path, ql, insert_counts)

    col_count = sum(insert_counts[i] + 1 for i in range(ql))
    col_count += insert_counts[ql]

    n_cand = len(cand_seqs)
    msa = np.full((n_cand + 1, col_count), _GAP, dtype=np.uint8)
    for ti in range(n_cand):
        _make_target_row(paths[ti], cand_seqs[ti], insert_counts, msa[ti])

    col = 0
    qrow = msa[n_cand]
    for i in range(ql):
        col += insert_counts[i]
        qrow[col] = query_seq[i]
        col += 1
    assert col + insert_counts[ql] == col_count
    return msa


def _trim_term_gaps(msa: np.ndarray) -> np.ndarray:
    """SeqDB::GetTermGapRange + DeleteColRange (src/seqdb.cpp:886-953):
    keep the column range where every row has its terminal gaps trimmed."""
    is_res = (msa != _GAP) & (msa != _DOT)
    lo = 0
    hi = msa.shape[1] - 1
    for r in range(msa.shape[0]):
        nz = np.nonzero(is_res[r])[0]
        if len(nz) == 0:
            raise SystemExit("Sequence is all gaps in star MSA")
        if nz[0] > lo:
            lo = int(nz[0])
        if nz[-1] < hi:
            hi = int(nz[-1])
    if hi < lo:
        return msa[:, lo:lo]
    return msa[:, lo:hi + 1]


# ---------------------------------------------------------------------------
# Segmenting DP over MSA columns (src/uparsedp.cpp)
# ---------------------------------------------------------------------------

class ParseResult:
    """Slice of UParseSink state produced by Parse()."""

    def __init__(self) -> None:
        self.mod = MOD_OTHER
        self.candidates: List[AlignResult] = []
        self.top_cand_index: Optional[int] = None
        self.diffs_qt: Optional[int] = None   # None == UINT_MAX
        self.pct_id_qt: float = -1.0
        self.diffs_qm: Optional[int] = None
        self.pct_id_qm: float = -1.0
        self.seg_count: Optional[int] = None
        self.seg_cand_indexes: List[int] = []
        self.seg_col_los: List[int] = []
        self.seg_los: List[int] = []
        self.seg_lengths: List[int] = []
        self.q_col_lo: int = 0
        self.q_col_hi: int = 0
        self.msa: Optional[np.ndarray] = None
        self.top_seg_index: Optional[int] = None
        self.second_seg_index: Optional[int] = None


def _uparse_dp(res: ParseResult, msa: np.ndarray) -> None:
    """UParseSink::DP (src/uparsedp.cpp:14-308)."""
    o = options()
    match_score = np.float32(o.flt("uparse_match"))
    mismatch_score = np.float32(o.flt("uparse_mismatch"))
    break_score = np.float32(o.flt("uparse_break"))

    msa = _trim_term_gaps(msa)
    res.msa = msa
    col_count = msa.shape[1]
    n_cand = msa.shape[0] - 1
    assert n_cand > 0
    qrow = msa[n_cand]

    from ..native import get_lib
    lib = get_lib()
    col_to_cand = np.empty(col_count, dtype=np.int64)
    if lib is not None and col_count:
        msa_c = np.ascontiguousarray(msa)
        diffs = np.empty(n_cand, dtype=np.int64)
        top_o = np.empty(1, dtype=np.int64)
        lib.uparse_dp_c(msa_c.ctypes.data, n_cand, col_count,
                        _TO_UPPER_C().ctypes.data,
                        _MATCH_U8_C().ctypes.data,
                        float(match_score), float(mismatch_score),
                        float(break_score),
                        col_to_cand.ctypes.data, diffs.ctypes.data,
                        top_o.ctypes.data)
        res.top_cand_index = int(top_o[0])
        res.diffs_qt = int(diffs[res.top_cand_index])
        res.pct_id_qt = (col_count - res.diffs_qt) * 100.0 / col_count
    else:
        # top hit by whole-row diff count (src/uparsedp.cpp:58-80)
        qup = TO_UPPER[qrow]
        diffs = np.empty(n_cand, dtype=np.int64)
        for j in range(n_cand):
            diffs[j] = int(np.count_nonzero(
                ~MATCH_MX_NUCLEO[qrow, msa[j]]))
        res.top_cand_index = int(np.argmin(diffs))  # strict <, first wins
        res.diffs_qt = int(diffs[res.top_cand_index])
        res.pct_id_qt = (col_count - res.diffs_qt) * 100.0 / col_count

        # DP over columns (float32 like the reference's Mx<float>)
        dp = np.zeros((n_cand, col_count + 1), dtype=np.float32)
        tb = np.zeros((n_cand, col_count + 1), dtype=np.int64)
        tb[:, 0] = np.arange(n_cand)

        tup = TO_UPPER[msa[:n_cand]]
        jidx = np.arange(n_cand)
        for col in range(col_count):
            q = qrow[col]
            cur = dp[:, col]
            s = cur + break_score
            i1 = int(np.argmax(s))
            m1 = s[i1]
            if n_cand > 1:
                s2 = s.copy()
                s2[i1] = -np.inf
                i2 = int(np.argmax(s2))
                m2 = s2[i2]
            else:
                i2, m2 = i1, np.float32(-np.inf)
            best = cur.copy()
            bestj = jidx.copy()
            # candidate j's best switch source: first strictly-greater
            # scan (src/uparsedp.cpp:108-120) == first-occurrence argmax
            switch_val = np.where(jidx == i1, m2, m1)
            switch_idx = np.where(jidx == i1, i2, i1)
            take = switch_val > best
            best = np.where(take, switch_val, best)
            bestj = np.where(take, switch_idx, bestj)

            t = msa[:n_cand, col]
            this_score = np.where(
                tup[:, col] == qup[col], match_score,
                np.where((q == _DOT) | (t == _DOT), np.float32(0.0),
                         mismatch_score))
            dp[:, col + 1] = best + this_score
            tb[:, col + 1] = bestj

        # traceback (src/uparsedp.cpp:151-178)
        j = int(np.argmax(dp[:, col_count]))   # strict >, first wins
        k = col_count
        while k > 0:
            col_to_cand[k - 1] = j
            j = int(tb[j][k])
            k -= 1

    # segment extraction (src/uparsedp.cpp:180-270)
    res.seg_cand_indexes = []
    res.seg_col_los = []
    res.seg_lengths = []
    res.q_col_lo = -1
    res.q_col_hi = -1
    last_cand = -1
    seg_length = 0
    seg_col_lo = 0
    for col in range(col_count):
        q = qrow[col]
        if q == _DOT:
            continue
        if res.q_col_lo < 0:
            res.q_col_lo = col
        res.q_col_hi = col
        if q == _GAP:
            continue
        cand = int(col_to_cand[col])
        if cand != last_cand:
            if seg_length > 0:
                res.seg_cand_indexes.append(last_cand)
                res.seg_lengths.append(seg_length)
                res.seg_col_los.append(seg_col_lo)
                seg_length = 0
            seg_col_lo = col
            last_cand = cand
        seg_length += 1
    if seg_length > 0:
        res.seg_cand_indexes.append(last_cand)
        res.seg_lengths.append(seg_length)
        res.seg_col_los.append(seg_col_lo)
    res.seg_count = len(res.seg_lengths)

    # longest seg / second-longest seg (src/uparsedp.cpp:272-286)
    res.top_seg_index = None
    res.second_seg_index = None
    for si in range(res.seg_count):
        if res.top_seg_index is None or \
                res.seg_lengths[si] > res.seg_lengths[res.top_seg_index]:
            res.top_seg_index = si
    for si in range(res.seg_count):
        if si == res.top_seg_index:
            continue
        if res.second_seg_index is None or \
                res.seg_lengths[si] > res.seg_lengths[res.second_seg_index]:
            res.second_seg_index = si

    # seg start positions in ungapped parent coords (ColToUngappedPos)
    res.seg_los = []
    for si in range(res.seg_count):
        cand = res.seg_cand_indexes[si]
        col = res.seg_col_los[si]
        row = msa[cand][:col]
        res.seg_los.append(
            int(np.count_nonzero((row != _GAP) & (row != _DOT))))


def _seg_col_hi(res: ParseResult, seg_index: int) -> int:
    """GetSegColHi (src/uparsepretty.cpp:282-288)."""
    if seg_index < res.seg_count - 1:
        return res.seg_col_los[seg_index + 1] - 1
    return res.q_col_hi


def _compare_qm(res: ParseResult, query_L: int) -> None:
    """CompareQM (src/uparsepretty.cpp:349-391), including the reference's
    `a && b || c` operator-precedence quirk in the terminal-gap trims."""
    msa = res.msa
    n_cand = msa.shape[0] - 1
    qrow = msa[n_cand]
    top_row = msa[res.top_cand_index]
    col_count = msa.shape[1]
    diffs_qm = 0
    diffs_qt = 0
    for si in range(res.seg_count):
        seg_col_lo = res.seg_col_los[si]
        seg_col_hi = _seg_col_hi(res, si)
        cand = res.seg_cand_indexes[si]
        prow = msa[cand]
        col_lo = max(res.q_col_lo, seg_col_lo)
        col_hi = min(res.q_col_hi, seg_col_hi)
        if si == 0:
            while ((col_lo < col_hi and qrow[col_lo] == _GAP)
                   or prow[col_lo] == _GAP):
                col_lo += 1
                if col_lo >= col_count:
                    break
        if si == res.seg_count - 1:
            while ((col_hi > col_lo and qrow[col_hi] == _GAP)
                   or prow[col_hi] == _GAP):
                col_hi -= 1
                if col_hi < 0:
                    break
        for col in range(col_lo, col_hi + 1):
            q = qrow[col]
            p = prow[col]
            t = top_row[col]
            if (q != _GAP or p != _GAP) and not MATCH_MX_NUCLEO[q, p]:
                diffs_qm += 1
            if (q != _GAP or t != _GAP) and not MATCH_MX_NUCLEO[q, t]:
                diffs_qt += 1
    res.diffs_qm = diffs_qm
    res.diffs_qt = diffs_qt
    res.pct_id_qm = 100.0 * (1.0 - float(np.float32(diffs_qm)
                                         / np.float32(query_L)))
    res.pct_id_qt = 100.0 * (1.0 - float(np.float32(diffs_qt)
                                         / np.float32(query_L)))


def _get_seg_diffs(res: ParseResult, seg_index: int) -> int:
    """GetSegDiffs (src/uparsepretty.cpp:32-60): counts columns from the
    seg's ColLo until SegLength columns have been consumed (a column with
    a parent-insert query gap still counts toward the length)."""
    msa = res.msa
    n_cand = msa.shape[0] - 1
    qrow = msa[n_cand]
    trow = msa[res.seg_cand_indexes[seg_index]]
    col_lo = res.seg_col_los[seg_index]
    seg_length = res.seg_lengths[seg_index]
    n = 0
    diff = 0
    col = col_lo
    col_count = msa.shape[1]
    while n < seg_length and col < col_count:
        q = TO_UPPER[qrow[col]]
        t = TO_UPPER[trow[col]]
        col += 1
        if t == _DOT and q == _GAP:
            continue
        n += 1
        if t != _DOT and q != _GAP and q != t:
            diff += 1
    return diff


# ---------------------------------------------------------------------------
# Parse + classification (src/uparsesink.cpp)
# ---------------------------------------------------------------------------

def uparse_parse(query_label: str, query_seq: np.ndarray,
                 hits: List[AlignResult]) -> ParseResult:
    """UParseSink::Parse (src/uparsesink.cpp:280-309)."""
    o = options()
    res = ParseResult()
    if not hits:
        return res

    # SetCandidates (src/uparsesink.cpp:237-278): hits via HitMgr::GetHit,
    # which is SCORE-SORTED descending order (src/hitmgr.cpp:464-483,
    # QuickSortOrderDesc on float32 fract-id), then filtered by query
    # coverage >= 0.8 and the optional -selfid exact-id exclusion.
    hm = HitMgr()
    hm.hits = hits
    sorted_hits = hm.sorted_hits()
    selfid = o.flag("selfid")
    diffs_qt = None
    top_cand = None
    for ar in sorted_hits:
        if ar.get_query_cov() < 0.8:
            continue
        fid = ar.get_fract_id()
        if selfid and fid == 1.0:
            continue
        d = ar.get_diff_count()
        if diffs_qt is None or d < diffs_qt:
            diffs_qt = d
            top_cand = len(res.candidates)
        res.candidates.append(ar)

    if not res.candidates:
        return res
    res.top_cand_index = top_cand
    res.diffs_qt = diffs_qt

    if len(res.candidates) == 1:
        # SetModelTop (src/uparsesink.cpp:183-195): stats from the HitMgr
        # top hit (max score over ALL hits, not just candidates).
        hm = HitMgr()
        hm.hits = hits
        top = hm.top_hit()
        res.seg_count = 1
        res.seg_cand_indexes = [res.top_cand_index]
        res.diffs_qt = top.get_diff_count()
        res.pct_id_qt = top.get_pct_id()
        res.diffs_qm = res.diffs_qt
        res.pct_id_qm = res.pct_id_qt
        return res

    cand_seqs = [ar.target_seq for ar in res.candidates]
    paths = [ar.path for ar in res.candidates]
    msa = star_align(query_seq, cand_seqs, paths)
    _uparse_dp(res, msa)
    _compare_qm(res, len(query_seq))
    return res


def calc_mod(res: ParseResult, query_size: int, is_cluster_otus: bool
             ) -> str:
    """UParseSink::CalcMod (src/uparsesink.cpp:542-576)."""
    if res.diffs_qt == 0:
        return MOD_PERFECT
    if res.seg_count in (2, 3):
        if res.diffs_qm == 0:
            return MOD_PERFECT_CHIMERA
        if res.diffs_qm == 1:
            return MOD_NOISY_CHIMERA
    if is_cluster_otus:
        if (res.seg_count == 2 and res.pct_id_qt < OTU_PCTID
                and res.pct_id_qm >= OTU_PCTID):
            return MOD_NOISY_CHIMERA
    else:
        if (res.seg_count == 2 and res.diffs_qm is not None
                and res.diffs_qt is not None
                and 2 * res.diffs_qm < res.diffs_qt):
            return MOD_NOISY_CHIMERA
    if res.diffs_qt is None:
        return MOD_OTHER
    if res.pct_id_qt >= 99.0:
        return MOD_GOOD
    if query_size == 1 and res.pct_id_qt >= OTU_PCTID1:
        return MOD_NOISY
    if res.pct_id_qt >= OTU_PCTID:
        return MOD_NOISY
    return MOD_OTHER


def mod_to_str(mod: str, is_cluster_otus: bool) -> str:
    """ModToStr (src/uparsesink.cpp:27-59)."""
    if is_cluster_otus:
        if mod == MOD_OTHER:
            return "otu"
        if mod in (MOD_NOISY, MOD_GOOD):
            return "match"
    return mod


def _strip_all_annots(label: str) -> str:
    """StripAllAnnots (src/label.cpp:5-11)."""
    n = label.find(";")
    if n <= 0:
        return label
    return label[:n]


def _get_parent_str(res: ParseResult) -> str:
    """GetParentStr (src/uparsesink.cpp:467-485)."""
    parts = []
    for si in range(res.seg_count):
        cand = res.seg_cand_indexes[si]
        label = _strip_all_annots(res.candidates[cand].target_label)
        lo = res.seg_los[si]
        hi = lo + res.seg_lengths[si] - 1
        d = _get_seg_diffs(res, si)
        parts.append(f"{label}({lo + 1}-{hi + 1}/{d})")
    return "+".join(parts)


def get_info_str(res: ParseResult, mod: str) -> str:
    """GetInfoStr (src/uparsesink.cpp:356-409)."""
    top_label = "*"
    if res.candidates and res.top_cand_index is not None:
        top_label = res.candidates[res.top_cand_index].target_label

    s = ""
    if res.diffs_qm == 0 and res.diffs_qt == 0:
        return f"top={top_label}({res.pct_id_qt:.1f}%);"
    if res.diffs_qt is not None:
        s += f"dqt={res.diffs_qt};"
        if res.pct_id_qt >= 90.0:
            s += f"top={top_label}({res.pct_id_qt:.1f}%);"
    if mod in (MOD_PERFECT_CHIMERA, MOD_NOISY_CHIMERA):
        div = res.pct_id_qm - res.pct_id_qt   # GetDivPct
        s += f"dqm={res.diffs_qm};"
        s += f"div={div:.1f};"
        s += f"segs={res.seg_count}"
        s += f";parents={_get_parent_str(res)};"
    if not s:
        s = "*"
    return s


# ---------------------------------------------------------------------------
# -uparsealnout pretty report (src/uparsepretty.cpp)
# ---------------------------------------------------------------------------

def _seg_char(res: ParseResult, seg_index: int) -> str:
    """GetSegChar (src/uparsepretty.cpp:238-249)."""
    cand = res.seg_cand_indexes[seg_index]
    if cand == res.top_cand_index:
        return "T"
    for i in range(seg_index + 1):
        if res.seg_cand_indexes[i] == cand:
            return chr(ord("A") + i)
    return "!"


def _parent_dupe(res: ParseResult, seg_index: int) -> bool:
    cand = res.seg_cand_indexes[seg_index]
    return cand in res.seg_cand_indexes[:seg_index]


def _top_hit_is_parent(res: ParseResult) -> bool:
    return res.top_cand_index in res.seg_cand_indexes


def _seg_parent_pct_id(res: ParseResult, seg_index: int) -> float:
    """GetSegParentPctId (src/uparsepretty.cpp:8-30): raw char compare
    (NOT the match matrix) over QColLo..QColHi, skipping dual '-' cols."""
    msa = res.msa
    q = TO_UPPER[msa[msa.shape[0] - 1]]
    t = TO_UPPER[msa[res.seg_cand_indexes[seg_index]]]
    diffs = 0
    n = 0
    for col in range(res.q_col_lo, res.q_col_hi + 1):
        if q[col] == _GAP and t[col] == _GAP:
            continue
        n += 1
        if q[col] != t[col]:
            diffs += 1
    return 100.0 * (1.0 - diffs / n)


def _seg_votes(res: ParseResult, seg_index: int):
    """GetSegVotes (src/uparsepretty.cpp:297-347)."""
    msa = res.msa
    lo = res.seg_col_los[seg_index]
    hi = _seg_col_hi(res, seg_index)
    q = TO_UPPER[msa[msa.shape[0] - 1]]
    top_row = TO_UPPER[msa[res.seg_cand_indexes[res.top_seg_index]]]
    y = n = a = 0
    if seg_index == res.top_seg_index:
        other = TO_UPPER[msa[res.seg_cand_indexes[res.second_seg_index]]]
        for col in range(lo, hi + 1):
            qc, tc, p2 = q[col], top_row[col], other[col]
            if qc == tc and qc == p2:
                pass
            elif qc == tc and qc != p2:
                y += 1
            elif qc != tc and qc == p2:
                n += 1
            else:
                a += 1
        return y, n, a
    parent = TO_UPPER[msa[res.seg_cand_indexes[seg_index]]]
    for col in range(lo, hi + 1):
        qc, pc, tc = q[col], parent[col], top_row[col]
        if qc == pc and qc == tc:
            pass
        elif qc == pc and qc != tc:
            y += 1
        elif qc != pc and qc == tc:
            n += 1
        else:
            a += 1
    return y, n, a


def _write_segs_table(f, res: ParseResult, query_L: int,
                      query_label: str) -> None:
    """WriteSegs (src/uparsepretty.cpp:62-143)."""
    if res.seg_count < 1:
        return
    f.write("\n")
    f.write("Parent      Lo      Hi  SegLen  Diffs  Yes   No  Abs"
            "  SegPctId  ParentPctId  Label\n")
    f.write("------  ------  ------  ------  -----  ---  ---  ---"
            "  --------  -----------  -----\n")
    sum_length = sum_diffs = sum_y = sum_n = sum_a = 0
    for si in range(res.seg_count):
        cand = res.seg_cand_indexes[si]
        parent_label = res.candidates[cand].target_label
        c = _seg_char(res, si)
        pos = res.seg_los[si]
        seg_len = res.seg_lengths[si]
        diffs = _get_seg_diffs(res, si)
        seg_pct = 100.0 * (1.0 - diffs / seg_len)
        parent_pct = _seg_parent_pct_id(res, si)
        y, n, a = _seg_votes(res, si)
        sum_y += y
        sum_n += n
        sum_a += a
        sum_length += seg_len
        sum_diffs += diffs
        f.write("%6c  %6u  %6u  %6u  %5u" % (
            c, pos + 1, pos + seg_len, seg_len, diffs))
        f.write("  %3u  %3u  %3u" % (y, n, a))
        f.write("  %8.1f  %11.1f  %s\n" % (seg_pct, parent_pct,
                                           parent_label))
    if sum_length != query_L:
        f.write("\nWARNING SumLength %u, QL %u >%s\n" % (
            sum_length, query_L, query_label))
        return
    if not _top_hit_is_parent(res):
        top_label = res.candidates[res.top_cand_index].target_label
        f.write("%6c                          %5u" % ("T", res.diffs_qt))
        f.write("               ")
        f.write("            %11.1f  %s\n" % (res.pct_id_qt, top_label))
    if res.seg_count > 1:
        model_pct = 100.0 * (1.0 - sum_diffs / sum_length)
        f.write("                        ------  -----  ---  ---  ---"
                "  --------  -----------\n")
        f.write("                        %6u  %5u  %3u  %3u  %3u"
                "  %8.1f\n" % (sum_length, sum_diffs, sum_y, sum_n,
                               sum_a, model_pct))


def _vote_char(qc: int, tc: int, pc: int) -> str:
    """GetVoteChar (src/uparsepretty.cpp:394-409): q vs parent vs top."""
    if qc == pc and qc == tc:
        return "_"
    if qc == pc and qc != tc:
        return "+"
    if qc == tc and qc != pc:
        return "X"
    return "o"


def _x_col_lo_hi(res: ParseResult):
    """GetXColLoHi (src/uparsepretty.cpp:436-527): crossover column range
    for 2-segment models."""
    msa = res.msa
    q = TO_UPPER[msa[msa.shape[0] - 1]]
    ca, cb = res.seg_cand_indexes[0], res.seg_cand_indexes[1]
    lo_a, lo_b = res.seg_col_los[0], res.seg_col_los[1]
    hi_a, hi_b = _seg_col_hi(res, 0), _seg_col_hi(res, 1)
    if lo_b < lo_a:
        ca, cb = cb, ca
        lo_a, lo_b = lo_b, lo_a
        hi_a, hi_b = hi_b, hi_a
    lo_a = max(lo_a, res.q_col_lo)
    hi_b = min(hi_b, res.q_col_hi)
    ra = TO_UPPER[msa[ca]]
    rb = TO_UPPER[msa[cb]]
    x_lo = x_hi = None
    for col in range(hi_a, lo_a - 1, -1):
        if q[col] == ra[col] and q[col] == rb[col]:
            x_lo = col
            if x_hi is None:
                x_hi = col
        else:
            break
    for col in range(lo_b, hi_b + 1):
        if q[col] == ra[col] and q[col] == rb[col]:
            x_hi = col
            if x_lo is None:
                x_lo = col
        else:
            break
    return x_lo, x_hi


def _write_uparse_msa(f, res: ParseResult) -> None:
    """WriteMSA (src/uparsepretty.cpp:625-706): 80-col blocks of parent /
    model / vote / query rows, all-gap columns dropped."""
    if res.seg_count < 2:
        return
    msa = res.msa
    qrow_full = msa[msa.shape[0] - 1]
    lo, hi = res.q_col_lo, res.q_col_hi
    col_count = hi - lo + 1

    query_row = "".join(chr(c) for c in qrow_full[lo:hi + 1])

    # model row: seg letters, 'X' over the 2-seg crossover range
    model = []
    for si in range(res.seg_count):
        c = _seg_char(res, si)
        a = max(lo, res.seg_col_los[si])
        b = min(hi, _seg_col_hi(res, si))
        model.extend(c * (b - a + 1))
    if res.seg_count == 2:
        x_lo, x_hi = _x_col_lo_hi(res)
        if x_lo is not None and x_hi is not None:
            for col in range(x_lo - lo, x_hi - lo + 1):
                model[col] = "X"
    model_row = "".join(model)

    # vote row (GetVoteRow reads the TOP-HIT candidate row, unlike
    # GetSegVotes which reads the top SEGMENT's parent row)
    q_up = TO_UPPER[qrow_full]
    top_row_up = TO_UPPER[msa[res.top_cand_index]]
    vote = []
    for si in range(res.seg_count):
        a = max(lo, res.seg_col_los[si])
        b = min(hi, _seg_col_hi(res, si))
        cand = res.seg_cand_indexes[si]
        if cand == res.top_cand_index:
            other = TO_UPPER[msa[res.seg_cand_indexes[res.second_seg_index]]]
            for col in range(a, b + 1):
                vote.append(_vote_char(int(q_up[col]), int(other[col]),
                                       int(top_row_up[col])))
        else:
            parent = TO_UPPER[msa[cand]]
            for col in range(a, b + 1):
                vote.append(_vote_char(int(q_up[col]), int(top_row_up[col]),
                                       int(parent[col])))
    vote_row = "".join(vote)

    # parent rows ('.' where equal to query and not '-')
    parent_rows = []
    for si in range(res.seg_count):
        if _parent_dupe(res, si):
            continue
        cand = res.seg_cand_indexes[si]
        p_up = TO_UPPER[msa[cand]]
        row = []
        for col in range(lo, hi + 1):
            p, q = int(p_up[col]), int(q_up[col])
            row.append("." if (q == p and q != _GAP) else chr(p))
        parent_rows.append("".join(row))

    col_all_gaps = []
    for col in range(col_count):
        if query_row[col] != "-":
            col_all_gaps.append(False)
            continue
        col_all_gaps.append(all(pr[col] == "." for pr in parent_rows))

    def write_row(tag, row, a, b):
        f.write(tag + "  ")
        for col in range(a, b + 1):
            if not col_all_gaps[col]:
                f.write(row[col])
        f.write("\n")

    block = 80
    col_lo = 0
    while True:
        n = 0
        col_hi = col_lo
        col = col_lo
        while col < col_count and n < block:
            if not col_all_gaps[col]:
                col_hi = col
                n += 1
            col += 1
        if n == 0:
            break
        f.write("\n")
        pi = 0
        for si in range(res.seg_count):
            if _parent_dupe(res, si):
                continue
            write_row(_seg_char(res, pi), parent_rows[pi], col_lo, col_hi)
            pi += 1
        if res.seg_count > 1:
            write_row("M", model_row, col_lo, col_hi)
            write_row("+", vote_row, col_lo, col_hi)
        write_row("Q", query_row, col_lo, col_hi)
        col_lo = col_hi + 1


def write_uparse_aln(f, res: ParseResult, query_label: str,
                     query_seq: np.ndarray, mod: str,
                     is_cluster_otus: bool) -> None:
    """WriteAln (src/uparsepretty.cpp:211-236 + WriteOneSeg/Footer)."""
    f.write("\n")
    f.write("=" * 75 + "\n")
    f.write("\n")
    f.write("Query %unt >%s\n" % (len(query_seq), query_label))
    mod_str = mod_to_str(mod, is_cluster_otus)
    if res.seg_count == 1:
        ar = res.candidates[res.top_cand_index]
        from ..amplicon.uchime import write_aln_pretty
        f.write("\n")
        f.write("Q (%u) >%s\n" % (len(ar.query_seq), ar.query_label))
        f.write("T (%u) >%s\n" % (len(ar.target_seq), ar.target_label))
        write_aln_pretty(f, ar.query_seq, ar.target_seq, ar.path)
        f.write("Non-chimeric, diffs %u Id %.1f%% [%s]\n" % (
            res.diffs_qt, res.pct_id_qt, mod_str))
        return
    if res.seg_count is not None and 2 <= res.seg_count <= 3:
        _write_segs_table(f, res, len(query_seq), query_label)
        _write_uparse_msa(f, res)
        # footer (WriteAlnFooter, src/uparsepretty.cpp:167-199)
        if res.seg_count >= 2:
            y = n = a = 0
            for si in range(res.seg_count):
                sy, sn, sa = _seg_votes(res, si)
                y += sy
                n += sn
                a += sa
            f.write("\n")
            f.write("%u segs, M %u diffs (%.1f%%), T %u diffs (%.1f%%),"
                    " +%u diffs (+%.1f%%) %u/%u/%u [%s]\n" % (
                        res.seg_count, res.diffs_qm, res.pct_id_qm,
                        res.diffs_qt, res.pct_id_qt,
                        res.diffs_qt - res.diffs_qm,
                        res.pct_id_qm - res.pct_id_qt,
                        y, n, a, mod_str))
        return
    f.write("No alignment\n")


def _psasc(label: str, field: str) -> str:
    """Psasc (src/myutils.cpp:824-840): ';'-separated append."""
    if label and not label.endswith(";"):
        label += ";"
    label += field
    if label and not label.endswith(";"):
        label += ";"
    return label


# ---------------------------------------------------------------------------
# ChunkSearcher + driver (src/chunksearcher.cpp, src/clustersmallmem.cpp)
# ---------------------------------------------------------------------------

class _OtuState:
    """UPClusterSink + the growing centroid UDB."""

    def __init__(self, nucleo: bool) -> None:
        params = UDBParams.global_usearch(nucleo)
        self.index = UDBIndex(params)
        self.index.seq_count = 0
        self.ranker = USortedRanker(self.index)
        self.labels: List[str] = []
        self.seqs: List[np.ndarray] = []
        self.is_chimera: List[bool] = []
        self.otu_count = 0
        self.chimera_count = 0

    def add_centroid(self, label: str, seq: np.ndarray,
                     chimera: bool) -> None:
        """UPClusterSink::AddCentroidToDB (src/upclustersink.cpp:55-90)."""
        o = options()
        # reference: dies when size= missing (GetSizeFromLabel UINT_MAX)
        if size_from_label(label, -1) < 0:
            raise SystemExit(f"Missing size= in >{label}")
        if o.filled("relabel"):
            if chimera:
                label = f"Chimera{self.chimera_count}"
            else:
                label = f"{o.str('relabel')}{self.otu_count}"
        ci = len(self.labels)
        self.labels.append(label)
        self.seqs.append(seq)
        self.is_chimera.append(chimera)
        self.index.add_seq(ci, seq)
        self.index.seq_count = ci + 1


def _chunk_search(state: _OtuState, q_label: str, q_seq: np.ndarray,
                  nucleo: bool, align_one, terminator: Terminator
                  ) -> List[AlignResult]:
    """ChunkSearcher::SearchImpl (src/chunksearcher.cpp:45-114)."""
    o = options()
    hits: List[AlignResult] = []

    def make_ar(tix: int, path: str) -> AlignResult:
        return AlignResult(query_label=q_label,
                           target_label=state.labels[tix],
                           query_seq=q_seq, target_seq=state.seqs[tix],
                           path=path, nucleo=nucleo, target_index=tix)

    # Step 1: plain usorted search with the real terminator (accept-all
    # accepter, maxaccepts=1/maxrejects=32 defaults).
    terminator.on_new_query()
    hm = HitMgr()
    tix_order, _counts = state.ranker.rank(q_seq)
    for tix in tix_order.tolist():
        path = align_one(q_seq, state.seqs[tix])
        accept = False
        if path is not None:
            ar = make_ar(tix, path)
            hits.append(ar)
            hm.append_hit(ar)
            accept = True
        if terminator.terminate(hm, accept):
            break

    set_target_indexes = set()
    if hits:
        top = hm.top_hit()
        if top.get_fract_id() * 100.0 >= OTU_PCTID:
            return hits
        set_target_indexes.add(top.target_index)

    db_size = len(state.seqs)
    if db_size <= o.uns("uparse_maxdball"):
        # AlignAll (src/udbusortedsearcher.cpp:173-190)
        for tix in range(db_size):
            path = align_one(q_seq, state.seqs[tix])
            if path is not None:
                hits.append(make_ar(tix, path))
        return hits

    # Chunked hot-candidate gathering
    chunk_length, los = get_chunk_info(len(q_seq), o.uns("chunks"),
                                       o.uns("minchunk"))
    max_hot = o.uns("uparse_maxhot")
    max_drop = o.uns("uparse_maxdrop")
    for lo in los:
        chunk = q_seq[lo:lo + chunk_length]
        for tix in state.ranker.get_hot(chunk, max_hot, max_drop).tolist():
            set_target_indexes.add(int(tix))

    for tix in sorted(set_target_indexes):
        path = align_one(q_seq, state.seqs[tix])
        if path is not None:
            hits.append(make_ar(tix, path))
    return hits


def cluster_otus(input_path: Optional[str]) -> None:
    """cmd_cluster_otus (src/clustersmallmem.cpp:142-149 + :49-135)."""
    o = options()
    if input_path is None:
        input_path = o.str("input", "")
    if not input_path:
        raise SystemExit("Missing input filename")
    if o.flag("sizein") or o.flag("sizeout"):
        raise SystemExit("-sizein/out not supported")
    if o.filled("id"):
        raise SystemExit("-id not supported by cluster_otus")
    if o.filled("fastaout"):
        raise SystemExit("-fastaout not supported, use -otus")
    minsize = o.uns("minsize", 2)
    sortedby = o.str("sortedby", "size")
    if sortedby != "size":
        raise SystemExit("Must sort by size")

    db = SeqDB.from_fastx(input_path)
    nucleo = db.get_is_nucleo()

    ap = AlnParams.from_cmdline(nucleo)
    ah = AlnHeuristics.from_cmdline(ap)
    terminator = Terminator("cluster_otus")
    state = _OtuState(nucleo)

    native = None
    if not o.flag("use_cpu_oracle"):
        try:
            from ..native import NativeAligner
            native = NativeAligner(ap, ah)
        except Exception:
            native = None
    from ..align.hsp import HSPFinder
    from ..align.global_aligner import global_align
    hf = HSPFinder(ap, ah)
    fail_if_no_hsps = not o.flag("gaforce")

    def align_one(q_seq, t_seq):
        if native is not None:
            native.set_b(t_seq)
            return native.global_align(full_dp_always=ah.full_dp_always,
                                       fail_if_no_hsps=fail_if_no_hsps)
        hf.set_b(t_seq)
        return global_align(q_seq, t_seq, ap, ah, hf,
                            full_dp_always=ah.full_dp_always,
                            fail_if_no_hsps=fail_if_no_hsps)

    f_tab = open(o.str("uparseout"), "w") if o.filled("uparseout") else None
    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    f_aln = open(o.str("uparsealnout"), "w") \
        if o.filled("uparsealnout") else None
    tab_otu_count = 0

    prev_size = None
    for rec_i in range(len(db)):
        label = db.labels[rec_i]
        seq = db.seqs[rec_i]
        size = size_from_label(label, -1)
        if size < 0:
            raise SystemExit(f"Missing size= in >{label}")
        if size < minsize:
            break   # AllDone: input is size-sorted
        if prev_size is not None and size > prev_size:
            raise SystemExit(f"Not sorted by size; prev {prev_size} >{label}")
        prev_size = size

        if native is not None:
            native.set_a(seq)
        else:
            hf.set_a(seq)
        hits = _chunk_search(state, label, seq, nucleo, align_one,
                             terminator)
        res = uparse_parse(label, seq, hits)
        query_size = size_from_label(label, 2)
        mod = calc_mod(res, query_size, is_cluster_otus=True)

        info = get_info_str(res, mod)
        if f_aln is not None:
            write_uparse_aln(f_aln, res, label, seq, mod,
                             is_cluster_otus=True)
        if f_tab is not None:
            # WriteTab (src/uparsesink.cpp:411-430)
            if mod == MOD_OTHER:
                tab_otu_count += 1
                mod_str = f"{mod_to_str(mod, True)}{tab_otu_count}"
            else:
                mod_str = mod_to_str(mod, True)
            f_tab.write(f"{label}\t{mod_str}\t{info}\n")
        if f_fq is not None and db.quals[rec_i] is not None:
            out_label = _psasc(label, f"parse={mod_to_str(mod, True)}")
            out_label += info
            write_fastq(f_fq, out_label, seq, db.quals[rec_i])

        # UPClusterSink::OnQueryDone (src/upclustersink.cpp:36-53)
        if mod == MOD_OTHER:
            state.otu_count += 1
            state.add_centroid(label, seq, chimera=False)
        elif mod == MOD_PERFECT_CHIMERA:
            state.chimera_count += 1
            state.add_centroid(label, seq, chimera=True)
        elif mod == MOD_NOISY_CHIMERA:
            state.chimera_count += 1

    if f_tab is not None:
        f_tab.close()
    if f_fq is not None:
        f_fq.close()

    # CentroidsToFASTA (src/upclustersink.cpp:92-109): DB order, skip
    # chimera-flagged centroids.
    if o.filled("otus"):
        with open(o.str("otus"), "w") as f:
            for ci in range(len(state.labels)):
                if state.is_chimera[ci]:
                    continue
                write_fasta(f, state.labels[ci], state.seqs[ci],
                            o.uns("fasta_cols"))
