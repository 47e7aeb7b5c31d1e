"""search_16s: 16S rRNA gene finding in contigs/genomes.

Parity with the reference GeneFinder (src/genefinder.{h,cpp},
src/findgene.cpp):
  - word-present profile: 13-mer membership lookups in the reference-DB
    bitvector (built by -udb2bitvec), sliding-window count over 1000 bp
  - candidate windows where count >= -mincount (350), expanded by
    window/2 +/- margin (200)
  - conserved terminal motifs GNTTGATCNTGNC / AGTCNNAACAAGGTANCNNTA
    located by k-diff scanning (FragAligner::FindTopHits,
    src/fragaligner.cpp:152-195) in the window's first / second half
  - start/end pairing with gene length gates (1200-2000), overlap
    resolution, repeat filter (top 13-mer count <= 8)
  - both strands plus an origin-crossing "circular" segment
    (src/genefinder.cpp:101-121 MakeCirc)

Device note: the genome-scale hot loop — word extraction, bitvec gather and
windowed counting — is expressed as flat numpy array ops (rolling 2-bit
encode, gather, prefix-sum difference), the same dataflow the device
kernel uses; motif scanning vectorizes over window offsets.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import options
from ..alpha import (CHAR_TO_LETTER_NUCLEO, MATCH_MX_NUCLEO, revcomp)
from ..io.fastx import read_fastx
from .sintax import GlobalRand

GF_DEFAULT_WINDOW = 1000
GF_DEFAULT_MARGIN = 200
GF_DEFAULT_MINCOUNT = 350
GF_DEFAULT_MAX_GENE_LENGTH = 2000
GF_DEFAULT_CIRC_SEG_LENGTH = 3 * GF_DEFAULT_MAX_GENE_LENGTH
GF_DEFAULT_MIN_FRAG_LENGTH = 100
GF_DEFAULT_MAX_TOPWORD_COUNT = 8

GF_START_MOTIF = b"GNTTGATCNTGNC"
GF_END_MOTIF = b"AGTCNNAACAAGGTANCNNTA"


def get_acc_from_label(label: str) -> str:
    """GetAccFromLabel (src/label.cpp:168-182): prefix up to the first
    space/'|'/';' — except a leading "gi" keeps going past its '|'."""
    acc = ""
    for c in label:
        if c in " |;":
            if acc != "gi":
                return acc
        acc += c
    return acc


def _psasc(label: str, field: str) -> str:
    if label and not label.endswith(";"):
        label += ";"
    label += field
    if label and not label.endswith(";"):
        label += ";"
    return label


def find_top_hits(frag: np.ndarray, seq: np.ndarray, max_diffs: int):
    """FragAligner::FindTopHits (src/fragaligner.cpp:152-195): all
    positions achieving the minimum diff count (<= max_diffs), where a
    window with >1 ambiguous base is excluded.  Returns (best_diffs or
    None, ascending position list)."""
    fl = len(frag)
    L = len(seq)
    if L < fl:
        return None, []
    n = L - fl + 1
    win = np.lib.stride_tricks.sliding_window_view(seq, fl)
    diffs = np.count_nonzero(~MATCH_MX_NUCLEO[win, frag], axis=1)
    ncount = np.count_nonzero(CHAR_TO_LETTER_NUCLEO[win] >= 4, axis=1)
    ok = (ncount <= 1) & (diffs <= max_diffs)
    if not ok.any():
        return None, []
    best = int(diffs[ok].min())
    pos = np.nonzero(ok & (diffs == best))[0]
    return best, pos.tolist()


def _get_overlap(lo1, hi1, lo2, hi2) -> int:
    mx, mn = max(lo1, lo2), min(hi1, hi2)
    return 0 if mx > mn else mn - mx + 1


class _WinInfo:
    __slots__ = ("seq", "rc", "circ", "lo", "hi", "gene_count",
                 "start_diffs", "end_diffs", "starts", "ends")


class _FragInfo:
    __slots__ = ("seq", "rc", "lo", "hi")


class _GeneInfo:
    __slots__ = ("rc", "circ", "lo", "hi", "seq", "start_diffs",
                 "end_diffs")


class GeneFinder:
    def __init__(self, word_length: int, present_vec: np.ndarray,
                 rng: GlobalRand) -> None:
        o = options()
        self.w = word_length
        self.present = present_vec
        self.rng = rng
        self.window = GF_DEFAULT_WINDOW
        self.margin = GF_DEFAULT_MARGIN
        self.min_count = o.uns("mincount", GF_DEFAULT_MINCOUNT)
        self.min_gene_length = o.uns("min_gene_length")
        self.max_gene_length = o.uns("max_gene_length")
        self.circ_seg_length = GF_DEFAULT_CIRC_SEG_LENGTH
        self.min_frag_length = GF_DEFAULT_MIN_FRAG_LENGTH
        self.max_topword_count = GF_DEFAULT_MAX_TOPWORD_COUNT
        if o.filled("start_motif"):
            self.start_motif = o.str("start_motif").encode()
        else:
            self.start_motif = GF_START_MOTIF
        if o.filled("end_motif"):
            self.end_motif = o.str("end_motif").encode()
        else:
            self.end_motif = GF_END_MOTIF
        self.start_motif_a = np.frombuffer(self.start_motif, dtype=np.uint8)
        self.end_motif_a = np.frombuffer(self.end_motif, dtype=np.uint8)
        self.max_start_diffs = o.uns("maxstartdiffs")
        self.max_end_diffs = o.uns("maxenddiffs")
        self.rev_comp = True
        # counters matching the reference's statics
        self.total_gene_count = 0
        self.motif_pair_overlap_count = 0
        self.gene_overlap_count = 0
        # output files (set by the driver)
        self.f_tab = None
        self.f_gene_fa = None
        self.f_win_fa = None
        self.f_frag_fa = None
        self.f_counts = None

    # -- per-variant state -------------------------------------------------

    def _set_query_letters(self, seq: np.ndarray) -> np.ndarray:
        """SetQueryLetters (src/genefinder.cpp:468-482): ambiguous bases
        get a random letter from the global RNG (call order preserved)."""
        letters = CHAR_TO_LETTER_NUCLEO[seq].astype(np.int64)
        bad = np.nonzero(letters >= 4)[0]
        for i in bad.tolist():
            letters[i] = self.rng.randu32() % 4
        return letters

    def _word_present(self, letters: np.ndarray) -> np.ndarray:
        w = self.w
        n = len(letters) - w + 1
        words = np.zeros(n, dtype=np.int64)
        for k in range(w):
            words = words * 4 + letters[k:k + n]
        return self.present[words]

    def _set_counts(self, present: np.ndarray) -> np.ndarray:
        """SetCounts (src/genefinder.cpp:285-303): trailing-window count
        as a prefix-sum difference."""
        c = np.cumsum(present.astype(np.int64))
        counts = c.copy()
        W = self.window
        if len(c) > W:
            counts[W:] = c[W:] - c[:-W]
        return counts

    def _set_raw_lo_his(self, counts: np.ndarray):
        """SetRawLoHis (src/genefinder.cpp:305-331): threshold-crossing
        positions (counts move by at most 1 per step)."""
        mc = self.min_count
        prev = np.concatenate(([0], counts[:-1]))
        los = np.nonzero((counts == mc) & (prev == mc - 1))[0].tolist()
        his = np.nonzero((counts == mc - 1) & (prev == mc))[0].tolist()
        if len(counts) and counts[-1] >= mc:
            his.append(len(counts) - 1)
        assert len(los) == len(his)
        return los, his

    def _expand_raw(self, los, his, qlen):
        """ExpandRawLoHis (src/genefinder.cpp:553-582)."""
        d_lo = self.window // 2 + self.margin
        d_hi = self.window // 2
        d_hi = d_hi - self.margin if self.window // 2 > self.margin else 0
        out_lo, out_hi = [], []
        for lo, hi in zip(los, his):
            lo = lo - d_lo if lo > d_lo else 0
            hi = min(hi + d_hi, qlen - 1)
            out_lo.append(lo)
            out_hi.append(hi)
        return out_lo, out_hi

    # -- motif / window search ----------------------------------------------

    def _search_window(self, seq, rc, circ, win_lo, win_hi,
                       raw_len: int) -> int:
        """SearchWindow (src/genefinder.cpp:251-283)."""
        win = seq[win_lo:win_hi + 1]
        wl = len(win)
        start_diffs, starts = find_top_hits(self.start_motif_a,
                                            win[:wl // 2],
                                            self.max_start_diffs)
        end_diffs, ends0 = find_top_hits(self.end_motif_a, win[wl // 2:],
                                         self.max_end_diffs)
        ends = [p + wl // 2 for p in ends0]

        sel_starts, sel_ends = self._select_start_ends(starts, ends)
        gene_count = len(sel_starts)
        for s, e in zip(sel_starts, sel_ends):
            gene_lo = win_lo + s
            gene_hi = win_lo + e + len(self.end_motif) - 1
            self._append_gene(seq, rc, circ, gene_lo, gene_hi,
                              start_diffs, end_diffs, raw_len)

        wi = _WinInfo()
        wi.seq = seq
        wi.rc = rc
        wi.circ = circ
        wi.lo = win_lo
        wi.hi = win_hi
        wi.gene_count = gene_count
        wi.start_diffs = start_diffs
        wi.end_diffs = end_diffs
        wi.starts = starts
        wi.ends = ends
        self.win_infos.append(wi)
        return gene_count

    def _select_start_ends(self, starts, ends):
        """SelectStartEnds (src/genefinder.cpp:162-249): all pairs within
        the gene length gates; overlapping pairs resolved by deleting the
        shorter one."""
        out_s, out_e = [], []
        for s in starts:
            for e in ends:
                if s >= e:
                    continue
                length = e - s + 1
                if length < self.min_gene_length or \
                        length > self.max_gene_length:
                    continue
                out_s.append(s)
                out_e.append(e)
        for _ in range(len(out_s)):
            deleted = False
            for i in range(len(out_s)):
                for j in range(i + 1, len(out_s)):
                    if _get_overlap(out_s[i], out_e[i],
                                    out_s[j], out_e[j]) > 0:
                        self.motif_pair_overlap_count += 1
                        leni = out_e[i] - out_s[i] + 1
                        lenj = out_e[j] - out_s[j] + 1
                        k = i if leni <= lenj else j
                        del out_s[k], out_e[k]
                        deleted = True
                        break
                if deleted:
                    break
            if not deleted:
                break
        return out_s, out_e

    def _top_word_count(self, seq: np.ndarray) -> int:
        """GetTopWord (src/genefinder.cpp:399-439): max 13-mer frequency
        in the gene (valid words only)."""
        w = self.w
        if len(seq) <= w:
            return 0
        letters = CHAR_TO_LETTER_NUCLEO[seq].astype(np.int64)
        n = len(seq) - w + 1
        words = np.zeros(n, dtype=np.int64)
        bad = np.zeros(n, dtype=bool)
        for k in range(w):
            words = words * 4 + letters[k:k + n]
            bad |= letters[k:k + n] >= 4
        words = words[~bad]
        if len(words) == 0:
            return 0
        _, cnt = np.unique(words, return_counts=True)
        return int(cnt.max())

    def _append_gene(self, seq, rc, circ, qlo, qhi, start_diffs,
                     end_diffs, raw_len) -> None:
        """AppendGeneInfo (src/genefinder.cpp:643-710)."""
        if circ:
            lo = qlo - self.circ_seg_length
            hi = qhi - self.circ_seg_length
            if hi < 0:
                lo = raw_len - self.circ_seg_length + qlo
                hi = raw_len - self.circ_seg_length + qhi
        else:
            lo, hi = qlo, qhi

        gene_seq = seq[qlo:qhi + 1]
        if self._top_word_count(gene_seq) > self.max_topword_count:
            return

        for gi in self.gene_infos:
            lo2, hi2, rc2 = gi.lo, gi.hi, gi.rc
            if lo2 == lo and hi2 == hi and rc2 == rc:
                return
            if rc2 != rc:
                lo2, hi2 = raw_len - hi2 - 1, raw_len - lo2 - 1
            if lo >= 0 and lo2 >= 0 and _get_overlap(lo, hi, lo2, hi2) > 0:
                self.gene_overlap_count += 1

        gi = _GeneInfo()
        gi.rc = rc
        gi.circ = circ
        gi.lo = lo
        gi.hi = hi
        gi.seq = gene_seq
        gi.start_diffs = start_diffs
        gi.end_diffs = end_diffs
        self.gene_infos.append(gi)
        self.total_gene_count += 1

    # -- per-query driver ----------------------------------------------------

    def _find_lo(self, seq: np.ndarray, rc: bool, circ: bool,
                 raw_len: int, raw_label: str) -> None:
        """FindLo (src/genefinder.cpp:803-824)."""
        qlen = len(seq)
        if qlen <= self.w:
            return
        letters = self._set_query_letters(seq)
        present = self._word_present(letters)
        counts = self._set_counts(present)
        self._write_counts(raw_label, rc, circ, present, counts)
        los, his = self._set_raw_lo_his(counts)
        los, his = self._expand_raw(los, his, qlen)
        # SetWinLoHis (src/genefinder.cpp:333-371)
        win_los, win_his = [], []
        for lo, hi in zip(los, his):
            length = hi - lo + 1
            if length < self.min_gene_length:
                if length >= self.min_frag_length:
                    fi = _FragInfo()
                    fi.seq = seq
                    fi.rc = rc
                    fi.lo = lo - self.window // 2 \
                        if lo >= self.window // 2 else 0
                    if hi <= self.window // 2:
                        fi.lo, fi.hi = lo, hi
                    else:
                        fi.hi = hi - self.window // 2
                    assert fi.hi > fi.lo
                    if fi.hi - fi.lo + 1 >= self.min_frag_length:
                        self.frag_infos.append(fi)
                continue
            win_los.append(lo)
            win_his.append(hi)
        # SearchWindows (src/genefinder.cpp:712-733)
        for lo, hi in zip(win_los, win_his):
            gene_count = self._search_window(seq, rc, circ, lo, hi,
                                             raw_len)
            if gene_count == 0 and not circ:
                fi = _FragInfo()
                fi.seq = seq
                fi.rc = rc
                fi.lo = lo
                fi.hi = hi
                self.frag_infos.append(fi)

    def find(self, label: str, seq: np.ndarray) -> None:
        """Find (src/genefinder.cpp:735-767)."""
        self.win_infos: List[_WinInfo] = []
        self.gene_infos: List[_GeneInfo] = []
        self.frag_infos: List[_FragInfo] = []
        raw_len = len(seq)

        circ_seq = None
        if raw_len >= 2 * self.circ_seg_length:
            sl = self.circ_seg_length
            circ_seq = np.concatenate((seq[raw_len - sl:], seq[:sl]))

        self._find_lo(seq, False, False, raw_len, label)
        if self.rev_comp:
            self._find_lo(revcomp(seq), True, False, raw_len, label)
        if circ_seq is not None:
            self._find_lo(circ_seq, False, True, raw_len, label)

        self._output(label, raw_len)

    # -- output (src/genefinder.cpp:826-1081) --------------------------------

    def _write_counts(self, raw_label, rc, circ, present, counts) -> None:
        """WriteCounts (src/genefinder.cpp:826-856)."""
        f = self.f_counts
        if f is None or circ:
            return
        acc = get_acc_from_label(raw_label)
        strand = "-" if rc else "+"
        mc = self.min_count
        for pos in range(len(counts)):
            c_present = "#" if present[pos] else "."
            c_win = "W" if counts[pos] >= mc else "_"
            f.write(f"{acc}\t{pos}\t{strand}\t{c_present}\t{c_win}"
                    f"\t{counts[pos]}\n")

    def _motif_diffs(self, gi: _GeneInfo):
        """GetStartMotif / GetEndMotif (src/genefinder.cpp:769-801)."""
        q = gi.seq
        sm = self.start_motif_a
        em = self.end_motif_a
        s_seg = q[:len(sm)]
        e_seg = q[len(q) - len(em):]
        s_d = int(np.count_nonzero(~MATCH_MX_NUCLEO[s_seg, sm]))
        e_d = int(np.count_nonzero(~MATCH_MX_NUCLEO[e_seg, em]))
        return (s_seg.tobytes().decode("latin1"), s_d,
                e_seg.tobytes().decode("latin1"), e_d)

    def _output(self, label: str, raw_len: int) -> None:
        acc = get_acc_from_label(label)
        f = self.f_tab
        if f is not None:
            f.write(f"{label}\tquery\tlength={raw_len}"
                    f"\twins={len(self.win_infos)}"
                    f"\tgenes={len(self.gene_infos)}"
                    f"\tfrags={len(self.frag_infos)}\n")
        for wi in self.win_infos:
            if f is not None:
                strand = "O" if wi.circ else ("-" if wi.rc else "+")
                length = wi.hi - wi.lo + 1
                un = len(wi.seq) - wi.hi - 1
                line = (f"{acc}\twin\tstrand={strand}\tlo={wi.lo}"
                        f"\thi={wi.hi}\tun={un}\tlen={length}"
                        f"\tgenes={wi.gene_count}"
                        f"\tstarts={len(wi.starts)}")
                if wi.starts:
                    line += "(" + ",".join(str(p) for p in wi.starts) + ")"
                    line += f"/{wi.start_diffs}"
                line += f"\tends={len(wi.ends)}"
                if wi.ends:
                    line += "(" + ",".join(str(p) for p in wi.ends) + ")"
                    line += f"/{wi.end_diffs}"
                f.write(line + "\n")
            if self.f_win_fa is not None:
                strand = "-" if wi.rc else "+"
                length = wi.hi - wi.lo + 1
                out_label = _psasc(label, f"window={wi.lo}-{wi.hi}"
                                   f"({length})/{raw_len}{strand}")
                self._fasta(self.f_win_fa, out_label,
                            wi.seq[wi.lo:wi.hi + 1])
        for fi in self.frag_infos:
            if self.f_frag_fa is not None:
                strand = "-" if fi.rc else "+"
                length = fi.hi - fi.lo + 1
                out_label = _psasc(label, f"frag={fi.lo}-{fi.hi}"
                                   f"({length})/{raw_len}{strand}")
                self._fasta(self.f_frag_fa, out_label,
                            fi.seq[fi.lo:fi.hi + 1])
            if f is not None:
                strand = "-" if fi.rc else "+"
                length = fi.hi - fi.lo + 1
                un = len(fi.seq) - fi.hi - 1
                f.write(f"{acc}\tfrag\tstrand={strand}\tlo={fi.lo}"
                        f"\thi={fi.hi}\tun={un}\tlen={length}\n")
        for gi in self.gene_infos:
            sm, sd, em, ed = self._motif_diffs(gi)
            if f is not None:
                strand = "-" if gi.rc else "+"
                length = gi.hi - gi.lo + 1
                f.write(f"{acc}\tgene\tstrand={strand}\tlo={gi.lo + 1}"
                        f"\thi={gi.hi + 1}\tlen={length}"
                        f"\tstart={sm}/{sd}\tend={em}/{ed}\n")
            if self.f_gene_fa is not None:
                strand = "-" if gi.rc else "+"
                length = gi.hi - gi.lo + 1
                out_label = _psasc(label, f"gene={gi.lo}-{gi.hi}"
                                   f"({length})/{raw_len}{strand}")
                self._fasta(self.f_gene_fa, out_label, gi.seq)

    @staticmethod
    def _fasta(f, label: str, seq: np.ndarray) -> None:
        from ..io.fastx import write_fasta
        write_fasta(f, label, seq, options().uns("fasta_cols"))


def search_16s(input_path: Optional[str]) -> None:
    """cmd_search_16s (src/findgene.cpp:94-216)."""
    o = options()
    if not input_path:
        raise SystemExit("Missing input filename")
    if not o.filled("bitvec"):
        raise SystemExit("-bitvec required")

    from ..index.udbfile import read_bitvec
    word_length, present = read_bitvec(o.str("bitvec"))

    # mask low-complexity words (<= 2 unique letters) out of the DB vector
    # (src/findgene.cpp:155-167)
    idx = np.nonzero(present)[0]
    if len(idx):
        w = idx.copy()
        bits = np.zeros(len(w), dtype=np.uint8)
        for _ in range(13):   # reference passes literal 13
            bits |= np.uint8(1) << (w & 3).astype(np.uint8)
            w >>= 2
        nuniq = np.array([bin(b).count("1") for b in range(16)],
                         dtype=np.uint8)[bits]
        present[idx[nuniq <= 2]] = False

    rev_comp = True
    if o.filled("strand"):
        s = o.str("strand")
        if s == "plus":
            rev_comp = False
        elif s != "both":
            raise SystemExit("Invalid -strand")

    rng = GlobalRand(o.uns("randseed", 1))
    gf = GeneFinder(word_length, present, rng)
    gf.rev_comp = rev_comp

    if o.filled("tabbedout"):
        gf.f_tab = open(o.str("tabbedout"), "w")
    if o.filled("fastaout"):
        gf.f_gene_fa = open(o.str("fastaout"), "w")
    if o.filled("hitsout"):
        gf.f_win_fa = open(o.str("hitsout"), "w")
    if o.filled("fragout"):
        gf.f_frag_fa = open(o.str("fragout"), "w")
    if o.filled("output2"):
        gf.f_counts = open(o.str("output2"), "w")

    for label, seq, _qual in read_fastx(input_path, stream=True):
        if len(seq) == 0:
            continue
        gf.find(label, seq)

    for f in (gf.f_tab, gf.f_gene_fa, gf.f_win_fa, gf.f_frag_fa,
              gf.f_counts):
        if f is not None:
            f.close()
