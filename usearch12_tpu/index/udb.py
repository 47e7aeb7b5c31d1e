"""UDB k-mer inverted index.

Redesign of the reference's UDBData (src/udbdata.{h,cpp},
src/udbparams.{h,cpp}): instead of 4^w growable pointer rows, postings live
in flat CSR-style numpy arrays that upload directly as device buffers for
the word-counting kernel.  Incremental append (clustering grows the index,
src/udbdata.h:55-60) is supported through per-word Python lists that are
re-flattened lazily.

Word extraction follows SeqToWordNoPattern (src/udbparams.cpp:540-556):
lowercase (soft-masked) and non-alphabet characters yield no word
(BAD_WORD); a word is valid only if all w characters are valid.

Default word widths per SetDefaults_GlobalUSearch (src/udbparams.cpp:235-261):
nt w=8 (4^8 = 65536 slots), aa w=5 (20^5 = 3.2M slots).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..alpha import CHAR_TO_LETTER_AMINO, CHAR_TO_LETTER_NUCLEO, IS_LOWER
from ..io.seqdb import SeqDB

BAD_WORD = -1


@dataclass
class UDBParams:
    is_nucleo: bool
    word_length: int
    alpha_size: int
    slot_count: int
    # legacy hashed dictionaries (src/udbparams.h:143-161): slot = an
    # RS-style hash of the RAW window characters, modulo slot_count
    hashed: bool = False

    @classmethod
    def global_usearch(cls, nucleo: bool, word_length: Optional[int] = None
                       ) -> "UDBParams":
        if word_length is None:
            # UDBParams::FromCmdLine honors -wordlength
            # (src/udbparams.cpp:62-67)
            from ..config import options
            o = options()
            if o.filled("wordlength"):
                word_length = o.uns("wordlength")
            else:
                word_length = 8 if nucleo else 5
        alpha = 4 if nucleo else 20
        return cls(is_nucleo=nucleo, word_length=word_length,
                   alpha_size=alpha, slot_count=alpha ** word_length)

    def seq_to_words(self, seq: np.ndarray) -> np.ndarray:
        """All positions 0..L-w; invalid positions yield BAD_WORD (-1)."""
        w = self.word_length
        L = len(seq)
        if L < w:
            return np.zeros(0, dtype=np.int64)
        if self.hashed:
            return self._seq_to_hashed_words(seq)
        table = (CHAR_TO_LETTER_NUCLEO if self.is_nucleo
                 else CHAR_TO_LETTER_AMINO)
        letters = table[seq].astype(np.int64)
        invalid = (letters == 0xFF) | IS_LOWER[seq]
        n = L - w + 1
        words = np.zeros(n, dtype=np.int64)
        bad = np.zeros(n, dtype=bool)
        for k in range(w):
            words = words * self.alpha_size + letters[k:k + n]
            bad |= invalid[k:k + n]
        words[bad] = BAD_WORD
        return words

    def _seq_to_hashed_words(self, seq: np.ndarray) -> np.ndarray:
        """UDBParams::Hash (src/udbparams.h:143-161): h = h*a + c with
        a starting at 63689 and multiplying by 378551 per character,
        over the RAW characters; lowercase or invalid letters make the
        window BAD.  h % slot_count is the word."""
        w = self.word_length
        L = len(seq)
        n = L - w + 1
        # coefficient of char k in the final h (mod 2^32):
        #   coef[k] = prod_{j=k+1..w-1} (63689 * 378551^j)
        coef = np.ones(w, dtype=np.uint64)
        a = np.uint64(63689)
        b = np.uint64(378551)
        m = np.uint64(0xFFFFFFFF)
        mults = np.empty(w, dtype=np.uint64)
        cur = a
        for j in range(w):
            mults[j] = cur
            cur = (cur * b) & m
        for k in range(w - 1, -1, -1):
            if k + 1 < w:
                coef[k] = (coef[k + 1] * mults[k + 1]) & m
        table = (CHAR_TO_LETTER_NUCLEO if self.is_nucleo
                 else CHAR_TO_LETTER_AMINO)
        invalid = (table[seq] == 0xFF) | IS_LOWER[seq]
        h = np.zeros(n, dtype=np.uint64)
        bad = np.zeros(n, dtype=bool)
        s64 = seq.astype(np.uint64)
        for k in range(w):
            h = (h + s64[k:k + n] * coef[k]) & m
            bad |= invalid[k:k + n]
        words = (h % np.uint64(self.slot_count)).astype(np.int64)
        words[bad] = BAD_WORD
        return words

    def valid_words(self, seq: np.ndarray) -> np.ndarray:
        """SetQueryWordsAllNoBad: in-order valid words (duplicates kept)."""
        words = self.seq_to_words(seq)
        return words[words != BAD_WORD]

    def unique_words(self, seq: np.ndarray) -> np.ndarray:
        """SetQueryUniqueWords: first-occurrence order dedup."""
        if not self.hashed:
            out = _unique_words_native(self, seq)
            if out is not None:
                return out
        words = self.valid_words(seq)
        # np.unique sorts; need first-occurrence order (stable)
        _, idx = np.unique(words, return_index=True)
        return words[np.sort(idx)]


_UW_CACHE = {}


def _unique_words_native(params, seq: np.ndarray):
    """C first-occurrence unique-word extraction (unique_words_c);
    returns None when the native library is unavailable."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    key = (params.is_nucleo, params.word_length)
    ent = _UW_CACHE.get(key)
    if ent is None:
        from ..alpha import IS_LOWER
        table = (CHAR_TO_LETTER_NUCLEO if params.is_nucleo
                 else CHAR_TO_LETTER_AMINO).copy()
        table[IS_LOWER] = 0xFF
        ent = (lib.rank_scratch_create(), np.ascontiguousarray(table))
        _UW_CACHE[key] = ent
    scratch, table = ent
    if not seq.flags["C_CONTIGUOUS"]:
        seq = np.ascontiguousarray(seq)
    out = np.empty(max(len(seq), 1), dtype=np.int64)
    n = lib.unique_words_c(scratch, seq.ctypes.data, len(seq),
                           table.ctypes.data, params.alpha_size,
                           params.word_length, params.slot_count,
                           out.ctypes.data)
    return out[:n]


class UDBIndex:
    """Inverted index word -> target sequence indexes (plain coding,
    SeqPosBits=0: one posting per (word occurrence, target), duplicates per
    target allowed — counts are per word-occurrence in the target)."""

    def __init__(self, params: UDBParams) -> None:
        self.params = params
        self.seq_count = 0
        self.db_step = 1    # m_DBStep from a loaded .udb header
        # pending (word, seq_index) pairs not yet merged into the CSR view
        self._pending_words: List[np.ndarray] = []
        self._pending_tix: List[np.ndarray] = []
        self._pending_cache = None
        self._pending_raw_cache = None
        self._pending_total = 0
        # word-sorted middle tier (between the raw tail and the CSR)
        self._sorted_w: Optional[np.ndarray] = None
        self._sorted_t: Optional[np.ndarray] = None
        # flattened CSR (lazily rebuilt)
        self._flat_dirty = True
        self._starts: Optional[np.ndarray] = None
        self._postings16: Optional[np.ndarray] = None
        self._sizes: Optional[np.ndarray] = None
        self._postings: Optional[np.ndarray] = None

    # -- build ---------------------------------------------------------------
    def add_seq(self, seq_index: int, seq: np.ndarray) -> None:
        """AddSeqNoncoded: index *unique* target words.

        Reference: udbbuild.cpp indexes each target's unique words (via
        SetTargetUniqueWords) so U counts shared unique words.  Postings per
        word keep seq-index append order (stable merge).

        Incremental appends use an LSM-style pending tier: a small raw
        tail merges into a word-sorted run every ~8k words, and the run
        folds into the CSR once it reaches a quarter of the base size —
        amortized O(n log n) for grow-as-you-cluster workloads."""
        words = self.params.unique_words(seq)
        self._pending_words.append(words)
        self._pending_tix.append(
            np.full(len(words), seq_index, dtype=np.int32))
        self.seq_count = max(self.seq_count, seq_index + 1)
        self._flat_dirty = True
        self._pending_cache = None
        self._pending_raw_cache = None
        self._pending_total += len(words)
        if self._pending_total >= 8192:
            base = len(self._postings) if self._postings is not None else 0
            sorted_n = len(self._sorted_w) if self._sorted_w is not None \
                else 0
            if sorted_n + self._pending_total > max(65536, base // 4):
                self._flatten()
            else:
                self._merge_pending_into_sorted()

    @classmethod
    def from_seqdb(cls, db: SeqDB, params: Optional[UDBParams] = None
                   ) -> "UDBIndex":
        if params is None:
            params = UDBParams.global_usearch(db.get_is_nucleo())
        idx = cls(params)
        # bulk build: collect every sequence's unique words, then build
        # the CSR with ONE stable sort (no LSM churn for a static DB)
        for i, seq in enumerate(db.seqs):
            words = params.unique_words(seq)
            idx._pending_words.append(words)
            idx._pending_tix.append(
                np.full(len(words), i, dtype=np.int32))
        idx.seq_count = len(db)
        idx._flat_dirty = True
        idx._flatten()
        return idx

    # -- flat CSR view ---------------------------------------------------------
    def _merge_pending_into_sorted(self) -> None:
        """Fold the raw tail into the word-sorted middle tier (stable, so
        per-word seq-index append order is preserved)."""
        if not self._pending_words:
            return
        new_w = np.concatenate(self._pending_words)
        new_t = np.concatenate(self._pending_tix)
        if self._sorted_w is not None and len(self._sorted_w):
            w = np.concatenate([self._sorted_w, new_w])
            t = np.concatenate([self._sorted_t, new_t])
        else:
            w, t = new_w, new_t
        order = np.argsort(w, kind="stable")
        self._sorted_w = w[order]
        self._sorted_t = t[order]
        self._pending_words = []
        self._pending_tix = []
        self._pending_cache = None
        self._pending_raw_cache = None
        self._pending_total = 0

    def _flatten(self) -> None:
        if not self._flat_dirty:
            return
        slot_count = self.params.slot_count
        parts_w, parts_t = [], []
        if self._postings is not None and len(self._postings):
            # reconstruct (word, tix) pairs of the existing CSR
            parts_w.append(np.repeat(
                np.arange(slot_count, dtype=np.int64),
                self._sizes.astype(np.int64)))
            parts_t.append(self._postings.astype(np.int32))
        if self._sorted_w is not None and len(self._sorted_w):
            parts_w.append(self._sorted_w)
            parts_t.append(self._sorted_t)
        if self._pending_words:
            parts_w.append(np.concatenate(self._pending_words))
            parts_t.append(np.concatenate(self._pending_tix))
        if parts_w:
            words = np.concatenate(parts_w) if len(parts_w) > 1 \
                else parts_w[0]
            tix = np.concatenate(parts_t) if len(parts_t) > 1 \
                else parts_t[0]
            # stable sort by word keeps per-row seq-index append order
            order = np.argsort(words, kind="stable")
            words = words[order]
            tix = tix[order]
            sizes = np.bincount(words, minlength=slot_count).astype(np.int64)
            starts = np.zeros(slot_count + 1, dtype=np.int64)
            np.cumsum(sizes, out=starts[1:])
            self._sizes = sizes
            self._starts = starts
            self._postings = tix.astype(np.int32)
        elif self._postings is None:
            self._sizes = np.zeros(slot_count, dtype=np.int64)
            self._starts = np.zeros(slot_count + 1, dtype=np.int64)
            self._postings = np.zeros(0, dtype=np.int32)
        self._pending_words = []
        self._pending_tix = []
        self._pending_cache = None
        self._pending_raw_cache = None
        self._pending_total = 0
        self._sorted_w = None
        self._sorted_t = None
        self._flat_dirty = False
        # 16-bit postings mirror: the rank walk is DRAM-latency bound on
        # the postings array; halving its bytes nearly halves the walk
        # on DBs that fit uint16 target indexes.  Entries stay valid if
        # seq_count later grows past 65535 (appends go to the pending
        # tiers, never this CSR).
        if self.seq_count <= 0xFFFF and len(self._postings):
            self._postings16 = self._postings.astype(np.uint16)
        else:
            self._postings16 = None

    @property
    def sizes(self) -> np.ndarray:
        self._flatten()
        return self._sizes

    @property
    def starts(self) -> np.ndarray:
        self._flatten()
        return self._starts

    @property
    def postings(self) -> np.ndarray:
        self._flatten()
        return self._postings

    # -- candidate counting (SetU) ------------------------------------------------
    def count_u(self, query_unique_words: np.ndarray, seq_count: Optional[int] = None
                ) -> np.ndarray:
        """U[target] = number of query unique words whose postings row
        contains target (with multiplicity) — SetU_NonCoded
        (src/udbusortedsearcher.cpp:375-410).  Host numpy path.

        Incremental appends (growing centroid DB during clustering) are
        counted from the pending per-seq word lists without re-flattening;
        pending is folded into the CSR once it grows past a threshold."""
        if seq_count is None:
            seq_count = self.seq_count
        if self._postings is None and self._sorted_w is None \
                and not self._pending_words:
            self._flatten()
        u = None
        if self._postings is not None and len(self._postings):
            u = self._count_u_base(query_unique_words, seq_count)
        if self._sorted_w is not None and len(self._sorted_w):
            if u is None:
                u = np.zeros(seq_count, dtype=np.uint32)
            self._count_sorted_tier(query_unique_words, seq_count, u,
                                    self._sorted_w, self._sorted_t)
        if self._pending_words:
            if u is None:
                u = np.zeros(seq_count, dtype=np.uint32)
            pw, pt = self._pending_concat()
            if len(pw):
                self._count_sorted_tier(query_unique_words, seq_count, u,
                                        pw, pt)
        if u is None:
            u = np.zeros(seq_count, dtype=np.uint32)
        return u

    @staticmethod
    def _count_sorted_tier(qw, seq_count, u, pw, pt) -> None:
        """Add counts from a word-sorted (words, tix) run into u."""
        lo = np.searchsorted(pw, qw, "left")
        hi = np.searchsorted(pw, qw, "right")
        cnt = hi - lo
        total = int(cnt.sum())
        if not total:
            return
        base_idx = np.repeat(lo, cnt)
        offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        tix = pt[base_idx + offs]
        tix = tix[tix < seq_count]
        np.add.at(u, tix, 1)

    def _pending_raw(self):
        """(words, seq indexes) of the raw pending tail, UNSORTED — the
        native rank kernel scans it linearly against the query-word
        bitmap, so no per-admit argsort is needed."""
        if self._pending_raw_cache is None:
            if self._pending_words:
                self._pending_raw_cache = (
                    np.concatenate(self._pending_words),
                    np.concatenate(self._pending_tix))
            else:
                self._pending_raw_cache = (np.zeros(0, np.int64),
                                           np.zeros(0, np.int32))
        return self._pending_raw_cache

    def _pending_concat(self):
        """(sorted tail words, their seq indexes) — the raw tail stays
        small (merged into the sorted tier every ~8k words), so sorting
        it once per append burst is cheap."""
        if self._pending_cache is None:
            if self._pending_words:
                pw = np.concatenate(self._pending_words)
                pt = np.concatenate(self._pending_tix)
                order = np.argsort(pw, kind="stable")
                self._pending_cache = (pw[order], pt[order])
            else:
                self._pending_cache = (np.zeros(0, np.int64),
                                       np.zeros(0, np.int32))
        return self._pending_cache

    def _count_u_base(self, query_unique_words: np.ndarray, seq_count: int
                      ) -> np.ndarray:
        if len(query_unique_words) == 0 or seq_count == 0:
            return np.zeros(seq_count, dtype=np.uint32)
        starts = self._starts
        sizes = self._sizes
        qw = query_unique_words
        seg_sizes = sizes[qw]
        total = int(seg_sizes.sum())
        if total == 0:
            return np.zeros(seq_count, dtype=np.uint32)
        # vectorized multi-segment gather: absolute index = segment start
        # repeated per element + within-segment offset
        seg_starts = starts[qw]
        rep_starts = np.repeat(seg_starts, seg_sizes)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(seg_sizes)[:-1])), seg_sizes)
        hits = self._postings[rep_starts + within]
        return np.bincount(hits, minlength=seq_count).astype(np.uint32)
