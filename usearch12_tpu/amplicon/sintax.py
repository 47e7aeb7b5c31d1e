"""SINTAX k-mer bootstrap taxonomy classifier (src/sintaxsearcher.cpp).

100 bootstrap iterations; each samples 32 query unique words (private LCG,
Numerical-Recipes constants, seeded from -randseed per query) and
scatter-adds their UDB postings rows; the arg-max target (ties broken with
the reference's global lagged-MWC RNG) votes for its taxonomy string.
Per-rank confidence = cumulative-product bootstrap fraction.

The device path (amplicon/sintax_device.py) replays the same RNG and
ties exactly; this host path is the reference it is checked against.
"""

from __future__ import annotations

from typing import List, Optional

import os

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB
from ..index.udb import UDBIndex, UDBParams

M32 = 0xFFFFFFFF


class GlobalRand:
    """The reference's global RNG (src/myutils.cpp:1757-1838): lagged
    multiply-with-carry seeded from a small LCG."""

    def __init__(self, seed: int) -> None:
        state = seed & M32
        for _ in range(10):
            state = (state * 214013 + 2531011) & M32
        x = []
        for _ in range(5):
            state = (state * 214013 + 2531011) & M32
            x.append(state)
        self.x = x
        for _ in range(100):
            self._inc()

    def _inc(self) -> None:
        x = self.x
        s = (2111111111 * x[3] + 1492 * x[2] + 1776 * x[1]
             + 5115 * x[0] + x[4])
        x[3] = x[2]
        x[2] = x[1]
        x[1] = x[0]
        x[4] = (s >> 32) & M32
        x[0] = s & M32

    def randu32(self) -> int:
        self._inc()
        return self.x[0]


def _next_rand(r: int) -> int:
    """Per-query boot LCG (src/sintaxsearcher.cpp:77-82)."""
    return (1664525 * r + 1013904223) & M32


def get_tax_str(label: str) -> str:
    for field in label.split(";"):
        if field.startswith("tax="):
            return field[4:]
    return ""


def tax_names(tax_str: str) -> List[str]:
    names = [n for n in tax_str.split(",")]
    for n in names:
        if len(n) < 3 or n[1] != ":":
            raise SystemExit(f"Missing x: in tax={tax_str}")
    return names


def name_in_tax_str(tax_str: str, name: str) -> bool:
    """NameIsInTaxStr (src/tax.cpp:299-308): substring match terminated by
    ',' or end."""
    n = tax_str.find(name)
    if n < 0:
        return False
    rest = tax_str[n + len(name):]
    return rest == "" or rest[0] == ","


class SintaxClassifier:
    _es = None
    _lib = False

    def __init__(self, db: SeqDB, index: UDBIndex, grand: GlobalRand) -> None:
        self.db = db
        self.index = index
        self.grand = grand
        self.tax_strs = [get_tax_str(l) for l in db.labels]
        o = options()
        self.boots = o.uns("boots")
        self.cutoff = o.flt("sintax_cutoff")
        self.randseed = o.uns("randseed")
        s = o.str("boot_subset", "") if o.filled("boot_subset") else "32"
        if not s:
            s = "32"
        if s.startswith("/"):
            self.boot_subset_divide = True
            self.boot_subset = int(s[1:])
        else:
            self.boot_subset_divide = False
            self.boot_subset = int(s)
        # flatten postings for the shuffle counting
        self.index._flatten()
        # numeric taxonomy structures so classify() avoids per-query
        # string work: distinct tax strings, their lexicographic rank,
        # per-tax name lists, and a name-containment matrix with
        # NameIsInTaxStr semantics (src/tax.cpp:299-308)
        uniq = sorted(set(self.tax_strs))
        tax_to_id = {t: i for i, t in enumerate(uniq)}
        self._tax_id = np.array([tax_to_id[t] for t in self.tax_strs],
                                dtype=np.int32)
        self._uniq_tax = uniq          # index = tax id, already lex-sorted
        def _names_or_none(t):
            try:
                return tax_names(t) if t else []
            except SystemExit:
                return None    # malformed: only an error if it ever wins
        self._tax_names = [_names_or_none(t) for t in uniq]
        all_names = sorted({n for ns in self._tax_names if ns
                            for n in ns})
        name_to_id = {n: i for i, n in enumerate(all_names)}
        self._name_ids = [np.array([name_to_id[n] for n in ns], np.int32)
                          if ns is not None else None
                          for ns in self._tax_names]
        k, nn = len(uniq), len(all_names)
        contains = np.zeros((k, nn), dtype=bool)
        for ti, t in enumerate(uniq):
            for ni, n in enumerate(all_names):
                if name_in_tax_str(t, n):
                    contains[ti, ni] = True
        self._contains = contains

    def _run_boots(self, uw, nuw, seq_count, starts, sizes, postings, m):
        """All boots' (winner index, word count): native when available
        (sintax_boots_c — both RNGs bit-exact, plus in-C winner-tax
        tally), numpy fallback.  The native path also sets
        self._c_tally = (tax_ids, counts, top_word_count)."""
        lib = self._lib
        if lib is False:
            from ..native import get_lib
            lib = self._lib = get_lib()
        self._c_tally = None
        if lib is not None and postings is not None:
            if self._es is None:
                es = self._es = lib.engine_scratch_create()
                self._out_ti = np.empty(self.boots, np.int32)
                self._out_u = np.empty(self.boots, np.int32)
                self._out_txi = np.empty(self.boots, np.int32)
                self._out_txc = np.empty(self.boots, np.int32)
                self._out_twc = np.empty(1, np.int32)
                # the global RNG state lives in _gx between native calls;
                # grand.x is only synced on demand (sync_grand)
                self._gx = np.array(self.grand.x, dtype=np.uint64)
                # args that never change across queries, prebound once
                self._pre = (es, starts.ctypes.data, postings.ctypes.data,
                             seq_count, self.boots, self.randseed,
                             self._gx.ctypes.data,
                             self._tax_id.ctypes.data,
                             self._out_ti.ctypes.data,
                             self._out_u.ctypes.data,
                             self._out_txi.ctypes.data,
                             self._out_txc.ctypes.data,
                             self._out_twc.ctypes.data)
            (es, p_st, p_po, p_sc, p_boots, p_seed, p_gx, p_tax,
             p_ti, p_u, p_txi, p_txc, p_twc) = self._pre
            uw_c = uw if (uw.dtype == np.int64 and
                          uw.flags["C_CONTIGUOUS"]) else \
                np.ascontiguousarray(uw, dtype=np.int64)
            ntax = lib.sintax_boots_c(
                es, uw_c.ctypes.data, nuw, p_st, p_po, p_sc,
                p_boots, m, p_seed, p_gx, p_tax, p_ti, p_u,
                p_txi, p_txc, p_twc)
            if ntax > 0:
                self._c_tally = (self._out_txi[:ntax].tolist(),
                                 self._out_txc[:ntax].tolist(),
                                 int(self._out_twc[0]))
            return self._out_ti, self._out_u
        # numpy fallback: draw picks up front, one scatter-add, per-boot
        # tie-break with the global RNG
        r = self.randseed
        picks = np.empty(self.boots * m, dtype=np.int64)
        for k in range(self.boots * m):
            r = _next_rand(r)
            picks[k] = r % nuw
        words = uw[picks]
        seg_sizes = sizes[words]
        total = int(seg_sizes.sum())
        U = np.zeros((self.boots, seq_count), dtype=np.int32)
        if total:
            base = np.repeat(starts[words], seg_sizes)
            offs = np.arange(total) - np.repeat(
                np.cumsum(seg_sizes) - seg_sizes, seg_sizes)
            flat = postings[base + offs]
            pick_boot = np.arange(self.boots * m) // m
            boot_ids = np.repeat(pick_boot, seg_sizes)
            np.add.at(U, (boot_ids, flat), 1)
        top_us = U.max(axis=1) if seq_count else np.zeros(self.boots, int)
        out_ti = np.zeros(self.boots, np.int32)
        out_u = np.zeros(self.boots, np.int32)
        for boot in range(self.boots):
            top_u = int(top_us[boot])
            if top_u == 0:
                tops = np.arange(seq_count, dtype=np.int64)
            else:
                tops = np.nonzero(U[boot] == top_u)[0]
            rr = self.grand.randu32() % len(tops)
            out_ti[boot] = int(tops[rr])
            out_u[boot] = top_u
        return out_ti, out_u

    def classify_window(self, seqs, both: bool):
        """Window of queries through sintax_window_c: per query the
        whole classify pipeline (both strands, unique words, boots,
        tally, strand vote) in one C call.  Returns a list of
        (strand_char, ids, counts, last_twc) or None (no native lib /
        hashed dictionary)."""
        lib = self._lib
        if lib is False:
            from ..native import get_lib
            lib = self._lib = get_lib()
        if (lib is None or self.index.params.hashed
                or self.index._postings is None):
            return None
        import ctypes
        n = len(seqs)
        if n == 0:
            return []
        if self._es is None:
            self._es = lib.engine_scratch_create()
            self._gx = np.array(self.grand.x, dtype=np.uint64)
        params = self.index.params
        if getattr(self, "_win_ctl", None) is None:
            from ..alpha import (CHAR_TO_LETTER_NUCLEO,
                                 CHAR_TO_LETTER_AMINO, CHAR_TO_COMP_CHAR,
                                 IS_LOWER)
            ctl = (CHAR_TO_LETTER_NUCLEO if params.is_nucleo
                   else CHAR_TO_LETTER_AMINO).copy()
            ctl[IS_LOWER] = 0xFF
            self._win_ctl = np.ascontiguousarray(ctl)
            self._win_comp = np.ascontiguousarray(CHAR_TO_COMP_CHAR)
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        qcat = np.concatenate(
            [np.ascontiguousarray(s) for s in seqs]) if n else \
            np.zeros(0, np.uint8)
        B = self.boots
        out_ntax = np.empty(n, np.int32)
        out_ids = np.empty(n * B, np.int32)
        out_cnts = np.empty(n * B, np.int32)
        out_twc = np.empty(n, np.int32)
        out_strand = np.empty(n, np.uint8)
        lib.sintax_window_c(
            self._es, qcat.ctypes.data, offs.ctypes.data, n,
            self._win_comp.ctypes.data, int(both),
            self._win_ctl.ctypes.data, params.alpha_size,
            params.word_length, params.slot_count,
            self.index._starts.ctypes.data,
            self.index._postings.ctypes.data, self.index.seq_count,
            B, self.boot_subset, int(self.boot_subset_divide),
            self.randseed, self._gx.ctypes.data,
            self._tax_id.ctypes.data,
            out_ntax.ctypes.data, out_ids.ctypes.data,
            out_cnts.ctypes.data, out_twc.ctypes.data,
            out_strand.ctypes.data)
        res = []
        ids_l = out_ids.tolist()
        cnts_l = out_cnts.tolist()
        for i in range(n):
            k = int(out_ntax[i])
            res.append((chr(out_strand[i]) if out_strand[i] else "+",
                        ids_l[i * B:i * B + k],
                        cnts_l[i * B:i * B + k],
                        int(out_twc[i])))
        return res

    def classify(self, q_seq: np.ndarray):
        """Returns (pred names, Ps, top_word_count)."""
        params = self.index.params
        uw = params.unique_words(q_seq)
        nuw = len(uw)
        if nuw < 8:
            return [], [], 0

        seq_count = self.index.seq_count
        starts = self.index._starts
        sizes = self.index._sizes
        postings = self.index._postings
        m = (nuw // self.boot_subset if self.boot_subset_divide
             else self.boot_subset)

        boot_ti, boot_u = self._run_boots(uw, nuw, seq_count, starts,
                                          sizes, postings, m)
        if self._c_tally is not None:
            # already in final CountMapToVecs order (C-side quicksort)
            ids, counts, top_word_count = self._c_tally
        else:
            top_word_count = int(boot_u.max()) if self.boots else 0
            # tax ids are assigned in lexicographic order, so np.unique's
            # ascending ids reproduce CountMapToVecs' map order exactly
            uti, ucnt = np.unique(self._tax_id[boot_ti],
                                  return_counts=True)
            from ..search.hitmgr import quick_sort_order
            order = quick_sort_order(ucnt.tolist(), desc=True)
            ids = [int(uti[i]) for i in order]
            counts = [int(ucnt[i]) for i in order]

        pred, ps = self.pred_from_tally(ids, counts)
        return pred, ps, top_word_count

    def pred_from_tally(self, ids, counts):
        """pred names + cumulative Ps from the ordered (tax id, count)
        tally (the tail of Classify, src/sintaxsearcher.cpp:200-228)."""
        top_id = ids[0]
        top_count = counts[0]
        pred = self._tax_names[top_id]
        if pred is None:             # malformed winner: reference dies here
            pred = tax_names(self._uniq_tax[top_id])
        name_ids = self._name_ids[top_id]
        if len(ids) > 1 and len(name_ids):
            other = self._contains[np.array(ids[1:], np.int64)][:, name_ids]
            extra = (np.array(counts[1:],
                              np.int64)[:, None] * other).sum(axis=0)
        else:
            extra = np.zeros(len(name_ids), np.int64)
        ps = []
        prod_p = 1.0
        for i, _name in enumerate(pred):
            cnt = top_count + int(extra[i])
            # the reference is compiled -ffast-math: cnt/BOOT_ITERS is
            # emitted as cnt * (1/BOOT_ITERS), which differs in the last
            # ulp and can flip the 4th printed decimal
            p = cnt * (1.0 / self.boots)
            prod_p *= p
            ps.append(prod_p)
        return pred, ps


def sintax(query_path: Optional[str]) -> None:
    from ..alpha import revcomp
    o = options()
    db_path = o.str("db")
    from ..commands import load_db
    db, index = load_db(db_path)
    nucleo = db.get_is_nucleo()
    if index is None:
        index = UDBIndex.from_seqdb(db)

    if nucleo:
        strand = o.str("strand", "")
        if not strand:
            raise SystemExit("Must specify -strand plus or both with nt db")
        both = strand == "both"
    else:
        both = False   # amino DB: single plus-strand classify

    grand = GlobalRand(o.uns("randseed"))
    cls = SintaxClassifier(db, index, grand)
    cutoff = o.flt("sintax_cutoff")

    f = open(o.str("tabbedout"), "w") if o.filled("tabbedout") else None
    from ..io.fastx import read_fastx

    def write_row(label, c_strand, pred, ps, last_twc, out_buf):
        ap = out_buf.append
        if last_twc == 0:
            ap(label + "\t*\t*\t*\n")
            return
        parts = [label, "\t",
                 ",".join(f"{n}({p:.4f})" for n, p in zip(pred, ps)),
                 "\t", c_strand, "\t"]
        out = []
        for i, (n, p) in enumerate(zip(pred, ps)):
            if p < cutoff:
                if i == 0:
                    out.append("*")
                break
            out.append(n)
        parts.append(",".join(out) if out != ["*"] else "*")
        parts.append("\n")
        ap("".join(parts))

    # device boots (int8 matmul formulation, amplicon/sintax_device.py):
    # forced by -sintax_device; auto for big DBs, where the host C argmax
    # scan (O(boots x T) per strand) grows with the DB.  The 40,000-target
    # auto threshold is a placeholder until the crossover is measured on
    # the GPU.
    dev_cls = None
    from .sintax_device import SintaxDeviceClassifier
    forced = o.flag("sintax_device")
    if o.flag("no_sintax_device"):
        dev_reason = "off"
    elif not SintaxDeviceClassifier.usable(cls):
        dev_reason = ("DB not usable on the device (-self, hashed index, "
                      "or incidence above the memory gate)")
        if forced:
            raise SystemExit("-sintax_device: " + dev_reason)
    elif not forced and index.seq_count < 40000:
        dev_reason = f"auto threshold: {index.seq_count} < 40000 targets"
    else:
        from .. import device
        dev_reason = device.gate("sintax_device", forced)
        if dev_reason is None:
            try:
                dev_cls = SintaxDeviceClassifier(cls)
            except Exception as e:
                # auto mode: e.g. device memory for the incidence; the
                # host classifier serves the run and the reason is logged
                if forced:
                    raise
                dev_reason = f"device init failed: {e!r}"[:200]
    from .. import runlog
    runlog.note("SINTAX: device boots " + (
        "on" if dev_cls is not None else f"off ({dev_reason})"))

    # windowed native classify (one C call per window); falls back to the
    # per-query path when the native lib or plain postings are missing
    use_window = dev_cls is not None \
        or cls.classify_window([], both) is not None
    if use_window:
        W = 512
        win_labels = []
        win_seqs = []
        out_buf = []

        def flush():
            if dev_cls is not None:
                res = dev_cls.classify_window(win_seqs, both)
            else:
                res = cls.classify_window(win_seqs, both)
            for label, (c_strand, ids, counts, last_twc) in zip(
                    win_labels, res):
                if f is None:
                    continue
                if last_twc == 0 or not ids:
                    write_row(label, c_strand, [], [], 0, out_buf)
                else:
                    pred, ps = cls.pred_from_tally(ids, counts)
                    write_row(label, c_strand, pred, ps, last_twc,
                              out_buf)
            if f is not None and out_buf:
                f.write("".join(out_buf))
                out_buf.clear()
            win_labels.clear()
            win_seqs.clear()

        n_classified = 0
        for label, seq, _q in read_fastx(query_path, stream=True):
            if len(seq) == 0:
                continue
            win_labels.append(label)
            win_seqs.append(seq)
            n_classified += 1
            if len(win_seqs) >= W:
                flush()
        flush()
        if f:
            f.close()
        stats_path = os.environ.get("USEARCH_DEVICE_STATS")
        if stats_path:
            # same provenance channel the engine uses (engine/batch.py):
            # lets the bench prove the AUTO device path actually served
            # the classification, no forcing flags
            import json
            with open(stats_path, "a") as sf:
                sf.write(json.dumps({
                    "cmd": "sintax",
                    "device": dev_cls is not None,
                    "reason": dev_reason,
                    "queries": n_classified,
                    "targets": index.seq_count}) + "\n")
        return

    for label, seq, _q in read_fastx(query_path, stream=True):
        if len(seq) == 0:
            continue
        pred_f, ps_f, twc_f = cls.classify(seq)
        if both:
            pred_r, ps_r, twc_r = cls.classify(revcomp(seq))
        else:
            pred_r, ps_r, twc_r = [], [], 0
        if twc_f >= twc_r:
            c_strand, pred, ps = "+", pred_f, ps_f
        else:
            c_strand, pred, ps = "-", pred_r, ps_r
        # reference quirk (src/sintaxsearcher.cpp:51-72 + WriteTabbed):
        # OnQueryDoneImpl picks the winning strand's prediction but NOT
        # m_TopWordCount, so the '*' row check uses the LAST classified
        # strand's count (the revcomp with -strand both)
        last_twc = twc_r if both else twc_f
        if f is None:
            continue
        out_one = []
        write_row(label, c_strand, pred, ps, last_twc, out_one)
        f.write("".join(out_one))
    if f:
        f.close()
