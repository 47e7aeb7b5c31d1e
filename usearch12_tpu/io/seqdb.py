"""In-memory sequence database (reference: src/seqdb.{h,cpp}).

Stores label / seq (np.uint8 ASCII) / optional qual per record, with helpers
for nt/aa typing, masking, size= annotations, and packing into fixed-shape
padded device batches.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..alpha import IS_ACGTU
from ..mask import mask_seq, db_mask_type

# reference semantics: strstr(";size=") — the annotation must follow a ';'
_SIZE_RE = re.compile(r";size=(\d+)")


def size_from_label(label: str, default: int = 1) -> int:
    if "size=" not in label:
        return default
    m = _SIZE_RE.search(label)
    return int(m.group(1)) if m else default


def sizes_bulk(db, n: int, default: int):
    """size_from_label over labels [0, n) as an int64 array.  Uses the
    C bulk parser on the lazy-label byte ranges when available (keeps
    the labels undecoded); exact size_from_label semantics."""
    labels = db.labels
    if isinstance(labels, _LazyLabels) and n > 0:
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            raw = labels.raw
            buf = np.frombuffer(raw, dtype=np.uint8)
            lo = np.ascontiguousarray(labels.lo[:n], dtype=np.int64)
            hi = np.ascontiguousarray(labels.hi[:n], dtype=np.int64)
            out = np.empty(n, np.int64)
            lib.sizes_from_labels_c(buf.ctypes.data, lo.ctypes.data,
                                    hi.ctypes.data, n, default,
                                    out.ctypes.data)
            return out
    return np.fromiter((size_from_label(labels[i], default)
                        for i in range(n)), np.int64, n)


def strip_size(label: str) -> str:
    if "size=" not in label:
        return label.strip(";")
    s = _SIZE_RE.sub("", label)
    return s.strip(";")


def relabel_with_size(label: str, size: int) -> str:
    base = strip_size(label)
    if base and not base.endswith(";"):
        base += ";"
    return f"{base}size={size};"


class _LazyCol:
    """List-like column that materializes elements from the bulk parse
    buffers on first access.  Loading a 300k-record FASTA eagerly costs
    ~2s of Python object churn (3 objects/record); commands like unoise3
    touch only the head of the (size-sorted) file, so per-record cost
    must be paid per *access*, not per load.  Supports the list surface
    the rest of the codebase uses: len/index/slice/iter/append."""

    __slots__ = ("n", "_extra")

    def __init__(self, n: int) -> None:
        self.n = n
        self._extra: list = []

    def _make(self, i: int):
        raise NotImplementedError

    def __len__(self) -> int:
        return self.n + len(self._extra)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if 0 <= i < self.n:
            return self._make(i)
        return self._extra[i - self.n]

    def __iter__(self):
        for i in range(self.n):
            yield self._make(i)
        yield from self._extra

    def append(self, x) -> None:
        self._extra.append(x)


class _LazyLabels(_LazyCol):
    __slots__ = ("raw", "lo", "hi")

    def __init__(self, raw: bytes, lo, hi, n: int) -> None:
        super().__init__(n)
        self.raw, self.lo, self.hi = raw, lo, hi

    def _make(self, i: int) -> str:
        # per-access decode: decoding the whole multi-MB input up front
        # costs more than decoding the few labels actually touched
        return self.raw[self.lo[i]:self.hi[i]].decode("latin1")


class _LazySeqs(_LazyCol):
    __slots__ = ("buf", "off")

    def __init__(self, buf, off, n: int) -> None:
        super().__init__(n)
        self.buf, self.off = buf, off

    def _make(self, i: int):
        return self.buf[self.off[i]:self.off[i + 1]]


class _LazyQuals(_LazyCol):
    __slots__ = ()

    def _make(self, i: int):
        return None


class SeqDB:
    def __init__(self) -> None:
        self.labels: List[str] = []
        self.seqs: List[np.ndarray] = []
        self.quals: List[Optional[str]] = []
        self._is_nucleo: Optional[bool] = None

    # -- construction -----------------------------------------------------
    @classmethod
    def from_fastx(cls, path: str, lazy: bool = False) -> "SeqDB":
        db = cls._from_fasta_bulk(path, lazy=lazy)
        if db is not None:
            return db
        from .fastx import read_fastx
        db = cls()
        for label, seq, qual in read_fastx(path):
            if len(seq) == 0:
                # reference warns and drops empty records at load
                continue
            db.add(label, seq, qual)
        return db

    @classmethod
    def _from_fasta_bulk(cls, path: str, lazy: bool = False):
        """Bulk C FASTA parse (fasta_parse_c); None => caller falls back
        to the streaming parser (FASTQ, or no native lib)."""
        from ..native import get_lib
        lib = get_lib()
        if lib is None:
            return None
        from .fastx import open_maybe_gz, _seq_delete_table, _proc_label
        from ..config import options
        try:
            with open_maybe_gz(path) as f:
                raw = f.read()
            if not raw.startswith(b">"):
                return None
        except (OSError, ValueError):
            return None
        buf = np.frombuffer(raw, dtype=np.uint8)
        n = len(buf)
        keep = np.ones(256, dtype=np.uint8)
        for c in _seq_delete_table(False):
            keep[c] = 0
        # every record starts with a line-initial '>', so the total count
        # of '>' bytes bounds the record count; sizing the offset arrays
        # by n//8 cost ~0.5s of first-touch page faults on an 86MB input
        # (bytes.count over a numpy == scan: no 86MB bool temp to fault in)
        max_rec = raw.count(b">") + 1
        while True:
            seq_buf = np.empty(max(n, 1), dtype=np.uint8)
            seq_off = np.empty(max_rec + 1, dtype=np.int64)
            lbl_off = np.empty(max_rec, dtype=np.int64)
            lbl_end = np.empty(max_rec, dtype=np.int64)
            n_empty = np.zeros(1, dtype=np.int64)
            nrec = lib.fasta_parse_c(
                buf.ctypes.data, n, keep.ctypes.data, seq_buf.ctypes.data,
                len(seq_buf), seq_off.ctypes.data, lbl_off.ctypes.data,
                lbl_end.ctypes.data, max_rec, n_empty.ctypes.data)
            if nrec >= 0:
                break
            max_rec *= 4
        db = cls()
        o = options()
        plain = not (o.flag("trunclabels") or o.filled("truncstr"))
        if lazy and plain:
            db.labels = _LazyLabels(raw, lbl_off[:nrec].copy(),
                                    lbl_end[:nrec].copy(), nrec)
            off = seq_off[:nrec + 1].copy()
            db.seqs = _LazySeqs(seq_buf, off, nrec)
            db.quals = _LazyQuals(nrec)
            db._bulk_buf = seq_buf
            db._bulk_off = off
            return db
        labels = db.labels
        seqs = db.seqs
        quals = db.quals
        if plain:
            # latin1 is 1 byte/char, so byte offsets index the decoded
            # string directly — one decode instead of one per label
            raw_s = raw.decode("latin1")
            lo_l = lbl_off[:nrec].tolist()
            hi_l = lbl_end[:nrec].tolist()
            so_l = seq_off[:nrec + 1].tolist()
            for i in range(nrec):
                labels.append(raw_s[lo_l[i]:hi_l[i]])
                seqs.append(seq_buf[so_l[i]:so_l[i + 1]])
                quals.append(None)
        else:
            for i in range(nrec):
                labels.append(_proc_label(raw[lbl_off[i]:lbl_end[i]]))
                seqs.append(seq_buf[seq_off[i]:seq_off[i + 1]])
                quals.append(None)
        # seqs are consecutive views of one buffer; keep it so whole-DB
        # passes (derep) can skip re-concatenation
        db._bulk_buf = seq_buf
        db._bulk_off = seq_off[:nrec + 1].copy()
        return db

    def add(self, label: str, seq: np.ndarray, qual: Optional[str] = None) -> int:
        idx = len(self.labels)
        self.labels.append(label)
        self.seqs.append(np.asarray(seq, dtype=np.uint8))
        self.quals.append(qual)
        return idx

    # -- accessors ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.labels)

    @property
    def seq_count(self) -> int:
        return len(self.labels)

    def seq_length(self, i: int) -> int:
        return len(self.seqs[i])

    def letter_count(self) -> int:
        return sum(len(s) for s in self.seqs)

    def get_is_nucleo(self) -> bool:
        """>80% of sampled letters in [ACGTUN] => nucleotide
        (src/seqdb.cpp:268-310; deterministic full count instead of the
        reference's rand() sampling — equivalent for unambiguous inputs)."""
        if self._is_nucleo is None:
            total = 0
            nuc = 0
            for s in self.seqs:
                if len(s) == 0:
                    continue
                total += len(s)
                nuc += int(IS_ACGTU[s].sum())
                nuc += int((s == ord("N")).sum()) + int((s == ord("n")).sum())
                if total >= 100000:
                    break
            self._is_nucleo = total > 0 and nuc / total > 0.8
        return self._is_nucleo

    def set_is_nucleo(self, v: bool) -> None:
        self._is_nucleo = v

    # -- masking ------------------------------------------------------------
    def mask(self, mtype: Optional[str] = None) -> None:
        nucleo = self.get_is_nucleo()
        if mtype is None:
            mtype = db_mask_type(nucleo)
        if mtype in ("fastnucleo", "fastamino") and self._mask_fast_batch(
                nucleo):
            return
        self.seqs = [mask_seq(s, mtype, nucleo) for s in self.seqs]

    def _mask_fast_batch(self, nucleo: bool) -> bool:
        """FastMask the whole DB in one native call (fast_mask_batch_c);
        False => caller falls back to the per-seq path."""
        from ..native import get_lib
        from ..config import options
        lib = get_lib()
        if lib is None or not hasattr(lib, "fast_mask_batch_c"):
            return False
        from ..alpha import TO_UPPER
        n = len(self.seqs)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in self.seqs], out=offs[1:])
        if offs[n] == 0:
            return True
        concat = np.concatenate(self.seqs) if n else np.zeros(0, np.uint8)
        out = np.ascontiguousarray(TO_UPPER[concat])
        lib.fast_mask_batch_c(
            out.ctypes.data, offs.ctypes.data, n,
            int(options().flag("hardmask")),
            ord("N") if nucleo else ord("X"))
        self.seqs = [out[offs[i]:offs[i + 1]] for i in range(n)]
        return True

    # -- device packing -------------------------------------------------------
    def pack_padded(self, indices=None, pad_to: Optional[int] = None,
                    multiple: int = 128):
        """Pack sequences into a (N, Lpad) uint8 array + lengths vector.
        Pads with 0 and rounds Lpad up to `multiple`."""
        if indices is None:
            indices = range(len(self))
        seqs = [self.seqs[i] for i in indices]
        lens = np.array([len(s) for s in seqs], dtype=np.int32)
        maxlen = int(lens.max()) if len(seqs) else 0
        if pad_to is not None:
            maxlen = max(maxlen, pad_to)
        lpad = max(multiple, ((maxlen + multiple - 1) // multiple) * multiple)
        out = np.zeros((len(seqs), lpad), dtype=np.uint8)
        for k, s in enumerate(seqs):
            out[k, : len(s)] = s
        return out, lens
