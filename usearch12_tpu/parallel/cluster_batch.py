"""Batch-synchronous greedy clustering with device-resident U counting.

The device formulation of cluster_mt (src/clustermt.cpp:46-123): queries
stream against a FROZEN centroid set; misses buffer as pending; at the
flush the misses are re-searched serially with admissions applied in
input order — the schedule that reconciles greedy-order semantics with
batch parallelism (SURVEY §2.2).

Between flushes the centroid set (and hence the UDB) is immutable, so the
hot USORT word-count scatter-add becomes one dense int8 matmul per query
window: U = Q_onehot @ W_incidence, optionally sharded over a device mesh
("data" x "db", jax.sharding + shard_map with an all_gather merge —
see parallel/search_step.py).  The full U rows come back to the host,
where the reference's exact SetTopBump + stable count-sort filters and
the HSP-anchored alignment replay run unchanged — so outputs are
byte-identical to the host cluster_mt path (asserted in
tests/test_parity_cluster.py::test_cluster_mt_device_batch).
"""

from __future__ import annotations

import os
from functools import partial

from typing import List, Optional

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB
from ..io.fastx import read_fastx, write_fasta
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex, UDBParams
from ..search.accepter import Accepter
from ..search.terminator import Terminator
from ..search.hitmgr import HitMgr
from ..search.usorted import (set_top_bump, set_top_no_bump,
                              count_sort_order_desc, quick_sort_order_desc)
from ..align.result import AlignResult
from ..cluster.uclust import _uc_hit_line


class DeviceUCounter:
    """U counting for a query window vs a frozen index: one int8 matmul
    with int32 accumulation (optionally sharded over a mesh's "db" axis).

    Admissions between flushes append COLUMNS in place: the incidence is
    int8 with geometric capacity and new centroid columns are written
    with a buffer-donating jitted update, so the per-flush cost is
    O(V * new_centroids) instead of a full O(V * T) rebuild+upload."""

    def __init__(self, mesh=None) -> None:
        self.mesh = mesh
        self._mat = None
        self._t = 0          # columns filled
        self._cap = 0        # device column capacity
        self._upd = None
        self._pending_cols = None

    def _sharding(self):
        from jax.sharding import NamedSharding, PartitionSpec as P
        return NamedSharding(self.mesh, P(None, "db"))

    def _alloc(self, index: UDBIndex, cap: int) -> None:
        """(Re)build the device incidence with column capacity cap."""
        import jax
        import jax.numpy as jnp
        v = index.params.slot_count
        if self.mesh is not None:
            cap += (-cap) % self.mesh.shape["db"]
        mat = np.zeros((v, cap), dtype=np.int8)
        t = index.seq_count
        if t:
            words = np.repeat(np.arange(v), index.sizes)
            np.add.at(mat, (words, index.postings), 1)
        if self.mesh is not None:
            self._mat = jax.device_put(jnp.asarray(mat), self._sharding())
        else:
            self._mat = jnp.asarray(mat)
        self._cap = cap
        self._t = t
        self._pending_cols = None

    def refresh(self, index: UDBIndex) -> None:
        """Bring the device incidence up to date with the index: appends
        new centroid columns in place, growing capacity geometrically."""
        import jax
        import jax.numpy as jnp
        t = index.seq_count
        if t == 0:
            self._mat = None
            self._t = 0
            self._cap = 0
            return
        if self._mat is None or t > self._cap or t < self._t:
            self._alloc(index, max(2 * t, 1024))
            return
        if t == self._t:
            return
        if self.mesh is not None:
            # sharded buffers: a dynamic_update_slice would cross shard
            # boundaries; rebuild (mesh clustering keeps T small)
            self._alloc(index, self._cap)
            return
        # incremental: write only columns [_t, t), with buffer donation
        # so XLA updates the live buffer instead of copying V*cap.
        # Column counts are bucketed to powers of two by repeating the
        # last column (idempotent scatter) so flush widths reuse a few
        # compiled updaters.
        cols = self._pending_cols
        assert cols is not None and cols.shape[1] == t - self._t, \
            "refresh without note_admitted for the new centroids"
        n_new = cols.shape[1]
        width = 1 << int(np.ceil(np.log2(max(n_new, 1))))
        idx = np.arange(self._t, self._t + width, dtype=np.int32)
        idx[n_new:] = self._t + n_new - 1
        pad = np.repeat(cols[:, -1:], width - n_new, axis=1)
        cols_p = np.concatenate([cols, pad], axis=1) if width > n_new \
            else cols
        if self._upd is None:
            @partial(jax.jit, donate_argnums=(0,))
            def upd(mat, cols, idx):
                return mat.at[:, idx].set(cols)
            self._upd = upd
        self._mat = self._upd(self._mat, jnp.asarray(cols_p),
                              jnp.asarray(idx))
        self._pending_cols = None
        self._t = t

    def note_admitted(self, index: UDBIndex, seqs) -> None:
        """Record the just-admitted centroid sequences so refresh() can
        append their incidence columns without touching the index's
        posting tiers."""
        v = index.params.slot_count
        cols = np.zeros((v, len(seqs)), dtype=np.int8)
        for k, s in enumerate(seqs):
            w = index.params.unique_words(s)
            np.add.at(cols, (w, np.full(len(w), k)), 1)
        if self._pending_cols is None:
            self._pending_cols = cols
        else:
            self._pending_cols = np.concatenate(
                [self._pending_cols, cols], axis=1)

    def count(self, index: UDBIndex, seqs: List[np.ndarray]) -> np.ndarray:
        """Returns (B, T) uint32 shared-unique-word counts."""
        import jax.numpy as jnp
        if self._t == 0:
            return np.zeros((len(seqs), 0), np.uint32)
        v = index.params.slot_count
        rows = len(seqs)
        if self.mesh is not None:
            # the "data" axis shards rows: pad with empty queries
            rows += (-rows) % self.mesh.shape["data"]
        q = np.zeros((rows, v), np.int8)
        for b, s in enumerate(seqs):
            q[b, index.params.unique_words(s)] = 1
        if self.mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            qd = jax.device_put(jnp.asarray(q),
                                NamedSharding(self.mesh, P("data", None)))
        else:
            qd = jnp.asarray(q)
        u = np.asarray(jnp.dot(qd, self._mat,
                               preferred_element_type=jnp.int32))
        return u[:len(seqs), :self._t].astype(np.uint32)


def _rank_from_u(u: np.ndarray):
    """Exact host replay of USortedRanker.rank given a precomputed U row
    (src/udbusortedsearcher.cpp SetTop/SortTop order)."""
    o = options()
    bump = o.uns("bump")
    if bump != 0:
        top_u, top_tix = set_top_bump(u, 1, bump)
    else:
        top_u, top_tix = set_top_no_bump(u, 1)
    if o.flag("quicksort"):
        order = quick_sort_order_desc(top_u)
    else:
        order = count_sort_order_desc(top_u)
    return top_tix[order]


def cluster_mt_batched(input_path: Optional[str], mesh=None) -> None:
    """cluster_mt with the U-counting phase on device (single chip or a
    sharded mesh).  Byte-identical outputs to cluster.uclust.cluster_mt."""
    o = options()
    if not o.filled("id"):
        raise SystemExit("Must set -id")
    max_pending = o.uns("maxpending") if o.filled("maxpending") else 128

    input_db = SeqDB.from_fastx(input_path)
    nucleo = input_db.get_is_nucleo()
    ap = AlnParams.from_cmdline(nucleo)
    ah = AlnHeuristics.from_cmdline(ap)
    params = UDBParams.global_usearch(nucleo)
    index = UDBIndex(params)
    accepter = Accepter(is_global=True)
    terminator = Terminator("cluster_mt")
    counter = DeviceUCounter(mesh)

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
    fail = not o.flag("gaforce")

    centroid_labels: List[str] = []
    centroid_seqs: List[np.ndarray] = []
    # -uc opens later: a checkpoint resume must preserve the records
    # already on disk instead of truncating them
    f_uc = None

    def align_candidates(q_label, q_seq, tix_order):
        """Terminator/accepter replay in candidate-rank order."""
        hm = HitMgr()
        terminator.on_new_query()
        if len(tix_order) == 0:
            return None
        if native is not None:
            native.set_a(q_seq)
        else:
            hf.set_a(q_seq)
        for tix in np.asarray(tix_order).tolist():
            t_label = centroid_labels[tix]
            t_seq = centroid_seqs[tix]
            if accepter.reject_pair(q_label, q_seq, t_label, t_seq):
                continue
            if native is not None:
                native.set_b(t_seq)
                path = native.global_align(fail_if_no_hsps=fail)
            else:
                hf.set_b(t_seq)
                path = global_align(q_seq, t_seq, ap, ah, hf,
                                    fail_if_no_hsps=fail)
            accept = False
            if path is not None:
                ar = AlignResult(query_label=q_label, target_label=t_label,
                                 query_seq=q_seq, target_seq=t_seq,
                                 path=path, nucleo=nucleo, target_index=tix)
                accept = accepter.is_accept(ar)
                if accept:
                    hm.append_hit(ar)
            if terminator.terminate(hm, accept):
                break
        return hm.top_hit()

    def search_one_serial(q_label, q_seq):
        """Host ranking vs the current (growing) set — the serial flush."""
        from ..search.usorted import USortedRanker
        ranker = USortedRanker(index)
        tix_order, _c = ranker.rank(q_seq)
        return align_candidates(q_label, q_seq, tix_order)

    def admit(q_label, q_seq) -> int:
        ci = len(centroid_labels)
        centroid_labels.append(q_label)
        centroid_seqs.append(q_seq)
        index.add_seq(ci, q_seq)
        index.seq_count = ci + 1
        return ci

    def flush(pending):
        """ProcessPending (src/clustermt.cpp:46-78)."""
        admitted = []
        for label, seq in pending:
            top = search_one_serial(label, seq)
            if top is None:
                ci = admit(label, seq)
                admitted.append(seq)
                if f_uc:
                    f_uc.write(f"S\t{ci}\t{len(seq)}\t*\t.\t*\t*\t*\t"
                               f"{label}\t*\n")
            else:
                if f_uc:
                    f_uc.write(_uc_hit_line(top, label))
        pending.clear()
        if admitted:
            counter.note_admitted(index, admitted)
        counter.refresh(index)

    records = [(label, seq) for label, seq, _q in read_fastx(input_path, stream=True)
               if len(seq) > 0]
    pending: List = []
    pos = 0
    window = max_pending

    # -- checkpoint/resume (SURVEY §5.4): the batch-synchronous round is
    # the natural checkpoint unit — after every flush the full run state
    # is (queries consumed, centroid set, -uc bytes written).  A resumed
    # run replays from the last flush and produces byte-identical output.
    ckpt_path = o.str("checkpoint") if o.filled("checkpoint") else None
    resumed = False
    if ckpt_path is not None and os.path.exists(ckpt_path):
        data = np.load(ckpt_path, allow_pickle=True)
        pos = int(data["pos"])
        uc_offset = int(data["uc_offset"])
        labels = list(data["labels"])
        seqs = list(data["seqs"])
        for lbl, s in zip(labels, seqs):
            admit(str(lbl), np.asarray(s, dtype=np.uint8))
        if o.filled("uc"):
            # keep the pre-checkpoint records; drop anything written
            # after the last checkpoint.  The file may not exist (the
            # crashed run lacked -uc, or it was removed): resume with an
            # empty one rather than failing.
            with open(o.str("uc"), "a+b") as fh:
                fh.truncate(uc_offset)
            f_uc = open(o.str("uc"), "a")
        resumed = True
    if not resumed and o.filled("uc"):
        f_uc = open(o.str("uc"), "w")

    def save_checkpoint():
        if ckpt_path is None:
            return
        if f_uc is not None:
            f_uc.flush()
            off = f_uc.tell()
        else:
            off = 0
        np.savez(ckpt_path + ".tmp.npz",
                 pos=pos, uc_offset=off,
                 labels=np.array(centroid_labels, dtype=object),
                 seqs=np.array(centroid_seqs, dtype=object))
        os.replace(ckpt_path + ".tmp.npz", ckpt_path)

    counter.refresh(index)
    while pos < len(records):
        batch = records[pos:pos + window]
        u_rows = counter.count(index, [s for _l, s in batch])
        flushed = False
        for b, (label, seq) in enumerate(batch):
            tix_order = _rank_from_u(u_rows[b]) if u_rows.shape[1] else []
            top = align_candidates(label, seq, tix_order)
            if top is None:
                pending.append((label, seq))
                if len(pending) >= max_pending:
                    # admissions change the frozen set: flush, then
                    # re-window from the next unprocessed query
                    flush(pending)
                    pos += b + 1
                    save_checkpoint()
                    flushed = True
                    break
            else:
                if f_uc:
                    f_uc.write(_uc_hit_line(top, label))
        if not flushed:
            pos += len(batch)
    flush(pending)

    if f_uc:
        f_uc.close()
    if o.filled("centroids"):
        with open(o.str("centroids"), "w") as f:
            for lbl, s in zip(centroid_labels, centroid_seqs):
                write_fasta(f, lbl, s, o.uns("fasta_cols"))
