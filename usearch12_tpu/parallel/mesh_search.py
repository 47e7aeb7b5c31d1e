"""Mesh-sharded usearch_global with full search semantics.

The multi-chip formulation of the USORT search (SURVEY.md §2.2/§5.8):

  mesh axes: "data" (query batch) x "db" (target shard)
  - query one-hots Q (B, V) sharded over "data"
  - UDB incidence W (V, T) sharded over "db" (int8: the dense-matmul
    formulation of SetU; each device holds T/n_db columns)
  - per-shard U = Q @ W (int8, int32 accumulation), per-shard lax.top_k
    (count desc,
    local index asc), all_gather over "db", then ONE lexicographic
    lax.sort with integer keys (-count, global index) — the exact
    stable count-sort order (src/countsort.h:49, lowest-target-first
    ties, no float key rounding)

The SetTopBump filter (src/udbusortedsearcher.cpp:205-282) looks like a
sequential index-order scan, but its ratchet reduces to two PARALLEL
prefix maxima, which makes it exact on the mesh:

  - cur_min only changes at RECORDS (new prefix maxima of U), and a
    record is never below cur_min (cur_min < previous max < record), so
    every record ratchets iff floor(v*bump/100) < previous prefix max;
  - therefore cur_min_at(i) = max over earlier records of those
    floor(v*bump/100) contributions — an (exclusive) prefix max of a
    pointwise function of U and the (exclusive) prefix max of U.

Both prefix maxima shard over "db" with a tiny all_gather carry (the
per-shard maxima), so the device computes the exact SetTopBump keep
mask, masks U, and the merged top-K equals the host candidate order.
The count-sort NextValue/2 cutoff is replayed on the host from the
merged counts (maxv and the first lower count are always visible in
the merged prefix).  The only remaining host fallback is top-K
capacity, which cannot trigger while K >= maxaccepts+maxrejects.

Alignment and output reuse the batch engine (engine/batch.py): the mesh
ranking is plugged into BatchEngine.search_window via rank_override, so
blast6/uc bytes are identical to the host path by construction once the
candidate prefixes match.  Asserted end-to-end by
__graft_entry__.dryrun_multichip on a virtual CPU mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB
from ..index.udb import UDBIndex


class MeshRanker:
    """Device-sharded USORT ranking over a jax Mesh."""

    def __init__(self, mesh, index: UDBIndex, db_axis: str = "db",
                 data_axis: str = "data", topk: int = 64) -> None:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.index = index
        self.db_axis = db_axis
        self.data_axis = data_axis
        self.topk = topk
        # per-run overhead accounting (VERDICT r3: a per-step overhead
        # table - collective bytes, dispatches per window - is the
        # meaningful sharding measurement on a virtual mesh, where
        # wall-clock is noise).  Collective bytes are analytic from the
        # program: per rank_window with B rows over n_db shards,
        #   all_gather carries: 2 prefix-max carries (n_db*B*4 B) when
        #     bump else 1, + count/index top-K gathers 2*(B*n_db*K*4 B)
        #   psum: NextValue reduce (B*4 B)
        self.overhead = {"dispatches": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                         "all_gather_bytes": 0, "psum_bytes": 0,
                         "windows": 0}
        index._flatten()
        v = index.params.slot_count
        t = index.seq_count
        self.t = t
        n_db = mesh.shape[db_axis]
        self.t_pad = t + ((-t) % n_db)
        # dense int8 incidence (V, T_pad), sharded over "db".  Entries
        # are per-word occurrence counts of the target's unique words
        # (0/1 for plain coding of unique words).
        mat = np.zeros((v, self.t_pad), dtype=np.int8)
        words = np.repeat(np.arange(v), index.sizes)
        np.add.at(mat, (words, index.postings), 1)
        self._w = jax.device_put(
            jnp.asarray(mat),
            NamedSharding(mesh, P(None, db_axis)))
        self._step = self._make_step()

    def _make_step(self):
        import jax
        import jax.numpy as jnp
        from usearch12_tpu.parallel.shardmap import shard_map_norep
        from jax.sharding import PartitionSpec as P

        K = self.topk
        db_axis = self.db_axis
        bump = int(options().uns("bump"))
        n_db = self.mesh.shape[db_axis]

        def _sharded_exclusive_prefix_max(x, shard):
            """Exclusive prefix max along axis 1 of a db-sharded array:
            per-shard associative scan + a carry of earlier shards'
            totals (one tiny all_gather)."""
            inc = jax.lax.associative_scan(jnp.maximum, x, axis=1)
            exc = jnp.concatenate(
                [jnp.zeros_like(x[:, :1]), inc[:, :-1]], axis=1)
            tot = inc[:, -1]                           # (B,)
            g = jax.lax.all_gather(tot, db_axis)       # (n_db, B)
            ids = jax.lax.broadcasted_iota(jnp.int32, (n_db, 1), 0)
            carry = jnp.max(jnp.where(ids < shard, g, 0), axis=0)
            return jnp.maximum(exc, carry[:, None])

        def local_step(q_onehot, w):
            # per-shard counting; counts fit int32 exactly
            u = jnp.dot(q_onehot.astype(jnp.int8), w,
                        preferred_element_type=jnp.int32)
            t_shard = u.shape[1]
            shard = jax.lax.axis_index(db_axis)
            # exclusive index-order prefix max of U — drives both the
            # SetTopBump ratchet and the count-sort NextValue (which is
            # the PENULTIMATE prefix record, src/countsort.h semantics
            # as replayed in usort_rank_c)
            pm = _sharded_exclusive_prefix_max(u, shard)
            u_orig = u
            if bump != 0:
                # exact SetTopBump keep mask via two prefix maxima
                record = u > pm
                nm = (u * bump) // 100
                contrib = jnp.where(record & (nm < pm), nm, 0)
                cur_min = _sharded_exclusive_prefix_max(contrib, shard)
                cur_min = jnp.maximum(cur_min, 1)
                u = jnp.where(u >= cur_min, u, 0)
            kk = min(K, t_shard)
            cnt, idx = jax.lax.top_k(u, kk)      # count desc, index asc
            gidx = idx + shard * t_shard
            # gather all shards' top-k and merge with integer
            # lexicographic keys: (-count asc, global index asc)
            gcnt = jax.lax.all_gather(cnt, db_axis, axis=1,
                                      tiled=True)    # (B, n_db*k)
            ggidx = jax.lax.all_gather(gidx, db_axis, axis=1, tiled=True)
            mcnt, midx = jax.lax.sort((-gcnt, ggidx), dimension=1,
                                      num_keys=2, is_stable=False)
            # NextValue = prefix max of U at the first global-max
            # position (bump drops are never records, so records of the
            # survivor sequence equal records of U)
            p_star = midx[:, 0]                      # lowest-index max
            local_p = p_star - shard * t_shard
            mine = (local_p >= 0) & (local_p < t_shard)
            lp = jnp.clip(local_p, 0, t_shard - 1)
            pmv = jnp.take_along_axis(pm, lp[:, None], axis=1)[:, 0]
            nextv = jax.lax.psum(jnp.where(mine, pmv, 0), db_axis)
            del u_orig
            return -mcnt[:, :K], midx[:, :K], nextv

        fn = shard_map_norep(
            local_step, mesh=self.mesh,
            in_specs=(P(self.data_axis, None), P(None, db_axis)),
            out_specs=(P(self.data_axis, None),
                       P(self.data_axis, None),
                       P(self.data_axis)))
        return jax.jit(fn)

    def _onehot(self, jbuf, j_off, rows):
        params = self.index.params
        n_jobs = len(j_off) - 1
        q = np.zeros((rows, params.slot_count), dtype=np.int8)
        for j in range(n_jobs):
            seq = jbuf[j_off[j]:j_off[j + 1]]
            q[j, params.unique_words(seq)] = 1
        return q

    def rank_window(self, jbuf: np.ndarray, j_off: np.ndarray):
        """Single-process entry: returns (cand (B,K) int64 global
        indexes, cnts (B,K), out_n, uncertain (B,) bool)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        n_jobs = len(j_off) - 1
        n_data = self.mesh.shape[self.data_axis]
        b_pad = n_jobs + ((-n_jobs) % n_data)
        q = self._onehot(jbuf, j_off, b_pad)
        qd = jax.device_put(
            jnp.asarray(q),
            NamedSharding(self.mesh, P(self.data_axis, None)))
        with self.mesh:
            cnts_d, cand_d, nextv_d = self._step(qd, self._w)
        cnts = np.asarray(cnts_d)[:n_jobs]
        cand = np.asarray(cand_d)[:n_jobs].astype(np.int64)
        nextv = np.asarray(nextv_d)[:n_jobs]
        ov = self.overhead
        n_db = self.mesh.shape[self.db_axis]
        bump = int(options().uns("bump"))
        k = min(self.topk, self.t_pad // max(n_db, 1) or 1)
        ov["dispatches"] += 2            # device_put + step
        ov["h2d_bytes"] += q.nbytes
        ov["d2h_bytes"] += (cnts.nbytes + cand.nbytes + nextv.nbytes)
        carries = 2 if bump else 1
        ov["all_gather_bytes"] += (carries * n_db * b_pad * 4
                                   + 2 * b_pad * n_db * k * 4)
        ov["psum_bytes"] += b_pad * 4
        ov["windows"] += 1
        return self._postprocess(cand, cnts, nextv, n_jobs)

    def rank_window_spmd(self, jbuf: np.ndarray, j_off: np.ndarray,
                         rows_per_host: int):
        """Multi-process entry: every process contributes rows_per_host
        query rows of a GLOBAL (n_proc*rows_per_host, V) batch and gets
        back the candidate lists for ITS rows.  All processes must call
        this the same number of times with the same rows_per_host (the
        jitted collective program is identical across hosts)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        n_jobs = len(j_off) - 1
        assert n_jobs <= rows_per_host
        q = self._onehot(jbuf, j_off, rows_per_host)
        sharding = NamedSharding(self.mesh, P(self.data_axis, None))
        qd = jax.make_array_from_process_local_data(sharding, q)
        with self.mesh:
            cnts_d, cand_d, nextv_d = self._step(qd, self._w)

        def local(arr):
            shards = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            return np.concatenate([np.asarray(s.data) for s in shards])

        cnts = local(cnts_d)[:n_jobs]
        cand = local(cand_d)[:n_jobs].astype(np.int64)
        nextv = local(nextv_d)[:n_jobs]
        return self._postprocess(cand, cnts, nextv, n_jobs)

    def _postprocess(self, cand, cnts, nextv, n_jobs):
        # SetTopBump ran on device; the merged list is the exact
        # candidate order.  Trim padding targets / empty slots (sorted
        # last) and replay the count-sort NextValue/2 cutoff with the
        # device-computed NextValue (penultimate prefix record).
        valid = (cnts > 0) & (cand < self.t)
        first_bad = np.where(valid.all(axis=1), cnts.shape[1],
                             np.argmin(valid, axis=1))
        out_n = first_bad.astype(np.int32)
        minv = np.maximum(nextv // 2, 1)
        keep = valid & (cnts >= minv[:, None])
        out_n = np.minimum(out_n, keep.sum(axis=1)).astype(np.int32)
        # capacity fallback: the true candidate list may extend past a
        # full device top-K; impossible while K >= maxaccepts+maxrejects
        uncertain = (out_n >= self.topk) & \
                    (self._consume_bound() > self.topk)
        return cand, cnts.astype(np.uint32), out_n, uncertain

    def _consume_bound(self) -> int:
        o = options()
        from ..search.terminator import Terminator
        term = Terminator("usearch_global")
        return term.max_accepts + term.max_rejects


def mesh_search_file(query_path: str, db: SeqDB, mesh,
                     on_query_done, fast_emit=None,
                     index: Optional[UDBIndex] = None,
                     topk: int = 64, window: int = 4096) -> dict:
    """usearch_global with mesh-sharded ranking + engine alignment.
    Returns stats {queries, fallbacks}."""
    from ..engine.batch import BatchEngine
    eng = BatchEngine("usearch_global", db, index=index)
    ranker = MeshRanker(mesh, eng.index, topk=topk)
    stats = {"queries": 0, "fallbacks": 0}

    def rank_override(jbuf, j_off):
        cand, cnts, out_n, uncertain = ranker.rank_window(jbuf, j_off)
        n_jobs = len(j_off) - 1
        stats["queries"] += n_jobs
        if uncertain.any():
            # exact host re-rank for uncertain jobs
            h_cand, h_cnts, h_out_n = eng._rank_jobs(jbuf, j_off)
            for j in np.nonzero(uncertain)[0]:
                stats["fallbacks"] += 1
                k = min(h_out_n[j], cand.shape[1])
                cand[j, :k] = h_cand[j, :k]
                cnts[j, :k] = h_cnts[j, :k]
                out_n[j] = k
        return (np.ascontiguousarray(cand.astype(np.uint32)),
                np.ascontiguousarray(cnts), out_n)

    eng.run_file(query_path, on_query_done, window=window,
                 fast_emit=fast_emit, rank_override=rank_override)
    stats["overhead"] = dict(ranker.overhead)
    stats["dims"] = {"v": ranker.index.params.slot_count,
                     "t_pad": ranker.t_pad,
                     "n_db": mesh.shape[ranker.db_axis]}
    return stats
