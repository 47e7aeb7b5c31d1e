"""Device CSR ranking: exact USORT candidate lists without the dense
(V, T) incidence.

The dense-incidence formulation (parallel/mesh_search.py) stores an int8
incidence column per target — 64 KB of device memory per 1k targets per
word-slot row, infeasible past ~100k targets.  This module keeps the index in its
native CSR form on device (postings ~4 bytes per target word occurrence,
~1 GB for 1M 250-mers) and computes, per query chunk:

  1. hit-stream gather: each query's words' posting rows concatenate
     into a fixed-capacity row of target ids (segment arithmetic +
     take, no scatter)
  2. per-target DENSE counts via a radix one-hot matmul histogram
     (t = hi*128 + lo; two one-hot compares + one int8 matmul per
     hit-stream slice) instead of a (B, cap) sort
  3. the exact SetTopBump ratchet as two prefix maxima over the dense
     ascending-target count row (same derivation as the mesh ranker;
     zero-count positions neither record nor survive cur_min >= 1),
     and the count-sort NextValue from the prefix max at the first
     global max
  4. top-K by packed single-key top_k (count high bits, reversed
     target low bits) — count desc, target asc, bit-exact with
     CountSortOrderDesc

No data-dependent shapes (the hit capacity is a pow2 bucket with a
hard 2^18 ceiling; over-cap queries re-rank exactly on the host via
the `uncertain` path) and no scatter.  The stages are jitted
separately and chained through device-resident arrays.  The radix
histogram, the split jits and the 2^18 ceiling were shaped by an
earlier target's compiler; whether the plain forms (segment_sum,
lax.sort) are better on the GPU is ROADMAP D2.  Exactness vs the host
ranker is asserted in tests/test_csr_rank.py.

It implements the non-big USORT semantics, so usearch_global refuses
-device_rank on DBs above -big (ROADMAP R3).

Reference semantics: SetU_NonCoded + SetTopBump + CountSortOrderDesc
(src/udbusortedsearcher.cpp:375-410, 205-282; src/countsort.h:49).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np


class CSRDeviceRanker:
    """Exact USORT ranking from device-resident CSR postings."""

    # hit-stream sort width ceiling (see prepare_chunks)
    CAP_MAX = 1 << 18

    def __init__(self, index, topk: int = 64, bump: Optional[int] = None,
                 chunk_b: int = 64) -> None:
        from ..config import options
        index._flatten()
        self.index = index
        self.topk = topk
        self.bump = int(options().uns("bump")) if bump is None else bump
        self.chunk_b = chunk_b
        self.t = index.seq_count
        self._sizes_np = np.asarray(index.sizes)
        self._params = index.params
        self._put_arrays(index.params.slot_count, index.starts,
                         index.sizes, index.postings)

    def _put_arrays(self, v, starts_in, sizes_in, postings_in):
        import jax
        import jax.numpy as jnp
        # CSR on device; an extra empty row V serves as the padding word
        starts = np.zeros(v + 2, dtype=np.int32)
        starts[:v + 1] = starts_in
        starts[v + 1] = starts[v]
        self._v = v
        self._starts = jax.device_put(jnp.asarray(starts))
        self._sizes = jax.device_put(
            jnp.asarray(np.concatenate(
                [sizes_in, [0]]).astype(np.int32)))
        self._postings = jax.device_put(
            jnp.asarray(np.asarray(postings_in).astype(np.int32)))
        self._fns = {}

    def _fn(self, wmax: int, cap: int):
        key = (wmax, cap)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._build(wmax, cap)
            self._fns[key] = fn
        return fn

    def _build(self, wmax: int, cap: int):
        """Separately jitted stages chained through device-resident
        intermediates (hits -> dense counts -> prefix scans -> NextValue
        -> packed top-K).  Intermediates never leave the device."""
        import jax
        import jax.numpy as jnp

        K = self.topk
        bump = self.bump
        T = self.t          # sentinel target id for padding

        # dense count layout: T padded to hi_bins x 128 (t = hi*128+lo)
        t_bits = max(int(T + 1).bit_length(), 7)
        TP = 1 << t_bits
        hi_bins = TP // 128
        CH = min(256, cap)   # hit-stream slice per histogram matmul

        CH2 = min(2048, cap)   # positions per idx-matvec slice

        def stage_hits(qw, starts, sizes, postings):
            # qw: (B, wmax) int32 word ids (pad = V+... the empty row)
            #
            # Flat posting index per stream position without per-element
            # gathers.  Telescoping: with base[w] = starts[qw[w]] -
            # seg_lo[w],
            #   idx[p] = base[0] + p + sum_w [p >= seg_off[w]] *
            #            (base[w+1] - base[w])
            # — the sum is a (cap, wmax) step-indicator contracted with
            # the per-word base deltas in int32 (deltas reach
            # tens of millions, past f32's exact-integer range), sliced
            # over positions.  Only the unavoidable postings gather
            # remains per-element.
            B = qw.shape[0]
            seg_sizes = sizes[qw]                        # (B, wmax)
            seg_off = jnp.cumsum(seg_sizes, axis=1)      # inclusive
            seg_lo = seg_off - seg_sizes                 # exclusive
            total = seg_off[:, -1]                       # (B,)
            starts_q = starts[qw]                        # (B, wmax)
            base = starts_q - seg_lo                     # (B, wmax)
            delta = jnp.concatenate(
                [base[:, 1:] - base[:, :-1],
                 jnp.zeros((B, 1), base.dtype)], axis=1)  # (B, wmax)
            def body(i, acc):
                p = (i * CH2
                     + jnp.arange(CH2, dtype=jnp.int32))  # (CH2,)
                ind = (p[None, :, None]
                       >= seg_off[:, None, :]).astype(jnp.int32)
                corr = jnp.sum(ind * delta[:, None, :],
                               axis=2)                    # (B, CH2)
                idx = base[:, 0:1] + p[None, :] + corr
                return jax.lax.dynamic_update_slice(acc, idx, (0, i * CH2))

            idx = jax.lax.fori_loop(
                0, cap // CH2, body, jnp.zeros((B, cap), jnp.int32))
            pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
            hits = postings[jnp.clip(idx, 0, postings.shape[0] - 1)]
            # padding -> TP-1 (top bin, zeroed out of the dense counts)
            return jnp.where(pos < total[:, None], hits, TP - 1)

        def stage_hist(hits):
            # per-target counts without a (B, cap) sort: radix
            # one-hot matmul histogram, t = hi*128 + lo, so
            # counts(B, hi, lo) accumulates as
            # sum_c onehot_hi(c) (x) onehot_lo(c) — a batched int8
            # matmul (int32 accumulation, exact) per CH-slice of the
            # hit stream.
            B = hits.shape[0]

            def body(i, acc):
                sl = jax.lax.dynamic_slice(hits, (0, i * CH), (B, CH))
                hi = (sl >> 7).astype(jnp.int32)
                lo = (sl & 127).astype(jnp.int32)
                oh_hi = (hi[:, :, None] == jnp.arange(
                    hi_bins, dtype=jnp.int32)[None, None, :])
                oh_lo = (lo[:, :, None] == jnp.arange(
                    128, dtype=jnp.int32)[None, None, :])
                contrib = jax.lax.dot_general(
                    oh_hi.astype(jnp.int8), oh_lo.astype(jnp.int8),
                    (((1,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.int32)   # (B, hi, lo)
                return acc + contrib

            counts3 = jax.lax.fori_loop(
                0, cap // CH, body,
                jnp.zeros((B, hi_bins, 128), jnp.int32))
            count = counts3.reshape(B, TP)
            tgrid = jnp.arange(TP, dtype=jnp.int32)[None, :]
            return jnp.where(tgrid < T, count, 0)

        def stage_scan(count):
            # prefix max of count in ascending-target order (exclusive)
            inc = jax.lax.associative_scan(jnp.maximum, count, axis=1)
            return jnp.concatenate(
                [jnp.zeros((count.shape[0], 1), count.dtype),
                 inc[:, :-1]], axis=1)

        def stage_contrib(count, pm):
            # SetTopBump record contributions (elementwise)
            record = count > pm
            nm = (count * bump) // 100
            return jnp.where(record & (nm < pm), nm, 0)

        def stage_kept(count, cm):
            cur_min = jnp.maximum(
                jnp.concatenate([jnp.zeros((count.shape[0], 1),
                                           count.dtype),
                                 cm[:, :-1]], axis=1), 1)
            return jnp.where(count >= cur_min, count, 0)

        def stage_nextv(count, pm):
            # NextValue: prefix max (pm) at the first global max
            maxv = jnp.max(count, axis=1)
            first_max = jnp.argmax(count == maxv[:, None], axis=1)
            nextv = jnp.take_along_axis(pm, first_max[:, None],
                                        axis=1)[:, 0]
            return jnp.where(maxv > 0, nextv, 0)

        def stage_topk(kept):
            B = kept.shape[0]
            tgrid = jnp.arange(TP, dtype=jnp.int32)[None, :]
            # top-K by (count desc, target asc): packed single-key
            # top_k over the dense count row.  The barrier keeps the
            # packing arithmetic out of the top_k comparator network.
            if (wmax + 1) << t_bits < 2 ** 31:
                packed = (kept << t_bits) | (TP - 1 - tgrid)
                packed = jax.lax.optimization_barrier(packed)
                topv, _ = jax.lax.top_k(packed, K)
                nc = topv >> t_bits
                nt = jnp.where(nc > 0,
                               TP - 1 - (topv & (TP - 1)), T)
            else:
                ncs, nts = jax.lax.sort(
                    (-kept, jnp.broadcast_to(tgrid, kept.shape)),
                    dimension=1, num_keys=2)
                nc, nt = -ncs[:, :K], nts[:, :K]
            nt = jnp.where(nc > 0, nt, T)
            return nc, nt

        j_hits = jax.jit(stage_hits)
        j_hist = jax.jit(stage_hist)
        j_scan = jax.jit(stage_scan)
        j_contrib = jax.jit(stage_contrib)
        j_kept = jax.jit(stage_kept)
        j_nextv = jax.jit(stage_nextv)
        j_topk = jax.jit(stage_topk)

        def step(qw, starts, sizes, postings):
            count = j_hist(j_hits(qw, starts, sizes, postings))
            pm = j_scan(count)
            if bump != 0:
                cm = j_scan(j_contrib(count, pm))
                kept = j_kept(count, cm)
            else:
                kept = count
            nextv = j_nextv(count, pm)
            nc, nt = j_topk(kept)
            return nc, nt, nextv

        return step

    def prepare_chunks(self, jbuf: np.ndarray, j_off: np.ndarray):
        """Host half: letters -> per-chunk padded unique-word arrays +
        pow2 geometry buckets."""
        params = self._params
        n_jobs = len(j_off) - 1
        v = self._v
        sizes_np = self._sizes_np
        uw = []
        for j in range(n_jobs):
            uw.append(params.unique_words(jbuf[j_off[j]:j_off[j + 1]]))
        K = self.topk
        # ONE (wmax, cap) bucket across the whole window: each distinct
        # geometry costs a compile
        max_w = max([len(w) for w in uw] + [8])
        wmax = 1 << int(np.ceil(np.log2(max_w)))
        # hard cap on the hit-stream width, so the compile geometry is
        # the same across DBs (one compile per wmax bucket).  Queries
        # whose posting total exceeds the ceiling rank exactly on the
        # host via the `uncertain` re-rank path.
        totals = np.array([int(sizes_np[w].sum()) for w in uw]
                          + [0], np.int64)[:n_jobs]
        over = totals > self.CAP_MAX
        fit = totals[~over] if (~over).any() else np.array([64])
        # cap >= K so the top-K slice is always full-width
        max_hits = max(int(fit.max(initial=64)), 64, K)
        cap = min(1 << int(np.ceil(np.log2(max_hits))), self.CAP_MAX)
        chunks = []
        for lo in range(0, n_jobs, self.chunk_b):
            hi = min(lo + self.chunk_b, n_jobs)
            chunk = uw[lo:hi]
            # tail padded to chunk_b rows (row count is a compile
            # geometry too); padding rows use the empty word -> zero
            # counts, sliced off by the caller
            qw = np.full((self.chunk_b, wmax), v, dtype=np.int32)
            for j, w in enumerate(chunk):
                if not over[lo + j]:
                    qw[j, :len(w)] = w
            chunks.append((lo, hi, qw, wmax, cap))
        return n_jobs, chunks, over

    def run_chunk_device(self, qw: np.ndarray, wmax: int, cap: int):
        """Device half: one jitted dispatch -> (cnts, targets, nextv)."""
        import jax.numpy as jnp
        fn = self._fn(wmax, cap)
        c_d, t_d, n_d = fn(jnp.asarray(qw), self._starts,
                           self._sizes, self._postings)
        return (np.asarray(c_d), np.asarray(t_d), np.asarray(n_d))

    def rank_window(self, jbuf: np.ndarray, j_off: np.ndarray):
        """Same contract as MeshRanker.rank_window: (cand, cnts, out_n,
        uncertain).  Queries run in chunks of chunk_b so the (B, cap)
        hit stream stays within a bounded HBM footprint."""
        n_jobs, chunks, over = self.prepare_chunks(jbuf, j_off)
        K = self.topk
        cnts = np.zeros((n_jobs, K), dtype=np.int32)
        cand = np.full((n_jobs, K), self.t, dtype=np.int64)
        nextv = np.zeros(n_jobs, dtype=np.int32)
        for lo, hi, qw, wmax, cap in chunks:
            c_n, t_n, n_n = self.run_chunk_device(qw, wmax, cap)
            cnts[lo:hi] = c_n[:hi - lo]
            cand[lo:hi] = t_n[:hi - lo].astype(np.int64)
            nextv[lo:hi] = n_n[:hi - lo]
        out = self._finish(n_jobs, cand, cnts, nextv)
        if over.any():
            out[3][over] = True   # over-cap queries: exact host re-rank
        return out

    def _finish(self, n_jobs, cand, cnts, nextv):
        valid = (cnts > 0) & (cand < self.t)
        first_bad = np.where(valid.all(axis=1), cnts.shape[1],
                             np.argmin(valid, axis=1))
        out_n = first_bad.astype(np.int32)
        minv = np.maximum(nextv // 2, 1)
        keep = valid & (cnts >= minv[:, None])
        out_n = np.minimum(out_n, keep.sum(axis=1)).astype(np.int32)
        from ..search.terminator import Terminator
        term = Terminator("usearch_global")
        bound = term.max_accepts + term.max_rejects
        uncertain = (out_n >= self.topk) & (bound > self.topk)
        return cand, cnts.astype(np.uint32), out_n, uncertain


def make_engine_override(ranker, eng):
    """rank_override for BatchEngine.search_window: device CSR ranking
    with an exact host re-rank for capacity-uncertain queries (counted
    in dev_stats rank_host_jobs)."""
    eng.dev_stats.setdefault("rank_host_jobs", 0)

    def override(jbuf, j_off):
        cand, cnts, out_n, unc = ranker.rank_window(jbuf, j_off)
        eng.dev_stats["rank_host_jobs"] += int(unc.sum())
        if unc.any():
            h_cand, h_cnts, h_out_n = eng._rank_jobs(jbuf, j_off)
            for j in np.nonzero(unc)[0]:
                k = min(int(h_out_n[j]), cand.shape[1])
                cand[j, :k] = h_cand[j, :k]
                cnts[j, :k] = h_cnts[j, :k]
                out_n[j] = k
        return (np.ascontiguousarray(cand.astype(np.uint32)),
                np.ascontiguousarray(cnts), out_n)
    return override
