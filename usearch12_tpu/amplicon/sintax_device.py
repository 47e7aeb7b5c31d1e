"""Device SINTAX bootstraps: the 100-boot word-sample scatter-add as one
batched int8 matmul per query window, with the reference's RNG replay
exact (src/sintaxsearcher.cpp:77-122, 151-187).

Key structural facts that make the device formulation exact AND cheap:

1. The per-query boot LCG (m_r) is re-seeded from -randseed for EVERY
   query (Classify, sintaxsearcher.cpp:146), so the raw 32-bit draw
   stream is IDENTICAL across queries — only the `% nuw` fold differs.
   One (boots*m,) uint32 stream uploads once; `stream % nuw` runs on
   device per query.

2. Boot counting factorizes: U_boot = P @ M_q where P (boots, nuw) is
   the per-boot pick histogram (how many times each unique query word
   was sampled) and M_q (nuw, T) gathers the word-incidence rows of the
   query's unique words.  That is one (boots x nuw) @ (nuw x T) int8
   matmul per query-strand with int32 accumulation (exact) — batched
   over the window it runs on the tensor cores, replacing the host's
   B x m x postings scatter + B x T argmax scan (the part that scales
   with DB size).

3. The reference's random tie-break consumes exactly `boots` global-RNG
   draws per classified strand, in query order (randu32 % M over the
   ascending-index tie list).  The draws are data-independent, so the
   host pre-generates them in order (advancing the shared GlobalRand
   state exactly as the host path would) and the device selects the
   (r % M)-th tie by cumsum+argmax — bit-identical winners.

Outputs match SintaxClassifier.classify_window tuple-for-tuple; the
driver's tally/strand-vote/output code is reused unchanged, so
-tabbedout bytes equal the host path (asserted in
tests/test_sintax_device.py and the bench A/B).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import options
from .sintax import SintaxClassifier, _next_rand

M32 = 0xFFFFFFFF


class BootEngine:
    """Device-resident SINTAX boot state: the (V, T) word-incidence
    matrix plus the compiled per-chunk boot matmul fns.  The incidence
    is built on the device from the CSR postings (sizes + postings,
    ~nnz*4 bytes) by a scatter-add, instead of uploading the dense int8
    matrix (1.3 GB for a 20k x 8-mer DB against ~19 MB of CSR)."""

    def __init__(self, v: int, t: int, sizes: np.ndarray,
                 postings: np.ndarray, boots: int) -> None:
        import jax
        import jax.numpy as jnp
        self.t = t
        self.B = boots
        nnz = int(sizes.sum())
        if t and nnz:
            def build(sizes_d, posts_d):
                words = jnp.repeat(
                    jnp.arange(v, dtype=jnp.int32), sizes_d,
                    total_repeat_length=nnz)
                mat = jnp.zeros((v, t), jnp.int8)
                return mat.at[words, posts_d].add(jnp.int8(1))

            self._w = jax.jit(build)(
                jnp.asarray(sizes.astype(np.int32)),
                jnp.asarray(postings.astype(np.int32)))
        else:
            self._w = jax.device_put(jnp.zeros((v, max(t, 1)), jnp.int8))
        self._fns = {}

    def fn(self, cq: int, uwmax: int, mmax: int, int8_ok: bool):
        key = (cq, uwmax, mmax, int8_ok)
        f = self._fns.get(key)
        if f is None:
            f = self._build(cq, uwmax, mmax, int8_ok)
            self._fns[key] = f
        return f

    def run_chunk(self, words, nuw, m, stream, rr):
        """(cq, uwmax) words -> (winners, tops) numpy, one jit call.
        The stream length defines the (pow2-bucketed) mmax geometry;
        the int8 path is keyed on the TRUE per-chunk max m (a bucket
        boundary must not force the int32 fallback)."""
        import jax.numpy as jnp
        int8_ok = int(np.asarray(m).max(initial=0)) <= 127
        f = self.fn(words.shape[0], words.shape[1],
                    int(stream.shape[0] // self.B), int8_ok)
        w_d, t_d = f(jnp.asarray(words), jnp.asarray(nuw),
                     jnp.asarray(m), jnp.asarray(stream),
                     jnp.asarray(rr.astype(np.int32)), self._w)
        return np.asarray(w_d), np.asarray(t_d)

    def _build(self, cq: int, uwmax: int, mmax: int, int8_ok: bool):
        import jax
        import jax.numpy as jnp

        B = self.B
        T = self.t

        def step(words, nuw, m_arr, stream, rr, w_mat):
            # words (cq, uwmax) i32 (pad = any valid slot, masked by nuw)
            # nuw (cq,) i32; m_arr (cq,) i32 picks per boot
            # stream (B*mmax,) u32 raw LCG draws
            # rr (cq, B) i32 tie-break draws (already % folded? no: raw)
            # picks: draw k of boot b is stream[b*m + k] — m varies per
            # query, so index by per-query (b, k) grid
            b_idx = jnp.arange(B, dtype=jnp.int32)[:, None]
            k_idx = jnp.arange(mmax, dtype=jnp.int32)[None, :]
            draw_pos = (b_idx * m_arr[:, None, None]
                        + k_idx[None, :, :])              # (cq, B, mmax)
            draw_pos = jnp.clip(draw_pos, 0, B * mmax - 1)
            draws = stream[draw_pos]                      # (cq, B, mmax) u32
            live = k_idx[None, :, :] < m_arr[:, None, None]
            pick = (draws % jnp.maximum(
                nuw[:, None, None].astype(jnp.uint32), 1)).astype(jnp.int32)
            # per-boot pick histogram over unique-word slots
            P = jnp.zeros((cq, B, uwmax), jnp.int32)
            n_i = jnp.broadcast_to(
                jnp.arange(cq, dtype=jnp.int32)[:, None, None],
                pick.shape)
            b_i = jnp.broadcast_to(b_idx[None, :, :], pick.shape)
            P = P.at[n_i, b_i, jnp.where(live, pick, 0)].add(
                jnp.where(live, 1, 0))
            # per-query incidence rows for its unique words
            mq = w_mat[jnp.clip(words, 0, w_mat.shape[0] - 1)]  # (cq,uwmax,T)
            wmask = (jnp.arange(uwmax, dtype=jnp.int32)[None, :]
                     < nuw[:, None])
            mq = jnp.where(wmask[:, :, None], mq, 0)
            # int8 P feeds the int8 matmul path; but one word can be
            # sampled up to m times per boot, so a large -boot_subset
            # (m > 127) would wrap int8 — fall back to int32 operands
            # for such windows (rare; still a matmul, just not int8)
            p_dt = jnp.int8 if int8_ok else jnp.int32
            U = jax.lax.dot_general(
                P.astype(p_dt), mq.astype(p_dt),
                (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.int32)          # (cq, B, T)
            top = jnp.max(U, axis=2)                       # (cq, B)
            is_tie = (U == top[:, :, None]).astype(jnp.int32)
            m_ties = jnp.sum(is_tie, axis=2)               # (cq, B)
            rsel = (rr.astype(jnp.uint32)
                    % jnp.maximum(m_ties, 1).astype(jnp.uint32)) \
                .astype(jnp.int32)
            cum = jnp.cumsum(is_tie, axis=2)
            winner = jnp.argmax(cum == (rsel + 1)[:, :, None],
                                axis=2).astype(jnp.int32)
            return winner, top

        return jax.jit(step)


class SintaxDeviceClassifier:
    """Drop-in classify_window provider running boots on the device
    (an in-process BootEngine)."""

    # dense incidence memory gate: V * T int8
    MAX_INCIDENCE_BYTES = 6 << 30

    def __init__(self, cls: SintaxClassifier, chunk_q: int = 128) -> None:
        self.cls = cls
        self.index = cls.index
        self.chunk_q = chunk_q
        index = self.index
        index._flatten()
        self._v = index.params.slot_count
        self.t = index.seq_count
        self._engine = BootEngine(self._v, self.t, np.asarray(index.sizes),
                                  np.asarray(index.postings),
                                  int(cls.boots))
        self._stream = None
        self._stream_len = 0

    @classmethod
    def usable(cls, sc: SintaxClassifier) -> bool:
        o = options()
        index = sc.index
        if o.flag("self") or index.params.hashed:
            return False
        index._flatten()
        if index._postings is None:
            return False
        v = index.params.slot_count
        return v * max(index.seq_count, 1) <= cls.MAX_INCIDENCE_BYTES

    def _lcg_stream(self, n: int) -> np.ndarray:
        """First n draws of the per-query boot LCG (seeded at -randseed;
        identical for every query)."""
        if self._stream is None or self._stream_len < n:
            r = self.cls.randseed
            out = np.empty(n, dtype=np.uint32)
            for k in range(n):
                r = _next_rand(r)
                out[k] = r
            self._stream = out
            self._stream_len = n
        return self._stream[:n]

    def classify_window(self, seqs: List[np.ndarray], both: bool):
        """Same contract as SintaxClassifier.classify_window; None is
        never returned (caller checked usable())."""
        from ..alpha import revcomp
        cls = self.cls
        params = self.index.params
        B = cls.boots
        n = len(seqs)
        if n == 0:
            return []

        # per (query, strand): unique words + per-boot sample size m
        jobs = []     # (qi, strand_idx, uw, m)
        per_q = []    # [(fwd_job_ix or None, rev_job_ix or None)]
        for qi, s in enumerate(seqs):
            ixs = []
            for si, qs in enumerate((s, revcomp(s)) if both else (s,)):
                uw = params.unique_words(qs)
                nuw = len(uw)
                if nuw < 8:
                    ixs.append(None)
                    continue
                m = (nuw // cls.boot_subset if cls.boot_subset_divide
                     else cls.boot_subset)
                jobs.append((qi, si, uw, m))
                ixs.append(len(jobs) - 1)
            per_q.append(ixs + [None] * (2 - len(ixs)))

        nj = len(jobs)
        winners = np.zeros((nj, B), np.int32)
        tops = np.zeros((nj, B), np.int32)
        if nj:
            m_all = np.array([j[3] for j in jobs], np.int32)
            # pow2-bucket the stream length so per-window jitter in
            # max(m) does not mint fresh compile geometries
            mmax = 8
            while mmax < int(m_all.max()):
                mmax *= 2
            stream = self._lcg_stream(B * mmax).astype(np.uint32)
            # tie-break draws: B per job, consumed in job order — the
            # exact order the host per-strand classify would use
            rr = np.empty((nj, B), np.uint32)
            for ji in range(nj):
                if jobs[ji][3] <= 0:
                    # m == 0: SetUShuffle adds nothing; U all zero —
                    # the boot loop still draws a tie-break per boot
                    pass
                for b in range(B):
                    rr[ji, b] = cls.grand.randu32()
            uwmax_n = max(int(max(len(j[2]) for j in jobs)), 8)
            uwmax = 1 << int(np.ceil(np.log2(uwmax_n)))
            cq = self.chunk_q
            for lo in range(0, nj, cq):
                hi = min(lo + cq, nj)
                c = hi - lo
                words = np.zeros((cq, uwmax), np.int32)
                nuw_a = np.ones(cq, np.int32)
                m_a = np.ones(cq, np.int32)
                rr_a = np.zeros((cq, B), np.uint32)
                for k in range(c):
                    uw = jobs[lo + k][2]
                    words[k, :len(uw)] = uw
                    nuw_a[k] = len(uw)
                    m_a[k] = jobs[lo + k][3]
                    rr_a[k] = rr[lo + k]
                w_np, t_np = self._engine.run_chunk(words, nuw_a, m_a,
                                                    stream, rr_a)
                winners[lo:hi] = w_np[:c]
                tops[lo:hi] = t_np[:c]

        # host tally + strand vote (identical to the numpy fallback in
        # SintaxClassifier.classify / the driver's vote)
        from ..search.hitmgr import quick_sort_order
        res = []
        for qi in range(n):
            fwd_ix, rev_ix = per_q[qi][0], per_q[qi][1]

            def strand_result(ji):
                if ji is None:
                    return [], [], 0
                w = winners[ji]
                twc = int(tops[ji].max()) if B else 0
                uti, ucnt = np.unique(cls._tax_id[w], return_counts=True)
                order = quick_sort_order(ucnt.tolist(), desc=True)
                ids = [int(uti[i]) for i in order]
                counts = [int(ucnt[i]) for i in order]
                return ids, counts, twc

            ids_f, cnt_f, twc_f = strand_result(fwd_ix)
            if both:
                ids_r, cnt_r, twc_r = strand_result(rev_ix)
            else:
                ids_r, cnt_r, twc_r = [], [], 0
            if twc_f >= twc_r:
                c_strand, ids, counts = "+", ids_f, cnt_f
            else:
                c_strand, ids, counts = "-", ids_r, cnt_r
            last_twc = twc_r if both else twc_f
            res.append((c_strand, ids, counts, int(last_twc)))
        return res
