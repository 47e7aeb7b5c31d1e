"""Sharded search step: the multi-device formulation of USORT search.

Layout (scaling-book style):
  mesh axes: "data" (query batch) x "db" (target shard)
  - query word one-hots Q: (B, V) sharded over B on "data"
  - UDB word->target incidence W: (V, T) 0/1, sharded over T on "db"
    (the dense-matmul formulation of SetU: U = Q @ W counts shared unique
    words, int8 operands with int32 accumulation, so exact; postings-CSR
    counting replaces this for very large V*T)
  - U: (B, T) sharded (data, db); per-shard top-k then all_gather over
    "db" and a deterministic merge (count desc, global target index asc —
    the reference's stable count-sort order)
  - the top candidate pair is aligned with the banded NW recurrence
    (a jnp row-frame formulation; the batch engine's device DP is
    ops/wavefront_nw.py)

This module is exercised by __graft_entry__.dryrun_multichip on a virtual
device mesh and provides the single-chip jittable entry() step.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def build_incidence(index, dtype=None):
    """Dense (V, T) 0/1 word->target incidence from the CSR index."""
    import jax.numpy as jnp
    v = index.params.slot_count
    t = index.seq_count
    mat = np.zeros((v, t), dtype=np.float32)
    starts = index.starts
    sizes = index.sizes
    postings = index.postings
    words = np.repeat(np.arange(v), sizes)
    mat[words, postings] = 1.0
    return mat


def query_onehot(index, seqs, amax: int):
    """(B, V) float32 one-hot of each query's unique words."""
    v = index.params.slot_count
    out = np.zeros((len(seqs), v), dtype=np.float32)
    for b, s in enumerate(seqs):
        out[b, index.params.unique_words(s)] = 1.0
    return out


def banded_nw_score_jnp(a_cls, bs_cls, la, lb, dlo, bw, gp, amax: int):
    """Score-only banded NW in plain jnp (same rotating-frame math as the
    Pallas kernel; works on any backend under jit/shard_map).
    a_cls (B, amax) int32 letters; bs_cls (B, amax+128) pre-shifted."""
    import jax
    import jax.numpy as jnp

    LANES = 128
    NEG = jnp.float32(-9e9)
    B = a_cls.shape[0]
    lane = jnp.arange(LANES, dtype=jnp.int32)[None, :]
    la_b = la[:, None]
    lb_b = lb[:, None]
    dlo_b = dlo[:, None]
    bw_b = bw[:, None]
    u = dlo_b - la_b
    klb = la_b + lb_b - dlo_b
    lb_lane = jnp.equal(lane, klb % LANES)
    neg = jnp.full((B, LANES), NEG, jnp.float32)

    (g_open_a, g_open_b, g_ext_a, g_ext_b, g_l_open_a, g_l_open_b,
     g_r_open_a, g_r_open_b, g_l_ext_a, g_l_ext_b, g_r_ext_a,
     g_r_ext_b) = [gp[i] for i in range(12)]

    def iscan(c, ext, kvec):
        x = jnp.roll(c, 1, 1)
        x = jnp.where(kvec < 1, NEG, x)
        s = 1
        while s < LANES:
            y = jnp.roll(x, s, 1)
            y = jnp.where(kvec < s, NEG, y + jnp.float32(s) * ext)
            x = jnp.maximum(x, y)
            s *= 2
        return x

    def row_body(i, carry):
        m_in, d_in, d_lb, m_last = carry
        r = i % LANES
        active = i < la_b
        rk = (lane - r) % LANES
        j = u + (rk + i)
        valid = (j >= 0) & (j < lb_b) & (rk < bw_b) & active
        aw = jax.lax.dynamic_slice_in_dim(a_cls, 0, a_cls.shape[1], 1)
        aw = jnp.take_along_axis(a_cls, jnp.full((B, 1), i), axis=1)
        base = (i // LANES) * LANES
        win = jax.lax.dynamic_slice_in_dim(bs_cls, base, 2 * LANES, 1)
        bw_win = jnp.where(lane >= r, win[:, :LANES],
                           win[:, LANES:2 * LANES])
        sub = jnp.where((aw < 4) & (bw_win < 4),
                        jnp.where(aw == bw_win, jnp.float32(1.0),
                                  jnp.float32(-2.0)),
                        jnp.float32(0.0))
        open_a = jnp.where(i == 0, g_l_open_a, g_open_a)
        ext_a = jnp.where(i == 0, g_l_ext_a, g_ext_a)
        open_b = jnp.where(j == 0, g_l_open_b, g_open_b)
        ext_b = jnp.where(j == 0, g_l_ext_b, g_ext_b)
        c = m_in + open_a
        i_before = iscan(c, ext_a, rk)
        xm = jnp.maximum(jnp.maximum(m_in, d_in), i_before)
        m_out = jnp.where(valid, xm + sub, neg)
        d_out = jnp.where(valid, jnp.maximum(m_in + open_b, d_in + ext_b),
                          neg)
        m_end = jnp.where(klb - i < LANES, m_in, neg)
        d_lb_new = jnp.where(lb_lane & active,
                             jnp.maximum(m_end + g_r_open_b,
                                         d_lb + g_r_ext_b), d_lb)
        is_last = i == (la_b - 1)
        m_last = jnp.where(is_last, m_out, m_last)
        m_next = jnp.where(active, jnp.roll(m_out, 1, 1), m_in)
        d_next = jnp.where(active, d_out, d_in)
        return m_next, d_next, d_lb_new, m_last

    import jax
    j0 = u + lane
    m0 = jnp.where(j0 == 0, jnp.float32(0), neg)
    m0, d, d_lb, m_last_rot = jax.lax.fori_loop(
        0, amax, row_body, (m0, neg, neg, neg))

    kk = jnp.arange(LANES, dtype=jnp.int32)[None, :]
    rot = (kk + (la[:, None] - 1)) % LANES
    m_last = jnp.take_along_axis(m_last_rot, rot, axis=1)
    fin_d = jnp.take_along_axis(d_lb, (klb % LANES)[:, 0:1], axis=1)[:, 0]
    # final DPI row
    c2 = m_last + g_r_open_a
    mi = jnp.concatenate([jnp.full((B, 1), NEG), c2[:, :-1]], axis=1)
    x = mi
    s = 1
    while s < LANES:
        y = jnp.concatenate(
            [jnp.full((B, s), NEG), x[:, :-s] + jnp.float32(s) * g_r_ext_a],
            axis=1)
        x = jnp.maximum(x, y)
        s *= 2
    k_last = (lb - dlo)[:, None]
    fin_i = jnp.take_along_axis(x, k_last, axis=1)[:, 0]
    fin_m = jnp.take_along_axis(m_last, k_last, axis=1)[:, 0]
    return jnp.maximum(jnp.maximum(fin_m, fin_d), fin_i)


def make_search_step(amax: int = 256):
    """Single-device jittable search step: word-count (int8 matmul) +
    top-1 candidate + banded NW score of query vs its top target."""
    import jax
    import jax.numpy as jnp

    def step(q_onehot, db_mat, a_cls, db_cls, db_len, gp):
        u = jnp.dot(q_onehot.astype(jnp.int8), db_mat.astype(jnp.int8),
                    preferred_element_type=jnp.int32)
        # deterministic top-1: max count, lowest index on ties
        top = jnp.argmax(u, axis=1).astype(jnp.int32)
        # align each query to its top target (main-diagonal band)
        b_cls = db_cls[top]
        lb = db_len[top]
        la = jnp.sum((a_cls < 4).astype(jnp.int32), axis=1)  # padded with 4
        lo = jnp.minimum(la, lb)
        hi = jnp.maximum(la, lb)
        dlo = jnp.maximum(lo - 16, 1)
        dhi = jnp.minimum(hi + 16, la + lb - 1)
        bw = dhi - dlo + 1
        # pre-shift B on device: bs[m] = b[m - (la - dlo)]
        off = (la - dlo)[:, None]
        m = jnp.arange(a_cls.shape[1] + 128, dtype=jnp.int32)[None, :]
        src = m - off
        src_c = jnp.clip(src, 0, b_cls.shape[1] - 1)
        bs = jnp.take_along_axis(b_cls, src_c, axis=1)
        bs = jnp.where((src >= 0) & (src < lb[:, None]), bs, 4)
        scores = banded_nw_score_jnp(a_cls, bs, la, lb, dlo, bw, gp,
                                     amax=a_cls.shape[1])
        return u.max(axis=1), top, scores

    return step


def make_sharded_search_step(mesh, amax: int = 256):
    """Multi-chip: queries sharded over "data", targets over "db".
    Per-shard top-k merges with deterministic tie-breaking (count desc,
    global target index asc) via all_gather over "db"."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from usearch12_tpu.parallel.shardmap import shard_map_norep

    n_db = mesh.shape["db"]

    def local_step(q_onehot, db_mat, a_cls, db_cls, db_len, gp):
        # per-shard counting (B_local, T_shard)
        u = jnp.dot(q_onehot.astype(jnp.int8), db_mat.astype(jnp.int8),
                    preferred_element_type=jnp.int32)
        t_shard = u.shape[1]
        shard_id = jax.lax.axis_index("db")
        local_top = jnp.argmax(u, axis=1).astype(jnp.int32)
        local_cnt = jnp.max(u, axis=1)
        # merge across db shards: max count, tie -> lowest global index
        gcnt = jax.lax.all_gather(local_cnt, "db")      # (n_db, B)
        gtop = jax.lax.all_gather(local_top + shard_id * t_shard, "db")
        order_key = (gcnt.astype(jnp.float32) * jnp.float32(1e9)
                     - gtop.astype(jnp.float32))
        win = jnp.argmax(order_key, axis=0)             # (B,)
        top = jnp.take_along_axis(gtop, win[None, :], axis=0)[0]
        cnt = jnp.take_along_axis(gcnt, win[None, :], axis=0)[0]
        # gather the winning target rows from the local shard, zero if not
        # ours, then psum over "db" to materialize them data-parallel
        local_ix = top - shard_id * t_shard
        mine = (local_ix >= 0) & (local_ix < t_shard)
        ix_c = jnp.clip(local_ix, 0, t_shard - 1)
        b_cls = jnp.where(mine[:, None], db_cls[ix_c], 0)
        b_len = jnp.where(mine, db_len[ix_c], 0)
        b_cls = jax.lax.psum(b_cls, "db")
        b_len = jax.lax.psum(b_len, "db")

        la = jnp.sum((a_cls < 4).astype(jnp.int32), axis=1)
        lb = b_len
        lo = jnp.minimum(la, lb)
        hi = jnp.maximum(la, lb)
        dlo = jnp.maximum(lo - 16, 1)
        dhi = jnp.minimum(hi + 16, la + lb - 1)
        bw = dhi - dlo + 1
        off = (la - dlo)[:, None]
        m = jnp.arange(a_cls.shape[1] + 128, dtype=jnp.int32)[None, :]
        src = m - off
        src_c = jnp.clip(src, 0, b_cls.shape[1] - 1)
        bs = jnp.take_along_axis(b_cls, src_c, axis=1)
        bs = jnp.where((src >= 0) & (src < lb[:, None]), bs, 4)
        scores = banded_nw_score_jnp(a_cls, bs, la, lb, dlo, bw, gp,
                                     amax=a_cls.shape[1])
        return cnt, top, scores

    step = shard_map_norep(
        local_step, mesh=mesh,
        in_specs=(P("data", None), P(None, "db"), P("data", None),
                  P("db", None), P("db"), P(None)),
        out_specs=(P("data"), P("data"), P("data")))
    return step


def sintax_boot_counts(incidence, words, mesh=None):
    """Device SINTAX boot counting: U[q, boot, t] = sum over the boot's
    sampled words of incidence[word, t] (the scatter-add in
    src/sintaxsearcher.cpp SetUShuffle as dense gathers).

    incidence: (V, T) float32; words: (Q, BOOTS, M) int32 sampled word ids
    (host LCG, sequential for parity).  With a mesh, targets shard over
    its "db" axis and each chip counts its target block (no cross-chip
    traffic; the host concatenates per-shard results).  Returns
    (Q, BOOTS, T) int32 counts.
    """
    import jax
    import jax.numpy as jnp

    def count(inc, w):
        q, boots, m = w.shape

        def body(acc, k):
            acc = acc + jnp.take(inc, w[:, :, k], axis=0)
            return acc, None

        init = jnp.zeros((q, boots, inc.shape[1]), jnp.float32)
        acc, _ = jax.lax.scan(body, init, jnp.arange(m))
        return acc.astype(jnp.int32)

    if mesh is None:
        return np.asarray(jax.jit(count)(jnp.asarray(incidence),
                                         jnp.asarray(words)))
    from jax.sharding import PartitionSpec as P
    from usearch12_tpu.parallel.shardmap import shard_map_norep
    axis = "db" if "db" in mesh.axis_names else mesh.axis_names[-1]
    n_db = mesh.shape[axis]
    t = incidence.shape[1]
    pad = (-t) % n_db
    inc = np.pad(incidence, ((0, 0), (0, pad)))
    specs = {a: None for a in mesh.axis_names}
    fn = shard_map_norep(count, mesh=mesh,
                         in_specs=(P(None, axis), P()),
                         out_specs=P(None, None, axis))
    with mesh:
        out = np.asarray(jax.jit(fn)(jnp.asarray(inc), jnp.asarray(words)))
    return out[:, :, :t]
