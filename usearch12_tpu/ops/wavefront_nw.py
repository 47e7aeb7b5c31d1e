"""Batched banded affine-gap global NW on the device, by anti-diagonals.

Cell semantics are those of align/oracle.py and the host kernel nw_band
(native/usearch_native.c), after the reference's
src/viterbifastbandmem.cpp: the recurrence, the tie-breaks, the band-edge
quirks and the 4-bit traceback layout are the same, and every float32 op
sees the same operands in the same order, so scores and paths are
bit-exact for any gap penalties.

The DP runs over anti-diagonals t = i + j, vectorised over pairs.  On step
t, lane u of a pair holds the cell on diagonal D* = la - i + j =
dlo + rho + 2u, with rho = (la - dlo + t) % 2, i.e.

    i = I0(t) - u,  j = J0(t) + u,  I0(t) = (la + t - dlo - rho) / 2,
    J0(t) = t - I0(t).

Between steps the lanes shift: on rho = 1 steps D(i-1, j) sits one lane up
(u + 1) and I(i, j-1) in the same lane; on rho = 0 steps D(i-1, j) is in
the same lane and I(i, j-1) one lane down.  M(i-1, j-1), from two steps
back, is always in the same lane.  A band of width bw needs
W = (bw - 1) // 2 + 2 lanes: the last one carries the right-terminal
column Drow[LB] (the cell (i, lb)), whose D value rides in the D array.

Besides the band cells, each step carries per-pair scalars: the final
DPI row (i = la) of the reference, whose column j needs M(la-1, j-1) from
the step before, and the final M and D values.  So the forward pass ends
with the score and the start state of the traceback, and no scan over the
last row is needed.

Traceback bits are packed 8 steps per int32 word: tb[w, u, p] holds the
nibbles of steps 8w .. 8w+7 of lane u of pair p; lane W holds the final
DPI row's TB_MI bit for column j at step t = la - 1 + j.  The traceback
is a pointer chase over that tensor, one gather per step over all pairs
(_make_traceback); trace_host is the same chase in plain Python.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np

from ..alpha import CHAR_TO_LETTER_NUCLEO
from ..align.oracle import band_diag_range

NEG = np.float32(-9e9)
TB_DM, TB_IM, TB_MD, TB_MI = 1, 2, 4, 8
OP_M, OP_D, OP_I, OP_PAD = 0, 1, 2, 3

# widest pair frame the device takes: lanes = (bw - 1) // 2 + 2, so bands
# up to bw = 510; wider holes run on the host kernel
MAX_LANES = 256
# traceback tensor budget of one launch; larger batches are chunked
LAUNCH_TB_BYTES = 1 << 30
MAX_LAUNCH_PAIRS = 1 << 16


def letters(seq: np.ndarray) -> np.ndarray:
    """Nucleotide letter classes: A, C, G, T = 0..3, anything else 4."""
    return np.minimum(CHAR_TO_LETTER_NUCLEO[seq], 4).astype(np.int8)


def lanes_for_band(bw):
    """Lanes of the pair frame: (bw - 1) // 2 + 1 band cells per step
    plus the Drow[LB] lane."""
    return (bw - 1) // 2 + 2


def bucket(x: int, lo: int) -> int:
    """Smallest m * 2**k >= x with m in 4..7 (four buckets per octave),
    at least lo: launch shapes repeat, and padding wastes < 25%."""
    x = max(int(x), lo)
    k = max(0, x.bit_length() - 3)
    m = -(-x >> k)
    return m << k


def _terminal(ap, cls: np.ndarray) -> np.ndarray:
    """(8, P) per-pair terminal penalties for hole classes cls (bit 0:
    left a, 1: left b, 2: right a, 3: right b; AlnParams.hole_params).
    Rows: l_open_a, l_ext_a, l_open_b, l_ext_b, r_open_a, r_ext_a,
    r_open_b, r_ext_b."""
    rows = ((1, ap.l_open_a, ap.open_a), (1, ap.l_ext_a, ap.ext_a),
            (2, ap.l_open_b, ap.open_b), (2, ap.l_ext_b, ap.ext_b),
            (4, ap.r_open_a, ap.open_a), (4, ap.r_ext_a, ap.ext_a),
            (8, ap.r_open_b, ap.open_b), (8, ap.r_ext_b, ap.ext_b))
    out = np.empty((8, len(cls)), np.float32)
    for r, (bit, term, inner) in enumerate(rows):
        out[r] = np.where(cls & bit, np.float32(term), np.float32(inner))
    return out


def _scalars(ap) -> np.ndarray:
    match = float(ap.subst_mx[ord("A"), ord("A")])
    mismatch = float(ap.subst_mx[ord("A"), ord("C")])
    return np.array([ap.open_a, ap.ext_a, ap.open_b, ap.ext_b, match,
                     mismatch], np.float32)


# ---------------------------------------------------------------------------
# forward pass

def _make_forward(n_words: int, W: int):
    """Un-jitted forward pass for one launch shape.

    run(a, b, geo, term, scal, n_run) with a/b (P, L) int8 letter
    classes (pad 4), geo (4, P) int32 rows la, lb, dlo, bw, term (8, P)
    and scal (6,) f32 (see _terminal, _scalars), and n_run the number of
    8-step words to run (dynamic; <= n_words).  Returns tb
    (n_words, W + 1, P) int32 and fin (3, P) f32: final M, D and DPI."""
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    i32 = jnp.int32

    def run(a, b, geo, term, scal, n_run):
        P, L = a.shape
        a_t, b_t = a.T, b.T
        la, lb, dlo, bw = geo[0], geo[1], geo[2], geo[3]
        (l_open_a, l_ext_a, l_open_b, l_ext_b,
         r_open_a, r_ext_a, r_open_b, r_ext_b) = (term[k] for k in range(8))
        open_a_s, ext_a_s, open_b_s, ext_b_s, match, mismatch = (
            scal[k] for k in range(6))
        r0 = (la - dlo) & 1
        sj = jnp.clip(dlo - 1, 0, lb - 1)      # startj of row la-1
        u = jax.lax.broadcasted_iota(i32, (W, 1), 0)
        neg_row = jnp.full((1, P), NEG, f32)
        neg_p = jnp.full((P,), NEG, f32)

        def step(t, k, carry):
            m1, m2, d, ist, ml, i1, fin_m, fin_d, acc = carry
            rho = (r0 + t) & 1
            I0 = (la + t - dlo - rho) >> 1
            ii = I0[None, :] - u
            jj = (t - I0)[None, :] + u
            umax = (bw - 1 - rho) >> 1
            valid = ((ii >= 0) & (ii < la[None, :]) & (jj >= 0)
                     & (jj < lb[None, :]) & (u <= umax[None, :]))
            odd = (rho == 1)[None, :]
            d_in = jnp.where(odd, jnp.concatenate([d[1:], neg_row], 0), d)
            i_in = jnp.where(odd, ist,
                             jnp.concatenate([neg_row, ist[:-1]], 0))
            m_in = jnp.where((ii == 0) & (jj == 0), f32(0), m2)
            av = jnp.take_along_axis(a_t, jnp.clip(ii, 0, L - 1), axis=0)
            bv = jnp.take_along_axis(b_t, jnp.clip(jj, 0, L - 1), axis=0)
            sub = jnp.where((av < 4) & (bv < 4),
                            jnp.where(av == bv, match, mismatch), f32(0))
            row0 = ii == 0
            col0 = jj == 0
            open_a = jnp.where(row0, l_open_a[None, :], open_a_s)
            ext_a = jnp.where(row0, l_ext_a[None, :], ext_a_s)
            open_b = jnp.where(col0, l_open_b[None, :], open_b_s)
            ext_b = jnp.where(col0, l_ext_b[None, :], ext_b_s)

            # MATCH: priority M over D over I
            take_d = d_in > m_in
            xm = jnp.where(take_d, d_in, m_in)
            take_i = i_in > xm
            xm = jnp.where(take_i, i_in, xm)
            m_out = jnp.where(valid, xm + sub, NEG)
            # DELETE and INSERT: >= favours the open
            md = m_in + open_b
            de = d_in + ext_b
            take_open = md >= de
            mi = m_in + open_a
            ie = i_in + ext_a
            take_iopen = mi >= ie
            i_out = jnp.where(valid, jnp.where(take_iopen, mi, ie), NEG)
            # right-terminal column Drow[LB]: cell (i, lb), every row
            upd = (jj == lb[None, :]) & (ii >= 0) & (ii < la[None, :])
            md_lb = m_in + r_open_b[None, :]
            de_lb = d_in + r_ext_b[None, :]
            take_lb = md_lb >= de_lb
            d_out = jnp.where(
                valid, jnp.where(take_open, md, de),
                jnp.where(upd, jnp.where(take_lb, md_lb, de_lb), NEG))
            bits = jnp.where(take_i, TB_IM, jnp.where(take_d, TB_DM, 0))
            bits = (bits | jnp.where(take_open, TB_MD, 0)
                    | jnp.where(take_iopen, TB_MI, 0))
            bits = jnp.where(valid, bits,
                             jnp.where(upd & take_lb, TB_MD, 0))

            # final DPI row, column jl: needs M(la-1, jl-1) (ml, from
            # the step before); M(la-1, startj-1) counts as NEG
            jl = t - (la - 1)
            in_rng = (jl >= sj) & (jl < lb)
            mi_l = jnp.where(jl > sj, ml, NEG) + r_open_a
            i1e = i1 + r_ext_a
            take_l = mi_l > i1e
            i1 = jnp.where(in_rng, jnp.where(take_l, mi_l, i1e), i1)
            fbit = jnp.where(in_rng & take_l, TB_MI, 0)
            last = valid & (ii == (la - 1)[None, :])
            ml = jnp.max(jnp.where(last, m_out, NEG), axis=0)
            fin_m = jnp.where(jl == lb - 1, ml, fin_m)
            fin_d = jnp.where(
                t == la - 1 + lb,
                jnp.max(jnp.where(upd, d_out, NEG), axis=0), fin_d)
            word = jnp.concatenate([bits, fbit[None, :]], 0).astype(i32)
            acc = acc | (word << (4 * k))
            return (m_out, m1, d_out, i_out, ml, i1, fin_m, fin_d, acc)

        def word_body(w, state):
            carry, tb = state
            carry = carry[:8] + (jnp.zeros((W + 1, P), i32),)
            for k in range(8):
                carry = step(w * 8 + k, k, carry)
            tb = jax.lax.dynamic_update_slice(tb, carry[8][None], (w, 0, 0))
            return carry, tb

        negW = jnp.full((W, P), NEG, f32)
        carry = (negW, negW, negW, negW, neg_p, neg_p, neg_p, neg_p,
                 jnp.zeros((W + 1, P), i32))
        tb = jnp.zeros((n_words, W + 1, P), i32)
        carry, tb = jax.lax.fori_loop(0, n_run, word_body, (carry, tb))
        i1, fin_m, fin_d = carry[5], carry[6], carry[7]
        return tb, jnp.stack([fin_m, fin_d, i1])

    return run


# ---------------------------------------------------------------------------
# traceback

def _make_traceback(n_words: int, W: int, n_ops: int):
    """Un-jitted pointer chase over the forward pass's traceback tensor.

    run(tb, geo, fin, n_run) -> (scores (P,) f32, ops (P, n_ops // 4)
    uint8): 2-bit ops (OP_*) from the end of the path to its start, four
    per byte, OP_PAD once the chase reached (0, 0).  n_run (dynamic) is
    the longest path, max(la + lb)."""
    import jax
    import jax.numpy as jnp

    i32 = jnp.int32

    def run(tb, geo, fin, n_run):
        P = geo.shape[1]
        la, lb, dlo, bw = geo[0], geo[1], geo[2], geo[3]
        r0 = (la - dlo) & 1
        flat = tb.reshape(-1)
        pidx = jnp.arange(P, dtype=i32)
        s_w = (W + 1) * P

        def nib(t, lane):
            t = jnp.clip(t, 0, 8 * n_words - 1)
            word = flat[(t >> 3) * s_w + lane * P + pidx]
            return (word >> ((t & 7) * 4)) & 15

        def bits_at(i, j):
            t = i + j
            rho = (r0 + t) & 1
            I0 = (la + t - dlo - rho) >> 1
            u_band = I0 - i
            u_lb = lb - (t - I0)
            k = j - (dlo + i - la)
            last = i == la
            at_lb = j == lb
            lane = jnp.where(last, W, jnp.where(at_lb, u_lb, u_band))
            v = nib(jnp.where(last, t - 1, t), jnp.clip(lane, 0, W))
            ok = jnp.where(last, True,
                           jnp.where(at_lb, (u_lb >= 0) & (u_lb < W),
                                     (k >= 0) & (k < bw)))
            other = jnp.where(last, 0, jnp.where(
                at_lb, TB_MD, jnp.where(k == -1, TB_IM, 0)))
            return jnp.where(ok, v, other)

        fin_m, fin_d, fin_i = fin[0], fin[1], fin[2]
        score = fin_m
        st = jnp.zeros(P, i32)
        better = fin_d > score
        score = jnp.where(better, fin_d, score)
        st = jnp.where(better, OP_D, st)
        better = fin_i > score
        score = jnp.where(better, fin_i, score)
        st = jnp.where(better, OP_I, st)

        def body(s, carry):
            i, j, st, ops = carry
            done = (i == 0) & (j == 0)
            bts = bits_at(jnp.where(st == OP_I, i, i - 1),
                          jnp.where(st == OP_D, j, j - 1))
            st_m = jnp.where(bts & TB_DM, OP_D,
                             jnp.where(bts & TB_IM, OP_I, OP_M))
            st_d = jnp.where(bts & TB_MD, OP_M, OP_D)
            st_i = jnp.where(bts & TB_MI, OP_M, OP_I)
            st_new = jnp.where(st == OP_M, st_m,
                               jnp.where(st == OP_D, st_d, st_i))
            op = jnp.where(done, OP_PAD, st).astype(jnp.uint8)
            ops = jax.lax.dynamic_update_slice(ops, op[None, :], (s, 0))
            i = jnp.where(done | (st == OP_I), i, i - 1)
            j = jnp.where(done | (st == OP_D), j, j - 1)
            st = jnp.where(done, st, st_new)
            return i, j, st, ops

        ops = jnp.full((n_ops, P), OP_PAD, jnp.uint8)
        _i, _j, _st, ops = jax.lax.fori_loop(0, n_run, body,
                                             (la, lb, st, ops))
        o = ops.reshape(n_ops // 4, 4, P)
        packed = (o[:, 0] | (o[:, 1] << 2) | (o[:, 2] << 4) | (o[:, 3] << 6))
        return score, packed.T

    return run


@functools.lru_cache(maxsize=None)
def _launch_fn(L: int, P: int, W: int, kernel: str = "lax"):
    """Jitted forward + traceback for one launch shape (L letters per
    sequence, P pairs, W lanes).  kernel "lax" is _make_forward and
    _make_traceback, "cuda" the kernels of ops/cuda/wave_fwd.cu (same
    results).  The two halves are jitted apart, so a caller can time
    the forward pass alone."""
    import jax
    n_words = L // 4               # 2L steps cover any la + lb <= 2L
    if kernel == "cuda":
        from . import wave_cuda
        return (jax.jit(wave_cuda.make_forward(n_words, W)),
                jax.jit(wave_cuda.make_traceback(n_words, W, 2 * L)))
    return (jax.jit(_make_forward(n_words, W)),
            jax.jit(_make_traceback(n_words, W, 2 * L)))


_OPS_ASCII = np.frombuffer(b"MDI?", dtype=np.uint8)


def decode_ops(packed: np.ndarray, n: int) -> List[str]:
    """(P, n_ops // 4) packed 2-bit ops, end first -> path strings of the
    first n pairs."""
    nb = packed.shape[1]
    ops = np.empty((n, nb * 4), np.uint8)
    pk = packed[:n]
    for s in range(4):
        ops[:, s::4] = (pk >> (2 * s)) & 3
    pad = ops == OP_PAD
    lens = np.where(pad.any(axis=1), np.argmax(pad, axis=1), nb * 4)
    asc = _OPS_ASCII[ops]
    return [asc[p, :lens[p]][::-1].tobytes().decode("ascii")
            for p in range(n)]


def trace_host(tb: np.ndarray, geo: np.ndarray, fin: np.ndarray, p: int):
    """Plain-Python traceback of pair p over the forward pass's outputs
    (lane-major tb; the reference's TraceBackBitMem on the anti-diagonal
    layout).  Returns (score, path)."""
    W = tb.shape[1] - 1
    la, lb, dlo, bw = (int(x) for x in geo[:, p])
    r0 = (la - dlo) % 2

    def nib(t, lane):
        return (int(tb[t // 8, lane, p]) >> (4 * (t % 8))) & 15

    def bits(i, j):
        t = i + j
        if i == la:
            return nib(t - 1, W)
        I0 = (la + t - dlo - (r0 + t) % 2) // 2
        if j == lb:
            u = lb - (t - I0)
            return nib(t, u) if 0 <= u < W else TB_MD
        k = j - (dlo + i - la)
        if k == -1:
            return TB_IM
        if not 0 <= k < bw:
            return 0
        return nib(t, I0 - i)

    fin_m, fin_d, fin_i = (np.float32(x) for x in fin[:, p])
    score, state = fin_m, "M"
    if fin_d > score:
        score, state = fin_d, "D"
    if fin_i > score:
        score, state = fin_i, "I"
    i, j = la, lb
    out = []
    while not (i == 0 and j == 0):
        out.append(state)
        if state == "M":
            b = bits(i - 1, j - 1)
            state = "D" if b & TB_DM else ("I" if b & TB_IM else "M")
            i -= 1
            j -= 1
        elif state == "D":
            state = "M" if bits(i - 1, j) & TB_MD else "D"
            i -= 1
        else:
            state = "M" if bits(i, j - 1) & TB_MI else "I"
            j -= 1
    return float(score), "".join(reversed(out))


def default_kernel() -> str:
    """The device DP's kernels: CUDA on the GPU; the lax formulation on
    XLA's CPU backend (the tests), where it is the plain reference the
    CUDA kernels are measured and checked against."""
    import jax
    return "cuda" if jax.default_backend() == "gpu" else "lax"


# ---------------------------------------------------------------------------

class Launch:
    """Host-side arrays of one device launch: pairs padded to P with
    inert 1x1 pairs, letters as (P, L) int8 classes."""

    def __init__(self, pairs, geo, cls, L: int, P: int, W: int, ap):
        n = len(pairs)
        self.L, self.P, self.W = L, P, W
        la, lb = geo[0], geo[1]
        a = np.full((P, L), 4, np.int8)
        b = np.full((P, L), 4, np.int8)
        cols = np.arange(L)
        a[:n][cols[None, :] < la[:, None]] = letters(
            np.concatenate([np.asarray(p[0]) for p in pairs]))
        b[:n][cols[None, :] < lb[:, None]] = letters(
            np.concatenate([np.asarray(p[1]) for p in pairs]))
        a[n:, 0] = 0
        b[n:, 0] = 0
        self.a, self.b = a, b
        g = np.ones((4, P), np.int32)         # padding: la = lb = dlo = bw = 1
        g[:, :n] = geo
        self.geo = g
        c = np.full(P, 15, np.int64)
        c[:n] = cls
        self.term = _terminal(ap, c)
        self.scal = _scalars(ap)
        self.n_run = int((g[0] + g[1]).max())


class WaveAligner:
    """Scores and paths of nucleotide pairs, aligned on the device with
    the banded DP of align/oracle.py.

    Pairs are grouped by frame width and length (bucket), and each group
    runs as launches of at most LAUNCH_TB_BYTES of traceback tensor.
    `launches` counts the device launches so far."""

    def __init__(self, ap, kernel: Optional[str] = None) -> None:
        assert ap.nucleo, "device DP scores nucleotides only"
        self.ap = ap
        self.kernel = kernel or default_kernel()
        self.launches = 0

    @staticmethod
    def geometry(pairs, band_radius: int) -> np.ndarray:
        """(4, n) int32 rows la, lb, dlo, bw of the main-diagonal band."""
        geo = np.empty((4, len(pairs)), np.int32)
        for k, pr in enumerate(pairs):
            la, lb = len(pr[0]), len(pr[1])
            d0, d1 = band_diag_range(la, lb, band_radius)
            geo[:, k] = (la, lb, d0, d1 - d0 + 1)
        return geo

    @staticmethod
    def fits(geo: np.ndarray) -> np.ndarray:
        """Pairs whose frame fits the device (MAX_LANES)."""
        return lanes_for_band(geo[3]) <= MAX_LANES

    def plan(self, geo: np.ndarray):
        """[(idx, L, P, W)]: the launches for pairs with geometry geo.
        The loops run as many steps as the launch's longest pair needs,
        so the letter length L is a power of two (it sizes buffers, not
        work); lanes W and pairs P pad the work, so they are bucketed
        finer."""
        W_p = np.array([bucket(w, 8) for w in lanes_for_band(geo[3])])
        L_p = 1 << np.maximum(
            6, np.ceil(np.log2(np.maximum(geo[0], geo[1]))).astype(int))
        out = []
        for W in np.unique(W_p):
            for L in np.unique(L_p[W_p == W]):
                idx = np.nonzero((W_p == W) & (L_p == L))[0]
                cap = LAUNCH_TB_BYTES // (int(L) * (int(W) + 1))
                cap = min(MAX_LAUNCH_PAIRS, 1 << max(5, cap.bit_length() - 1))
                for lo in range(0, len(idx), cap):
                    part = idx[lo:lo + cap]
                    out.append((part, int(L), bucket(len(part), 32), int(W)))
        return out

    def run(self, launch: Launch):
        """Device outputs of one launch: (scores, packed ops) as numpy."""
        import jax.numpy as jnp
        fwd, tbk = _launch_fn(launch.L, launch.P, launch.W, self.kernel)
        n_run = jnp.int32(-(-launch.n_run // 8))
        geo = jnp.asarray(launch.geo)
        tb, fin = fwd(jnp.asarray(launch.a), jnp.asarray(launch.b), geo,
                      jnp.asarray(launch.term), jnp.asarray(launch.scal),
                      n_run)
        scores, packed = tbk(tb, geo, fin, jnp.int32(launch.n_run))
        self.launches += 1
        return np.asarray(scores), np.asarray(packed)

    def align(self, pairs: Sequence, band_radius: int,
              cls: Optional[np.ndarray] = None):
        """(scores f32 array, paths) of pairs (a, b) of uint8 letters.
        cls: per-pair hole class (see _terminal); default 15, the
        command's own terminal penalties on all four sides."""
        n = len(pairs)
        scores = np.zeros(n, np.float32)
        paths: List[Optional[str]] = [None] * n
        if n == 0:
            return scores, paths
        geo = self.geometry(pairs, band_radius)
        if not self.fits(geo).all():
            raise ValueError("band wider than the device frame")
        cls = np.full(n, 15, np.int64) if cls is None else np.asarray(cls)
        for idx, L, P, W in self.plan(geo):
            launch = Launch([pairs[i] for i in idx], geo[:, idx], cls[idx],
                            L, P, W, self.ap)
            sc, packed = self.run(launch)
            scores[idx] = sc[:len(idx)]
            for k, path in zip(idx, decode_ops(packed, len(idx))):
                paths[k] = path
        return scores, paths
