"""Device banded DP (ops/wavefront_nw.py) on XLA's CPU backend: scores and
paths bit-exact against the oracle (align/oracle.py) and the host C
kernel nw_band, the XLA traceback against the plain-Python one, and the
launch planning (bucketing, padding, chunking)."""

import numpy as np
import pytest

from usearch12_tpu.align.oracle import band_diag_range, banded_nw
from usearch12_tpu.native import get_lib, nw_band
from usearch12_tpu.ops import wavefront_nw as wnw
from usearch12_tpu.scoring import AlnParams, nuc_mx

CONV = np.frombuffer(b"ACGT", np.uint8)


def _ap(pen):
    ap = AlnParams(nucleo=True, subst_mx=nuc_mx(1.0, -2.0))
    ap.init4(*pen)
    return ap


def _pairs(rng, n, lmin, lmax, asym=0, ns=False):
    """Related pairs: b is a with substitutions, indels and (asym) a
    trimmed or extended end; ns puts N letters in."""
    out = []
    for _ in range(n):
        a = CONV[rng.integers(0, 4, int(rng.integers(lmin, lmax)))]
        if ns:
            a = a.copy()
            a[rng.integers(0, len(a), 3)] = ord("N")
        b = list(a)
        for _ in range(max(1, len(b) // 25)):
            b[int(rng.integers(0, len(b)))] = int(CONV[rng.integers(0, 4)])
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, len(b)))
            if rng.integers(0, 2):
                del b[p]
            else:
                b.insert(p, int(CONV[rng.integers(0, 4)]))
        if asym:
            k = int(rng.integers(-asym, asym + 1))
            b = b[:len(b) + k] if k < 0 else b + list(
                CONV[rng.integers(0, 4, k)])
        out.append((a, np.array(b, np.uint8)))
    return out


DYADIC = (-10.0, -1.0, -0.5, -0.5)
NONDYADIC = (-10.3, -1.1, -0.7, -0.4)


@pytest.mark.parametrize("seed,radius,lmin,lmax,asym,pen", [
    (1, 16, 40, 60, 0, DYADIC),
    (2, 16, 40, 60, 12, NONDYADIC),
    (3, 4, 40, 60, 3, DYADIC),
    (4, 0, 40, 60, 6, NONDYADIC),
    (5, 16, 1490, 1510, 4, DYADIC),
    (6, 40, 40, 60, 40, DYADIC),
])
def test_wave_matches_oracle_and_c(seed, radius, lmin, lmax, asym, pen):
    """Every pair's score and path equal the oracle's and C nw_band's,
    under each pair's own terminal-gap class."""
    ap = _ap(pen)
    rng = np.random.default_rng(seed)
    n = 6 if lmax > 1000 else 24
    pairs = _pairs(rng, n, lmin, lmax, asym, ns=seed % 2 == 0)
    cls = rng.integers(0, 16, n)
    scores, paths = wnw.WaveAligner(ap).align(pairs, radius, cls)
    lib = get_lib()
    for k, (a, b) in enumerate(pairs):
        c = int(cls[k])
        hap = ap.hole_params(bool(c & 1), bool(c & 2), bool(c & 4),
                             bool(c & 8))
        d0, d1 = band_diag_range(len(a), len(b), radius)
        s_o, p_o = banded_nw(a, b, d0, d1, hap)
        assert paths[k] == p_o, k
        assert scores[k] == np.float32(s_o), k
        if lib is not None:
            s_c, p_c = nw_band(a, b, d0, d1, hap)
            assert paths[k] == p_c and scores[k] == np.float32(s_c), k


@pytest.mark.parametrize("seed,radius", [(7, 16), (8, 2)])
def test_device_traceback_matches_host(seed, radius):
    """The XLA pointer chase reads the forward pass's tensor exactly as
    the plain-Python traceback does."""
    import jax.numpy as jnp
    ap = _ap(DYADIC)
    rng = np.random.default_rng(seed)
    pairs = _pairs(rng, 12, 30, 60, asym=8)
    wa = wnw.WaveAligner(ap)
    geo = wa.geometry(pairs, radius)
    for idx, L, P, W in wa.plan(geo):
        launch = wnw.Launch([pairs[i] for i in idx], geo[:, idx],
                            np.full(len(idx), 15), L, P, W, ap)
        fwd, tbk = wnw._launch_fn(L, P, W)
        g = jnp.asarray(launch.geo)
        tb, fin = fwd(jnp.asarray(launch.a), jnp.asarray(launch.b), g,
                      jnp.asarray(launch.term), jnp.asarray(launch.scal),
                      jnp.int32(-(-launch.n_run // 8)))
        scores, packed = tbk(tb, g, fin, jnp.int32(launch.n_run))
        paths = wnw.decode_ops(np.asarray(packed), len(idx))
        tb, fin = np.asarray(tb), np.asarray(fin)
        for p in range(len(idx)):
            s_h, p_h = wnw.trace_host(tb, launch.geo, fin, p)
            assert paths[p] == p_h
            assert np.asarray(scores)[p] == np.float32(s_h)


def test_plan_buckets_shapes():
    """Lanes and pairs pad by less than 25%; letter length is a power
    of two; every pair lands in exactly one launch."""
    assert [wnw.bucket(x, 8) for x in (1, 8, 18, 21, 33, 100)] == \
        [8, 8, 20, 24, 40, 112]
    rng = np.random.default_rng(3)
    pairs = _pairs(rng, 50, 30, 300, asym=30)
    geo = wnw.WaveAligner.geometry(pairs, 16)
    seen = []
    for idx, L, P, W in wnw.WaveAligner(_ap(DYADIC)).plan(geo):
        seen += list(idx)
        assert L & (L - 1) == 0 and L >= np.maximum(geo[0], geo[1])[idx].max()
        lanes = wnw.lanes_for_band(geo[3][idx])
        assert lanes.max() <= W < 1.25 * lanes.max() + 8
        assert len(idx) <= P < 1.25 * len(idx) + 32
    assert sorted(seen) == list(range(50))


def test_wide_band_refused():
    """Frames wider than MAX_LANES are the host's; align() refuses them
    (the engine routes them to nw_band and counts them)."""
    a = CONV[np.arange(40) % 4]
    b = CONV[np.arange(40 + 2 * wnw.MAX_LANES) % 4]
    geo = wnw.WaveAligner.geometry([(a, b)], 16)
    assert not wnw.WaveAligner.fits(geo).any()
    with pytest.raises(ValueError):
        wnw.WaveAligner(_ap(DYADIC)).align([(a, b)], 16)
