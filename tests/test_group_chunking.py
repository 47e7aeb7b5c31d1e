"""WaveAligner launch chunking: a batch whose traceback tensor exceeds
LAUNCH_TB_BYTES splits into launches of one shape (one compile), the
tail padded with inert pairs, with per-pair results identical to the
oracle."""

import numpy as np

from usearch12_tpu.align.oracle import band_diag_range, banded_nw
from usearch12_tpu.ops import wavefront_nw as wnw
from usearch12_tpu.scoring import AlnParams

CONV = np.frombuffer(b"ACGT", np.uint8)


def _mk_pairs(rng, n, length):
    pairs = []
    for _ in range(n):
        a = CONV[rng.integers(0, 4, length)]
        b = a.copy()
        b[rng.integers(0, length, 4)] = CONV[rng.integers(0, 4, 4)]
        pairs.append((a, b))
    return pairs


def _check(pairs, band, ap, scores, paths):
    for i, (a, b) in enumerate(pairs):
        d0, d1 = band_diag_range(len(a), len(b), band)
        s0, p0 = banded_nw(a, b, d0, d1, ap)
        assert paths[i] == p0, i
        assert float(scores[i]) == s0, i


def test_group_chunking_matches_oracle(monkeypatch):
    # 64 letters x 9 lanes (W 8) = 576 bytes of traceback per pair: a
    # 32-pair budget turns 130 pairs into 5 launches of 32
    monkeypatch.setattr(wnw, "LAUNCH_TB_BYTES", 32 * 64 * 9)
    ap = AlnParams.from_cmdline(nucleo=True)
    band = 4
    pairs = _mk_pairs(np.random.default_rng(17), 130, 40)
    wa = wnw.WaveAligner(ap)
    shapes = [(L, P, W) for _i, L, P, W in
              wa.plan(wa.geometry(pairs, band))]
    assert shapes == [(64, 32, 8)] * 5
    scores, paths = wa.align(pairs, band)
    assert wa.launches == 5
    _check(pairs, band, ap, scores, paths)


def test_group_small_batch_unchunked():
    ap = AlnParams.from_cmdline(nucleo=True)
    band = 4
    pairs = _mk_pairs(np.random.default_rng(5), 6, 36)
    wa = wnw.WaveAligner(ap)
    (idx, L, P, W), = wa.plan(wa.geometry(pairs, band))
    assert (len(idx), L, P, W) == (6, 64, 32, 8)
    scores, paths = wa.align(pairs, band)
    assert wa.launches == 1
    _check(pairs, band, ap, scores, paths)
