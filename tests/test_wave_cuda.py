"""The CUDA kernels of the device DP (ops/cuda/wave_fwd.cu) against the
lax formulation and the oracle, on the GPU: USEARCH_GPU_TESTS=1 python -m
pytest tests -m gpu.  They have no interpret mode, so they skip on the
CPU; chip_smoke.py phase B runs the same comparison at real sizes."""

import numpy as np
import pytest

from usearch12_tpu.align.oracle import band_diag_range, banded_nw
from usearch12_tpu.ops import wavefront_nw as wnw
from usearch12_tpu.scoring import AlnParams, nuc_mx

CONV = np.frombuffer(b"ACGT", np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("radius,extra", [(16, 0), (16, 90), (8, 180),
                                          (4, 300)])
def test_cuda_matches_lax_and_oracle(radius, extra):
    """Bands of 1, 2, 4 and 8 frame lanes per thread (W <= 32, 64,
    128, 256)."""
    ap = AlnParams(nucleo=True, subst_mx=nuc_mx(1.0, -2.0))
    ap.init4(-10.3, -1.1, -0.7, -0.4)
    rng = np.random.default_rng(radius + extra)
    pairs = []
    for _ in range(40):
        a = CONV[rng.integers(0, 4, int(rng.integers(100, 400)))]
        b = a.copy()
        b[rng.integers(0, len(b), 8)] = CONV[rng.integers(0, 4, 8)]
        b = np.concatenate([b, CONV[rng.integers(0, 4, extra)]])
        pairs.append((a, b))
    cls = rng.integers(0, 16, len(pairs))
    s_c, p_c = wnw.WaveAligner(ap, kernel="cuda").align(pairs, radius, cls)
    s_l, p_l = wnw.WaveAligner(ap, kernel="lax").align(pairs, radius, cls)
    assert p_c == p_l and np.array_equal(s_c, s_l)
    for k, (a, b) in enumerate(pairs[:8]):
        c = int(cls[k])
        hap = ap.hole_params(bool(c & 1), bool(c & 2), bool(c & 4),
                             bool(c & 8))
        d0, d1 = band_diag_range(len(a), len(b), radius)
        s_o, p_o = banded_nw(a, b, d0, d1, hap)
        assert p_c[k] == p_o and s_c[k] == np.float32(s_o)
