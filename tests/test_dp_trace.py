"""tools/dp_trace.py stays in lockstep with the oracle and the C
kernel (the TRACELOG-equivalent debugging tool must itself be
trustworthy)."""

import numpy as np
import pytest

from usearch12_tpu.align.oracle import band_diag_range, banded_nw
from usearch12_tpu.scoring import AlnParams

from tools.dp_trace import main as dp_trace_main
from tools.dp_trace import run_c_kernel, traced_banded_nw

CONV = np.frombuffer(b"ACGT", np.uint8)


def _rand_pair(rng, n1, n2):
    a = CONV[rng.integers(0, 4, n1)]
    b = a.copy()[:n2] if n2 <= n1 else np.concatenate(
        [a, CONV[rng.integers(0, 4, n2 - n1)]])
    idx = rng.integers(0, len(b), max(1, len(b) // 10))
    b = b.copy()
    b[idx] = CONV[rng.integers(0, 4, len(idx))]
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traced_oracle_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    ap = AlnParams.from_cmdline(nucleo=True)
    for (n1, n2) in [(30, 30), (50, 44), (17, 60)]:
        a, b = _rand_pair(rng, n1, n2)
        dlo, dhi = band_diag_range(len(a), len(b), 8)
        s0, p0 = banded_nw(a, b, dlo, dhi, ap)
        s1, p1, cells, tb = traced_banded_nw(a, b, dlo, dhi, ap)
        assert (s1, p1) == (s0, p0)
        assert len(cells) > 0


def test_c_tb_reader_decodes_band_layout():
    """The band-relative tb reader must agree with the oracle's full
    matrix on a pair long enough to trigger the banded layout."""
    rng = np.random.default_rng(7)
    ap = AlnParams.from_cmdline(nucleo=True)
    a, b = _rand_pair(rng, 300, 290)
    dlo, dhi = band_diag_range(len(a), len(b), 16)
    assert (dhi - dlo + 1) + 2 <= len(b) + 1   # banded layout active
    _s0, _p0, _cells, tb = traced_banded_nw(a, b, dlo, dhi, ap)
    s1, p1, tb_at = run_c_kernel(a, b, dlo, dhi, ap)
    from usearch12_tpu.align.oracle import get_range_j
    for i in range(len(a) + 1):
        sj, ej = get_range_j(len(a), len(b), dlo, dhi,
                             min(i, len(a) - 1))
        for j in list(range(max(0, sj - 1), ej)) + [len(b)]:
            assert tb_at(i, j) == tb[i][j], (i, j)


@pytest.mark.parametrize("cmp,says", [
    ("c", "all agree"), ("c,device", "device DP: score and path agree")])
def test_cli_agreement_exit_zero(capsys, cmp, says):
    rc = dp_trace_main(["--a", "ACGTACGTAC", "--b", "ACGTACCTAC",
                        "--band", "3", "--cmp", cmp])
    out = capsys.readouterr().out
    assert rc == 0
    assert says in out
