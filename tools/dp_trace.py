"""Per-cell DP trace + cross-kernel first-divergence finder.

The reference debugs its banded DP with TRACELOG per-cell dumps
(src/viterbifastbandmem.cpp:8-22) and an ungapped TRACE switch
(src/ungappedblast.cpp:6).  This tool is the equivalent for this
framework's three implementations of the banded affine-gap global DP:

  * a traced copy of the NumPy oracle (align/oracle.py) that records
    every in-band cell's (M, D, I, traceback bits),
  * the C host kernel (native/usearch_native.c nw_band), whose
    traceback matrix is read back from the caller-owned workspace and
    diffed bit-for-bit against the oracle — including the
    band-relative storage layout,
  * the device DP (ops/wavefront_nw.py: the CUDA kernels on the GPU,
    the lax formulation elsewhere), compared at the (score, path) level,
    with the first differing path op located.

Usage:
  python -m tools.dp_trace --a ACGT... --b ACGT... [--band 16]
      [--amino] [--out trace.tsv] [--cmp c,device]

With --out, writes one TSV row per in-band cell:
  i  j  M  D  I  bits
where M/D/I are the DP values of cell (i+1, j+1)/(i+1, j)/(i+1, j+1)
produced while scanning row i (the same rolling-array timing the
kernels use), and bits are the traceback byte written at tb[i][j].

Exit status 0 when every requested comparison agrees, 1 otherwise.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from usearch12_tpu.align.oracle import (TB_DM, TB_IM, TB_MD, TB_MI,
                                        band_diag_range, get_range_j)
from usearch12_tpu.scoring import MINUS_INFINITY, AlnParams

f32 = np.float32


def traced_banded_nw(a: np.ndarray, b: np.ndarray, dlo: int, dhi: int,
                     ap: AlnParams):
    """oracle.banded_nw with per-cell recording.  Returns
    (score, path, cells, tb) where cells is a list of
    (i, j, m_new, d_new, i_new, bits) for every in-band cell and tb is
    the full (la+1) x (lb+1) traceback byte matrix.  Kept in lockstep
    with align/oracle.py banded_nw (test_dp_trace.py asserts equality
    of score and path on randomized pairs)."""
    from usearch12_tpu.align.oracle import _traceback

    la, lb = len(a), len(b)
    mx = ap.subst_mx
    NEG = f32(MINUS_INFINITY)
    mrow = np.full(lb + 2, NEG, dtype=f32)
    drow = np.full(lb + 1, NEG, dtype=f32)
    tb = [bytearray(lb + 1) for _ in range(la + 1)]
    cells = []

    open_a = f32(ap.l_open_a)
    ext_a = f32(ap.l_ext_a)
    iopen_a = f32(ap.open_a)
    iext_a = f32(ap.ext_a)
    iopen_b = f32(ap.open_b)
    iext_b = f32(ap.ext_b)

    startj = endj = 0
    for i in range(la):
        startj, endj = get_range_j(la, lb, dlo, dhi, i)
        if endj == 0:
            continue
        open_b = f32(ap.l_open_b) if startj == 0 else iopen_b
        ext_b = f32(ap.l_ext_b) if startj == 0 else iext_b
        mx_row = mx[a[i]]
        i0 = NEG
        if i == 0:
            m0 = f32(0)
        else:
            m0 = NEG if startj == 0 else mrow[startj]
        tbrow = tb[i]
        if startj > 0:
            tbrow[startj - 1] = TB_IM
        for j in range(startj, endj):
            bb = b[j]
            bits = 0
            saved_m0 = m0
            xm = m0
            if drow[j] > xm:
                xm = drow[j]
                bits = TB_DM
            if i0 > xm:
                xm = i0
                bits = TB_IM
            m0 = mrow[j + 1]
            mrow[j + 1] = f32(xm + mx_row[bb])
            md = f32(saved_m0 + open_b)
            drow[j] = f32(drow[j] + ext_b)
            if md >= drow[j]:
                drow[j] = md
                bits |= TB_MD
            mi = f32(saved_m0 + open_a)
            i0 = f32(i0 + ext_a)
            if mi >= i0:
                i0 = mi
                bits |= TB_MI
            open_b = iopen_b
            ext_b = iext_b
            tbrow[j] = bits
            cells.append((i, j, float(mrow[j + 1]), float(drow[j]),
                          float(i0), bits))
        tbrow[lb] = 0
        md = f32(m0 + f32(ap.r_open_b))
        drow[lb] = f32(drow[lb] + f32(ap.r_ext_b))
        if md >= drow[lb]:
            drow[lb] = md
            tbrow[lb] = TB_MD
        cells.append((i, lb, float("nan"), float(drow[lb]), float("nan"),
                      tbrow[lb]))
        m0 = NEG
        open_a = iopen_a
        ext_a = iext_a

    startj, endj = get_range_j(la, lb, dlo, dhi, la - 1)
    assert endj == lb, "band does not reach the final column"
    tbrow = tb[la]
    i1 = NEG
    mrow[startj] = NEG
    for j in range(startj, endj):
        tbrow[j] = 0
        mi = f32(mrow[j] + f32(ap.r_open_a))
        i1 = f32(i1 + f32(ap.r_ext_a))
        if mi > i1:
            i1 = mi
            tbrow[j] = TB_MI
        cells.append((la, j, float("nan"), float("nan"), float(i1),
                      tbrow[j]))

    final_m, final_d, final_i = mrow[lb], drow[lb], i1
    score, state = final_m, "M"
    if final_d > score:
        score, state = final_d, "D"
    if final_i > score:
        score, state = final_i, "I"
    path = _traceback(tb, la, lb, state)
    return float(score), path, cells, tb


def run_c_kernel(a: np.ndarray, b: np.ndarray, dlo: int, dhi: int,
                 ap: AlnParams):
    """nw_band via ctypes with caller-owned workspaces; returns
    (score, path, tb_reader) where tb_reader(i, j) yields the stored
    traceback byte, decoding the band-relative layout the C kernel
    switches to when bw+2 <= lb+1 (usearch_native.c nw_band)."""
    from usearch12_tpu.native import GapParams, get_lib
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    la, lb = len(a), len(b)
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    mx = np.ascontiguousarray(ap.subst_mx, np.float32)
    tb = np.zeros((la + 1) * (lb + 1), np.uint8)
    mrow = np.zeros(lb + 2, np.float32)
    drow = np.zeros(lb + 1, np.float32)
    path_buf = ctypes.create_string_buffer(la + lb + 2)
    score = ctypes.c_float(0.0)
    gp = GapParams.from_alnparams(ap)
    n = lib.nw_band(a, la, b, lb, dlo, dhi, ctypes.byref(gp), mx, tb,
                    mrow, drow, path_buf, ctypes.byref(score))
    if n < 0:
        raise RuntimeError(f"nw_band failed: {n}")
    path = path_buf.raw[:n].decode()

    bw = dhi - dlo + 1
    banded = (bw + 2) <= (lb + 1)
    stride = (bw + 2) if banded else (lb + 1)
    lb_slot = (bw + 1) if banded else lb

    def tb_at(i: int, j: int) -> int:
        if not banded:
            return int(tb[stride * i + j])
        if j == lb:
            return int(tb[stride * i + lb_slot])
        sj, _ = get_range_j(la, lb, dlo, dhi, min(i, la - 1))
        slot = 0 if j + 1 <= sj else min(j - sj + 1, bw)
        return int(tb[stride * i + slot])

    return float(score.value), path, tb_at


def run_device(a: np.ndarray, b: np.ndarray, band_radius: int,
               ap: AlnParams):
    """(score, path) from the device DP (JAX's default backend)."""
    from usearch12_tpu.ops.wavefront_nw import WaveAligner
    scores, paths = WaveAligner(ap).align([(a, b)], band_radius)
    return float(scores[0]), paths[0]


def _first_path_diff(p1: str, p2: str):
    n = min(len(p1), len(p2))
    for k in range(n):
        if p1[k] != p2[k]:
            return k
    return None if len(p1) == len(p2) else n


def main(argv=None) -> int:
    pa = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    pa.add_argument("--a", required=True, help="sequence A (letters)")
    pa.add_argument("--b", required=True, help="sequence B (letters)")
    pa.add_argument("--band", type=int, default=16,
                    help="band radius (default 16, reference -band)")
    pa.add_argument("--amino", action="store_true",
                    help="protein scoring (default: nucleotide)")
    pa.add_argument("--out", help="write per-cell TSV trace here")
    pa.add_argument("--cmp", default="c",
                    help="comma list of kernels to diff vs the oracle: "
                         "c, device, none (default c)")
    args = pa.parse_args(argv)

    a = np.frombuffer(args.a.upper().encode(), np.uint8).copy()
    b = np.frombuffer(args.b.upper().encode(), np.uint8).copy()
    ap = AlnParams.from_cmdline(nucleo=not args.amino)
    dlo, dhi = band_diag_range(len(a), len(b), args.band)

    score, path, cells, tb = traced_banded_nw(a, b, dlo, dhi, ap)
    print(f"oracle: score={score} path_len={len(path)} "
          f"band=[{dlo},{dhi}] cells={len(cells)}")

    if args.out:
        with open(args.out, "w") as f:
            f.write("i\tj\tM\tD\tI\tbits\n")
            for (i, j, m, d, iv, bits) in cells:
                f.write(f"{i}\t{j}\t{m:.6g}\t{d:.6g}\t{iv:.6g}\t"
                        f"{bits:#04x}\n")
        print(f"wrote {len(cells)} cells to {args.out}")

    ok = True
    todo = {t.strip() for t in args.cmp.split(",") if t.strip()} - {"none"}
    if "c" in todo:
        c_score, c_path, tb_at = run_c_kernel(a, b, dlo, dhi, ap)
        diverged = None
        for i in range(len(a) + 1):
            sj, ej = get_range_j(len(a), len(b), dlo, dhi,
                                 min(i, len(a) - 1))
            lo = max(0, sj - 1)
            for j in list(range(lo, ej)) + [len(b)]:
                if tb_at(i, j) != tb[i][j]:
                    diverged = (i, j, tb[i][j], tb_at(i, j))
                    break
            if diverged:
                break
        if diverged:
            i, j, ov, cv = diverged
            print(f"C DIVERGES at cell ({i},{j}): oracle bits {ov:#04x} "
                  f"vs C {cv:#04x}")
            near = [c for c in cells if c[0] == i and abs(c[1] - j) <= 2]
            for (ci, cj, m, d, iv, bits) in near:
                print(f"  oracle ({ci},{cj}): M={m:.6g} D={d:.6g} "
                      f"I={iv:.6g} bits={bits:#04x}")
            ok = False
        elif (c_score, c_path) != (score, path):
            k = _first_path_diff(path, c_path)
            print(f"C DIVERGES: score {c_score} vs {score}; first path "
                  f"diff at op {k}")
            ok = False
        else:
            print("C kernel: traceback matrix, score and path all agree")
    if "device" in todo:
        p_score, p_path = run_device(a, b, args.band, ap)
        if (p_score, p_path) != (score, path):
            k = _first_path_diff(path, p_path or "")
            print(f"DEVICE DIVERGES: score {p_score} vs {score}; first "
                  f"path diff at op {k} "
                  f"(oracle ...{path[max(0, (k or 0)-5):(k or 0)+5]}... vs "
                  f"device ...{(p_path or '')[max(0, (k or 0)-5):(k or 0)+5]}...)")
            ok = False
        else:
            print("device DP: score and path agree")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
