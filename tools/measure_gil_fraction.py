"""Measure the GIL-released fraction of a usearch_global engine run.

The engine's hot loops live in C behind ctypes (usearch_native.c /
usearch_engine.c); ctypes CDLL calls drop the GIL for the duration of
the call, so the fraction of wall time spent inside the native boundary
is the fraction an N-thread driver could overlap (the reference gets its
thread scaling the same way: all DP/ranking inside C++ worker threads,
/root/reference/src/search.cpp:119-128).

Method: after the shared library is built and bound, every ctypes
function attribute on the CDLL is replaced with a timing proxy (the same
object all callers hold, so the wrap is global), then one in-process
usearch_global run executes and we report

    gil_released_fraction = sum(native call wall time) / engine wall time

The proxy adds ~1 us of *held*-GIL overhead per call, so the reported
fraction is a lower bound.  The Amdahl projection for N cores is
1 / ((1-f) + f/N) with f = the measured fraction; it assumes the Python
driver section does not shrink with threads (conservative: the window
pool also overlaps Python emit with native work of other windows).

Usage: python tools/measure_gil_fraction.py QUERY.fa DB.fa
Prints one JSON line.
"""

import ctypes
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# host-only: this measures the C/GIL split, not device offload
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def wrap_lib(lib):
    """Replace every bound ctypes function with a timing proxy.
    Returns the shared accumulator {name: [calls, seconds]}."""
    acc = {}
    perf = time.perf_counter
    for name, fn in list(lib.__dict__.items()):
        if not isinstance(fn, ctypes._CFuncPtr):
            continue
        cell = acc.setdefault(name, [0, 0.0])

        def proxy(*args, _fn=fn, _cell=cell, _perf=perf):
            t0 = _perf()
            r = _fn(*args)
            _cell[1] += _perf() - t0
            _cell[0] += 1
            return r

        setattr(lib, name, proxy)
    return acc


def main():
    q_fa, db_fa = sys.argv[1], sys.argv[2]
    from usearch12_tpu.native import get_lib
    lib = get_lib()
    if lib is None:
        print(json.dumps({"error": "native library unavailable"}))
        return 1
    acc = wrap_lib(lib)

    from usearch12_tpu.cli import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                   "-strand", "plus", "-blast6out", os.devnull,
                   "-quiet", "-threads", "1"])
    total = time.perf_counter() - t0
    if rc != 0:
        print(json.dumps({"error": f"cli rc={rc}"}))
        return 1

    native = sum(c[1] for c in acc.values())
    f = native / total if total > 0 else 0.0
    top = sorted(((n, c[1], c[0]) for n, c in acc.items() if c[0]),
                 key=lambda t: -t[1])[:8]

    def amdahl(n):
        return round(1.0 / ((1.0 - f) + f / n), 2)

    print(json.dumps({
        "total_s": round(total, 3),
        "native_s": round(native, 3),
        "gil_released_fraction": round(f, 4),
        "top_native_s": {n: [round(s, 3), calls] for n, s, calls in top},
        "amdahl_projection": {"x2": amdahl(2), "x4": amdahl(4),
                              "x10": amdahl(10)},
        "note": ("fraction is a lower bound (proxy overhead counts as "
                 "held); projection assumes no overlap of the Python "
                 "driver, which the window pool partially provides"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
