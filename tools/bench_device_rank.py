"""Device CSR ranking vs the host C ranker on a large DB.

Builds a 90k-target nucleotide DB (below -big 100000: the device ranker
implements the non-big semantics, ROADMAP R3), ranks the same query
window with the host ranker (rank_batch_c: dense SetTopBump scan,
usearch_engine.c) and the device CSR ranker (ops/csr_rank.py: gather +
radix histogram + prefix scans + top-K), asserts the candidate prefixes
are IDENTICAL per query, and reports paired wall times.

Prints one JSON line.  Run it alone on the card: python
tools/bench_device_rank.py
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np


def main(n_targets=90000, n_queries=2048, length=250):
    from usearch12_tpu import device
    device.enable_compile_cache()
    from usearch12_tpu.cli import parse_argv
    parse_argv(["-usearch_global", "/dev/null", "-db", "/dev/null",
                "-id", "0.9", "-strand", "plus", "-quiet"])
    from usearch12_tpu.io.seqdb import SeqDB
    from usearch12_tpu.engine.batch import BatchEngine
    from usearch12_tpu.ops.csr_rank import CSRDeviceRanker

    rng = np.random.default_rng(13)
    conv = np.frombuffer(b"ACGT", np.uint8)
    # template families so queries share real word structure with the DB
    tpls = [conv[rng.integers(0, 4, length)] for _ in range(2000)]
    db = SeqDB()
    for t in range(n_targets):
        s = tpls[t % 2000].copy()
        s[rng.integers(0, length, 8)] = conv[rng.integers(0, 4, 8)]
        db.add(f"t{t}", s)
    db.set_is_nucleo(True)

    t0 = time.perf_counter()
    eng = BatchEngine("usearch_global", db)
    t_index = time.perf_counter() - t0

    qs = []
    for qn in range(n_queries):
        s = tpls[qn % 2000].copy()
        s[rng.integers(0, length, 12)] = conv[rng.integers(0, 4, 12)]
        qs.append(s)
    jbuf = np.concatenate(qs)
    j_off = np.zeros(n_queries + 1, np.int64)
    np.cumsum([len(s) for s in qs], out=j_off[1:])

    # host ranker (rank_batch_c)
    best_h = None
    for _ in range(3):
        t0 = time.perf_counter()
        h_cand, h_cnts, h_out_n = eng._rank_jobs(jbuf, j_off)
        dt = time.perf_counter() - t0
        best_h = dt if best_h is None else min(best_h, dt)

    # device CSR ranker
    term_k = eng.max_accepts + eng.max_rejects
    cr = CSRDeviceRanker(eng.index, topk=max(64, term_k), chunk_b=128)
    d_cand, d_cnts, d_out_n, unc = cr.rank_window(jbuf, j_off)  # warm
    best_d = None
    for _ in range(3):
        t0 = time.perf_counter()
        d_cand, d_cnts, d_out_n, unc = cr.rank_window(jbuf, j_off)
        dt = time.perf_counter() - t0
        best_d = dt if best_d is None else min(best_d, dt)

    same = True
    for j in range(n_queries):
        n = min(int(h_out_n[j]), int(d_out_n[j]), term_k)
        if int(h_out_n[j]) != int(d_out_n[j]) and not unc[j]:
            # out_n may exceed the device top-K only when flagged
            same = same and (min(int(h_out_n[j]), term_k)
                             == min(int(d_out_n[j]), term_k))
        if not np.array_equal(h_cand[j, :n].astype(np.int64),
                              d_cand[j, :n]):
            same = False
            break

    print(json.dumps({
        "targets": n_targets, "queries": n_queries,
        "host_rank_s": round(best_h, 3), "device_rank_s": round(best_d, 3),
        "device_vs_host": round(best_h / best_d, 3),
        "order_identical": bool(same),
        "uncertain_fallbacks": int(unc.sum()),
        "index_build_s": round(t_index, 2)}))


if __name__ == "__main__":
    main()
