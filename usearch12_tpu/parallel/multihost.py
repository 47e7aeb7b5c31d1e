"""Multi-host scaffolding: jax.distributed init + host-sharded search.

The reference is strictly single-process (SURVEY.md §2.2); this module
spreads one search over several hosts:

  - `init_multihost()` wires `jax.distributed.initialize` from either
    explicit arguments or the standard env vars, giving every process a
    view of the GLOBAL device set.
  - Meshes are laid out host-major: the "db" (posting-shard) axis maps
    to devices within a host (collectives stay on the host's NVLink),
    while the "data" (query-batch) axis spans hosts (only all_gathers of
    tiny top-K tuples cross the network).
  - `multihost_search()` runs the mesh-sharded ranking step
    (parallel/mesh_search.py) with each host feeding its own query
    slice; per-host outputs concatenate in process order, so the bytes
    equal a single-process run over the concatenated input.

Testable without hardware: two local processes x 4 virtual CPU devices
(tests/test_multihost.py launches the companion worker below).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   platform: Optional[str] = None) -> None:
    """Initialize jax.distributed.  Arguments default to the standard
    env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID); no-op when num_processes <= 1 and no coordinator
    is configured."""
    import jax
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if platform:
        # must be set before backend init; overrides plugin autoload
        jax.config.update("jax_platforms", platform)
    if coordinator is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def host_major_mesh(db_per_host: Optional[int] = None):
    """Mesh(data x db) with the db axis inside each host and the data
    axis across hosts."""
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    n_proc = jax.process_count()
    per_host = len(devs) // n_proc
    if db_per_host is None:
        db_per_host = per_host
    assert per_host % db_per_host == 0
    data = len(devs) // db_per_host
    arr = np.array(devs).reshape(data, db_per_host)
    return Mesh(arr, ("data", "db"))


def multihost_search(query_path: str, db_path: str, out_path: str,
                     topk: int = 64, window: int = 512) -> dict:
    """usearch_global across processes: the posting incidence shards over
    every host's devices ("db" axis), queries stripe across hosts (the
    host-side SeqSource sharding), and every process executes the SAME
    jitted collective program per window (SPMD) — each host contributes
    its stripe's rows to the global query batch and gets its rows'
    candidate lists back.  Alignment and emission run host-locally
    through the batch engine; process 0 splices the per-host blast6
    stripes, so the bytes equal a single-process run."""
    import jax
    from ..config import options
    from ..io.seqdb import SeqDB
    from ..engine.batch import BatchEngine, _FastaWindows
    from ..engine.emit import Blast6Emitter
    from .mesh_search import MeshRanker

    o = options()
    pid = jax.process_index()
    n_proc = jax.process_count()
    db = SeqDB.from_fastx(db_path)
    db.mask()
    mesh = host_major_mesh()

    eng = BatchEngine("usearch_global", db)
    ranker = MeshRanker(mesh, eng.index, topk=topk)

    win = _FastaWindows(query_path)
    n = win.n
    per = (n + n_proc - 1) // n_proc
    lo, hi = pid * per, min(n, (pid + 1) * per)
    n_windows = (per + window - 1) // window   # SAME count on all hosts

    part = f"{out_path}.part{pid}"
    fpart = open(part, "w")
    emitter = Blast6Emitter(fpart, db, o.flag("output_no_hits"))
    stats = {"queries": 0, "fallbacks": 0, "windows": n_windows}

    soff = win.seq_off
    for w in range(n_windows):
        wlo = min(lo + w * window, hi)
        whi = min(wlo + window, hi)
        nrec = whi - wlo
        jbuf = (np.ascontiguousarray(win.seq_buf[soff[wlo]:soff[whi]])
                if nrec else np.zeros(1, np.uint8))
        j_off = (soff[wlo:whi + 1] - soff[wlo]).astype(np.int64)
        # SPMD rank: all hosts participate even with an empty stripe
        cand, cnts, out_n, unc = ranker.rank_window_spmd(
            jbuf, j_off, rows_per_host=window)
        stats["queries"] += nrec
        if nrec == 0:
            continue
        if unc.any():
            h_cand, h_cnts, h_out_n = eng._rank_jobs(jbuf, j_off)
            for j in np.nonzero(unc)[0]:
                stats["fallbacks"] += 1
                k = min(h_out_n[j], cand.shape[1])
                cand[j, :k] = h_cand[j, :k]
                cnts[j, :k] = h_cnts[j, :k]
                out_n[j] = k

        per_job_hits = [[] for _ in range(nrec)]
        eng.search_window(
            jbuf, j_off,
            lambda j, tix, p, st: per_job_hits[j].append((tix, p, st)),
            rank_override=lambda *_a: (
                np.ascontiguousarray(cand.astype(np.uint32)),
                np.ascontiguousarray(cnts), out_n))

        def label_of(i):
            return bytes(
                win.buf[win.lbl_off[i]:win.lbl_end[i]]).decode("latin1")
        emitter.emit(label_of, wlo, whi, per_job_hits, 1, j_off, jbuf)
    fpart.close()

    # barrier, then process 0 splices the stripes in order
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("usearch_multihost_done")
    if pid == 0:
        with open(out_path, "wb") as out:
            for p in range(n_proc):
                with open(f"{out_path}.part{p}", "rb") as f:
                    out.write(f.read())
    multihost_utils.sync_global_devices("usearch_multihost_merged")
    return stats
