"""Top-level command implementations (cmd_* entry points).

Each mirrors a reference pipeline (src/searchcmd.cpp, src/clusterfast.cpp,
etc.), composed from the package's engine layers.
"""

from __future__ import annotations

import sys
from typing import Optional

from .config import options
from .io.seqdb import SeqDB
from .io.fastx import read_fastx
from .out.blast6 import blast6_line, blast6_no_hits_line


def _is_udb(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            import struct
            from .index.udbfile import MAGIC1
            return struct.unpack("<I", f.read(4))[0] == MAGIC1
    except Exception:
        return False


def load_db(path: str):
    """LoadDB (src/loaddb.cpp:127): dispatch .udb vs FASTA.  Returns
    (SeqDB, UDBIndex-or-None); .udb DBs are already masked/indexed."""
    if _is_udb(path):
        from .index.udbfile import read_udb
        index, db = read_udb(path)
        if len(db) == 0:
            raise SystemExit("Database is empty")
        return db, index
    db = SeqDB.from_fastx(path)
    if len(db) == 0:
        raise SystemExit("Database is empty")
    db.mask()
    return db, None


def _load_db(path: str) -> SeqDB:
    return load_db(path)[0]


def _engine_device_mode() -> str:
    """BatchEngine device mode from -engine_device / -no_engine_device."""
    o = options()
    if o.flag("no_engine_device"):
        return "off"
    return "forced" if o.flag("engine_device") else "auto"


def _mesh():
    """jax.sharding.Mesh from -mesh, or None when the flag is unset.

    -mesh accepts "DATAxDB" (e.g. "2x4"), a device count (db-major
    factoring), or "auto" (all visible devices).  This is the product
    surface for multi-chip: usearch_global routes its USORT ranking
    through parallel/mesh_search.py and cluster_mt its U counting
    through parallel/cluster_batch.py over this mesh (the device
    counterpart of the reference's thread fan-out,
    src/search.cpp:119-128 and src/clustermt.cpp:46-123).  The mesh
    follows the algorithm; every card reaches every other at the same
    rate, so no device order is preferred."""
    o = options()
    if not o.filled("mesh"):
        return None
    spec = o.str("mesh")
    from . import device
    device.gate("mesh", True)
    import jax
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()
    if "x" in spec:
        try:
            n_data, n_db = (int(x) for x in spec.split("x"))
        except ValueError:
            raise SystemExit(f"-mesh {spec}: expected DATAxDB, a device "
                             "count, or auto")
    else:
        if spec == "auto":
            n = len(devs)
        else:
            try:
                n = int(spec)
            except ValueError:
                raise SystemExit(f"-mesh {spec}: expected DATAxDB, a "
                                 "device count, or auto")
        n_db = 1
        for cand in (2, 4, 8):
            if n % cand == 0:
                n_db = cand
        if n // n_db == 1 and n_db >= 4:
            n_db //= 2
        n_data = max(1, n // n_db)
    need = n_data * n_db
    if len(devs) < need:
        raise SystemExit(f"-mesh {spec}: needs {need} devices, have "
                         f"{len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_data, n_db),
                ("data", "db"))


def cmd_usearch_global(query_path: Optional[str]) -> None:
    """usearch_global: UDB global search with USORT ranking
    (src/searchcmd.cpp:6-50, src/search.cpp:89-141)."""
    o = options()
    if query_path is None:
        query_path = o.str("query")
    if not o.filled("id"):
        raise SystemExit("--id not set")
    db, db_index = load_db(o.str("db"))

    from .search.driver import search_file

    f_b6 = open(o.str("blast6out"), "w") if o.filled("blast6out") else None
    f_aln = open(o.str("alnout"), "w") if o.filled("alnout") else None
    if f_aln:
        from .out.alnout import write_program_header
        write_program_header(f_aln)
    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None
    f_m = open(o.str("matched"), "w") if o.filled("matched") else None
    f_nm = open(o.str("notmatched"), "w") if o.filled("notmatched") else None
    f_fp = open(o.str("fastapairs"), "w") if o.filled("fastapairs") else None
    f_user = open(o.str("userout"), "w") if o.filled("userout") else None

    from .out import uc as uc_mod
    from .io.fastx import write_fasta

    dbhit = None
    if (o.filled("dbmatched") or o.filled("dbnotmatched")
            or o.filled("dbcutout")):
        from .out.dbhit import DBHitSink
        dbhit = DBHitSink(db)
    f_qseg = open(o.str("qsegout"), "w") if o.filled("qsegout") else None
    f_tseg = open(o.str("tsegout"), "w") if o.filled("tsegout") else None
    f_trim = open(o.str("trimout"), "w") if o.filled("trimout") else None

    def on_query_done(label, seq, hits):
        from .search.hitmgr import HitMgr
        hm = HitMgr()
        hm.hits = hits
        ordered = hm.sorted_hits()
        if f_aln:
            from .out.alnout import write_aln, write_query_report
            q_nucleo = ordered[0].nucleo or bool(ordered[0].orf_frame) \
                if ordered else db.get_is_nucleo()
            write_query_report(f_aln, label, ordered, local=False,
                               query_nucleo=q_nucleo,
                               target_nucleo=db.get_is_nucleo())
            for ar in ordered:
                write_aln(f_aln, ar)
        if f_b6:
            for ar in ordered:
                f_b6.write(blast6_line(ar))
            if not ordered and o.flag("output_no_hits"):
                f_b6.write(blast6_no_hits_line(label))
        if f_user:
            from .out.userout import user_out_lines, user_out_no_hits
            for ar in ordered:
                f_user.write(user_out_lines(ar))
            if not ordered and o.flag("output_no_hits"):
                f_user.write(user_out_no_hits(label, seq))
        if f_fp:
            from .out.alnout import fasta_pair
            for ar in ordered:
                fasta_pair(f_fp, ar)
        if f_qseg or f_tseg or f_trim:
            from .out.alnout import write_qseg, write_tseg, write_trim
            for ar in ordered:
                write_qseg(f_qseg, ar)
                write_tseg(f_tseg, ar)
                write_trim(f_trim, ar)
        if f_uc:
            if ordered:
                for ar in ordered:
                    f_uc.write(uc_mod.uc_hit_record(ar))
            else:
                f_uc.write(uc_mod.uc_no_hit_record(label, len(seq)))
        if dbhit:
            dbhit.on_query_done(label, ordered, "usearch_global")
        if ordered:
            if f_m:
                write_fasta(f_m, label, seq, o.uns("fasta_cols"))
        else:
            if f_nm:
                write_fasta(f_nm, label, seq, o.uns("fasta_cols"))

    from .io.fastx import file_is_nucleo
    from .engine import BatchEngine, engine_eligible
    xlat = (not db.get_is_nucleo()) and file_is_nucleo(query_path)
    mesh = _mesh()
    if mesh is not None:
        if not engine_eligible("usearch_global", db.get_is_nucleo(), xlat) \
                or (db_index is not None and db_index.params.hashed):
            raise SystemExit("-mesh requires an engine-eligible "
                             "usearch_global run (global id search, "
                             "non-hashed index)")
        from .parallel.mesh_search import mesh_search_file
        only_b6 = (f_b6 is not None and dbhit is None
                   and not any((f_aln, f_uc, f_m, f_nm, f_fp, f_user,
                                f_qseg, f_tseg, f_trim)))
        fast_emit = None
        if only_b6:
            from .engine.emit import Blast6Emitter
            fast_emit = Blast6Emitter(f_b6, db, o.flag("output_no_hits"))
        mesh_search_file(query_path, db, mesh, on_query_done,
                         fast_emit=fast_emit, index=db_index)
    elif engine_eligible("usearch_global", db.get_is_nucleo(), xlat) \
            and not (db_index is not None and db_index.params.hashed) \
            and not o.flag("use_serial_driver"):
        eng = BatchEngine("usearch_global", db, index=db_index,
                          device=_engine_device_mode())
        # device ranking (ops/csr_rank.py): CSR gather/count/top-K on the
        # device, explicit only.  It implements the non-big USORT
        # semantics, so it refuses DBs above -big, where the reference
        # ranks with UDBSearchBig.
        rank_override = None
        if o.flag("device_rank") and not o.flag("no_device_rank"):
            big = o.uns("big")
            if eng.index.seq_count > big:
                raise SystemExit(
                    f"-device_rank: the DB has {eng.index.seq_count} "
                    f"targets, above -big {big}; the device ranker does "
                    "not implement big-DB ranking yet")
            from . import device
            device.gate("device_rank", True)
            from .ops.csr_rank import CSRDeviceRanker, make_engine_override
            term_k = eng.max_accepts + eng.max_rejects
            cr = CSRDeviceRanker(eng.index, topk=max(64, term_k))
            rank_override = make_engine_override(cr, eng)
        only_b6 = (f_b6 is not None and dbhit is None
                   and not any((f_aln, f_uc, f_m, f_nm, f_fp, f_user,
                                f_qseg, f_tseg, f_trim)))
        if only_b6:
            from .engine.emit import Blast6Emitter
            em = Blast6Emitter(f_b6, db, o.flag("output_no_hits"))
            eng.run_file(query_path, on_query_done, fast_emit=em,
                         rank_override=rank_override)
        else:
            eng.run_file(query_path, on_query_done,
                         rank_override=rank_override)
    else:
        search_file("usearch_global", query_path, db, on_query_done,
                    index=db_index)

    if dbhit:
        dbhit.on_all_done()
    for f in (f_b6, f_aln, f_uc, f_m, f_nm, f_fp, f_user, f_qseg, f_tseg,
              f_trim):
        if f:
            f.close()


def cmd_usearch_local(query_path: Optional[str]) -> None:
    """usearch_local: gapped local search with Karlin-Altschul E-values
    (src/searchcmd.cpp:42-45, src/makedbsearcher.cpp:87-127).  -evalue is
    required (oget_flt dies when unset); -id is optional for local."""
    o = options()
    if query_path is None:
        query_path = o.str("query")
    if not o.filled("evalue"):
        raise SystemExit("-evalue required for local search")
    db, db_index = load_db(o.str("db"))

    from .search.driver import search_file
    from .io.fastx import write_fasta

    f_b6 = open(o.str("blast6out"), "w") if o.filled("blast6out") else None
    f_m = open(o.str("matched"), "w") if o.filled("matched") else None
    f_nm = open(o.str("notmatched"), "w") if o.filled("notmatched") else None
    f_user = open(o.str("userout"), "w") if o.filled("userout") else None
    f_aln = open(o.str("alnout"), "w") if o.filled("alnout") else None
    if f_aln:
        from .out.alnout import write_program_header
        write_program_header(f_aln)
    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None

    def on_query_done(label, seq, hits):
        from .search.hitmgr import HitMgr
        hm = HitMgr()
        hm.hits = hits
        ordered = hm.sorted_hits()
        maxhits = o.uns("maxhits") if o.filled("maxhits") else 0
        if maxhits > 0:
            ordered = ordered[:maxhits]
        if f_aln:
            from .out.alnout import write_aln, write_query_report
            q_nucleo = (ordered[0].nucleo or bool(ordered[0].orf_frame)) \
                if ordered else db.get_is_nucleo()
            write_query_report(f_aln, label, ordered, local=True,
                               query_nucleo=q_nucleo,
                               target_nucleo=db.get_is_nucleo())
            for ar in ordered:
                write_aln(f_aln, ar)
        if f_b6:
            for ar in ordered:
                f_b6.write(blast6_line(ar))
            if not ordered and o.flag("output_no_hits"):
                f_b6.write(blast6_no_hits_line(label))
        if f_user:
            from .out.userout import user_out_lines
            for ar in ordered:
                f_user.write(user_out_lines(ar))
        if f_uc:
            from .out import uc as uc_mod
            for ar in ordered:
                f_uc.write(uc_mod.uc_hit_record(ar))
            if not ordered:
                f_uc.write(uc_mod.uc_no_hit_record(label, len(seq)))
        if ordered:
            if f_m:
                write_fasta(f_m, label, seq, o.uns("fasta_cols"))
        else:
            if f_nm:
                write_fasta(f_nm, label, seq, o.uns("fasta_cols"))

    search_file("usearch_local", query_path, db, on_query_done,
                index=db_index)

    for f in (f_b6, f_m, f_nm, f_user, f_aln, f_uc):
        if f:
            f.close()


def cmd_cluster_fast(input_path: Optional[str]) -> None:
    from .cluster.uclust import cluster_fast
    cluster_fast(input_path)


def cmd_cluster_smallmem(input_path: Optional[str]) -> None:
    from .cluster.uclust import cluster_smallmem
    cluster_smallmem(input_path)


def cmd_fastx_uniques(input_path: Optional[str]) -> None:
    from .cluster.derep import fastx_uniques
    fastx_uniques(input_path)


def cmd_unoise3(input_path: Optional[str]) -> None:
    from .amplicon.unoise import unoise3
    unoise3(input_path)


def cmd_uchime3_denovo(input_path: Optional[str]) -> None:
    from .amplicon.uchime import uchime3_denovo
    uchime3_denovo(input_path)


def cmd_sintax(input_path: Optional[str]) -> None:
    from .amplicon.sintax import sintax
    sintax(input_path)


def cmd_otutab(input_path: Optional[str]) -> None:
    # cmd_otutab per-command defaults (src/searchcmd.cpp:21-27)
    o = options()
    o.set_default("id", 0.97)
    o.set_default("maxaccepts", 3)
    o.set_default("maxrejects", 32)
    o.set_default("stepwords", 0)
    o.set_default("strand", "both")
    from .amplicon.otutab import otutab
    otutab(input_path)


def cmd_closed_ref(input_path: Optional[str]) -> None:
    # cmd_closed_ref per-command defaults (src/searchcmd.cpp:10-16)
    o = options()
    o.set_default("id", 0.97)
    o.set_default("stepwords", 0)
    from .amplicon.otutab import closed_ref
    closed_ref(input_path)


def cmd_fastq_filter(input_path: Optional[str]) -> None:
    from .fastq.filter import fastq_filter
    fastq_filter(input_path)


def cmd_fastq_mergepairs(input_path: Optional[str]) -> None:
    from .fastq.merge import fastq_mergepairs
    fastq_mergepairs(input_path)


def cmd_fastq_join(input_path: Optional[str]) -> None:
    from .fastq.join import fastq_join
    fastq_join(input_path)


def cmd_fastx_orient(input_path: Optional[str]) -> None:
    from .fastq.orient import fastx_orient
    fastx_orient(input_path)


def cmd_fastx_truncate(input_path: Optional[str]) -> None:
    from .fastq.filter import fastx_truncate
    fastx_truncate(input_path)


def cmd_makeudb_usearch(input_path: Optional[str]) -> None:
    from .index.udbfile import makeudb_usearch
    makeudb_usearch(input_path)


def cmd_fastx_get_sample_names(input_path: Optional[str]) -> None:
    from .amplicon.summary import fastx_get_sample_names
    fastx_get_sample_names(input_path)


def cmd_sintax_summary(input_path: Optional[str]) -> None:
    from .amplicon.summary import sintax_summary
    sintax_summary(input_path)


def cmd_fastq_filter2(input_path: Optional[str]) -> None:
    from .fastq.filter import fastq_filter2
    fastq_filter2(input_path)


def cmd_cluster_mt(input_path: Optional[str]) -> None:
    mesh = _mesh()
    if mesh is not None:
        # batch-synchronous greedy rounds with the U-counting matmul
        # sharded over the mesh ("data" x "db"); byte-identical to the
        # host path (src/clustermt.cpp:46-123 pending semantics)
        from .parallel.cluster_batch import cluster_mt_batched
        cluster_mt_batched(input_path, mesh=mesh)
        return
    from .cluster.uclust import cluster_mt
    cluster_mt(input_path)


def cmd_cluster_otus(input_path: Optional[str]) -> None:
    from .cluster.uparse import cluster_otus
    cluster_otus(input_path)


def cmd_udb2bitvec(input_path: Optional[str]) -> None:
    from .index.udbfile import udb2bitvec
    udb2bitvec(input_path)


def cmd_search_16s(input_path: Optional[str]) -> None:
    from .amplicon.gene16s import search_16s
    search_16s(input_path)


def cmd_test(_input_path: Optional[str]) -> None:
    """-test: x-drop alignment smoke test (src/xdropalignmem.cpp:336-364)."""
    import numpy as np
    from .alpha import to_bytes
    from .scoring import AlnParams, AlnHeuristics
    from .align.hsp import HSPFinder
    from .align.global_aligner import global_align
    a = to_bytes("SEQVENCE")
    b = to_bytes("SEQVECE")
    from .config import oset
    ap = AlnParams.from_cmdline(False)
    ah = AlnHeuristics.from_cmdline(ap)
    hf = HSPFinder(ap, ah)
    hf.set_a(a)
    hf.set_b(b)
    path = global_align(a, b, ap, ah, hf, fail_if_no_hsps=False)
    print(f"test: {path}")
