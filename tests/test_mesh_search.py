"""Mesh-sharded search semantics on the virtual 8-device CPU mesh:
the device ranking (matmul counting + prefix-max SetTopBump + lexicographic
count-sort merge) must reproduce the host candidate lists exactly, and
the end-to-end blast6 bytes must equal the host engine's."""

import numpy as np
import pytest

from usearch12_tpu.cli import parse_argv


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from genseqs import make_amplicons, write_fasta
    d = tmp_path_factory.mktemp("mesh")
    recs = make_amplicons(n_templates=60, reads_per_template=4,
                          length=220, seed=19)
    db_fa = str(d / "db.fa")
    q_fa = str(d / "q.fa")
    write_fasta(db_fa, [r for r in recs if r[0].startswith("tpl")])
    write_fasta(q_fa, [r for r in recs if not r[0].startswith("tpl")])
    return db_fa, q_fa, str(d)


def _mesh():
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices())
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(devs[:8].reshape(2, 4), ("data", "db"))


def test_mesh_rank_exact(small_db):
    db_fa, q_fa, d = small_db
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                "-strand", "plus", "-quiet"])
    from usearch12_tpu.io.seqdb import SeqDB
    from usearch12_tpu.io.fastx import read_fastx
    from usearch12_tpu.engine.batch import BatchEngine
    from usearch12_tpu.parallel.mesh_search import MeshRanker
    from usearch12_tpu.search.usorted import USortedRanker
    mesh = _mesh()
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    eng = BatchEngine("usearch_global", db)
    mr = MeshRanker(mesh, eng.index, topk=32)
    ur = USortedRanker(eng.index)
    recs = list(read_fastx(q_fa, stream=True))
    jbuf = np.ascontiguousarray(np.concatenate([s for _l, s, _q in recs]))
    j_off = np.zeros(len(recs) + 1, np.int64)
    np.cumsum([len(s) for _l, s, _q in recs], out=j_off[1:])
    cand, cnts, out_n, unc = mr.rank_window(jbuf, j_off)
    for i, (_l, s, _q) in enumerate(recs):
        tix, c = ur.rank(s)
        exp_n = min(len(tix), 32)
        assert out_n[i] == exp_n, (i, out_n[i], exp_n)
        assert np.array_equal(tix[:exp_n], cand[i][:exp_n]), i
        assert np.array_equal(c[:exp_n], cnts[i][:exp_n]), i


def test_mesh_blast6_byte_parity(small_db):
    db_fa, q_fa, d = small_db
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                "-strand", "both", "-quiet"])
    from usearch12_tpu.io.seqdb import SeqDB
    from usearch12_tpu.engine.batch import BatchEngine
    from usearch12_tpu.engine.emit import Blast6Emitter
    from usearch12_tpu.parallel.mesh_search import mesh_search_file
    mesh = _mesh()
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    mesh_b6 = f"{d}/mesh.b6"
    host_b6 = f"{d}/host.b6"
    # topk=64 >= maxaccepts+maxrejects (33): capacity fallback is
    # impossible by design, so assert none fired
    with open(mesh_b6, "w") as f:
        em = Blast6Emitter(f, db, False)
        stats = mesh_search_file(q_fa, db, mesh, lambda *a: None,
                                 fast_emit=em.emit, window=64, topk=64)
    with open(host_b6, "w") as f:
        em2 = Blast6Emitter(f, db, False)
        eng = BatchEngine("usearch_global", db)
        eng.run_file(q_fa, lambda *a: None, fast_emit=em2.emit)
    assert stats["fallbacks"] == 0
    assert open(mesh_b6).read() == open(host_b6).read()
    # topk=32 < 33: the capacity edge CAN fire; the host re-rank
    # fallback must still give byte parity
    small_b6 = f"{d}/mesh_small.b6"
    with open(small_b6, "w") as f:
        em3 = Blast6Emitter(f, db, False)
        stats2 = mesh_search_file(q_fa, db, mesh, lambda *a: None,
                                  fast_emit=em3.emit, window=64, topk=32)
    assert open(small_b6).read() == open(host_b6).read()


@pytest.mark.parametrize("n_seqs", [1, 3, 8])
def test_mesh_ucounter_pads_odd_batches(small_db, n_seqs):
    """cluster_mt's sharded U counting pads a query batch to the "data"
    axis and returns exactly the rows asked for, equal to one device."""
    db_fa, q_fa, _d = small_db
    parse_argv(["-cluster_mt", q_fa, "-id", "0.9", "-quiet"])
    from usearch12_tpu.io.seqdb import SeqDB
    from usearch12_tpu.index.udb import UDBIndex
    from usearch12_tpu.parallel.cluster_batch import DeviceUCounter
    db = SeqDB.from_fastx(db_fa)
    index = UDBIndex.from_seqdb(db)
    index._flatten()
    seqs = SeqDB.from_fastx(q_fa).seqs[:n_seqs]
    counts = []
    for mesh in (_mesh(), None):
        c = DeviceUCounter(mesh)
        c.refresh(index)
        counts.append(c.count(index, seqs))
    assert counts[0].shape == (n_seqs, index.seq_count)
    assert np.array_equal(counts[0], counts[1])
