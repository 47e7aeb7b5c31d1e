"""Wide-hole split in the batch engine: holes whose band is wider than
the device frame (wavefront_nw.MAX_LANES) route to the host kernel while
the rest dispatch to the device, the re-interleaved paths must equal the
host-only run, and dev_stats counts both.

Runs the engine with -engine_device on XLA's CPU backend; the workload
mixes one very length-asymmetric pair (query middle much longer than
target middle -> hole band above the frame) with normal equal-length
pairs.
"""

import json

import numpy as np

from usearch12_tpu.cli import main as cli_main


def _write(path, recs):
    with open(path, "w") as f:
        for label, seq in recs:
            f.write(f">{label}\n{seq.tobytes().decode()}\n")


def test_wide_hole_split_parity(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pre = conv[rng.integers(0, 4, 300)]
    suf = conv[rng.integers(0, 4, 300)]

    def seq(mid_len, seed):
        r = np.random.default_rng(seed)
        return np.concatenate([pre, conv[r.integers(0, 4, mid_len)], suf])

    # target: short middle; queries: one with a much longer middle
    # (hole band = |600-120| + 33 = 513: 258 lanes > MAX_LANES) + normal
    # ones
    targets = [("t0", seq(120, 1)), ("t1", seq(120, 2))]
    queries = [("qwide", seq(600, 3)),
               ("q1", seq(120, 4)), ("q2", seq(120, 5)),
               ("q3", seq(124, 6))]
    db_fa = str(tmp_path / "db.fa")
    q_fa = str(tmp_path / "q.fa")
    _write(db_fa, targets)
    _write(q_fa, queries)

    base = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.3",
            "-strand", "plus", "-gaforce", "-quiet"]
    d_b6 = str(tmp_path / "d.b6")
    h_b6 = str(tmp_path / "h.b6")
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    # static gate forces every hole batch at the device split logic
    assert cli_main(base + ["-blast6out", d_b6, "-engine_device",
                            "-dev_batch_cells", "1"]) == 0
    assert cli_main(base + ["-blast6out", h_b6,
                            "-no_engine_device"]) == 0
    d = open(d_b6).read()
    assert d == open(h_b6).read()
    assert "qwide" in d, "wide-hole query produced no hit - vacuous test"
    dev, host = (json.loads(x) for x in stats.read_text().splitlines())
    assert dev["device"] and dev["device_cells"] > 0
    assert dev["wide_holes"] >= 1 and dev["host_cells"] > 0
    assert not host["device"] and host["reason"] == "off"
