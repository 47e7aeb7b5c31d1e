"""The one device gate (device.py), the compile-cache location, and what
the CLI records or refuses around it, on XLA's CPU backend."""

import json

import numpy as np
import pytest

from usearch12_tpu import device
from usearch12_tpu.cli import main as cli_main

CONV = np.frombuffer(b"ACGT", np.uint8)


def test_gate_auto_stays_off_on_cpu():
    assert device.backend() == "cpu"
    assert device.gate("engine_device", False) == "backend cpu"


@pytest.mark.parametrize("platforms,ok", [("cpu", True), ("", False),
                                          ("cuda,cpu", False)])
def test_gate_forced_needs_gpu_or_explicit_cpu(monkeypatch, platforms, ok):
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if ok:
        assert device.gate("engine_device", True) is None
    else:
        with pytest.raises(SystemExit, match="needs a GPU"):
            device.gate("engine_device", True)


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compile_cache_dir(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR wins; else one fixed in-checkout path."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert device.compile_cache_dir() == device.CACHE_DIR
        assert device.CACHE_DIR.startswith(device.REPO_ROOT)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert device.compile_cache_dir() == env


def _db_and_queries(tmp_path, n_t=20, n_q=8, length=150):
    rng = np.random.default_rng(4)
    tpls = [CONV[rng.integers(0, 4, length)] for _ in range(n_t)]
    db, q = tmp_path / "db.fa", tmp_path / "q.fa"
    db.write_text("".join(f">t{k}\n{t.tobytes().decode()}\n"
                          for k, t in enumerate(tpls)))
    with open(q, "w") as f:
        for k in range(n_q):
            s = tpls[k % n_t].copy()
            s[rng.integers(0, length, 4)] = CONV[rng.integers(0, 4, 4)]
            # a diverged stretch leaves a hole for the batched DP
            mid = length // 2
            s[mid:mid + length // 8] = CONV[rng.integers(0, 4,
                                                         length // 8)]
            f.write(f">q{k}\n{s.tobytes().decode()}\n")
    return str(db), str(q)


@pytest.mark.parametrize("probe_s,reason", [
    (1.0, "no hole batch with 1 s of host work"),
    (0.0, "backend cpu")])
def test_auto_mode_records_why_device_is_off(tmp_path, monkeypatch,
                                             probe_s, reason):
    """Auto mode meets the gate only for a batch worth a device run;
    either way the stats record and the -log say why the DP stayed on
    the host."""
    from usearch12_tpu.engine.batch import DevicePerfModel
    monkeypatch.setattr(DevicePerfModel, "PROBE_HOST_S", probe_s)
    db, q = _db_and_queries(tmp_path, length=800)
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    log = tmp_path / "run.log"
    assert cli_main(["-usearch_global", q, "-db", db, "-id", "0.8",
                     "-strand", "plus", "-blast6out",
                     str(tmp_path / "o.b6"), "-quiet", "-log",
                     str(log)]) == 0
    rec = json.loads(stats.read_text())
    assert rec["device"] is False and rec["reason"] == reason
    assert f"device DP off ({reason})" in log.read_text()


def test_device_rank_refuses_above_big(tmp_path):
    db, q = _db_and_queries(tmp_path)
    with pytest.raises(SystemExit, match="above -big 10"):
        cli_main(["-usearch_global", q, "-db", db, "-id", "0.9",
                  "-strand", "plus", "-blast6out", str(tmp_path / "o.b6"),
                  "-quiet", "-device_rank", "-big", "10"])


def test_device_rank_below_big_matches_host(tmp_path):
    db, q = _db_and_queries(tmp_path)
    base = ["-usearch_global", q, "-db", db, "-id", "0.9", "-strand",
            "plus", "-quiet"]
    assert cli_main(base + ["-blast6out", str(tmp_path / "d.b6"),
                            "-device_rank"]) == 0
    assert cli_main(base + ["-blast6out", str(tmp_path / "h.b6")]) == 0
    d = (tmp_path / "d.b6").read_text()
    assert d and d == (tmp_path / "h.b6").read_text()
