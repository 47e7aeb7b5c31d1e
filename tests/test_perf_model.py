"""DevicePerfModel: the self-tuning host-vs-device dispatch gate must
converge out of a polluted state within a few observations, start with
no device prediction and calibrate itself with probes, and retire
constants learned under another kernel architecture or on another
device kind (the gate must reach device-wins without hand-forcing)."""

import json

import pytest

from usearch12_tpu.engine.batch import MODEL_VERSION, DevicePerfModel


@pytest.fixture
def model(tmp_path, monkeypatch):
    monkeypatch.setattr(DevicePerfModel, "CACHE",
                        str(tmp_path / "perf.json"))
    return DevicePerfModel("testplat", "kindA")


def test_versioned_cache_key_retires_stale_constants(tmp_path,
                                                     monkeypatch):
    cache = tmp_path / "perf.json"
    # constants learned under an old kernel architecture (unversioned
    # key) and on another device kind (current version)
    stale = {"host_rate": 2.4e7, "rtt": 10.7, "up_bw": 2.3e5,
             "dn_bw": 5.6e4, "dev_rate": 1.4e8, "warm_tax": 71.0,
             "n_obs": 9}
    cache.write_text(json.dumps({
        "testplat": stale, f"testplat/kindB/v{MODEL_VERSION}": stale}))
    monkeypatch.setattr(DevicePerfModel, "CACHE", str(cache))
    m = DevicePerfModel("testplat", "kindA")
    # neither entry is loaded: the device terms stay unknown
    assert m.rtt < 1.0 and m.dn_bw > 1e6 and m.n_obs == 0
    assert not m.device_wins(10 ** 9, 0, 0, dispatches_left=1)
    assert m.key == f"testplat/kindA/v{MODEL_VERSION}"
    m.save()
    d = json.loads(cache.read_text())
    assert f"testplat/kindA/v{MODEL_VERSION}" in d
    assert "n_obs" in d[f"testplat/kindA/v{MODEL_VERSION}"]
    assert DevicePerfModel("testplat", "kindB").n_obs == 9


def test_geometric_correction_converges_fast(model):
    """Pollute the model to pointer-chase-era pessimism, then feed it
    the cursor-chase reality (59M cells in 0.5s, tiny transfers); the
    gate must flip to device-wins within 6 observations."""
    m = model
    m.rtt, m.up_bw, m.dn_bw, m.dev_rate = 10.7, 2.3e5, 5.6e4, 1.4e8
    m.host_rate = 2.4e7
    m.n_obs = 2     # learned (if wrongly), so the model predicts
    m.warm = True   # past the first-dispatch warm-tax branch
    cells, up, dn = 59_000_000, 3_000_000, 750_000
    flipped_at = None
    for k in range(12):
        if m.device_wins(cells, up, dn, dispatches_left=10):
            flipped_at = k
            break
        m.observe_dev(cells, up, dn, secs=0.5)
    assert flipped_at is not None and flipped_at <= 6, flipped_at
    # steady state: repeated consistent observations keep it stable
    for _ in range(5):
        m.observe_dev(cells, up, dn, secs=0.5)
    assert m.device_wins(cells, up, dn, dispatches_left=10)


def test_probe_fires_once_and_only_on_big_workloads(model):
    m = model
    m.warm = True
    # cold model, zero steady observations -> probe on a big window
    big = int(m.host_rate * 3)     # ~3s of host work
    small = int(m.host_rate * 0.2)  # 0.2s of host work: never probe
    assert not m.should_probe(small)
    assert m.should_probe(big)
    assert not m.should_probe(big)   # one-shot per process
    # an observation re-arms the probe until two steady ones exist
    m.observe_dev(big, 1000, 1000, secs=1.0)
    assert m.n_obs == 1 and m.should_probe(big)
    # once >=2 steady observations exist, no probing even fresh
    m2 = DevicePerfModel("testplat", "kindA")
    m2.n_obs = 2
    assert not m2.should_probe(big)


def test_observe_counts_persist(model):
    m = model
    m.warm = True
    m.observe_dev(1_000_000, 1000, 1000, secs=0.01)
    m.observe_dev(1_000_000, 1000, 1000, secs=0.01)
    m.save()
    m2 = DevicePerfModel("testplat", "kindA")
    assert m2.n_obs == 2
    # the first steady observation set the rate from the wall time
    assert m2.dev_rate == pytest.approx(1e8)
