#!/usr/bin/env python3
"""Smoke run of the system's device paths on one GPU, through the CLI.

    python3 chip_smoke.py [--seed N] [--out FILE] [--four]

Run from the root of a checkout on a machine with an NVIDIA GPU.  Data is
generated from --seed; nothing is downloaded.  One JSON line per phase,
then the card's name and power limit, then the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase, or a JAX backend other than the GPU, exits non-zero
without the result line.

  A  search: usearch_global -id 0.97 -strand plus -blast6out of 10,000
     reads (1-3% divergence, indels) against 20,000 16S-like targets of
     ~1,450 nt; forced device (-engine_device -dev_batch_cells 1) with a
     cold and a warm compile cache, auto mode, and -no_engine_device.
     The blast6 bytes must agree; the forced runs must put cells on the
     device.
  B  DP kernel: 65,536 x 250 nt and 4,096 x 1,500 nt pairs through the
     device DP, every score and path equal to C nw_band's; Gcells/s of
     each forward formulation (lax, cuda) and of forward + traceback.
  C  SINTAX: -sintax_device against -no_sintax_device, 5,000 queries,
     20,000-target taxonomy DB; -tabbedout bytes must agree.
  D  device ranking: usearch_global -device_rank against the host ranker
     on a 60,000 x 250 nt DB (below -big); blast6 bytes must agree.

--four runs only the -mesh path on four GPUs: usearch_global -mesh 4
(500 reads against 5,000 of the 16S-like targets) and cluster_mt -mesh 4
(1,000 reads), each compared byte for byte with -mesh 1, with the peak
memory in use on each card.

Each phase runs in a process of its own, one at a time: a JAX process
reserves most of a card's memory, so this parent never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASES = np.frombuffer(b"ACGT", np.uint8)
PHASE_TIMEOUT = 900


# ---------------------------------------------------------------------------
# data

def _mutate(rng, s: np.ndarray, sub_rate: float, n_indels: int,
            where=None) -> np.ndarray:
    """Substitutions at sub_rate, then n_indels indels of 1-3 nt, at
    positions drawn from `where` (default: anywhere)."""
    s = s.copy()
    hit = rng.random(len(s)) < sub_rate
    s[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    for _ in range(n_indels):
        pos = (int(rng.choice(where)) if where is not None
               else int(rng.integers(0, len(s))))
        pos = min(pos, len(s) - 1)
        k = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            s = np.delete(s, slice(pos, pos + k))
        else:
            s = np.insert(s, pos, BASES[rng.integers(0, 4, k)])
    return s


def make_16s(rng, n_targets: int, length: int = 1450,
             per_genus: int = 10):
    """16S-like targets: ten conserved regions shared by all, nine
    variable regions (V1-V9, ~40% of the length) drawn per genus, then
    per target 0.5% substitutions in conserved and 5% in variable
    positions and up to three indels in variable regions.  Returns
    (sequences, genus index per target)."""
    var = np.zeros(length, bool)
    bounds = np.linspace(0, length, 20).astype(int)
    for k in range(9):
        var[bounds[2 * k + 1]:bounds[2 * k + 2]] = True
    var_pos = np.nonzero(var)[0]
    root = BASES[rng.integers(0, 4, length)]
    n_genera = -(-n_targets // per_genus)
    seqs, genus = [], []
    for g in range(n_genera):
        tpl = root.copy()
        tpl[var] = BASES[rng.integers(0, 4, int(var.sum()))]
        for _ in range(min(per_genus, n_targets - len(seqs))):
            t = tpl.copy()
            rate = np.where(var, 0.05, 0.005)
            hit = rng.random(length) < rate
            t[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
            t = _mutate(rng, t, 0.0, int(rng.integers(0, 4)), var_pos)
            seqs.append(t)
            genus.append(g)
    return seqs, np.array(genus)


def make_reads(rng, seqs, n: int):
    """Reads of random targets at 1-3% substitutions plus 1-4 indels."""
    src = rng.integers(0, len(seqs), n)
    return [_mutate(rng, seqs[i], float(rng.uniform(0.01, 0.03)),
                    int(rng.integers(1, 5))) for i in src]


def make_amplicon_db(rng, n_targets: int, length: int = 250,
                     per_template: int = 20):
    """Random templates, per_template variants each at 3% divergence."""
    seqs = []
    while len(seqs) < n_targets:
        tpl = BASES[rng.integers(0, 4, length)]
        for _ in range(min(per_template, n_targets - len(seqs))):
            seqs.append(_mutate(rng, tpl, 0.03, int(rng.integers(0, 2))))
    return seqs


def write_fasta(path: str, labels, seqs) -> None:
    with open(path, "w") as f:
        f.write("".join(f">{lab}\n{s.tobytes().decode()}\n"
                        for lab, s in zip(labels, seqs)))


def tax_labels(genus):
    """SINTAX labels: species = target, genus, and ranks above it."""
    out = []
    for i, g in enumerate(genus):
        g = int(g)
        out.append(f"t{i};tax=d:Bacteria,p:P{g // 1000},c:C{g // 300},"
                   f"o:O{g // 100},f:F{g // 20},g:G{g},s:S{i};")
    return out


# ---------------------------------------------------------------------------
# running

def _env(stats: str = None, extra: dict = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    if stats:
        env["USEARCH_DEVICE_STATS"] = stats
    env.update(extra or {})
    return env


def run_cli(args, stats: str = None, extra: dict = None) -> dict:
    """One CLI process; returns its wall time and dev_stats records."""
    if stats and os.path.exists(stats):
        os.unlink(stats)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "usearch12_tpu.cli"] + args,
                       cwd=HERE, env=_env(stats, extra), capture_output=True,
                       text=True, timeout=PHASE_TIMEOUT)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(args[:2])} exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    recs = []
    if stats and os.path.exists(stats):
        with open(stats) as f:
            recs = [json.loads(x) for x in f if x.strip()]
    return {"wall_s": wall, "stats": recs}


def same_bytes(*paths) -> bool:
    data = [open(p, "rb").read() for p in paths]
    return all(d == data[0] for d in data) and len(data[0]) > 0


def cache_entries() -> int:
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        HERE, ".jax_cache")
    return len(os.listdir(d)) if os.path.isdir(d) else 0


def phase_a(work: str, seed: int) -> dict:
    db, q = os.path.join(work, "db16s.fa"), os.path.join(work, "q16s.fa")
    base = ["-usearch_global", q, "-db", db, "-id", "0.97", "-strand",
            "plus", "-quiet"]
    stats = os.path.join(work, "a_stats.jsonl")
    out = {"phase": "A", "cache_entries_at_start": cache_entries()}
    legs = [("forced_cold", ["-engine_device", "-dev_batch_cells", "1"]),
            ("forced_warm", ["-engine_device", "-dev_batch_cells", "1"]),
            ("auto", []), ("host", ["-no_engine_device"])]
    b6 = {}
    for name, extra in legs:
        b6[name] = os.path.join(work, f"a_{name}.b6")
        out[name] = run_cli(base + extra + ["-blast6out", b6[name]], stats)
    forced = out["forced_cold"]["stats"][0]
    out["hits"] = sum(1 for _ in open(b6["host"]))
    out["parity"] = same_bytes(*b6.values())
    out["ok"] = out["parity"] and forced["device_cells"] > 0
    return out


def phase_b(work: str, seed: int) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", "kernel", "--seed", str(seed)],
                       cwd=HERE, env=_env(), capture_output=True, text=True,
                       timeout=PHASE_TIMEOUT)
    if r.returncode != 0:
        raise RuntimeError(f"kernel worker exited {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["ok"] = all(c["exact"] for c in out["cases"])
    return out


def phase_c(work: str, seed: int) -> dict:
    db, q = os.path.join(work, "db16s.fa"), os.path.join(work, "q_sintax.fa")
    base = ["-sintax", q, "-db", db, "-strand", "both", "-randseed", "1",
            "-quiet"]
    stats = os.path.join(work, "c_stats.jsonl")
    d_out, h_out = (os.path.join(work, f"c_{k}.tab") for k in "dh")
    out = {"phase": "C"}
    out["device"] = run_cli(base + ["-sintax_device", "-tabbedout", d_out],
                            stats)
    out["host"] = run_cli(base + ["-no_sintax_device", "-tabbedout", h_out],
                          stats)
    out["parity"] = same_bytes(d_out, h_out)
    out["ok"] = out["parity"] and out["device"]["stats"][0]["device"]
    return out


def phase_d(work: str, seed: int) -> dict:
    db, q = os.path.join(work, "db250.fa"), os.path.join(work, "q250.fa")
    base = ["-usearch_global", q, "-db", db, "-id", "0.97", "-strand",
            "plus", "-quiet", "-no_engine_device"]
    stats = os.path.join(work, "d_stats.jsonl")
    d_b6, h_b6 = (os.path.join(work, f"d_{k}.b6") for k in "dh")
    out = {"phase": "D"}
    out["device_rank"] = run_cli(base + ["-device_rank", "-blast6out", d_b6],
                                 stats)
    out["host_rank"] = run_cli(base + ["-blast6out", h_b6], stats)
    out["parity"] = same_bytes(d_b6, h_b6)
    rec = out["device_rank"]["stats"][0]
    out["ok"] = (out["parity"] and rec["rank_device_jobs"] > 0
                 and rec["rank_host_jobs"] < rec["rank_device_jobs"])
    return out


def phase_four(work: str, seed: int) -> dict:
    """-mesh 4 against -mesh 1, with each card's peak memory in use."""
    db, q = os.path.join(work, "db16s.fa"), os.path.join(work, "q_mesh.fa")
    reads = os.path.join(work, "cluster.fa")
    # no up-front reservation, so memory.used shows what each card holds
    extra = {"XLA_PYTHON_CLIENT_PREALLOCATE": "false"}
    out = {"phase": "four"}
    legs = {}
    for n in (4, 1):
        g = os.path.join(work, f"m{n}.b6")
        uc = os.path.join(work, f"m{n}.uc")
        with MemorySampler() as mem:
            legs[f"search_mesh{n}"] = run_cli(
                ["-usearch_global", q, "-db", db, "-id", "0.97", "-strand",
                 "plus", "-quiet", "-mesh", str(n), "-blast6out", g],
                extra=extra)
        legs[f"search_mesh{n}"]["peak_mib_per_card"] = mem.peak
        with MemorySampler() as mem:
            legs[f"cluster_mesh{n}"] = run_cli(
                ["-cluster_mt", reads, "-id", "0.97", "-quiet", "-mesh",
                 str(n), "-uc", uc], extra=extra)
        legs[f"cluster_mesh{n}"]["peak_mib_per_card"] = mem.peak
    out.update(legs)
    out["search_parity"] = same_bytes(*(os.path.join(work, f"m{n}.b6")
                                        for n in (4, 1)))
    out["cluster_parity"] = same_bytes(*(os.path.join(work, f"m{n}.uc")
                                         for n in (4, 1)))
    out["ok"] = out["search_parity"] and out["cluster_parity"]
    return out


class MemorySampler:
    """Peak memory.used per card from nvidia-smi, sampled every 0.2 s
    while a phase runs (a thread of this parent, which stays off JAX)."""

    def __enter__(self):
        self.peak = {}
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=index,memory.used",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True)
            for line in r.stdout.strip().splitlines():
                i, m = (int(x) for x in line.split(","))
                self.peak[i] = max(self.peak.get(i, 0), m)
            self._stop.wait(0.2)

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()


# ---------------------------------------------------------------------------
# phase B worker (runs in its own process: imports JAX)

def kernel_worker(seed: int, sizes=((65536, 250), (4096, 1500)),
                  kernels=("lax", "cuda"), require_gpu: bool = True) -> None:
    import jax
    import jax.numpy as jnp
    from usearch12_tpu.native import nw_band
    from usearch12_tpu.ops import wavefront_nw as wnw
    from usearch12_tpu.scoring import AlnParams
    from usearch12_tpu.config import reset_options
    if require_gpu and jax.default_backend() != "gpu":
        raise SystemExit("phase B needs the GPU")
    reset_options()
    ap = AlnParams.from_cmdline(True)
    rng = np.random.default_rng(seed + 2)
    radius = 16
    cases = []
    for n, length in sizes:
        t0 = time.perf_counter()
        pairs = []
        for _ in range(n):
            a = BASES[rng.integers(0, 4, length)]
            pairs.append((a, _mutate(rng, a, 0.02, int(rng.integers(0, 3)))))
        geo = wnw.WaveAligner.geometry(pairs, radius)
        cells = int((np.minimum(geo[0], geo[1]).astype(np.int64)
                     * (2 * radius + 1)).sum())
        case = {"pairs": n, "length": length, "cells": cells,
                "gen_s": time.perf_counter() - t0, "kernels": {}}
        ref = []
        t0 = time.perf_counter()
        for (a, b), d0, d1 in zip(pairs, geo[2], geo[2] + geo[3] - 1):
            ref.append(nw_band(a, b, int(d0), int(d1), ap))
        case["c_nw_band_s"] = time.perf_counter() - t0
        exact = True
        for kernel in kernels:
            wa = wnw.WaveAligner(ap, kernel=kernel)
            plan = wa.plan(geo)
            k = {"launches": len(plan)}
            t0 = time.perf_counter()
            scores, paths = wa.align(pairs, radius)
            k["first_align_s"] = time.perf_counter() - t0
            k["mismatches"] = sum(
                1 for (s, p), sc, pa in zip(ref, scores, paths)
                if np.float32(s) != sc or p != pa)
            exact &= k["mismatches"] == 0
            # device time of the forward pass alone and of forward +
            # traceback, warm, best of three
            fw, full = [], []
            for idx, L, P, W in plan:
                launch = wnw.Launch([pairs[i] for i in idx], geo[:, idx],
                                    np.full(len(idx), 15), L, P, W, ap)
                fwd, tbk = wnw._launch_fn(L, P, W, kernel)
                args = [jnp.asarray(x) for x in (launch.a, launch.b,
                                                 launch.geo, launch.term,
                                                 launch.scal)]
                n_run = jnp.int32(-(-launch.n_run // 8))
                n_ops = jnp.int32(launch.n_run)
                tf, tt = [], []
                for _ in range(3):
                    t0 = time.perf_counter()
                    tb, fin = fwd(*args, n_run)
                    jax.block_until_ready((tb, fin))
                    t1 = time.perf_counter()
                    jax.block_until_ready(tbk(tb, args[2], fin, n_ops))
                    t2 = time.perf_counter()
                    tf.append(t1 - t0)
                    tt.append(t2 - t0)
                fw.append(min(tf))
                full.append(min(tt))
            k["forward_s"] = sum(fw)
            k["forward_gcells_s"] = cells / sum(fw) / 1e9
            k["fwd_traceback_s"] = sum(full)
            k["fwd_traceback_gcells_s"] = cells / sum(full) / 1e9
            case["kernels"][kernel] = k
        case["exact"] = exact
        cases.append(case)
    print(json.dumps({"phase": "B", "cases": cases}))


# ---------------------------------------------------------------------------

def device_info() -> dict:
    """platform, device_kind and count as JAX reports them (in a child:
    this process stays off the card)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import json, jax; d = jax.devices(); print(json.dumps({"
         "'platform': d[0].platform, 'kind': d[0].device_kind, "
         "'count': len(d)}))"],
        cwd=HERE, env=_env(), capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise SystemExit("JAX found no device: " + r.stderr[-1000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def generate(work: str, seed: int, four: bool, scale: float = 1.0) -> None:
    """The phases' FASTA files; scale < 1 shrinks every count (for a
    rehearsal on the CPU, which this script itself refuses)."""
    def n(x):
        return max(8, int(x * scale))

    rng = np.random.default_rng(seed)
    seqs, genus = make_16s(rng, n(5000 if four else 20000))
    write_fasta(os.path.join(work, "db16s.fa"), tax_labels(genus), seqs)
    if four:
        reads = make_reads(rng, seqs, n(500))
        write_fasta(os.path.join(work, "q_mesh.fa"),
                    [f"q{i}" for i in range(len(reads))], reads)
        tpl, _g = make_16s(rng, n(100))
        cl = make_reads(rng, tpl, n(1000))
        write_fasta(os.path.join(work, "cluster.fa"),
                    [f"r{i}" for i in range(len(cl))], cl)
        return
    reads = make_reads(rng, seqs, n(10000))
    write_fasta(os.path.join(work, "q16s.fa"),
                [f"q{i}" for i in range(len(reads))], reads)
    write_fasta(os.path.join(work, "q_sintax.fa"),
                [f"q{i}" for i in range(n(5000))], reads[:n(5000)])
    amp = make_amplicon_db(rng, n(60000))
    write_fasta(os.path.join(work, "db250.fa"),
                [f"a{i}" for i in range(len(amp))], amp)
    q = make_reads(rng, amp, n(2000))
    write_fasta(os.path.join(work, "q250.fa"),
                [f"q{i}" for i in range(len(q))], q)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four", action="store_true",
                    help="run only the -mesh path on four GPUs")
    ap.add_argument("--out", help="also append the phase lines here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.worker == "kernel":
        kernel_worker(args.seed)
        return 0
    import usearch12_tpu  # noqa: F401  (fails outside a checkout)

    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"JAX backend is {dev['platform']!r}, not the GPU",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if dev["count"] < need:
        print(f"needs {need} GPUs, JAX sees {dev['count']}", file=sys.stderr)
        return 1
    card = card_line()
    work = os.path.join(HERE, ".smoke_work")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    generate(work, args.seed, args.four)
    print(json.dumps({"phase": "data", "gen_s": time.perf_counter() - t0}),
          flush=True)
    phases = [phase_four] if args.four else [phase_a, phase_b, phase_c,
                                             phase_d]
    ok = True
    for fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(work, args.seed)
        except Exception as e:
            res = {"phase": fn.__name__, "ok": False, "error": repr(e)[-3000:]}
        res["card"] = card
        res["phase_s"] = time.perf_counter() - t0
        ok &= bool(res["ok"])
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(card)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
