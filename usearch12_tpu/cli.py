"""usearch-compatible command line driver.

Invocation mirrors the reference (src/usearch_main.cpp, src/getcmd.cpp):
    usearch12_tpu -usearch_global q.fa -db db.fa -id 0.97 -blast6out out.b6
The first -flag that names a command selects it; all other -flag [value]
pairs populate the option registry.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .config import reset_options, options

COMMANDS = [
    "cluster_fast", "cluster_otus", "cluster_smallmem", "cluster_mt",
    "closed_ref", "fastq_filter", "fastq_filter2", "fastq_join",
    "fastq_mergepairs", "fastx_orient", "fastx_uniques", "fastx_truncate",
    "fastx_get_sample_names", "makeudb_usearch", "sintax_summary",
    "uchime3_denovo", "unoise3", "usearch_global", "usearch_local",
    "sintax", "otutab", "search_16s", "udb2bitvec", "test", "version",
]

_FLAG_OPTS_NO_VALUE = {
    "quiet", "self", "notself", "selfid", "gaforce", "fulldp", "quicksort",
    "top_hit_only", "top_hits_only", "output_no_hits", "show_termgaps",
    "hardmask", "sizein",
    "sizeout", "fastq_eeout", "fastq_nostagger",
    "interleaved", "uc_hitsonly", "trunclabels",
    "maxskew", "tov", "log_objmgr_stats", "log_touched_opts",
    "no_progress", "version",
    "use_cpu_oracle", "notrunclabels", "orf_plusonly",
    "engine_device", "no_engine_device", "use_serial_driver", "device_rank",
    "no_device_rank", "sintax_device", "no_sintax_device",
    "ignore_label_mismatches", "fastq_forceq", "fastq_noguess", "keepgaps",
}


def parse_argv(argv: List[str]):
    """Returns (cmd, cmd_arg) and fills the option registry."""
    opts = reset_options()
    opts.argv = list(argv)      # for PrintCmdLine-style file banners
    cmd = None
    cmd_arg = None
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise SystemExit(f"Expected -flag, got '{tok}'")
        name = tok.lstrip("-")
        if name in COMMANDS:
            if cmd is not None:
                raise SystemExit(f"Two commands: {cmd}, {name}")
            cmd = name
            # command flag takes the input filename as its value (if any)
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                cmd_arg = argv[i + 1]
                i += 1
        elif name in _FLAG_OPTS_NO_VALUE:
            opts.declare(name, "flag", False)
            opts.set(name, True)
        else:
            # strict registry like the reference's MyCmdLine
            # (src/opts.cpp): options not in the o_*.h lists (plus our
            # documented extensions) are rejected
            if not opts.known(name):
                raise SystemExit(f"Unknown command-line option -{name}")
            if i + 1 >= len(argv):
                raise SystemExit(f"Command line error, missing value for '{name}'")
            val = argv[i + 1]
            opts.declare(name, "str")
            opts.set(name, val)
            i += 1
        i += 1
    return cmd, cmd_arg


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cmd, cmd_arg = parse_argv(argv)
    if cmd is None:
        print("No command given", file=sys.stderr)
        return 1
    if cmd == "version":
        from . import __version__
        print(f"usearch12_tpu v{__version__}")
        return 0
    from . import commands
    fn = getattr(commands, f"cmd_{cmd}", None)
    if fn is None:
        print(f"Command -{cmd} not implemented yet", file=sys.stderr)
        return 2

    # -log: run header + end-of-run elapsed/RAM summary (the reference's
    # SetLogFileName / LogElapsedTimeAndRAM, src/myutils.cpp:843,1451)
    f_log = None
    t0 = None
    if options().filled("log"):
        import time as _time
        from . import __version__
        f_log = open(options().str("log"), "w")
        f_log.write(" ".join(["usearch12_tpu"] + argv) + "\n")
        f_log.write(f"usearch12_tpu v{__version__}\n\n")
        f_log.write(_time.strftime("Started %a %b %d %H:%M:%S %Y\n\n"))
        t0 = _time.time()

    # -xprof DIR: JAX profiler trace around the whole command (SURVEY
    # §5.1 — the device-side counterpart of the reference's TRACE dumps
    # and mymutex profiler); view with xprof/tensorboard.
    xprof = options().str("xprof") if options().filled("xprof") else None
    if xprof:
        import jax
        jax.profiler.start_trace(xprof)
    try:
        fn(cmd_arg)
    finally:
        if xprof:
            import jax
            jax.profiler.stop_trace()

    # global options are always "used" (read by the harness itself)
    options().flag("quiet")
    if options().filled("threads"):
        options().uns("threads")
    unused = options().unused_filled()
    if unused and not options().flag("quiet"):
        for u in unused:
            print(f"WARNING: Option -{u} not used", file=sys.stderr)
    if f_log is not None:
        import time as _time
        import resource
        secs = _time.time() - t0
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        if unused:
            f_log.write("WARNING: Option(s) set but not used: "
                        + " ".join(f"-{u}" for u in unused) + "\n")
        from . import runlog
        for line in runlog.drain():
            f_log.write(line + "\n")
        f_log.write(f"\nElapsed time {secs:.2f} secs\n")
        f_log.write(f"Peak memory {peak_kb / (1 << 20):.1f}Gb\n")
        f_log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
