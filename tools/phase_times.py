#!/usr/bin/env python3
"""Run a tree's ``chip_smoke.py`` with each of its phases timed.

    python3 tools/phase_times.py [--deep] [--only PHASE,...] ROOT [ROOT ...]

For each ROOT (a checkout, for example a ``git archive`` of another commit
unpacked under ``build/``), in turn and each in a fresh process, imports
ROOT/chip_smoke.py, wraps every ``phase_*`` function, ``make_flagship``
and ``time_kernels`` in a host-clock timer that counts only the outermost
call (a phase that drives another, as ``heads`` drives ``slice``, is
timed as itself), runs its ``main`` as the card's run does (with
``--only``, as ``chip_smoke.py --only`` runs), and prints, after the
script's own output,

    PHASE SECONDS ROOT total T s wall W s: {"phase_build": s, ...}

largest first.  W is the whole run's wall time, the build included; T the
sum of the timed phases.  ``--deep`` also times every other function of
the script, each name's outermost calls summed (so the names overlap:
a phase's time holds its helpers'), printed as ``DEEP SECONDS``.  Exits
with the first non-zero exit code of a run.  Needs the card, as
``chip_smoke.py`` does.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def timed_run(root: Path, deep: bool, argv: list) -> int:
    """Run ROOT's chip_smoke.main(argv) in this process with its phases
    timed; print the PHASE SECONDS line (and DEEP SECONDS); return its
    exit code."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    phases: dict = {}
    helpers: dict = {}
    depth = {"phase": 0}

    def wrap(name, fn, sums, key):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            depth[key] = depth.get(key, 0) + 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[key] -= 1
                if depth[key] == 0:
                    sums[name] = round(sums.get(name, 0.0)
                                       + time.perf_counter() - t0, 1)
        return timed

    for name in list(vars(smoke)):
        fn = getattr(smoke, name)
        if not callable(fn) or getattr(fn, "__module__", None) != "chip_smoke":
            continue
        if name.startswith("phase_") or name in ("make_flagship",
                                                 "time_kernels"):
            setattr(smoke, name, wrap(name, fn, phases, "phase"))
        elif deep and name != "main" and not isinstance(fn, type):
            setattr(smoke, name, wrap(name, fn, helpers, name))
    t0 = time.perf_counter()
    try:
        rc = smoke.main(argv)
    finally:
        wall = time.perf_counter() - t0
        for label, sums in (("PHASE", phases), ("DEEP", helpers)):
            if sums:
                order = dict(sorted(sums.items(), key=lambda kv: -kv[1]))
                print(f"{label} SECONDS {root} total "
                      f"{sum(sums.values()):.1f} s wall {wall:.1f} s: "
                      f"{json.dumps(order)}", flush=True)
    return rc


def main(argv) -> int:
    deep = "--deep" in argv
    argv = [a for a in argv if a != "--deep"]
    only = []
    if "--only" in argv:
        i = argv.index("--only")
        only, argv = argv[i:i + 2], argv[:i] + argv[i + 2:]
    if argv and argv[0] == "--one":
        return timed_run(Path(argv[1]).resolve(), deep, only)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    first = 0
    for root in argv:
        rc = subprocess.call([sys.executable, __file__, "--one", root, *only]
                             + (["--deep"] if deep else []))
        first = first or rc
    return first


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
