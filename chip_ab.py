#!/usr/bin/env python3
"""Run one of chip_smoke.py's phases from several checkouts in turn, each in
its own process, on the card.

    python3 chip_ab.py phase_kernels_wkv_bwd build/parent . . build/parent

For each directory, in the order given, a new process imports that
checkout's ``chip_smoke.py`` (its ``src/`` first on the path), builds its
kernels into that checkout's build directory, runs the named phase and
prints one line, ``{"tree": dir, "phase": name, "rc": code, "lines": [the
JSON lines the phase printed]}``.  Two versions are compared inside one call
and in turns (parent, change, change, parent), since cards and their power
limits differ between calls.  Exits non-zero if any run fails.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = (
    "import sys, torch; sys.path[:0] = ['src', '.']; import chip_smoke; "
    "chip_smoke.phase_build(); getattr(chip_smoke, sys.argv[1])(torch)"
)


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    phase, trees = argv[0], argv[1:]
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, phase], cwd=tree, capture_output=True, text=True,
                              timeout=1800)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(json.dumps({"tree": tree, "phase": phase, "rc": proc.returncode, "lines": lines}), flush=True)
        if proc.returncode:
            rc = 1
            print(proc.stderr[-4000:], file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
