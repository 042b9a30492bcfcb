#!/usr/bin/env python3
"""Compare the SASS of kernels between two builds of one kernel library.

    python3 tools/sass_diff.py A.so B.so flash_fwd_wgmmaILi64E flash_fwd_wgmmaILi128E

Each library is disassembled with ``cuobjdump -sass``.  For each pattern,
the functions whose mangled name holds it are matched across the two by
the part of the name from the pattern on (the anonymous namespace's hash
before it differs between builds) and compared instruction by instruction,
with addresses and encodings stripped.  One JSON line a function: the
instruction counts and the lines that differ.  Exits 1 if a pattern
matches no function in either library.
"""

from __future__ import annotations

import difflib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path


def cuobjdump() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "cuobjdump").exists():
            return str(Path(root) / "bin" / "cuobjdump")
    found = shutil.which("cuobjdump")
    if found:
        return found
    raise RuntimeError("cuobjdump not found in $CUDA_HOME, /usr/local/cuda or on PATH")


def functions(lib: str) -> dict:
    """Mangled name -> its instructions, addresses and encodings stripped."""
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        lines = []
        for ln in body.splitlines():
            ln = re.sub(r"/\*\s*0x[0-9a-f]+\s*\*/", "", re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln)).strip()
            if ln and not ln.startswith(("....", ".")):
                lines.append(ln)
        out[name] = lines
    return out


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = functions(argv[0]), functions(argv[1])
    rc = 0
    for pattern in argv[2:]:
        ka = {n[n.index(pattern):]: n for n in a if pattern in n}
        kb = {n[n.index(pattern):]: n for n in b if pattern in n}
        if not ka and not kb:
            print(json.dumps({"pattern": pattern, "error": "no function matches"}), flush=True)
            rc = 1
        for key in sorted(set(ka) | set(kb)):
            la, lb = a.get(ka.get(key), []), b.get(kb.get(key), [])
            diff = [d for d in difflib.unified_diff(la, lb, lineterm="", n=0)
                    if d[:1] in "+-" and not d.startswith(("+++", "---"))]
            print(json.dumps({"function": key, "instructions": [len(la), len(lb)],
                              "identical": la == lb, "differing_lines": len(diff), "first_differences": diff[:12]}),
                  flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
