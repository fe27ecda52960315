"""Compare the SASS of two checkouts' kernels, function by function.

    python exploring_flash_attention_tpu_torch/utils/compare_sass.py ROOT_A ROOT_B

Each ROOT is the root of a checkout of the port (for example a ``git
archive`` of another commit unpacked under ``build/``).  Each builds its
own kernels (``kernels.build()``, into ``ROOT/build/kernels/``) and dumps
their SASS (``kernels.sass_by_function()``, cuobjdump) in a process of its
own.  Functions are matched by kernel and template arguments (a mangled
name also holds a hash of its source file, and the parameter types as
the template spells them); ``paged_decode_kernel``'s fifth argument, the
f32 instance flag, is dropped where false, so its bf16 instances match
those of a tree without it.  Prints, per kernel family, how many matched
functions have the same instructions (addresses left out, encodings
kept), how many differ (with the largest change in the instruction
count), and how many functions only one build has.  It needs nvcc and
cuobjdump, so it runs on the card's machine.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

FAMILIES = ("prefill_attention_f32_kernel", "prefill_attention_kernel",
            "splitkv_combine_kernel", "paged_decode_kernel",
            "paged_extend_f32_kernel", "paged_extend_kernel",
            "attention_bwd_dkv_f32_kernel", "attention_bwd_dq_f32_kernel",
            "attention_bwd_dkv_kernel", "attention_bwd_dq_kernel",
            "kvquant_attention_f32_kernel", "kvquant_attention_kernel",
            "int8_attention_kernel", "dtiled_attention_f32_kernel",
            "dtiled_attention_cluster_kernel", "dtiled_attention_kernel")
_DUMP = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from exploring_flash_attention_tpu_torch import kernels; "
         "print(json.dumps(kernels.sass_by_function()))")


def sass(root: Path) -> dict:
    """The SASS of ``root``'s kernels by function name, built there."""
    res = subprocess.run([sys.executable, "-c", _DUMP, str(root)],
                         capture_output=True, text=True, check=True)
    return json.loads(res.stdout.splitlines()[-1])


def instructions(text: str) -> list:
    """A function's SASS lines without their addresses and with their
    spaces collapsed (cuobjdump pads each line to the widest instruction of
    its object, which a new function in the same file can widen), up to
    the dots that end it (cuobjdump prints the next section's header after
    the last function of an object), and without the NOPs that pad its
    end."""
    lines = []
    for ln in text.splitlines():
        ln = " ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split())
        if ln.startswith(".."):
            break
        if ln:
            lines.append(ln)
    while lines and (lines[-1].startswith("/*")
                     or lines[-1].split()[0].rstrip(";") == "NOP"):
        lines.pop()
    return lines


def family(name: str) -> str:
    return next((f for f in FAMILIES if f in name), "other")


def key(name: str) -> tuple:
    """(kernel family, its template arguments): the match of a function
    across builds."""
    fam = family(name)
    m = re.search(re.escape(fam) + r"I((?:L[a-z]+\d+E)+)E", name)
    args = re.findall(r"L[a-z]+\d+E", m.group(1)) if m else []
    if fam == "paged_decode_kernel" and len(args) == 5 and args[4] == "Lb0E":
        args = args[:4]
    return fam, "".join(args) if fam != "other" else name


def by_key(functions: dict) -> dict:
    return {key(n): instructions(t) for n, t in functions.items()}


def compare(root_a: Path, root_b: Path) -> str:
    a, b = by_key(sass(root_a)), by_key(sass(root_b))
    same, diff, only, grown = Counter(), Counter(), Counter(), Counter()
    for k in sorted(set(a) | set(b)):
        fam = k[0]
        if k not in a or k not in b:
            only[f"{fam} ({'B' if k in b else 'A'})"] += 1
        elif a[k] == b[k]:
            same[fam] += 1
        else:
            diff[fam] += 1
            n = len(b[k]) - len(a[k])
            if abs(n) >= abs(grown[fam]):
                grown[fam] = n
    fams = sorted(set(same) | set(diff))
    lines = [f"{f}: {same[f]} identical, {diff[f]} differ"
             + (f" (instruction lines changed by up to {grown[f]:+d})"
                if diff[f] else "") for f in fams]
    lines += [f"only in {k[-2]}: {v} {k[:-4]}" for k, v in
              sorted(only.items())]
    return "\n".join(lines)


if __name__ == "__main__":
    print(compare(Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()))
