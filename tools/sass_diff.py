#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA sources between two checkouts.

    python3 tools/sass_diff.py [--diff N] OTHER_ROOT [SOURCE ...]

Each SOURCE (default: every source of ``lqr_tpu_torch/ops/_build.SOURCES``
that OTHER_ROOT also has, e.g. the parent commit unpacked with
``git archive``) is compiled from this checkout and from OTHER_ROOT with the
package's nvcc flags into a cubin and disassembled with ``cuobjdump -sass``.
Addresses and encodings are dropped; per kernel the script prints the
instruction count in each tree and whether the two listings are identical,
the same instructions with other register numbers ("registers renamed"),
or different;
with --diff N, the first N lines of a unified diff of each kernel that
differs.
Exits 1 when any kernel differs. Needs the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import difflib
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lqr_tpu_torch.ops import _build  # noqa: E402

_COMMENT = re.compile(r"/\*.*?\*/")
# an anonymous namespace's mangled name carries hashes of the file (its
# path, and the translation unit: they change with an edit of the file or
# of a header it includes)
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\w*?_[0-9a-f]{8}(?=\d)")
_REG = re.compile(r"\bU?[RP]\d+\b")


def sass(src: pathlib.Path, out: pathlib.Path) -> dict[str, list[str]]:
    """{kernel: [instruction, ...]} of one source compiled to a cubin."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(out),
                    str(src)], check=True)
    nvcc = pathlib.Path(_build._nvcc())
    text = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass",
                           str(out)], check=True, capture_output=True,
                          text=True).stdout
    kernels: dict[str, list[str]] = {}
    cur = None
    for line in _ANON.sub("_GLOBAL__N__", text).splitlines():
        if "Function :" in line:
            cur = kernels.setdefault(line.split("Function :")[1].strip(), [])
            continue
        ins = _COMMENT.sub("", line).strip()
        if cur is not None and ins and ins.endswith(";"):
            cur.append(" ".join(ins.split()))
    return kernels


def main(argv: list[str]) -> int:
    show = 0
    if argv[:1] == ["--diff"]:
        show, argv = int(argv[1]), argv[2:]
    other = pathlib.Path(argv[0]).resolve()
    rels = argv[1:] or [str(s.relative_to(ROOT)) for s in _build.SOURCES
                        if (other / s.relative_to(ROOT)).exists()]
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        for i, rel in enumerate(rels):
            here = sass(ROOT / rel, pathlib.Path(tmp) / f"here{i}.cubin")
            there = sass(other / rel, pathlib.Path(tmp) / f"there{i}.cubin")
            for name in sorted(set(here) | set(there)):
                a, b = here.get(name), there.get(name)
                eq = a == b
                renamed = not eq and a is not None and b is not None and [
                    _REG.sub("R", i) for i in a] == [_REG.sub("R", i)
                                                      for i in b]
                verdict = ("identical" if eq else "registers renamed"
                           if renamed else "DIFFERENT")
                same &= eq
                print(f"{rel} {name}: {len(a or [])} instructions here, "
                      f"{len(b or [])} there: {verdict}")
                if show and not eq and a and b:
                    lines = list(difflib.unified_diff(b, a, "there", "here",
                                                      n=0, lineterm=""))
                    print("\n".join(lines[2:2 + show]))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
