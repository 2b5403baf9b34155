"""Compare the CUDA builds of two checkouts kernel by kernel: each
kernel's SASS (``cuobjdump -sass``) and its ``ptxas -v`` registers and
spills, for the libraries named.

The port's own tool, for a change that must leave some kernels as they
were (a shared template that gains a parameter, a header that loses dead
code). Both trees must have been built (``ops/_cuda.build()``: the labs,
the tests and ``chip_smoke.py`` build at first use); each library is the
newest ``lib<name>_<hash>.so`` under ``<tree>/nwhead_tpu_torch/build/`` and
its ``.ptxas.txt``. ``--rename OLD=NEW`` rewrites the change's kernel names
before they are matched, e.g. a template argument that the change adds at
its default::

    python nwhead_tpu_torch/labs/build_diff.py PARENT_TREE CHANGE_TREE \\
        --rename ELi3EEEvNS_6TcArgsENS_6TcMapsE=EEEvNS_6TcArgsENS_6TcMapsE

It prints, per library, the kernels of each tree, how many of those in
both have identical SASS and identical registers and spills, and each
kernel that differs or is in one tree only. Needs ``cuobjdump`` (beside
``nvcc``).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
from typing import Dict, List, Tuple

LIBRARIES = ("nw_prepared", "nw_fused", "lab_nw")


def sass_functions(text: str) -> Dict[str, str]:
    """``cuobjdump -sass`` output -> {kernel: its SASS}."""
    out: Dict[str, str] = {}
    name, body = None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = "\n".join(body)
            name, body = m.group(1), []
        elif name is not None:
            body.append(line)
    if name is not None:
        out[name] = "\n".join(body)
    return out


def ptxas_report(text: str) -> Dict[str, Tuple[int, int, int]]:
    """``ptxas -v`` output -> {kernel: (registers, spill store bytes, spill
    load bytes)}."""
    out: Dict[str, List[int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def compare(parent: Dict[str, object], change: Dict[str, object]):
    """``(same, differ, parent_only, change_only)``: the kernels in both
    whose values are equal and those that differ, and those in one only."""
    both = sorted(set(parent) & set(change))
    same = [k for k in both if parent[k] == change[k]]
    differ = [k for k in both if parent[k] != change[k]]
    return same, differ, sorted(set(parent) - set(change)), sorted(set(change) - set(parent))


def _renamed(d: dict, renames) -> dict:
    out = {}
    for k, v in d.items():
        for old, new in renames:
            k = k.replace(old, new)
        out[k] = v
    return out


def _library(tree: str, name: str) -> str:
    found = sorted(glob.glob(os.path.join(tree, "nwhead_tpu_torch", "build", f"lib{name}_*.so")),
                   key=os.path.getmtime)
    if not found:
        raise SystemExit(f"no build of {name} under {tree}: build that tree first")
    return found[-1]


def _cuobjdump() -> str:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from nwhead_tpu_torch.ops._cuda import find_nvcc

    nvcc = find_nvcc()
    if nvcc is None:
        raise SystemExit("cuobjdump not found (it sits beside nvcc)")
    return os.path.join(os.path.dirname(nvcc), "cuobjdump")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--libraries", default=",".join(LIBRARIES))
    ap.add_argument("--rename", action="append", default=[], metavar="OLD=NEW",
                    help="rewrite the change's kernel names before matching")
    args = ap.parse_args(argv)
    renames = [tuple(r.split("=", 1)) for r in args.rename]
    if any(len(r) != 2 for r in renames):
        ap.error("--rename takes OLD=NEW")
    tool = _cuobjdump()
    for name in args.libraries.split(","):
        sides = []
        for tree in (args.parent, args.change):
            so = _library(tree, name)
            sass = sass_functions(subprocess.run([tool, "-sass", so], capture_output=True,
                                                 text=True, check=True).stdout)
            with open(so[:-3] + ".ptxas.txt") as f:
                regs = ptxas_report(f.read())
            sides.append((sass, regs))
        (ps, pr), (cs, cr) = sides[0], tuple(_renamed(d, renames) for d in sides[1])
        same, differ, p_only, c_only = compare(ps, cs)
        r_same, r_differ, _, _ = compare(pr, cr)
        print(f"{name}: {len(ps)} kernels in the parent, {len(cs)} in the change, "
              f"{len(same) + len(differ)} in both: SASS identical {len(same)}, registers and "
              f"spills identical {len(r_same)}")
        for k in sorted(set(differ) | set(r_differ)):
            print(f"  differs: {k} (registers, spill stores, loads {pr.get(k)} -> {cr.get(k)})")
        for k in p_only:
            print(f"  parent only: {k}")
        for k in c_only:
            print(f"  change only: {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
