#!/usr/bin/env python3
"""Compare the machine code of each kernel source in two checkouts.

Run from the repository root on a machine with the CUDA toolkit (unpack
the commit to compare with into a directory that .gitignore lists, as
for tools/compare_parent.py):

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/sass_compare.py build/parent [--change DIR]

Compiles every phaneron_tpu_torch/csrc/*.cu of both checkouts to a cubin
with that checkout's own flags (ops/_build.py nvcc_flags, without
ptxas's report), disassembles each with cuobjdump -sass and prints, for
each source, the two instruction counts and whether the instruction
streams are the same (addresses, encodings and the per-file names of
anonymous namespaces left out), and for a source that differs, the same
for each of its kernels.  A kernel found in one checkout only (its name
changed: a template argument or a parameter added, as a band-free
full-frame template gains them) is paired with a kernel of the other
checkout whose instruction stream is the same, where there is one.  A
kernel record that moves between two checkouts whose machine code is
the same moved by noise.  Cubins go to
build/sass/.  Exits 1 when a compile or disassembly fails.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSTRUCTION = re.compile(r"\s+/\*[0-9a-f]{4}\*/")
ANON = re.compile(r"_GLOBAL__N__[0-9A-Za-z_]+")
FUNCTION = re.compile(r"\s*Function : (\S+)")
ANON_NAME = re.compile(r"(\d+)_GLOBAL__N__")  # a mangled name's length-prefixed anonymous namespace


def kernel_name(mangled: str) -> str:
    """The mangled name with its anonymous namespace, whose name differs
    from file to file, cut out (the rest names the kernel)."""
    m = ANON_NAME.search(mangled)
    if m is None:
        return mangled
    return mangled[:m.start()] + "ANON" + mangled[m.end(1) + int(m.group(1)):]


def flags_of(tree: Path) -> list:
    """The tree's own nvcc flags, without ptxas's resource report."""
    code = ("import sys; sys.path.insert(0, %r); from phaneron_tpu_torch.ops import _build; "
            "print(' '.join(_build.nvcc_flags()))") % str(tree)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    return [f for f in out.split() if f not in ("-Xptxas", "-v")]


def instructions(tree: Path, out: Path) -> dict:
    """source name -> {kernel (mangled name): its instructions, one
    string each}."""
    from phaneron_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    flags = flags_of(tree)
    out.mkdir(parents=True, exist_ok=True)
    code = {}
    for cu in sorted((tree / "phaneron_tpu_torch" / "csrc").glob("*.cu")):
        cubin = out / f"{cu.stem}.cubin"
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(cu)], check=True)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
        kernels, name = {}, None
        for ln in sass.splitlines():
            if (m := FUNCTION.match(ln)) is not None:
                name = kernel_name(m.group(1))
            elif INSTRUCTION.match(ln):
                kernels.setdefault(name, []).append(ANON.sub("ANON", ln.split(";")[0].strip()))
        code[cu.name] = kernels
    return code


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("parent", type=Path)
    parser.add_argument("--change", type=Path, default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    try:
        parent = instructions(args.parent.resolve(), ROOT / "build" / "sass" / "parent")
        change = instructions(args.change.resolve(), ROOT / "build" / "sass" / "change")
    except (subprocess.CalledProcessError, RuntimeError) as exc:
        print(f"sass_compare: {exc}", file=sys.stderr)
        return 1
    for name in sorted(set(parent) | set(change)):
        p, c = parent.get(name), change.get(name)
        if p is None or c is None:
            print(f"{name}: only in the {'change' if p is None else 'parent'}")
            continue
        count = lambda kernels: sum(len(v) for v in kernels.values())
        print(f"{name}: {count(p)} / {count(c)} instructions, {'same machine code' if p == c else 'differs'}")
        if p == c:
            continue
        for kernel in sorted(set(p) | set(c)):
            kp, kc = p.get(kernel), c.get(kernel)
            if kp is None or kc is None:
                side, own, other = ("change", c, p) if kp is None else ("parent", p, c)
                code = own[kernel]
                twin = next((k for k, v in other.items() if k not in own and v == code), None)
                print(f"  {kernel}: only in the {side}, {len(code)} instructions"
                      + (f", the same machine code as {twin}" if twin is not None else ", no kernel of the same code"))
            else:
                print(f"  {kernel}: {len(kp)} / {len(kc)} instructions, {'same' if kp == kc else 'differs'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
