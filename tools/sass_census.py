#!/usr/bin/env python3
"""Static instruction census of the port's CUDA kernels.

Compiles each given ``csrc/*.cu`` of a checkout with the port's own nvcc
flags (``kernels/build.NVCC_FLAGS``, as a cubin), disassembles it with
``cuobjdump -sass`` and counts, for every kernel whose name holds one of
the ``--kernels`` words, its instructions by opcode class: barriers
(``BAR``), warp shuffles (``SHFL``), shared-memory loads and stores
(``LDS``, ``STS``), shared and global atomics, global loads and stores,
integer multiply-adds (``IMAD``, ``IDP``, ``IMUL``), integer adds, abs,
min / max and the rest. Beside them, what ``ptxas -v`` reports for the
kernel (registers, spills, barriers, shared memory). The counts are
static: an instruction inside a loop counts once.

    python3 tools/sass_census.py CHECKOUT csrc/mvsearch.cu csrc/analyze.cu \\
        --kernels km_kernel kp_kernel

Prints one JSON line per kernel. Needs nvcc and cuobjdump (the CUDA
toolkit), not a card.
"""
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

CLASSES = (("BAR", ("BAR",)), ("SHFL", ("SHFL",)), ("LDS", ("LDS",)),
           ("STS", ("STS",)), ("ATOMS", ("ATOMS",)),
           ("ATOMG", ("ATOMG", "RED")), ("LDG", ("LDG",)),
           ("STG", ("STG",)), ("IMAD", ("IMAD", "IDP", "IMUL")),
           ("IADD", ("IADD3", "IADD", "IABS", "VIADD", "IMNMX",
                     "VABSDIFF")))


def tool(name):
    p = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(p):
        raise SystemExit(f"{name} not found")
    return p


def demangle(names):
    out = subprocess.run([tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def ptxas_info(lines):
    """What ``ptxas -v`` said of each entry function, from its output
    lines ("Compiling entry function '<mangled>'", then that function's
    lines): {mangled name: [its registers and stack / spill lines]}."""
    info, cur = collections.defaultdict(list), None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
        elif cur and ("registers" in ln or "spill" in ln):
            info[cur].append(ln.split(":", 1)[-1].strip())
    return dict(info)


def census(tree, source, words):
    sys.path.insert(0, tree)
    from aom_av1_psy_tpu_torch.kernels.build import CSRC, NVCC_FLAGS
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        p = subprocess.run([tool("nvcc"), *flags, "-cubin", "-I", CSRC, "-o",
                            cubin, os.path.join(tree, source)],
                           capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(p.stdout + p.stderr)
        ptxas = (p.stdout + p.stderr).splitlines()
        sass = subprocess.run([tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
    info = ptxas_info(ptxas)
    ops, cur = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", ln)
        if m:
            cur = m.group(1)
            ops[cur] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     ln)
        if cur and m:
            ops[cur][m.group(1).split(".")[0]] += 1
    names = demangle(list(ops))
    for mangled, count in ops.items():
        if not any(w in names[mangled] for w in words):
            continue
        row = {"kernel": names[mangled], "source": source,
               "instructions": sum(count.values())}
        seen = set()
        for cls, prefixes in CLASSES:
            row[cls] = sum(n for op, n in count.items() if op in prefixes)
            seen.update(prefixes)
        row["other"] = sum(n for op, n in count.items() if op not in seen)
        row["ptxas"] = info.get(mangled, [])
        yield row


def main() -> int:
    args = sys.argv[1:]
    if "--kernels" not in args or args.index("--kernels") < 2:
        print(__doc__, file=sys.stderr)
        return 2
    k = args.index("--kernels")
    tree, sources, words = os.path.abspath(args[0]), args[1:k], args[k + 1:]
    for src in sources:
        for row in census(tree, src, words):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
