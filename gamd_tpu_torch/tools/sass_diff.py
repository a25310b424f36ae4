"""Compare the machine code (SASS) of two builds of the port's CUDA library,
kernel by kernel: which kernels of a change compile to the instructions of
its parent.

    python3 -m gamd_tpu_torch.tools.sass_diff PARENT.so CHANGE.so \\
        [--pair 'PARENT_REGEX=CHANGE_REGEX' ...]

It runs cuobjdump -sass on both libraries and demangles the kernel names
with cu++filt (the CUDA toolkit's, on PATH or under $CUDA_HOME/bin or
/usr/local/cuda/bin). Each instruction's offsets into constant bank 0 (the
kernel's parameters) are masked, so a kernel whose parameter struct gained
fields still compares equal when its instructions do. Kernels are paired
by the regular expressions of each --pair (the first name that matches on
each side), or, with no --pair, by equal names. One JSON line a pair:
both names, each side's instruction count and the number of positions
whose instructions differ (0: the same code). Needs the CUDA toolkit, no
card.
"""

import argparse
import json
import os
import re
import shutil
import subprocess

#: Spellings of the demangled names that differ between demanglers: the
#: anonymous namespace, and casts in template arguments.
_NAME_FORMS = ((r"\(anonymous namespace\)::|<unnamed>::", ""),
               (r"\(bool\)0", "false"), (r"\(bool\)1", "true"),
               (r"\(int\)(?=-?\d)", ""))


def find_tool(name: str) -> str:
    """A CUDA toolkit program on PATH, else under $CUDA_HOME/bin, else
    under /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", name), os.X_OK):
            return os.path.join(home, "bin", name)
    raise RuntimeError(f"{name} not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin")


def normal_name(demangled: str) -> str:
    """A demangled kernel name without its return type, namespace spelling
    or the casts some demanglers print in template arguments."""
    name = demangled.strip()
    for form, plain in _NAME_FORMS:
        name = re.sub(form, plain, name)
    return name[5:] if name.startswith("void ") else name


def sass_functions(dump: str, names: dict) -> dict:
    """{normal name: [instructions]} of a cuobjdump -sass listing; names
    maps each mangled name to its demangled one. Offsets into constant bank
    0, the kernel's parameters, are masked as c[0x0][X]."""
    out, current = {}, None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = normal_name(names.get(head.group(1), head.group(1)))
            out[current] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if current is not None and ins:
            out[current].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]",
                                       "c[0x0][X]", ins.group(1)))
    return out


def library_functions(lib: str) -> dict:
    """sass_functions of a shared library."""
    dump = subprocess.run([find_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    mangled = sorted(set(re.findall(r"Function : (\S+)", dump)))
    demangled = subprocess.run([find_tool("cu++filt")],
                               input="\n".join(mangled), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return sass_functions(dump, dict(zip(mangled, demangled)))


def compare(parent: dict, change: dict, pairs=None) -> list:
    """One record a kernel pair: the parent's and the change's names, their
    instruction counts, and the positions that differ (a missing side:
    null counts)."""
    if not pairs:
        pairs = [(re.escape(k), re.escape(k)) for k in sorted(parent)
                 if k in change]
    records = []
    for p_re, c_re in pairs:
        a = next((k for k in parent if re.search(p_re, k)), None)
        b = next((k for k in change if re.search(c_re, k)), None)
        rec = {"parent": a or p_re, "change": b or c_re,
               "parent_instructions": None, "change_instructions": None,
               "differ": None}
        if a is not None and b is not None:
            x, y = parent[a], change[b]
            rec.update(parent_instructions=len(x),
                       change_instructions=len(y),
                       differ=sum(u != v for u, v in zip(x, y))
                       + abs(len(x) - len(y)))
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pair", action="append", default=[],
                    help="PARENT_REGEX=CHANGE_REGEX")
    args = ap.parse_args(argv)
    pairs = [tuple(p.split("=", 1)) for p in args.pair]
    records = compare(library_functions(args.parent),
                      library_functions(args.change), pairs)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
