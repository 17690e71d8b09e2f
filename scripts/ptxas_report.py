#!/usr/bin/env python3
"""Registers, shared memory and spills of every kernel instantiation, as
``ptxas -v`` reports them, and the count of tensor-core and asynchronous
copy instructions in its SASS, for the port's CUDA sources.

Compiles each ``*.cu`` of each given source directory (default: the
port's ``gofr_tpu_torch/csrc``) to an object file with the flags the
port builds with (``ops/cuda/_build.py``), plus ``-Xptxas -v``, and
prints one JSON object: for each source file, each kernel (demangled,
``(anonymous namespace)::`` dropped) with its registers, shared-memory
bytes and spill bytes, and, from ``cuobjdump -sass`` of the object, how
many ``HGMMA`` (wgmma on the tensor cores), ``UTMALDG`` (TMA loads) and
``LDGSTS`` (``cp.async`` copies) instructions it holds. Given two
directories (say a parent commit's sources beside the change's) it
reports both, so that an unchanged instantiation can be checked to
compile to the same resources.

Run from the root of a checkout on a host with ``nvcc``:
``python3 scripts/ptxas_report.py [DIR ...] [--out FILE]``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gofr_tpu_torch.ops.cuda import _build  # noqa: E402

_ENTRY = re.compile(r"Function properties for (\S+)")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS")


def _demangle(names):
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return [name.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for name in out.splitlines()]


def parse(log: str) -> dict:
    """Each kernel's resources in a ``ptxas -v`` log, by demangled name."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if (m := _ENTRY.search(line)):
            name, spill = m.group(1), (0, 0)
        elif (m := _SPILL.search(line)) and name:
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _USED.search(line)) and name:
            rows.append(dict(kernel=name, registers=int(m.group(1)),
                             smem_bytes=int(m.group(2) or 0),
                             spill_stores=spill[0], spill_loads=spill[1]))
            name = None
    for row, pretty in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = pretty
    return {row["kernel"]: {k: v for k, v in row.items() if k != "kernel"}
            for row in rows}


def sass_counts(sass: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing (demangled name), the
    count of each of ``SASS_OPS``."""
    counts, name = {}, None
    for line in sass.splitlines():
        if (m := _SASS_FUNCTION.search(line)):
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def _cuobjdump(nvcc: str) -> str:
    beside = Path(nvcc).parent / "cuobjdump"
    found = str(beside) if beside.exists() else shutil.which("cuobjdump")
    if not found:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return found


def report(source: Path, nvcc: str) -> dict:
    """ptxas resources and SASS instruction counts of each kernel in
    ``source``."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        obj = str(Path(tmp) / "k.o")
        proc = subprocess.run(
            [nvcc, *flags, "-c", "-Xptxas", "-v", "-o", obj, str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
        sass = subprocess.run([_cuobjdump(nvcc), "-sass", obj],
                              capture_output=True, text=True, check=True)
    rows = parse(proc.stdout + proc.stderr)
    for name, counts in sass_counts(sass.stdout).items():
        rows.setdefault(name, {}).update(counts)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="*", default=[str(_build.CSRC)])
    parser.add_argument("--out", default="chiprun_out/ptxas_report.json")
    args = parser.parse_args()
    nvcc = _build.find_nvcc()
    result = {d: {src.name: report(src, nvcc)
                  for src in sorted(Path(d).glob("*.cu"))}
              for d in args.dirs}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
