"""The GRU kernels' machine code before and after a change to the shared
grid layer (csrc/recurrent_grid.cuh): builds csrc/fused_gru.cu and
csrc/fused_gru_bwd.cu from this checkout and from another copy of csrc/
(``--parent``, e.g. ``git archive <commit> deeplearning4j_tpu_torch/csrc``
unpacked under ``_proof/``) with the port's nvcc flags, dumps both with
``cuobjdump -sass`` and compares every device function's code line by line
(addresses and all; the anonymous namespace's path hash, which differs
between two build directories, taken out of the names).

Run on the machine with the card (nvcc and cuobjdump from the toolkit):

    python3 experiments/lstm_grid/gru_sass_same.py --parent _proof/parent/deeplearning4j_tpu_torch/csrc

Prints one JSON object last on stdout: for each source, the device
functions compared and those whose code differs; exits 1 if any differs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.ops.cuda import build  # noqa: E402

SOURCES = ("fused_gru.cu", "fused_gru_bwd.cu")


#: an anonymous namespace's mangled name holds a hash of the path the
#: source was built from: two builds of one file from two directories
#: name the same function differently
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]{8}")


def sass(csrc: Path, source: str, out_dir: Path) -> dict:
    """{mangled device function: its SASS} of ``source`` built from
    ``csrc``."""
    lib = out_dir / (source + ".so")
    nvcc = build.find_nvcc()
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(lib),
                           str(csrc / source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    tool = Path(nvcc).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        line = ANON.sub("_GLOBAL__N_", line).strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None and line:
            funcs[name].append(line)
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path,
                    help="a copy of csrc/ to compare this checkout's with")
    args = ap.parse_args()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for source in SOURCES:
            old_dir, new_dir = Path(tmp, "old"), Path(tmp, "new")
            old_dir.mkdir(exist_ok=True)
            new_dir.mkdir(exist_ok=True)
            old = sass(args.parent, source, old_dir)
            new = sass(build.CSRC_DIR, source, new_dir)
            differ = sorted(n for n in set(old) | set(new)
                            if old.get(n) != new.get(n))
            result[source] = {
                "functions": len(new),
                "grid_functions": sorted(n for n in new if "grid" in n),
                "differ": differ,
                "sass_lines": sum(len(v) for v in new.values())}
    ok = not any(r["differ"] for r in result.values())
    print(json.dumps({"gru_sass_identical": ok, "sources": result}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
