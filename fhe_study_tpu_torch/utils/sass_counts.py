#!/usr/bin/env python3
"""Count the SASS instructions in the loop of each ``alu_rate`` kernel, and
the loads and barriers in the loop of each shared-memory ceiling kernel.

    python3 -m fhe_study_tpu_torch.utils.sass_counts

(from the repository root.)

Builds the kernel library if needed, disassembles it with ``cuobjdump
-sass``, finds in every instantiation of ``alu_kernel`` (csrc/bench_cuda.cu)
the one loop (the instructions from the target of the backward branch to
the branch), and prints the loop's instructions by mnemonic and their number
per word and round: the loop body holds ALU_UNROLL rounds on ALU_PER_THREAD
words, plus the counter's add (on the uniform datapath), compare and branch,
which are left out.  These are the counts
that ``ops/alu_bench.OP_COUNTS`` records.  In every instantiation of
``ntt_smem_ceiling_kernel`` it counts the global loads and barriers of the
``reps`` loop, against those of one forward transform (``chain_loads``): equal
counts mean ptxas hoisted no twiddle load out of the loop, so the ceiling
loads what the kernels load.  Needs nvcc and cuobjdump (the CUDA toolkit); no
card.
"""

import json
import pathlib
import re
import shutil
import subprocess
from collections import Counter

from ..ops import _cuda, alu_bench
from ..ops import ntt_cuda as nc

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                    r"([^;]*);")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = pathlib.Path(_cuda._nvcc()).with_name("cuobjdump")
    if beside.is_file():
        return str(beside)
    raise FileNotFoundError("cuobjdump not found beside nvcc or on PATH")


def disassemble() -> str:
    _cuda.library()
    so = _cuda.build_dir() / _cuda.LIB_NAME
    return subprocess.run([cuobjdump(), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout


def loop_of(function_sass: str) -> list:
    """[(mnemonic, operands)] of the last backward branch's loop."""
    instrs = [(int(m.group(1), 16), m.group(2), m.group(3))
              for m in _INSTR.finditer(function_sass)]
    loops = []
    for addr, name, rest in instrs:
        if name.startswith("BRA"):
            target = re.search(r"0x([0-9a-f]+)", rest)
            if target and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
    if not loops:
        return []
    lo, hi = max(loops, key=lambda r: r[1] - r[0])
    return [(name, rest) for addr, name, rest in instrs if lo <= addr <= hi]


def loop_counts(sass: str) -> dict:
    """{op: {"per_word_round": x, "loop": {mnemonic: count}}} for every
    ``alu_kernel`` instantiation found in the disassembly."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        head = block.split("\n", 1)[0]
        m = re.search(r"alu_kernelILi(\d+)E", head)
        if not m:
            continue
        op = alu_bench.OPS[int(m.group(1))]
        hist = Counter(name for name, _ in loop_of(block))
        # not the operation's: the branch, the loop counter's compare (the
        # one ISETP.LE/NE on it) and whatever runs on the uniform datapath
        # (the counter's own add, constants)
        work = sum(v for k, v in hist.items()
                   if not k.startswith(("BRA", "U"))) - 1
        units = alu_bench.ALU_UNROLL * alu_bench.ALU_PER_THREAD
        if op == "butterfly":
            units //= 2
        out[op] = {"per_word_round": work / units, "loop": dict(hist)}
    return out


def chain_loads(logn: int) -> tuple:
    """(global loads, barriers) of one forward transform on the plan at
    2^logn: each stage u of a pass loads its 2^(3 - u) twiddles and their
    companions, in two uint4 words at u = 0 and one word otherwise; a
    barrier ends each pass."""
    fwd = nc._radix_plan(logn).forward
    return (2 * sum(2 if u == 0 else 1 for p in fwd for u in p.stages),
            len(fwd))


def ceiling_loops(sass: str) -> dict:
    """{log n: (global loads, barriers)} in the loop of every
    ``ntt_smem_ceiling_kernel`` instantiation."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        m = re.search(r"ntt_smem_ceiling_kernelILi(\d+)E",
                      block.split("\n", 1)[0])
        if m:
            names = [name for name, _ in loop_of(block)]
            out[int(m.group(1))] = (sum(n.startswith("LDG") for n in names),
                                    sum(n.startswith("BAR") for n in names))
    return out


def main() -> None:
    sass = disassemble()
    for logn, got in sorted(ceiling_loops(sass).items()):
        print(f"ntt_smem_ceiling_kernel<{logn}>: {got[0]} global loads and "
              f"{got[1]} barriers in its loop; one transform: "
              f"{chain_loads(logn)}", flush=True)
    counts = loop_counts(sass)
    for op in alu_bench.OPS:
        c = counts.get(op)
        if c is None:
            raise SystemExit(f"no alu_kernel for {op} in the disassembly")
        print(f"{op:11s} {c['per_word_round']:7.3f} instructions a "
              f"{'butterfly' if op == 'butterfly' else 'word'} and round "
              f"(OP_COUNTS {alu_bench.OP_COUNTS[op]}); loop {c['loop']}",
              flush=True)
    print(json.dumps({op: counts[op]["per_word_round"]
                      for op in alu_bench.OPS}))


if __name__ == "__main__":
    main()
