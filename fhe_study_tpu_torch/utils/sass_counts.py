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
which are left out, and the same by integer pipe (``PIPES``).  These are
the counts that ``ops/alu_bench.OP_COUNTS`` and ``OP_PIPES`` record.  In
every instantiation of ``ntt_smem_ceiling_kernel`` it counts the global
loads and barriers of the ``reps`` loop, against those of one forward
transform (``chain_loads``): equal counts mean ptxas hoisted no twiddle load
out of the loop, so the ceiling loads what the kernels load.  Needs nvcc
and cuobjdump (the CUDA toolkit); no card.
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


# The integer pipes of an sm_90 SM, 64 lanes a clock each (16 in each of
# the four partitions), by the mnemonic's opcode: the ALU pipe takes adds,
# logic, compares, selects, shifts; the FMA pipe takes the IMAD family and
# VIADD.  IMAD.HI and IMAD.WIDE ("wide") take two FMA issue slots and one
# ALU slot each.  The evidence is the alu_rate loops' own rates (PERF.md):
# shoup_lazy (one IMAD.HI and two IMAD a word) issues 16 words a clock and
# SM, which is 4 FMA slots a word; a loop of one IMAD.HI and four ALU
# instructions a word issues 16 words a clock (4 + 1 ALU slots), not the 21
# of 4 ALU slots; VIADD's loops fit the FMA pipe and beat a bound that puts
# it on the ALU pipe.  What runs on the uniform datapath (U*) and the
# branch are left out.
PIPES = {"IADD3": "alu", "LOP3": "alu", "ISETP": "alu", "SEL": "alu",
         "SHF": "alu", "LEA": "alu", "IMNMX": "alu", "PRMT": "alu",
         "IMAD": "fma", "VIADD": "fma"}
WIDE = ("IMAD.HI", "IMAD.WIDE")


def pipe_of(mnemonic: str) -> str | None:
    """"alu" or "fma" for an integer instruction, None for the branch and
    the uniform datapath; any other mnemonic raises (it is not guessed)."""
    if mnemonic.startswith(("BRA", "U")):
        return None
    pipe = PIPES.get(mnemonic.split(".")[0])
    if pipe is None:
        raise ValueError(f"SASS mnemonic {mnemonic}: no pipe assigned in "
                         "sass_counts.PIPES")
    return pipe


def pipe_counts(hist: dict) -> tuple:
    """(ALU, FMA, wide) instructions of an alu_kernel loop's histogram,
    less the loop counter's compare (its one ISETP on the ALU pipe)."""
    count = {"alu": 0, "fma": 0}
    wide = 0
    for mnemonic, n in hist.items():
        pipe = pipe_of(mnemonic)
        if pipe is not None:
            count[pipe] += n
            wide += n if mnemonic.startswith(WIDE) else 0
    return count["alu"] - 1, count["fma"], wide


def loop_counts(sass: str) -> dict:
    """{op: {"per_word_round": x, "pipes": (alu, fma, wide), "loop":
    {mnemonic: count}}} for every ``alu_kernel`` instantiation found in the
    disassembly, per word and round (per butterfly)."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        head = block.split("\n", 1)[0]
        m = re.search(r"alu_kernelILi(\d+)E", head)
        if not m:
            continue
        op = alu_bench.OPS[int(m.group(1))]
        hist = Counter(name for name, _ in loop_of(block))
        units = alu_bench.ALU_UNROLL * alu_bench.ALU_PER_THREAD
        if op == "butterfly":
            units //= 2
        alu, fma, wide = pipe_counts(hist)
        out[op] = {"per_word_round": (alu + fma) / units,
                   "pipes": (alu / units, fma / units, wide / units),
                   "loop": dict(hist)}
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
              f"(OP_COUNTS {alu_bench.OP_COUNTS[op]}), (ALU, FMA, wide) "
              f"{c['pipes']} (OP_PIPES {alu_bench.OP_PIPES[op]}); loop "
              f"{c['loop']}", flush=True)
    print(json.dumps({op: counts[op]["pipes"] for op in alu_bench.OPS}))


if __name__ == "__main__":
    main()
