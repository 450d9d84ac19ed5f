"""Registers and SASS of the port's CUDA kernels: what each kernel's item
loop issues per item, by pipe, and which routines it calls.

    python -m ceph_tpu_torch.tools.sass_report [--lib PATH]

Needs the CUDA toolkit's ``cuobjdump`` (on the card's machine); builds the
kernel library first unless ``--lib`` names one.  For every kernel it prints
the registers, shared memory and spills that ptxas assigned
(``cuobjdump -res-usage``, the numbers of ``nvcc -Xptxas -v``), and for the
straw2 kernels their item loop: the innermost loop that holds the rjenkins
hash, with its instructions per item (per hash32_3 in the loop body)
grouped by the pipe that issues them, and the routines it calls.  For each
instance of the GF kernel (``gf_matvec_kernel<k>``, k = 0 for the run-time
k loop) its lookup loop: the innermost loop with the most shared-memory
loads, its instructions per lookup (per LDS) and per byte column, which
takes k packed lookups for up to four outputs (k = 8, the encode).

Pipe groups (Hopper; an approximation from NVIDIA's architecture documents,
which do not list every opcode):

  alu      IADD3 LOP3 SHF ISETP LEA SEL PRMT FLO IMNMX VIMNMX PLOP3 FSETP
           FSEL FMNMX MOV                        (16 lanes per scheduler)
  fma      IMAD* FFMA FMUL FADD HFMA2             (the FMA pipe)
  viadd    VIADD                                  (Hopper; pipe undocumented)
  mio      LDS STS LDG STG LDC SHFL ATOM RED S2R  (memory and shuffles)
  xu       MUFU I2F F2I I2FP F2IP FCHK            (conversions, transcendentals)
  control  BRA BSSY BSYNC CALL RET EXIT WARPSYNC BREAK
  uniform  U*                                     (the uniform datapath)

A CALL is named by what it reaches: "u64 divide" (the routine nvcc emits
for a 64-bit integer division: it holds I2F.U64.RP), "f32 divide slow path"
(the IEEE division's fallback, entered only when FCHK flags an operand
range the fast sequence cannot round), else "device function" (an
out-of-line __device__ function such as ln_f32).
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys

#: the kernels whose item loop is reported (they hold the straw2 hash)
LOOP_KERNELS = ("straw2_root_kernel", "straw2_froot_kernel",
                "straw2_leaf_kernel")
#: the immediate 231232 of hash32_3 (its constant x), once per hash
HASH_MARK = "0x38740"
#: the GF kernel's name, before its template argument
GF_KERNEL = "gf_matvec_kernel"
#: packed lookups per byte column in the GF report: k at the encode
GF_LOOKUPS_PER_COLUMN = 8

_PIPES = {
    "alu": {"IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "FLO",
            "IMNMX", "VIMNMX", "PLOP3", "FSETP", "FSEL", "FMNMX", "MOV",
            "IABS", "BMSK", "SGXT", "P2R", "R2P", "CS2R"},
    "fma": {"IMAD", "FFMA", "FMUL", "FADD", "HFMA2", "IDP", "DFMA"},
    "viadd": {"VIADD"},
    "mio": {"LDS", "STS", "LDG", "STG", "LDC", "SHFL", "ATOM", "ATOMS",
            "ATOMG", "RED", "S2R", "LD", "ST"},
    "xu": {"MUFU", "I2F", "F2I", "I2FP", "F2IP", "FCHK", "F2F"},
    "control": {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "BREAK", "NOP", "BAR"},
}
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                  r"([^;]*);")
_RES = re.compile(r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+) "
                  r"SHARED:(\d+) LOCAL:(\d+)")


def pipe_of(op: str) -> str:
    root = op.split(".")[0]
    if root.startswith("U") and root not in _PIPES["alu"]:
        return "uniform"
    for name, ops in _PIPES.items():
        if root in ops:
            return name
    return "other"


def _kernel_name(mangled: str) -> str:
    """The last component of an Itanium-mangled nested name
    (_ZN<len><name>...<len><name>E...), with an integer template argument
    as ``name<8>`` (I Li8 E), else the name itself."""
    if not mangled.startswith("_ZN"):
        return mangled
    rest, last = mangled[3:], mangled
    while rest and rest[0].isdigit():
        digits = re.match(r"\d+", rest).group(0)
        n = int(digits)
        last, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    arg = re.match(r"ILi(\d+)E", rest)
    return f"{last}<{arg.group(1)}>" if arg else last


def parse_sass(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """cuobjdump -sass text -> kernel name -> [(address, opcode, operands)]."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        mangled = part.split("\n", 1)[0].strip()
        out[_kernel_name(mangled)] = [
            (int(m.group(1), 16), m.group(3), m.group(4).strip())
            for m in _INS.finditer(part)]
    return out


def parse_res_usage(text: str) -> dict[str, dict[str, int]]:
    """cuobjdump -res-usage text -> kernel name -> registers etc."""
    return {_kernel_name(m.group(1)): {
        "registers": int(m.group(2)), "stack": int(m.group(3)),
        "shared": int(m.group(4)), "local": int(m.group(5))}
        for m in _RES.finditer(text)}


def _target(operands: str) -> int | None:
    m = re.search(r"0x([0-9a-f]+)", operands)
    return int(m.group(1), 16) if m else None


def _routine(ins, start: int) -> list[tuple[int, str, str]]:
    """The instructions of the subroutine at ``start``, to its RET."""
    body = []
    for addr, op, args in ins:
        if addr >= start:
            body.append((addr, op, args))
            if op.startswith("RET"):
                break
    return body


def call_kind(ins, i: int) -> str:
    """What the CALL at index i of ``ins`` reaches."""
    body = _routine(ins, _target(ins[i][2]) or 0)
    ops = {op for _a, op, _r in body}
    if any(op.startswith("I2F.U64") for op in ops):
        return "u64 divide"
    if any(op.startswith("FCHK") for _a, op, _r in ins[max(0, i - 12):i]):
        return "f32 divide slow path"
    return "device function"


def loops(ins) -> list[tuple[int, int]]:
    """(first, last) instruction indices of every backward branch's body."""
    index = {addr: k for k, (addr, _op, _r) in enumerate(ins)}
    out = []
    for k, (addr, op, args) in enumerate(ins):
        if op.startswith("BRA"):
            tgt = _target(args)
            if tgt is not None and tgt < addr and tgt in index:
                out.append((index[tgt], k))
    return out


def item_loop(ins) -> dict | None:
    """The innermost loop holding hash32_3, counted per item."""
    best = None
    for lo, hi in loops(ins):
        inner = any(lo <= a and b <= hi and (a, b) != (lo, hi)
                    for a, b in loops(ins))
        body = ins[lo:hi + 1]
        hashes = sum(HASH_MARK in args for _a, _op, args in body)
        if inner or not hashes:
            continue
        if best is None or len(body) > best[1] - best[0] + 1:
            best = (lo, hi, hashes)
    if best is None:
        return None
    lo, hi, hashes = best
    body = ins[lo:hi + 1]
    pipes = collections.Counter(pipe_of(op) for _a, op, _r in body)
    ops = collections.Counter(op.split(".")[0] for _a, op, _r in body)
    calls = [{"kind": call_kind(ins, k),
              "instructions": len(_routine(ins, _target(ins[k][2]) or 0))}
             for k in range(lo, hi + 1) if ins[k][1].startswith("CALL")]
    return {
        "address": f"{ins[lo][0]:#06x}-{ins[hi][0]:#06x}",
        "instructions": len(body), "hashes": hashes,
        "per_item": {p: round(n / hashes, 2) for p, n in sorted(pipes.items())},
        "per_item_total": round(len(body) / hashes, 2),
        "opcodes": dict(ops.most_common()),
        "calls": calls,
    }


def lookup_loop(ins) -> dict | None:
    """The innermost loop with the most shared-memory loads (the GF
    kernel's lookups), counted per lookup and per byte column."""
    best = None
    for lo, hi in loops(ins):
        inner = any(lo <= a and b <= hi and (a, b) != (lo, hi)
                    for a, b in loops(ins))
        lds = sum(op.startswith("LDS") for _a, op, _r in ins[lo:hi + 1])
        if not inner and lds and (best is None or lds > best[2]):
            best = (lo, hi, lds)
    if best is None:
        return None
    lo, hi, lds = best
    body = ins[lo:hi + 1]
    pipes = collections.Counter(pipe_of(op) for _a, op, _r in body)
    return {
        "address": f"{ins[lo][0]:#06x}-{ins[hi][0]:#06x}",
        "instructions": len(body), "lookups": lds,
        "per_lookup": round(len(body) / lds, 2),
        "per_byte_column": round(len(body) * GF_LOOKUPS_PER_COLUMN / lds, 2),
        "by_pipe": dict(sorted(pipes.items())),
    }


def report(lib: str) -> dict[str, dict]:
    """Registers and item-loop counts of every kernel in ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, check=True).stdout
    usage = parse_res_usage(res)
    out = {}
    for name, ins in parse_sass(sass).items():
        calls = [call_kind(ins, k) for k, (_a, op, _r) in enumerate(ins)
                 if op.startswith("CALL")]
        row = dict(usage.get(name, {}), instructions=len(ins), calls=calls)
        if name in LOOP_KERNELS:
            row["item_loop"] = item_loop(ins)
        if name.startswith(GF_KERNEL):
            row["lookup_loop"] = lookup_loop(ins)
        out[name] = row
    return out


def format_report(rep: dict[str, dict]) -> str:
    lines = []
    for name, row in rep.items():
        lines.append(
            f"{name:22s} {row.get('registers', '?')} registers, "
            f"{row.get('local', '?')} B local (spills), {row['instructions']} "
            f"instructions, calls: {row['calls'] or 'none'}")
        loop = row.get("item_loop")
        if loop:
            per = "  ".join(f"{p} {n:g}" for p, n in loop["per_item"].items())
            calls = ", ".join(f"{c['kind']} ({c['instructions']} "
                              f"instructions)" for c in loop["calls"])
            lines.append(
                f"  item loop {loop['address']}: {loop['instructions']} "
                f"instructions, {loop['hashes']} item(s) per iteration; per "
                f"item {loop['per_item_total']:g}: {per}; calls in the loop: "
                f"{calls or 'none'}")
        gf = row.get("lookup_loop")
        if gf:
            per = "  ".join(f"{p} {n}" for p, n in gf["by_pipe"].items())
            lines.append(
                f"  lookup loop {gf['address']}: {gf['instructions']} "
                f"instructions, {gf['lookups']} lookups; per lookup "
                f"{gf['per_lookup']:g}, per byte column (k = "
                f"{GF_LOOKUPS_PER_COLUMN}) {gf['per_byte_column']:g}; by pipe: "
                f"{per}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", help="kernel library (default: build this "
                    "checkout's)")
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from ceph_tpu_torch.ops import _build
        lib = _build.build()
    print(format_report(report(lib)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
