"""Compare the SASS of this checkout's kernel libraries with another
checkout's, function by function, on a machine with the CUDA toolkit.

    python -m paddle_tpu_torch.tools.sass_compare --against DIR
        [--libs moe_dispatch,adamw_q,ragged_paged_attention,flash_bwd]
        [--dtype bf16[,f16,f32]] [--skip REGEX]

Builds `paddle_tpu_torch/csrc/<lib>.cu` of this checkout and of DIR (the
root of another checkout, such as an unpacked parent under the ignored
`build/`) with this checkout's nvcc flags, one process per source, all
at once, and lists each library's functions with `cuobjdump -sass`. A
function's element type is its template argument (`__nv_bfloat16`,
`__half` or `float` in its mangled name); a function that names none is
taken as bf16, the type every kernel took before it had options (so the
kernels templated on head_dim alone, as flash_f32's, count as bf16).
`--skip` leaves out, on both sides, the functions whose mangled names
match REGEX (kernels this checkout redesigned: `--libs rms_norm --skip
rms_fused_kernel` holds rows 7 and 8 alone). For the functions of each
type of `--dtype` it prints one JSON line a library: how many each
build has, and how many of this build's have a function in the other
build with the same instructions (addresses and encodings stripped; the
names may differ, since a kernel that became a template gains its type
in its name), and the two builds' instruction counts by opcode where
they differ. Exits 1 when a library's functions of that type are not all
matched. The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

LIBS = ("moe_dispatch", "adamw_q", "ragged_paged_attention", "flash_bwd")
_TYPE = re.compile(r"I(13__nv_bfloat16|6__half|f)(?=L|E)")
_TAGS = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
_COMMENT = re.compile(r"/\*.*?\*/")


def functions(sass: str):
    """{mangled name: (element type, [instruction text])} of a
    `cuobjdump -sass` listing."""
    out = {}
    for fn in sass.split("Function : ")[1:]:
        head, body = fn.split("\n", 1)
        m = _TYPE.search(head)
        tag = _TAGS[m.group(1)] if m else "bf16"
        ins = []
        for line in body.splitlines():
            text = " ".join(_COMMENT.sub("", line).split())
            if text.endswith(";"):
                ins.append(text)
        out[head.strip()] = (tag, ins)
    return out


def build(nvcc, flags, src: Path, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([nvcc, *flags, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def main(argv=None) -> int:
    from paddle_tpu_torch import _build
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True)
    ap.add_argument("--libs", default=",".join(LIBS))
    ap.add_argument("--dtype", default="bf16",
                    help="comma-separated, of " + ", ".join(
                        sorted(_TAGS.values())))
    ap.add_argument("--skip", default=None)
    args = ap.parse_args(argv)
    dtypes = args.dtype.split(",")
    if not set(dtypes) <= set(_TAGS.values()):
        ap.error(f"--dtype takes {sorted(_TAGS.values())}")
    skip = re.compile(args.skip) if args.skip else None
    other = Path(args.against).resolve() / "paddle_tpu_torch" / "csrc"
    here = _build.CSRC
    out_dir = _build.BUILD_DIR / "sass_compare"
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = args.libs.split(",")
    procs = []
    for lib in libs:
        for side, root in (("this", here), ("other", other)):
            procs.append((lib, side, out_dir / f"{side}_lib{lib}.so",
                          build(nvcc, flags, root / f"{lib}.cu",
                                out_dir / f"{side}_lib{lib}.so")))
    ok = True
    built = {}
    for lib, side, path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"lib": lib, "side": side, "build": log[-2000:]}))
            return 1
        sass = subprocess.run([_build.cuobjdump(), "-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout
        built[(lib, side)] = {n: f for n, f in functions(sass).items()
                              if skip is None or not skip.search(n)}
    for lib, dtype in ((lib, d) for lib in libs for d in dtypes):
        mine = {n: i for n, (t, i) in built[(lib, "this")].items()
                if t == dtype}
        theirs = {n: i for n, (t, i) in built[(lib, "other")].items()
                  if t == dtype}
        pool = Counter(tuple(i) for i in theirs.values())
        matched = 0
        unmatched = []
        for name, ins in mine.items():
            if pool[tuple(ins)] > 0:
                pool[tuple(ins)] -= 1
                matched += 1
            else:
                unmatched.append(name)
        ops_mine = Counter(x.split()[0] for i in mine.values() for x in i)
        ops_theirs = Counter(x.split()[0] for i in theirs.values() for x in i)
        diff = {op: [ops_theirs.get(op, 0), ops_mine.get(op, 0)]
                for op in sorted(set(ops_mine) | set(ops_theirs))
                if ops_mine.get(op, 0) != ops_theirs.get(op, 0)}
        same = matched == len(mine) == len(theirs)
        ok = ok and same
        print(json.dumps({"lib": lib, "dtype": dtype,
                          "functions_this": len(mine),
                          "functions_other": len(theirs),
                          "identical": matched, "all_identical": same,
                          "instructions_this": sum(map(len, mine.values())),
                          "instructions_other": sum(map(len,
                                                        theirs.values())),
                          "opcode_counts_other_this": diff,
                          "unmatched": unmatched}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
