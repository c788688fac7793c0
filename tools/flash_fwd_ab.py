#!/usr/bin/env python3
"""Time build variants of the port's bf16 flash forward against each other
on one CUDA card.

    python3 tools/flash_fwd_ab.py [--variant NAME=DEFS ...]
                                  [--tree NAME=DIR ...] [--ablate] [--sass]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is ``paddle_tpu_torch/kernels/csrc/flash_attention.cu`` with
the forward's shape per head_dim rewritten (``DEFS``: ``D:SHAPE`` items
joined by ``;``, SHAPE the four ``FwdShape`` arguments ``MT, WARPS, MINB,
BC``, e.g. ``128:1, 4, 2, 64``; empty for the file's own), linked with the
other sources' objects into its own library under
``paddle_tpu_torch/kernels/_build/ab/``.  ``--tree NAME=DIR``
adds DIR's ``paddle_tpu_torch/kernels/csrc/flash_attention.cu`` (another
checkout's, e.g. the parent commit's) as the variant NAME.  ``--ablate``
adds the file with one part of ``flash_fwd_mma``'s tile loop cut out
(``ABLATIONS``: the exponentials, the whole softmax, the P V product, the
K / V streaming); these compute something else, are timed unchecked and
show what each part costs.  All ``nvcc`` processes start together.

The script prints ptxas' registers, stack frame and spills of each
variant's flash kernels (``--sass``: also the SASS opcode counts of its
``flash_fwd_mma`` instances, the SASS itself written to
``chiprun_out/flash_fwd_sass_<variant>.txt``), checks each variant's bf16
``flash_fwd`` against ``flash_fwd_ref`` on every flash case of
``chip_smoke.py`` (out: 2e-2, or no further from the fp32 result than 1.5
x the plain bf16 version; lse: 1e-4), then times ``flash_fwd`` at
``chip_smoke.py``'s slice, gpt and encoder shapes, the variants in turns
(a, b, ..., b, a), beside the bound and ``scaled_dot_product_attention``'s
forward.  Writes ``chiprun_out/flash_fwd_ab.json``.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

DEFAULT_VARIANTS = ("default=",)
ITERS = 20                       # timed calls a variant and turn

# the forward's tile loop with one part cut out: (old, new) text pairs
# applied to flash_fwd_mma alone
_P = """            const float p = MASK ? ex2((s[mt][j][e] - m[mt][i]) * LOG2E)
                                 : ex2(fmaf(s[mt][j][e], sl2, -mc[mt][i]));"""
_P_RAW = "            const float p = s[mt][j][e];"
ABLATIONS = {
    "no_exp": [(_P, _P_RAW)],
    "no_softmax": [(_P, _P_RAW), ("      float mc[MT][2];", "      /*"),
                   ("      unsigned pa[MT][KP][4];",
                    "*/\n      unsigned pa[MT][KP][4];")],
    "no_pv": [("      mma_ab<MT, ND, KP, LD>(acc, pa, Vs, lane);", "")],
    "no_stream": [("    if (kt + 1 < nkt) stage(kt + 1);", "")],
}


def _ablated(text, cuts):
    """flash_attention.cu's text with ``cuts`` applied inside
    flash_fwd_mma (each old text must occur there once)."""
    a = text.index("    flash_fwd_mma(FlashArgs a) {")
    b = text.index("\n}\n", a)
    body = text[a:b]
    for old, new in cuts:
        if body.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        body = body.replace(old, new)
    return text[:a] + body + text[b:]


# the line that holds the forward's shape for each head_dim
_SHAPE_LINE = {
    "128": r"(template <int D> struct FwdShapeOf \{ using T = FwdShape<)[^>]*>",
    "64": r"(template <> struct FwdShapeOf<64> \{ using T = FwdShape<)[^>]*>"}


def _parse(items):
    """{name: {head_dim: shape}} from NAME=D:SHAPE;D:SHAPE items."""
    out = {}
    for item in items:
        name, _, defs = item.partition("=")
        out[name] = dict(d.split(":", 1) for d in defs.split(";") if d)
    return out


def _reshaped(text, shapes):
    """flash_attention.cu's text with the forward's shapes replaced."""
    for d, shape in shapes.items():
        text, n = re.subn(_SHAPE_LINE[d], lambda m: m.group(1) + shape + ">",
                          text)
        if n != 1:
            raise ValueError(f"no single FwdShapeOf line for D {d}")
    return text


def _ptxas(text):
    """{kernel: "regs R, stack S, spill st/ld X/Y"} from ptxas -v output,
    for the flash kernels."""
    rows, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or "flash" not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_st=int(m.group(2)),
                spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(name, {})["regs"] = int(m.group(1))
    try:
        dem = subprocess.run(["cu++filt"], input="\n".join(rows),
                             capture_output=True, text=True, check=True)
        names = dem.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = list(rows)
    return dict(zip(names, rows.values()))


def _sass(obj, name):
    """Opcode counts of each flash_fwd_mma instance in ``obj``; the SASS
    goes to chiprun_out/flash_fwd_sass_<name>.txt."""
    from paddle_tpu_torch.kernels import build
    dump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(dump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out = ROOT / "chiprun_out" / f"flash_fwd_sass_{name}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "flash_fwd_mma" in m.group(1) else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if fn and m:
            c = counts.setdefault(fn, {})
            op = m.group(2).split(".")[0]
            c[op] = c.get(op, 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]))
            for k, v in counts.items()}


def build_variants(variants, trees, ablate=False):
    """{name: (ctypes library, ptxas table)}."""
    import ctypes
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = build._sources()
    flash = build.CSRC / "flash_attention.cu"
    others = [f for f in cu if f != flash]
    srcs = {}
    for name, shapes in variants.items():
        srcs[name] = out_dir / f"flash_{name}.cu"
        srcs[name].write_text(_reshaped(flash.read_text(), shapes))
    for name, tree in trees.items():
        srcs[name] = (Path(tree).resolve()
                      / "paddle_tpu_torch/kernels/csrc/flash_attention.cu")
    for name, cuts in (ABLATIONS.items() if ablate else ()):
        srcs[name] = out_dir / f"flash_{name}.cu"
        srcs[name].write_text(_ablated(flash.read_text(), cuts))
    cmds = [[nvcc, *build.NVCC_FLAGS, "-c", str(f), "-o",
             str(out_dir / (f.stem + ".o"))] for f in others]
    cmds += [[nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas", "-v",
              "-c", str(src), "-o", str(out_dir / f"flash_{name}.o")]
             for name, src in srcs.items()]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise build.KernelBuildError(f"$ {' '.join(c)}\n{log}")
    libs = {}
    links = {name: [nvcc, *build.NVCC_FLAGS, "-shared",
                    *(str(out_dir / (f.stem + ".o")) for f in others),
                    str(out_dir / f"flash_{name}.o"), "-o",
                    str(out_dir / f"lib_{name}.so")] for name in srcs}
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in links.items()}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise build.KernelBuildError(log)
        lib = ctypes.CDLL(str(out_dir / f"lib_{name}.so"))
        build._bind(lib)
        libs[name] = (lib, _ptxas(logs[len(others) + list(srcs).index(name)]))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention as fc
    card = cs.phase_device()
    trees = dict(t.split("=", 1) for t in args.tree)
    variants = _parse(args.variant or ([] if trees else DEFAULT_VARIANTS))
    libs = build_variants(variants, trees, args.ablate)
    report = {"card": card, "variants": {}}
    for name, (_, table) in libs.items():
        report["variants"][name] = {"ptxas": table}
        for k, v in table.items():
            cs.info(f"ptxas {name}: {k}: {v}")
        if args.sass:
            obj = build.BUILD_DIR / "ab" / f"flash_{name}.o"
            report["variants"][name]["sass"] = ops = _sass(obj, name)
            for k, v in ops.items():
                cs.info(f"sass {name}: {k}: {v}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    order = list(libs) + list(reversed(libs))
    for case in cs.FLASH_CASES + [cs.FLASH_GPT]:
        t32, kw, extra = cs.flash_inputs(case, gen, "cuda")
        q, k, v = (t32[n].to(torch.bfloat16) for n in ("q", "k", "v"))
        fargs = (kw["scale"], kw["causal"], *extra)
        out_p, lse_p = fa.flash_fwd_ref(q, k, v, *fargs)
        o32, _ = fa.flash_fwd_ref(q.float(), k.float(), v.float(), *fargs)
        for name, (lib, _) in libs.items():
            if name in ABLATIONS:
                continue
            build._lib = lib
            out, lse = fc.flash_fwd_cuda(q, k, v, *fargs)
            torch.cuda.synchronize()
            cs.check_close(f"{name} {case[0]} lse", lse, lse_p,
                           cs.TOL["float32"])
            cs.check_layer_out(f"{name} {case[0]} out", out, out_p, o32,
                               cs.TOL["bfloat16"])
        del t32, q, k, v, out_p, lse_p, o32, out, lse
        torch.cuda.empty_cache()
    for case in (cs.FLASH_CASES[0], cs.FLASH_GPT, cs.FLASH_ENC):
        label = case[0]
        t32, kw, extra = cs.flash_inputs(case, gen, "cuda")
        q, k, v = (t32[n].to(torch.bfloat16) for n in ("q", "k", "v"))
        del t32
        fargs = (kw["scale"], kw["causal"], *extra)
        times = {name: [] for name in libs}
        for name in order:
            build._lib = libs[name][0]
            dev, call = cs.time_ms(lambda: fc.flash_fwd_cuda(q, k, v, *fargs),
                                   ITERS, per_launch=True)
            times[name].append(call if dev is None else dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cs.time_ms(lambda: sdpa(qt, kt, vt, is_causal=kw["causal"]),
                            ITERS)[0]
        bms, bby = cs.bound_ms(*cs.flash_bytes_ops(*case[1:8], 2)["flash_fwd"])
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            report["variants"][name][label] = dict(
                ms=ts, mean_ms=mean, bound_ms=bms, bound_by=bby,
                sdpa_fwd_ms=lib_ms, of_bound=bms / mean, x_sdpa=mean / lib_ms)
            cs.info(f"{label} {name}: {ts} ms (mean {mean:.4f}), bound "
                    f"{bms:.4f} ({bby}, {100 * bms / mean:.1f} %), SDPA fwd "
                    f"{lib_ms:.4f} ({mean / lib_ms:.2f}x)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / "flash_fwd_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
