#!/usr/bin/env python3
"""Time builds of the port's weight-only matmul kernels against each other
on one CUDA card.

    python3 tools/wo_ab.py [--tree NAME=DIR ...] [--ablate] [--no-prefill]
                           [--sass]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is a ``quant_linear.cu`` linked with this tree's other
sources' objects into its own library under
``paddle_tpu_torch/kernels/_build/ab/``: ``change`` is this tree's
``paddle_tpu_torch/kernels/csrc/quant_linear.cu``; ``--tree NAME=DIR``
adds DIR's (another checkout's, e.g. the parent commit unpacked by
``git archive`` into the git-ignored ``archive_check/``).  ``--ablate``
adds this tree's file with one part of ``wo_wgmma``'s main loop cut out
(``ABLATIONS``: the widening of the codes; the wgmma; all but the
copies), which compute something else, and with the launcher's x-row
tile fixed at 128 or 256; these are timed unchecked and show what each
part or choice costs.  All ``nvcc`` processes start together.

The script prints ptxas' registers, stack frame and spills of each
variant's ``wo_`` kernels and any note of serialized wgmmas or ignored
``setmaxnreg`` (``--sass``: also the SASS opcode counts of each ``wo_``
kernel, the SASS itself written to ``chiprun_out/wo_sass_<variant>.txt``),
checks each variant against ``weight_only_matmul[_int4]_ref`` on
``CASES`` (bf16 x: within
2e-2 of the plain version, or no further from the fp32 result than 1.5 x
the plain bf16 version, as ``chip_smoke.py`` holds it), then times, the
variants in turns (a, b, ..., b, a):

* the seven block matmuls of one llama_7b layer (``chip_smoke.py``'s
  ``LAYER_MATMULS``, per channel) at M 1024 and M 300, int8 and int4,
  beside the bound, cuBLAS on the codes dequantized to bf16 beforehand,
  times the scale, and the bytes the kernel's TMA copies (``tma_bytes``);
* unless ``--no-prefill``, the prefill of llama_7b at 32 layers, B 8 x
  prompt 128, int8 and int4 (``build_llama_decoder(..., quant=...)``'s
  ``prefill``): wall ms (CUDA events) and the ``wo_`` kernels' device ms.

Writes ``chiprun_out/wo_ab.json``.  Imports nothing of the JAX package.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ITERS = 10                       # timed calls a variant and turn
# (width, M, K, N, group_size): chip_smoke's small cases, the tiled
# kernel's edges, and the layer's shapes at prefill rows
CASES = ([c for c in cs.WO_SMALL if c[1] > 16]
         + [("int8", 17, 4096, 4096, -1), ("int8", 257, 4096, 400, -1),
            ("int4", 257, 301, 400, -1), ("int4", 129, 11008, 4096, 128),
            ("int8", 200, 4096, 1024, 64)]
         + [(w, 1024, K, N, -1) for w in ("int8", "int4")
            for K, N in cs.WO_SHAPES])
REPEATS = 3                      # calls a case: a missing fence shows rarely
ROWS = (1024, 300)
PREFILL_LAYERS, PREFILL_B, PREFILL_S = 32, 8, 128
# quant_linear.cu with one part of wo_wgmma's loop or launcher changed:
# (old, new) text pairs
_WIDEN = """      if (C::INT4) {
        widen_i4(cr[2 * step], plane, A[0], A[1]);
        widen_i4(cr[2 * step + 1], plane, A[2], A[3]);
      } else {
        widen_i8(cr[2 * step], A[0], A[1]);
        widen_i8(cr[2 * step + 1], A[2], A[3]);
      }"""
_NARROW = "  const bool narrow = 3 * waves(128) < 5 * waves(256);"
_MMA = ("      WgmmaRS<C::BM>::mma(acc, A, (plane ? dhi : dlo) + 2 * step, "
        "!fresh);")
ABLATIONS = {
    # the codes' bits go to wgmma as they are
    "no_widen": [(_WIDEN, "      A[0] = A[1] = cr[2 * step];\n"
                          "      A[2] = A[3] = cr[2 * step + 1];")],
    # ldmatrix and widening stay (their result feeds one add), no wgmma
    "no_wgmma": [(_MMA, "      acc[0] += __uint_as_float(A[0] ^ A[1] ^ A[2] "
                        "^ A[3]);")],
    # nothing reads the stages: the TMA stream, barriers and epilogue
    # (ptxas drops the unused ldmatrix and widening)
    "copies_only": [(_MMA, "")],
    # the launcher's choice of x rows a block, fixed
    "rows_128": [(_NARROW, "  const bool narrow = true;")],
    "rows_256": [(_NARROW, "  const bool narrow = false;")],
}
SASS_OPS = ("HGMMA", "HMMA", "PRMT", "FADD", "LOP3", "HFMA2", "LDSM", "LDS",
            "STG", "SYNCS", "UTMALDG")


def _ptxas(text):
    """{kernel: {regs, stack, spill_st, spill_ld}} from ptxas -v output
    for the wo_ kernels, and ptxas' notes of lost performance."""
    rows, name, notes = {}, None, []
    for line in text.splitlines():
        if "Performance Loss" in line or "setmaxnreg" in line:
            notes.append(line.strip())
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or "wo_" not in name:
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
    return dict(zip(names, rows.values())), notes


def _sass(obj, name):
    """Opcode counts of each wo_ kernel in ``obj``; the SASS goes to
    chiprun_out/wo_sass_<name>.txt."""
    from paddle_tpu_torch.kernels import build
    dump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(dump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out = ROOT / "chiprun_out" / f"wo_sass_{name}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "wo_" in m.group(1) else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if fn and m:
            c = counts.setdefault(fn, {})
            op = m.group(2).split(".")[0]
            c[op] = c.get(op, 0) + 1
    return {k: {op: v.get(op, 0) for op in SASS_OPS} | {"total": sum(
        v.values())} for k, v in counts.items()}


def _ablated(text, cuts):
    """quant_linear.cu's text with ``cuts`` applied (each old text must
    occur in it once)."""
    for old, new in cuts:
        if text.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(srcs):
    """{name: (ctypes library, ptxas table, ptxas notes, object path)}
    for ``srcs`` {name: quant_linear.cu path}."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = build._sources()
    ql = build.CSRC / "quant_linear.cu"
    others = [f for f in cu if f != ql]
    cmds = [[nvcc, *build.NVCC_FLAGS, "-c", str(f), "-o",
             str(out_dir / (f.stem + ".o"))] for f in others]
    cmds += [[nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas",
              "-v", "-c", str(src), "-o", str(out_dir / f"wo_{name}.o")]
             for name, src in srcs.items()]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise build.KernelBuildError(f"$ {' '.join(c)}\n{log}")
    libs = {}
    for i, name in enumerate(srcs):
        so = out_dir / f"lib_wo_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(out_dir / (f.stem + ".o")) for f in others),
                        str(out_dir / f"wo_{name}.o"), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        build._bind(lib)
        table, notes = _ptxas(logs[len(others) + i])
        libs[name] = (lib, table, notes, out_dir / f"wo_{name}.o")
    return libs


def check_variant(name, gen):
    """Every case of CASES, REPEATS calls each, against the plain
    version; raises on the first miss."""
    import torch
    from paddle_tpu_torch.nn.quant import weight_quantize
    worst = 0.0
    for width, M, K, N, gs in CASES:
        fn, ref = cs.wo_fns(width)
        w = 0.02 * torch.randn(K, N, device="cuda", generator=gen)
        codes, scale = weight_quantize(w, f"weight_only_{width}",
                                       group_size=gs)
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        plain = ref(x, codes, scale, group_size=gs)
        truth = ref(x.float(), codes, scale, group_size=gs)
        for i in range(REPEATS):
            got = fn(x, codes, scale, group_size=gs)
            torch.cuda.synchronize()
            ratios = []
            cs.check_layer_out(f"{name} {width} M {M} [{K}, {N}] group {gs} "
                               f"call {i}", got, plain, truth,
                               cs.TOL["bfloat16"], ratios)
            worst = max(worst, ratios[0])
    return worst


def tma_bytes(M, K, N, width, bm):
    """Bytes the prefill kernel's TMA copies into shared memory for one
    matmul at ``bm`` x rows a block: each 128-channel tile loads its x
    rows' columns again (64-row stages of codes, 64-column x boxes, two
    x boxes a stage for int4)."""
    planes = 2 if width == "int4" else 1
    rows = -(-K // 2) if width == "int4" else K
    blocks = -(-N // 128) * -(-M // bm)
    return blocks * -(-rows // 64) * (planes * bm * 128 + 64 * 128)


def layer_weights(width, gen):
    import torch
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.quant_linear import unpack_int4
    out = []
    for _, K, N in cs.LAYER_MATMULS:
        codes, scale = weight_quantize(
            0.02 * torch.randn(K, N, device="cuda", generator=gen),
            f"weight_only_{width}")
        wdq = (codes if width == "int8" else unpack_int4(codes, K)).to(
            torch.bfloat16)
        out.append((K, N, codes, scale, wdq))
    return out


def wo_device_ms(breakdown):
    hit = [(mean, n) for k, (mean, n) in breakdown.items() if "wo_" in k]
    return sum(mean * n for mean, n in hit) if hit else None


def time_layers(libs, order, gen, report):
    import torch
    from paddle_tpu_torch.kernels import build
    for width in ("int8", "int4"):
        fn, _ = cs.wo_fns(width)
        lw = layer_weights(width, gen)
        for M in ROWS:
            xs = {K: torch.randn(M, K, device="cuda", generator=gen).to(
                torch.bfloat16) for K in {K for _, K, _ in cs.LAYER_MATMULS}}

            def kernels():
                for K, N, codes, scale, _ in lw:
                    fn(xs[K], codes, scale)

            def library():
                for K, N, codes, scale, wdq in lw:
                    torch.matmul(xs[K], wdq) * scale
            times = {name: [] for name in libs}
            for name in order:
                build._lib = libs[name][0]
                by = {}
                _, call = cs.time_ms(kernels, ITERS, by)
                dev = wo_device_ms(by)
                times[name].append(call if dev is None else dev)
            lib_ms = cs.time_ms(library, ITERS)[0]
            nbytes = ops = 0
            for K, N, *_ in lw:
                b, o = cs.wo_bytes_ops(M, K, N, width)
                nbytes, ops = nbytes + b, ops + o
            bms, bby = cs.bound_ms(nbytes, ops)
            label = f"layer {width} M {M}"
            tb = {bm: sum(tma_bytes(M, K, N, width, bm) for _, K, N in
                          cs.LAYER_MATMULS) for bm in (128, 256)}
            report.setdefault("tma_bytes", {})[label] = tb
            cs.info(f"{label}: TMA copies {tb[128] / 1e9:.3f} / "
                    f"{tb[256] / 1e9:.3f} GB at 128 / 256 x rows a block")
            for name, ts in times.items():
                mean = sum(ts) / len(ts)
                report["variants"][name][label] = dict(
                    ms=ts, mean_ms=mean, bound_ms=bms, bound_by=bby,
                    cublas_ms=lib_ms, of_bound=bms / mean,
                    x_cublas=mean / lib_ms)
                cs.info(f"{label} {name}: {ts} ms (mean {mean:.4f}), bound "
                        f"{bms:.4f} ({bby}, {100 * bms / mean:.1f} %), "
                        f"cuBLAS on the dequantized weight {lib_ms:.4f} "
                        f"({mean / lib_ms:.2f}x)")
            del xs
        del lw
        torch.cuda.empty_cache()


def time_prefill(libs, order, report):
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models import generation as tgen
    from paddle_tpu_torch.models import llama as tllama
    cfg = tllama.llama_7b(num_layers=PREFILL_LAYERS, dtype="bfloat16")
    params = tllama.init_params(cfg, make_generator(cs.SEED, "cuda"),
                                device="cuda")
    ids = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to("cuda")
    for width in ("int8", "int4"):
        quant = f"weight_only_{width}"
        p = tgen.quantize_llama_params(params, quant)
        prefill, _ = tgen.build_llama_decoder(cfg, 2 * PREFILL_S, quant=quant)
        times = {name: [] for name in libs}
        with torch.inference_mode():
            for name in order:
                build._lib = libs[name][0]
                by = {}
                _, call = cs.time_ms(lambda: prefill(p, ids), 3, by)
                times[name].append((call, wo_device_ms(by)))
        label = f"prefill llama_7b x {PREFILL_LAYERS} {width}"
        for name, ts in times.items():
            wall = sum(c for c, _ in ts) / len(ts)
            wo = [d for _, d in ts if d is not None]
            report["variants"][name][label] = dict(
                wall_ms=[c for c, _ in ts], mean_wall_ms=wall,
                wo_device_ms=[d for _, d in ts],
                mean_wo_device_ms=sum(wo) / len(wo) if wo else None)
            cs.info(f"{label} {name}: wall {[round(c, 2) for c, _ in ts]} ms "
                    f"(mean {wall:.2f}); wo_ kernels "
                    f"{[d and round(d, 2) for _, d in ts]} ms")
        del p, prefill
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--no-prefill", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import build
    card = cs.phase_device()
    srcs = {}
    for item in args.tree:
        name, _, tree = item.partition("=")
        srcs[name] = (Path(tree).resolve()
                      / "paddle_tpu_torch/kernels/csrc/quant_linear.cu")
    srcs["change"] = build.CSRC / "quant_linear.cu"
    for name, cuts in (ABLATIONS.items() if args.ablate else ()):
        srcs[name] = build.BUILD_DIR / "ab" / f"ql_{name}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(_ablated(srcs["change"].read_text(), cuts))
    libs = build_variants(srcs)
    report = {"card": card, "variants": {}}
    for name, (_, table, notes, obj) in libs.items():
        report["variants"][name] = {"ptxas": table, "wgmma_notes": notes}
        for k, v in table.items():
            cs.info(f"ptxas {name}: {k}: {v}")
        for line in notes:
            cs.info(f"ptxas {name}: {line}")
        if args.sass:
            report["variants"][name]["sass"] = ops = _sass(obj, name)
            for k, v in ops.items():
                cs.info(f"sass {name}: {k}: {v}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for name, (lib, *_) in libs.items():
        if name in ABLATIONS:
            continue
        build._lib = lib
        report["variants"][name]["bf16_vs_fp32_ratio"] = check_variant(
            name, gen)
    order = list(libs) + list(reversed(libs))
    time_layers(libs, order, gen, report)
    if not args.no_prefill:
        whole = [n for n in order if n not in ABLATIONS]
        time_prefill({n: libs[n] for n in whole}, whole, report)
    out = ROOT / "chiprun_out" / "wo_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
