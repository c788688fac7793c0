#!/usr/bin/env python3
"""Time builds of the serving chain's GEMM kernels (``gemm_xw``) against
each other on one CUDA card.

    python3 tools/gemm_ab.py [--tree NAME=DIR ...] [--ablate] [--sass]
                             [--only NAME,...] [--no-time] [--turns N]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is a ``gemm.cu`` linked with this tree's other sources'
objects into its own library under ``paddle_tpu_torch/kernels/_build/ab/``:
``change`` is this tree's ``paddle_tpu_torch/kernels/csrc/gemm.cu``;
``--tree NAME=DIR`` adds DIR's (another checkout's, e.g. the parent commit
unpacked by ``git archive`` into the git-ignored ``archive_check/``).
``--ablate`` adds this tree's file with the choices of ``TUNINGS`` (the
fold's weight in the choice of K splits; 64-row tiles above M 64; the
tensor maps prefetched; an unsplit launch with the cluster attribute;
three decode blocks an SM; the epilogue's pairs a round), which are
checked and timed like a tree, and
with one part of the bf16 body cut out (``ABLATIONS``: the wgmmas; the
epilogue's stores; the epilogue; the exchange of the K splits' partial
slices and the epilogue; both of those and the wgmmas, leaving the TMA
ring alone), which compute something else and are timed unchecked.
``--only`` keeps the named variants.  All ``nvcc`` processes start
together.

The script prints ptxas' registers, stack frame and spills of each
variant's ``gemm`` kernels and any note of serialized wgmmas or ignored
``setmaxnreg`` (``--sass``: also the SASS opcode counts of each kernel,
the SASS itself written to ``chiprun_out/gemm_sass_<variant>.txt``), the
launch plan of each timed shape where the library has one
(``pt_gemm_xw_plan``: x rows a tile, blocks an SM, K splits, tiles, and
the clusters the card keeps resident), and checks each checked variant on
``CASES`` (bf16 and fp32 against ``gemm_xw_ref`` by ``chip_smoke.py``'s
rule, 2e-2 / 1e-4; each case called twice, bit-identical, one launch of
the regime's kernel each).  Unless ``--no-time`` it then times, the
variants in turns (a, b, ..., b, a; ``--turns N`` runs that order N
times), the chain's four GEMMs of a llama_7b layer (q, o + residual,
gate/up SwiGLU, down + residual) at M 4, 16, 64 and 256, each call on a
weight the L2 does not hold (copies in rotation), beside the bound and
cuBLAS (``torch.matmul``; two calls for SwiGLU), and the host time of one
``gemm_xw_cuda`` call (enqueue only, the median of 30).

Writes ``chiprun_out/gemm_ab.json``.  Imports nothing of the JAX package.
"""

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ITERS = 20                       # timed calls a variant, shape and turn
# (M, K, N, epi): both regimes at their edges (M 8 / 9 / 16 / 17, one
# 256-row tile and past it), K past a 64-row step, N past a 128-column
# tile, and the chain's shapes
CASES = ([(M, 520, 264, e) for M in (1, 8, 9, 16, 17, 64, 255, 256, 300)
          for e in ("none", "resid", "swiglu")]
         + [(M, 4096, 4096, "none") for M in (4, 256)]
         + [(M, 11008, 4096, "resid") for M in (4, 64)]
         + [(M, 4096, 11008, "swiglu") for M in (16, 256)])
# the chain's GEMMs of one llama_7b layer: (label, K, N, epi)
CHAIN = (("q", 4096, 4096, "none"), ("o", 4096, 4096, "resid"),
         ("gate_up", 4096, 11008, "swiglu"), ("down", 11008, 4096, "resid"))
ROWS = (4, 16, 64, 256)
COLD_BYTES = 120e6               # weight copies rotate past the 50 MB L2
_MMA = """      WgmmaSS<C::NX, 1, 0>::mma(acc, da + 128 * kk, db + 2 * kk,
                                it > 0 || kk > 0);"""
_PUSH = "  splitk::push<C::NX>(red, recv, recv_bar, S, rank, tid);"
_EPI = "    for (int p0 = tid; p0 < P; p0 += 256 * U) {"
_U = "    constexpr int U = C::NX <= 16 ? 1 : 4;"
_STORE = """          *reinterpret_cast<__nv_bfloat162 *>(
              a.Y + out_index(m0 + r0 + r, n0 + c, a.M, a.N, a.qkv_d)) ="""
_PRODUCER = "    if (warp == 8 && lane == 0) {\n"
_SMALL = "using S8 = Cfg<8, 6, 2>;\nusing S16 = Cfg<16, 6, 2>;"
_LAUNCH = "  cfg.numAttrs = p.splits > 1;"
_FOLD_STEPS = "constexpr int FOLD_STEPS = 12;"
_ROWS = "M <= 32 ? 2 : M <= 64 ? 3 : 4;"
# gemm.cu with one choice of the launch plan changed: (old, new) text
# pairs; checked and timed like a tree
TUNINGS = {
    # the fold's weight in the choice of K splits
    "fold_steps_4": [(_FOLD_STEPS, _FOLD_STEPS.replace("12", "4"))],
    # M > 32 as 64-row tiles, two blocks an SM
    "rows_64": [(_ROWS, "M <= 32 ? 2 : 3;")],
    # the producer prefetches the three tensor maps before its first load
    "tmap_prefetch": [(_PRODUCER, _PRODUCER + "".join(
        f'      asm volatile("prefetch.tensormap [%0];" :: '
        f'"l"((uint64_t){m}) : "memory");\n' for m in ("tw", "tw2", "tx")))],
    # an unsplit launch with the cluster attribute (a cluster of one)
    "cluster_1": [(_LAUNCH, "  cfg.numAttrs = 1;")],
    # decode: three blocks an SM, 4 stages each
    "small_3": [(_SMALL, "using S8 = Cfg<8, 4, 3>;\nusing S16 = Cfg<16, 4, 3>;")],
    # the epilogue's pairs a thread and round, the same in every instance
    "epi_u1": [(_U, "    constexpr int U = 1;")],
    "epi_u4": [(_U, "    constexpr int U = 4;")],
    "epi_u8": [(_U, "    constexpr int U = 8;")],
}
_NO_EPI = (_EPI, _EPI.replace("p0 = tid;", "p0 = P;"))
# the fold's exchange as a split of one (its barriers kept, no copies, no
# wait)
_NO_FOLD = [(_PUSH, _PUSH.replace("S, rank", "1, 0")), _NO_EPI]
# gemm.cu with one part of the bf16 body cut: (old, new) text pairs;
# timed unchecked
ABLATIONS = {
    # the ring, the staging, the fold and the stores; no wgmma
    "copies_only": [(_MMA, "      (void)da, (void)db;")],
    # the epilogue's loads and arithmetic, stores only of a value it
    # never holds (so the arithmetic stays)
    "epi_no_store": [(_STORE, "          if (x[u].x == 1.2345e-30f) "
                              + _STORE.strip())],
    # the ring, the wgmmas and the exchange of the partial slices; no
    # epilogue, no stores
    "no_epilogue": [_NO_EPI],
    # the ring and the wgmmas (kept live by the staging); no exchange, no
    # epilogue, no stores
    "no_fold": _NO_FOLD,
    # the TMA ring and its barriers alone
    "ring_only": [(_MMA, "      (void)da, (void)db;")] + _NO_FOLD,
}
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "BAR", "LDS", "STS", "LD", "STG",
            "LDG", "FADD", "MUFU")
PLAN_KEYS = ("nx", "blocks_per_sm", "splits", "row_tiles", "col_tiles",
             "k_steps", "resident_clusters")


def _ptxas(text):
    """{kernel: {regs, stack, spill_st, spill_ld}} from ptxas -v output
    for the gemm kernels, and ptxas' notes of lost performance."""
    rows, name, notes = {}, None, []
    for line in text.splitlines():
        if "Performance Loss" in line or "setmaxnreg" in line:
            notes.append(line.strip())
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or "gemm" not in name:
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
    """Opcode counts of each gemm kernel in ``obj``; the SASS goes to
    chiprun_out/gemm_sass_<name>.txt."""
    from paddle_tpu_torch.kernels import build
    dump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(dump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out = ROOT / "chiprun_out" / f"gemm_sass_{name}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "gemm" in m.group(1) else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if fn and m:
            c = counts.setdefault(fn, {})
            op = m.group(2).split(".")[0]
            c[op] = c.get(op, 0) + 1
    return {k: {op: v.get(op, 0) for op in SASS_OPS} | {"total": sum(
        v.values())} for k, v in counts.items()}


def _edited(text, cuts):
    """gemm.cu's text with ``cuts`` applied (each old text occurs once)."""
    for old, new in cuts:
        if text.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(srcs):
    """{name: (ctypes library, ptxas table, ptxas notes, object path)}
    for ``srcs`` {name: gemm.cu path}."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = build._sources()
    gm = build.CSRC / "gemm.cu"
    others = [f for f in cu if f != gm]
    cmds = [[nvcc, *build.NVCC_FLAGS, "-c", str(f), "-o",
             str(out_dir / (f.stem + ".o"))] for f in others]
    cmds += [[nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas",
              "-v", "-c", str(src), "-o", str(out_dir / f"gemm_{name}.o")]
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
        so = out_dir / f"lib_gemm_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(out_dir / (f.stem + ".o")) for f in others),
                        str(out_dir / f"gemm_{name}.o"), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        build._bind(lib)
        table, notes = _ptxas(logs[len(others) + i])
        libs[name] = (lib, table, notes, out_dir / f"gemm_{name}.o")
    return libs


def plan(lib, M, K, N, epi):
    """The library's launch plan of one bf16 call, or None where the
    library has no ``pt_gemm_xw_plan`` (a tree before it)."""
    from paddle_tpu_torch.kernels import build
    try:
        fn = lib.pt_gemm_xw_plan
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    code = {"none": build.EPI_NONE, "resid": build.EPI_RESID,
            "swiglu": build.EPI_SWIGLU}[epi]
    build.check(fn(M, K, N, code, out), "pt_gemm_xw_plan")
    return dict(zip(PLAN_KEYS, out))


def operands(M, K, N, epi, dt, gen, copies=1):
    """x [M, K], ``copies`` weights [K, N] (and as many w2 for SwiGLU), the
    residual for ``resid``; std 0.02 weights as chip_smoke's layer."""
    import torch

    def t(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda",
                                    generator=gen)).to(dt)
    ws = [t(K, N, scale=0.02) for _ in range(copies)]
    w2s = [t(K, N, scale=0.02) for _ in range(copies)] \
        if epi == "swiglu" else [None] * copies
    r = t(M, N) if epi == "resid" else None
    return t(M, K), ws, w2s, r


def call(fn, x, w, w2, r):
    kw = {"w2": w2} if w2 is not None else \
        {"residual": r} if r is not None else {}
    return fn(x, w, **kw)


def check_variant(name, gen):
    """Every case of CASES in bf16 (and the small ones in fp32), twice
    each: within tolerance of the plain version, bit-identical, one launch
    of the regime's kernel a call; raises on the first miss.  Returns the
    largest |kernel - plain| in bf16."""
    import torch
    from paddle_tpu_torch.ops.cuda import kernels as K
    from paddle_tpu_torch.ops.cuda import layer
    worst = 0.0
    for M, Kd, N, epi in CASES:
        for dtn, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
            if dt == torch.float32 and Kd > 1024:
                continue
            x, (w,), (w2,), r = operands(M, Kd, N, epi, dt, gen)
            ref = call(K.gemm_xw_ref, x, w, w2, r)
            outs = []
            for _ in range(2):
                layer.reset_counts()
                outs.append(call(K.gemm_xw_cuda, x, w, w2, r))
                torch.cuda.synchronize()
                got = {k: v for k, v in layer.launch_counts().items() if v}
                want = "gemm_xw_f32" if dt == torch.float32 else \
                    "gemm_xw_small_m" if M <= 16 else "gemm_xw_tiled"
                if got != {want: 1}:
                    raise cs.SmokeFailure(f"{name} M {M} [{Kd}, {N}] {epi} "
                                          f"{dtn}: launches {got}")
            label = f"{name} gemm_xw M {M} [{Kd}, {N}] {epi} {dtn}"
            err = cs.check_close(label, outs[0], ref, cs.TOL[dtn])
            if not torch.equal(outs[0], outs[1]):
                raise cs.SmokeFailure(f"{label}: two calls differ")
            if dt == torch.bfloat16:
                worst = max(worst, err)
    cs.info(f"{name}: {len(CASES)} cases correct, bit-identical twice, one "
            f"launch each; max |kernel - plain| bf16 {worst:.3e}")
    return worst


def bytes_ops(M, K, N, epi):
    nw = 2 if epi == "swiglu" else 1
    nbytes = (M * K + nw * K * N + M * N + (M * N if epi == "resid" else 0))
    return 2 * nbytes, 2 * nw * M * K * N


def time_chain(libs, order, gen, report):
    """Device ms a launch of each chain GEMM at each M, the variants in
    ``order``, each call on the next of the weight copies."""
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops.cuda import kernels as K
    for label, Kd, N, epi in CHAIN:
        nw = 2 if epi == "swiglu" else 1
        copies = max(1, math.ceil(COLD_BYTES / (2 * nw * Kd * N)))
        for M in ROWS:
            x, ws, w2s, r = operands(M, Kd, N, epi, torch.bfloat16, gen,
                                     copies)
            turn = [0]

            def nxt(fn):
                i = turn[0] = (turn[0] + 1) % copies
                return call(fn, x, ws[i], w2s[i], r)

            def library():
                i = turn[0] = (turn[0] + 1) % copies
                y = torch.matmul(x, ws[i])
                if w2s[i] is not None:
                    torch.matmul(x, w2s[i])
                return y
            times = {name: [] for name in libs}
            hosts = {name: [] for name in libs}
            for name in order:
                build._lib = libs[name][0]
                ms, call_ms = cs.time_ms(lambda: nxt(K.gemm_xw_cuda), ITERS,
                                         per_launch=True)
                times[name].append(call_ms if ms is None else ms)
                hosts[name].append(cs.host_ms(lambda: nxt(K.gemm_xw_cuda)))
            lib_ms = cs.time_ms(library, ITERS)[0]
            bms, bby = cs.bound_ms(*bytes_ops(M, Kd, N, epi))
            key = f"{label} M {M} [{Kd}x{N}] {epi}"
            for name, ts in times.items():
                mean = sum(ts) / len(ts)
                p = plan(libs[name][0], M, Kd, N, epi)
                report["variants"][name][key] = dict(
                    ms=ts, mean_ms=mean, bound_ms=bms, bound_by=bby,
                    cublas_ms=lib_ms, of_bound=bms / mean,
                    x_cublas=mean / lib_ms, host_ms=hosts[name], plan=p)
                cs.info(f"{key} {name}: {[round(t, 5) for t in ts]} ms "
                        f"(mean {mean:.5f}), bound {bms:.5f} ({bby}, "
                        f"{100 * bms / mean:.1f} %), cuBLAS {lib_ms:.5f} "
                        f"({mean / lib_ms:.2f}x), host ms a call "
                        f"{[round(h, 4) for h in hosts[name]]}; plan {p}")
            del x, ws, w2s, r
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--turns", type=int, default=1)
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
                      / "paddle_tpu_torch/kernels/csrc/gemm.cu")
    srcs["change"] = build.CSRC / "gemm.cu"
    for name, cuts in ({**TUNINGS, **ABLATIONS}.items() if args.ablate
                       else ()):
        srcs[name] = build.BUILD_DIR / "ab" / f"gemm_{name}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(_edited(srcs["change"].read_text(), cuts))
    if args.only:
        keep = args.only.split(",")
        srcs = {k: v for k, v in srcs.items() if k in keep}
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
        report["variants"][name]["max_abs_err"] = check_variant(name, gen)
    if not args.no_time:
        order = (list(libs) + list(reversed(libs))) * args.turns
        time_chain(libs, order, gen, report)
    out = ROOT / "chiprun_out" / "gemm_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
