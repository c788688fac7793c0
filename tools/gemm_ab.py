#!/usr/bin/env python3
"""Time builds of the serving chain's GEMM kernels (``gemm_xw``) against
each other on one CUDA card.

    python3 tools/gemm_ab.py [--tree NAME=DIR ...] [--ablate] [--sass]
                             [--only NAME,...] [--no-time] [--turns N]
                             [--chain llama,gpt]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is a ``gemm.cu`` linked with this tree's other sources'
objects into its own library under ``paddle_tpu_torch/kernels/_build/ab/``:
``change`` is this tree's ``paddle_tpu_torch/kernels/csrc/gemm.cu``;
``--tree NAME=DIR`` adds DIR's (another checkout's, e.g. the parent commit
unpacked by ``git archive`` into the git-ignored ``archive_check/``).
``--ablate`` adds this tree's file with the choices of ``TUNINGS`` (the
fold's weight in the choice of K splits at M <= 64 and above; above M 64
the tile fixed at 128 x 128 or 64 x 64, and the K split fixed; the
64 x 64 tiles' blocks an SM and ring; the tensor maps prefetched; an
unsplit launch with the cluster attribute; three decode blocks an SM),
which are checked and
timed like a tree, and with one part of the bf16 body cut out
(``ABLATIONS``: the wgmmas; the epilogue's stores; the epilogue; the
exchange of the K splits' partial slices and the epilogue; both of those
and the wgmmas, leaving the TMA ring alone; every K step, leaving the
launch, the staging, the fold and the stores), which compute something
else and are timed unchecked.  ``--only`` keeps the named variants.  All
``nvcc`` processes start together.

The script prints ptxas' registers, stack frame and spills of each
variant's ``gemm`` kernels and any note of serialized wgmmas or ignored
``setmaxnreg`` (``--sass``: also the SASS opcode counts of each kernel,
the SASS itself written to ``chiprun_out/gemm_sass_<variant>.txt``), the
launch plan of each timed shape where the library has one
(``pt_gemm_xw_plan``: x rows a tile, blocks an SM, K splits, tiles, the
clusters the card keeps resident and W columns a tile), and checks each
checked variant on ``CASES`` (bf16 and fp32 against ``gemm_xw_ref`` by
``chip_smoke.py``'s rule, 2e-2 / 1e-4, the qkv product against
``qkv_split_ref``; each case called twice, bit-identical, one launch of
the regime's kernel each).  Unless ``--no-time`` it then times, the
variants in turns (a, b, ..., b, a; ``--turns N`` runs that order N
times), ``--chain``'s GEMMs: ``llama``, the four of a llama_7b layer (q,
o + residual, gate/up SwiGLU, down + residual) at M 4, 16, 64 and 256,
each call on a weight the L2 does not hold (copies in rotation); ``gpt``,
the four of a GPT-125M layer (``chip_smoke.GPT_MATMULS``: qkv + bias
stored split at D 64 and, beside it, stored row-major; proj and fc2 +
bias + residual; fc1 + bias, GELU) at M 4 and 256 on one warm weight, as
``chip_smoke.py`` times them; each beside the bound and the library
(``torch.matmul``, two calls for SwiGLU; the GPT rows' bias, GELU and
residual as torch ops after it), and the host time of one
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
# tile, the chain's shapes, and GPT-125M's with their epilogues (the qkv
# split at D 64, and at D 32 and 128 on 576 / 768 columns)
CASES = ([(M, 520, 264, e) for M in (1, 8, 9, 16, 17, 64, 255, 256, 300)
          for e in ("none", "resid", "swiglu")]
         + [(M, 4096, 4096, "none") for M in (4, 256)]
         + [(M, 11008, 4096, "resid") for M in (4, 64)]
         + [(M, 4096, 11008, "swiglu") for M in (16, 256)]
         + [(M, 768, 2304, "bias_qkv") for M in (4, 17, 256, 300)]
         + [(M, 768, 768, "bias_resid") for M in (4, 256)]
         + [(M, 768, 3072, "bias_gelu") for M in (4, 256, 300)]
         + [(M, 3072, 768, "bias_resid") for M in (4, 256)]
         + [(M, 520, 576, "bias_qkv32") for M in (9, 256)]
         + [(M, 520, 768, "bias_qkv128") for M in (9, 256)])
# the chains' GEMMs: (label, K, N, epi); llama_7b's on cold weights at
# LLAMA_ROWS, GPT-125M's on a warm one at GPT_ROWS
CHAINS = {
    "llama": (("q", 4096, 4096, "none"), ("o", 4096, 4096, "resid"),
              ("gate_up", 4096, 11008, "swiglu"),
              ("down", 11008, 4096, "resid")),
    "gpt": tuple((label, K, N, "bias_qkv" if epi == "bias" else epi)
                 for label, K, N, epi in cs.GPT_MATMULS)
    + (("qkv_rowmajor", 768, 2304, "bias"),),
}
LLAMA_ROWS = (4, 16, 64, 256)
GPT_ROWS = (4, 256)
COLD_BYTES = 120e6               # weight copies rotate past the 50 MB L2
# the epilogues' qkv head dims (the split store)
QKV_D = {"bias_qkv": 64, "bias_qkv32": 32, "bias_qkv128": 128}
_MMA = """      WgmmaSS<C::NX, 1, 0>::mma(acc, da + 128 * kk, db + 2 * kk,
                                it > 0 || kk > 0);"""
_PUSH = "  splitk::push<C::NX, C::BN>(red, recv, recv_bar, S, rank, tid);"
_EPI = "  for (int p = tid; p < rows << lg; p += C::CONSUMERS) {"
_STORE = "    dst.store(a.Y, m0 + r0 + r, o);"
_N64 = "using N64 = Cfg<1, 64, 4, 3>;"
_KB1 = "  const int kb1 = (int)((long long)a.nk * (rank + 1) / S);"
_PRODUCER = "    if (warp == 4 * C::WG && lane == 0) {\n"
_SMALL = "using S8 = Cfg<2, 8, 6, 2>;\nusing S16 = Cfg<2, 16, 6, 2>;"
_LAUNCH = "  if (p.splits > 1) {"
_FOLD_STEPS = "constexpr int FOLD_STEPS = 12;"
_FORCE = "constexpr int XW_FORCE_INST = -1, XW_FORCE_SPLIT = 0;"
_FOLD_KB = "constexpr int FOLD_KB = 16;"
_INSTS = {"t128": 4, "n64": 5}


def _force(inst=-1, split=0):
    return [(_FORCE, _FORCE.replace("= -1", f"= {inst}").replace(
        "SPLIT = 0", f"SPLIT = {split}"))]


# gemm.cu with one choice of the launch plan changed: (old, new) text
# pairs; checked and timed like a tree
TUNINGS = {
    # the fold's weight in the choice of K splits at M <= 64
    "fold_steps_4": [(_FOLD_STEPS, _FOLD_STEPS.replace("12", "4"))],
    # above M 64: the fold weighed at half and at twice the model's
    "fold_kb_half": [(_FOLD_KB, _FOLD_KB.replace("16", "8"))],
    "fold_kb_twice": [(_FOLD_KB, _FOLD_KB.replace("16", "32"))],
    # above M 64: the tile fixed (128 W columns x 128 x rows, or 64 x 64;
    # SwiGLU keeps 128 x 128), the split planned; and the split fixed at
    # 1, 2 or 4 on each tile
    **{f"inst_{name}": _force(i) for name, i in _INSTS.items()},
    **{f"{name}_split_{n}": _force(i, n) for name, i in _INSTS.items()
       for n in (1, 2, 4)},
    # the 64 x 64 tiles two blocks an SM on a ring of 6 stages
    "n64_minb2": [(_N64, "using N64 = Cfg<1, 64, 6, 2>;")],
    # the producer prefetches the three tensor maps before its first load
    "tmap_prefetch": [(_PRODUCER, _PRODUCER + "".join(
        f'      asm volatile("prefetch.tensormap [%0];" :: '
        f'"l"((uint64_t){m}) : "memory");\n' for m in ("tw", "tw2", "tx")))],
    # an unsplit launch with the cluster attribute (a cluster of one)
    "cluster_1": [(_LAUNCH, "  if (true) {")],
    # decode: three blocks an SM, 4 stages each
    "small_3": [(_SMALL, "using S8 = Cfg<2, 8, 4, 3>;\n"
                         "using S16 = Cfg<2, 16, 4, 3>;")],
}
_NO_EPI = (_EPI, _EPI.replace("p = tid;", "p = rows << lg;"))
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
    "epi_no_store": [(_STORE, "    if (o[0] == 0x7fc17fc1u) "
                              + _STORE.strip())],
    # the ring, the wgmmas and the exchange of the partial slices; no
    # epilogue, no stores
    "no_epilogue": [_NO_EPI],
    # the ring and the wgmmas (kept live by the staging); no exchange, no
    # epilogue, no stores
    "no_fold": _NO_FOLD,
    # the TMA ring and its barriers alone
    "ring_only": [(_MMA, "      (void)da, (void)db;")] + _NO_FOLD,
    # no K step: the launch, the barriers' set-up, the staging, the fold
    # and the stores
    "empty": [(_KB1, "  const int kb1 = kb0;")],
}
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "BAR", "LDS", "STS", "LD", "STG",
            "LDG", "FADD", "MUFU")
PLAN_KEYS = ("nx", "blocks_per_sm", "splits", "row_tiles", "col_tiles",
             "k_steps", "resident_clusters", "w_columns")


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


def epi_code(epi):
    """The library's EPI_* of one of this script's epilogue names."""
    from paddle_tpu_torch.kernels import build
    if epi.startswith("bias_qkv"):
        return build.EPI_BIAS
    return {"none": build.EPI_NONE, "resid": build.EPI_RESID,
            "swiglu": build.EPI_SWIGLU, "bias": build.EPI_BIAS,
            "bias_resid": build.EPI_BIAS_RESID,
            "bias_gelu": build.EPI_BIAS_GELU}[epi]


def plan(lib, M, K, N, epi):
    """The library's launch plan of one bf16 call, or None where the
    library has no ``pt_gemm_xw_plan`` (a tree before it; a tree before
    the 64-column tiles reports no ``w_columns``: its tiles are 128)."""
    from paddle_tpu_torch.kernels import build
    try:
        fn = lib.pt_gemm_xw_plan
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    build.check(fn(M, K, N, epi_code(epi), out), "pt_gemm_xw_plan")
    got = dict(zip(PLAN_KEYS, out))
    got["w_columns"] = got["w_columns"] or 128
    return got


def operands(M, K, N, epi, dt, gen, copies=1):
    """x [M, K], ``copies`` weights [K, N] (and as many w2 for SwiGLU), and
    the epilogue's keyword arguments of ``gemm_xw_cuda`` / ``gemm_xw_ref``
    (residual, bias, GELU; the qkv split's head dim comes apart, since
    the plain version returns the product unsplit); std 0.02 weights as
    chip_smoke's layer, biases std 0.1."""
    import torch

    def t(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda",
                                    generator=gen)).to(dt)
    ws = [t(K, N, scale=0.02) for _ in range(copies)]
    w2s = [t(K, N, scale=0.02) for _ in range(copies)] \
        if epi == "swiglu" else [None] * copies
    kw = {}
    if epi in ("resid", "bias_resid"):
        kw["residual"] = t(M, N)
    if epi.startswith("bias"):
        kw["bias"] = t(N, scale=0.1)
    if epi == "bias_gelu":
        kw["gelu"] = True
    return t(M, K), ws, w2s, kw


def call(fn, x, w, w2, kw, qkv_d=0):
    """One call of ``gemm_xw_cuda`` / ``gemm_xw_ref``; ``qkv_d``: the
    kernel's split store (the plain version is split by the caller)."""
    if w2 is not None:
        return fn(x, w, w2=w2)
    return fn(x, w, **kw, **({"qkv_head_dim": qkv_d} if qkv_d else {}))


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
        D = QKV_D.get(epi, 0)
        for dtn, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
            if dt == torch.float32 and Kd > 1024:
                continue
            x, (w,), (w2,), kw = operands(M, Kd, N, epi, dt, gen)
            ref = call(K.gemm_xw_ref, x, w, w2, kw)
            if D:
                ref = torch.stack(K.qkv_split_ref(ref, D))
            outs = []
            for _ in range(2):
                layer.reset_counts()
                out = call(K.gemm_xw_cuda, x, w, w2, kw, D)
                outs.append(torch.stack(out) if D else out)
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
    """The bytes one call must move (x, the weights, y, the residual and
    the bias once each) and its operations."""
    nw = 2 if epi == "swiglu" else 1
    nbytes = (M * K + nw * K * N + M * N
              + (M * N if epi in ("resid", "bias_resid") else 0)
              + (N if epi.startswith("bias") else 0))
    return 2 * nbytes, 2 * nw * M * K * N


def library(x, w, w2, kw):
    """One torch.matmul (two for SwiGLU), then the GPT epilogue's bias,
    GELU and residual as torch ops: the yardstick, used nowhere in the
    port."""
    import torch
    y = torch.matmul(x, w)
    if w2 is not None:
        torch.matmul(x, w2)
    if "bias" in kw:
        y = y + kw["bias"]
        if kw.get("gelu"):
            y = torch.nn.functional.gelu(y, approximate="tanh")
    return y + kw["residual"] if "residual" in kw else y


def time_chain(libs, order, gen, report, chain):
    """Device ms a launch of each of ``chain``'s GEMMs at each M, the
    variants in ``order``; the llama_7b chain on the next of its cold
    weight copies each call, the GPT chain on one warm weight."""
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops.cuda import kernels as K
    cold = chain == "llama"
    for label, Kd, N, epi in CHAINS[chain]:
        nw = 2 if epi == "swiglu" else 1
        copies = max(1, math.ceil(COLD_BYTES / (2 * nw * Kd * N))) \
            if cold else 1
        D = QKV_D.get(epi, 0)
        for M in (LLAMA_ROWS if cold else GPT_ROWS):
            x, ws, w2s, kw = operands(M, Kd, N, epi, torch.bfloat16, gen,
                                      copies)
            turn = [0]

            def nxt():
                i = turn[0] = (turn[0] + 1) % copies
                return x, ws[i], w2s[i], kw

            def kernel():
                return call(K.gemm_xw_cuda, *nxt(), D)

            times = {name: [] for name in libs}
            hosts = {name: [] for name in libs}
            for name in order:
                build._lib = libs[name][0]
                ms, call_ms = cs.time_ms(kernel, ITERS, per_launch=True)
                times[name].append(call_ms if ms is None else ms)
                hosts[name].append(cs.host_ms(kernel))
            lib_ms = cs.time_ms(lambda: library(*nxt()), ITERS)[0]
            bms, bby = cs.bound_ms(*bytes_ops(M, Kd, N, epi))
            key = f"{chain} {label} M {M} [{Kd}x{N}] {epi}"
            for name, ts in times.items():
                mean = sum(ts) / len(ts)
                pl = plan(libs[name][0], M, Kd, N, epi)
                report["variants"][name][key] = dict(
                    ms=ts, mean_ms=mean, bound_ms=bms, bound_by=bby,
                    library_ms=lib_ms, of_bound=bms / mean,
                    x_library=mean / lib_ms, host_ms=hosts[name], plan=pl)
                cs.info(f"{key} {name}: {[round(t, 5) for t in ts]} ms "
                        f"(mean {mean:.5f}), bound {bms:.5f} ({bby}, "
                        f"{100 * bms / mean:.1f} %), library {lib_ms:.5f} "
                        f"({mean / lib_ms:.2f}x), host ms a call "
                        f"{[round(h, 4) for h in hosts[name]]}; plan {pl}")
            del x, ws, w2s, kw
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--chain", default="llama,gpt")
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
    keep = args.only.split(",") if args.only else None
    for name, cuts in ({**TUNINGS, **ABLATIONS}.items() if args.ablate
                       else ()):
        if keep and name not in keep:
            continue
        srcs[name] = build.BUILD_DIR / "ab" / f"gemm_{name}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(_edited(srcs["change"].read_text(), cuts))
    if keep:
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
        for chain in args.chain.split(","):
            time_chain(libs, order, gen, report, chain)
    out = ROOT / "chiprun_out" / "gemm_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
