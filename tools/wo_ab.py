#!/usr/bin/env python3
"""Time builds of the port's weight-only matmul kernels against each other
on one CUDA card.

    python3 tools/wo_ab.py [--tree NAME=DIR ...] [--ablate] [--only NAME ...]
                           [--no-model] [--turns N] [--sass]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is a ``quant_linear.cu`` linked with this tree's other
sources' objects into its own library under
``paddle_tpu_torch/kernels/_build/ab/``: ``change`` is this tree's
``paddle_tpu_torch/kernels/csrc/quant_linear.cu``; ``--tree NAME=DIR``
adds DIR's (another checkout's, e.g. the parent commit unpacked by
``git archive`` into the git-ignored ``archive_check/``).  ``--ablate``
adds this tree's file with one part cut out (``ABLATIONS``, of the
prefill body ``wo_wgmma`` and, ``dec_*``, of the decode body ``wo_dec``:
the widening of the codes; the wgmma; all but the copies; for both
every K step, leaving the launch, fold and stores (``empty``,
``dec_empty``), and the fold's exchange), which compute something else,
and with one choice changed (``TUNINGS``: the prefill's x-row tile fixed
at 128 or 256 rows, its K split fixed at 1, 2, 4 or 8 blocks of 128-row
tiles, its fold weighed at 4 or 16 K steps, its cap of one wave more
than the unsplit launch lifted; the decode's K split fixed at 2, 4 or 8
blocks, its fold weighed at 4 or 24 K steps, its ring's bytes, its
blocks an SM, a prefetch of its tensor maps); the cut ones are timed
unchecked and show what each part or choice costs.  ``--only`` keeps the
named variants.  All ``nvcc`` processes start together.

The script prints ptxas' registers, stack frame and spills of each
variant's ``wo_`` kernels and any note of serialized wgmmas or ignored
``setmaxnreg`` (``--sass``: also the SASS opcode counts of each ``wo_``
kernel, the SASS itself written to ``wo_sass_<variant>.txt`` in the
output directory, and with ``--tree`` whether each kernel's SASS is byte
for byte the first tree's),
checks each variant against ``weight_only_matmul[_int4]_ref`` on
``CASES`` (bf16 x: within
2e-2 of the plain version, or no further from the fp32 result than 1.5 x
the plain bf16 version, as ``chip_smoke.py`` holds it), then times, the
variants in turns (a, b, ..., b, a):

* the quantized serving chain's layer GEMMs at M 256 (``wo_wgmma``) and
  at the decode rows M 4 (``wo_dec``) through the layer entry
  (``wo_layer_cuda``, ``pt_wo_layer``) with their epilogues: a llama_7b
  layer's seven (``chip_smoke.QUANT_MATMULS``: residual on o and down,
  SwiGLU on up) in int8 and int4 per channel, and a GPT-125M layer's four
  (``chip_smoke.GPT_MATMULS``: bias, the qkv split, GELU, residual) in
  int8 per channel and int4 groups of 64, the qkv product also stored
  row-major (``qkv_rowmajor``: what the split store costs); each GEMM's
  device ms, the sum, the launch plan each took at M 256 (``pt_wo_plan``:
  x rows a tile, K splits), the bound and cuBLAS on the weights
  dequantized to bf16 beforehand (no epilogue); each variant's outputs
  checked first against ``wo_layer_ref``, two calls bit-identical;
* the seven block matmuls of one llama_7b layer (``chip_smoke.py``'s
  ``LAYER_MATMULS``, per channel) at the decode rows M 8, 1 and 16 and the
  prefill rows M 1024 and 300, int8 and int4, beside the bound, cuBLAS on
  the codes dequantized to bf16 beforehand, times the scale, the bytes the
  prefill kernel's TMA copies (``tma_bytes``), and the wrapper's host
  cost a call: the CUDA-event time of the layer's calls minus their
  device time, over 7, and at the decode rows the host time of one call
  with the card idle (``chip_smoke.host_ms``);
* unless ``--no-model``, llama_7b at 32 layers, B 8, int8 and int4
  (``build_llama_decoder(..., quant=...)``): the prefill of a 128-token
  prompt and one decode step at position 128: wall ms (CUDA events) and
  the ``wo_`` kernels' device ms.

``--turns N`` repeats the order N times.

Writes ``chiprun_out/wo_ab.json``.  Imports nothing of the JAX package.
"""

import argparse
import ctypes
import hashlib
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
CASES = (cs.WO_SMALL
         + [("int8", 17, 4096, 4096, -1), ("int8", 257, 4096, 400, -1),
            ("int4", 257, 301, 400, -1), ("int4", 129, 11008, 4096, 128),
            ("int8", 200, 4096, 1024, 64), ("int8", 1, 520, 48, -1),
            ("int8", 9, 4096, 11008, -1), ("int4", 16, 4095, 144, 64),
            ("int4", 3, 11008, 4096, 128)]
         + [(w, M, K, N, -1) for w in ("int8", "int4") for M in (8, 1024)
            for K, N in cs.WO_SHAPES])
REPEATS = 3                      # calls a case: a missing fence shows rarely
ROWS = (8, 1, 16, 1024, 300)     # decode, then prefill rows
MODEL_LAYERS, MODEL_B, MODEL_S = 32, 8, 128
# quant_linear.cu with one part of wo_wgmma's loop or launcher changed:
# (old, new) text pairs
_WIDEN = """      if (C::INT4) {
        widen_i4(cr[2 * step], plane, A[0], A[1]);
        widen_i4(cr[2 * step + 1], plane, A[2], A[3]);
      } else {
        widen_i8(cr[2 * step], A[0], A[1]);
        widen_i8(cr[2 * step + 1], A[2], A[3]);
      }"""
_FORCE = "constexpr int WG_FORCE_BM = 0, WG_FORCE_SPLIT = 0;"
_FOLD = "constexpr int WG_STEP_128 = 6, WG_STEP_256 = 10, WG_FOLD = 8;"
_PUSH = "    splitk::push<C::BM>(red, recv, recv_bar, S, rank, tid);"
_RANGE = "  const int kb0 = nt * rank / S, kb1 = nt * (rank + 1) / S;"
_CAP = "      else if (waves > waves1 + 1 && !WG_FORCE_SPLIT) continue;"

_MMA = ("      WgmmaRS<C::BM>::mma(acc, A, (plane ? dhi : dlo) + 2 * step, "
        "!fresh);")
_DEC_WIDEN = "      widen_step<C::INT4>(cr, step, plane, A);"
_DEC_MMA = ("      WgmmaRS<C::NX>::mma(acc, A, (plane ? dhi : dlo) + 2 * step, "
            "keep);")
_DEC_RANGE = "  const int kb0 = nk * rank / S, kb1 = nk * (rank + 1) / S;"
_DEC_PUSH = "  splitk::push<C::NX>(red, recv, recv_bar, S, rank, tid);"
_DEC_SPLIT = "  p->splits = splitk::best_split(p->tiles, p->nk, res, FOLD_STEPS);"
_DEC_FOLD = "constexpr int FOLD_STEPS = 12;"
_DEC_MINB = "  static constexpr int MINB = 2;               // blocks an SM"
_DEC_RING = ("  static constexpr int RING = 100 * 1024;      // stage bytes a "
             "block")
_DEC_SYNC = """    mbar_init(recv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {"""


def _ring(kb):
    return (_DEC_RING, _DEC_RING.replace("100 *", f"{kb} *"))
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
    # the prefill split's exchange as a split of one (its barriers kept;
    # each block folds its own partial and stale slots)
    "no_fold": [(_PUSH, _PUSH.replace("S, rank", "1, 0"))],
    # no K steps: the launch, the barriers' set-up, the fold and the stores
    "empty": [(_RANGE, _RANGE.replace("nt * (rank + 1) / S", "kb0"))],
    # the decode body: the codes' bits to wgmma as they are; no wgmma
    "dec_no_widen": [(_DEC_WIDEN, "      A[0] = A[1] = cr[2 * step];\n"
                                  "      A[2] = A[3] = cr[2 * step + 1];")],
    "dec_no_wgmma": [(_DEC_MMA, "      acc[0] += __uint_as_float(A[0] ^ A[1] "
                                "^ A[2] ^ A[3]);")],
    # the ring, the ldmatrix reads (asm volatile), the fold and the
    # stores: no widening, no wgmma
    "dec_copies_only": [(_DEC_MMA, ""), (_DEC_WIDEN, "")],
    # no K steps: the launch, the barriers' set-up, the fold and the stores
    "dec_empty": [(_DEC_RANGE, _DEC_RANGE.replace("nk * (rank + 1) / S",
                                                  "kb0"))],
    # the fold's exchange as a split of one (its barriers kept)
    "dec_no_fold": [(_DEC_PUSH, _DEC_PUSH.replace("S, rank", "1, 0"))],
}
# quant_linear.cu with one choice of the decode launch changed; checked and
# timed like a tree
TUNINGS = {
    # the prefill launcher's choice of x rows a block, fixed (the split
    # planned; 256-row tiles run unsplit)
    "rows_128": [(_FORCE, _FORCE.replace("BM = 0", "BM = 128"))],
    "rows_256": [(_FORCE, _FORCE.replace("BM = 0", "BM = 256"))],
    # its K split fixed (128-row tiles; at most the K steps)
    **{f"split_{n}": [(_FORCE, _FORCE.replace("BM = 0", "BM = 128").replace(
        "SPLIT = 0", f"SPLIT = {n}"))] for n in (1, 2, 4, 8)},
    # its fold weighed at n K steps of a 128-row tile
    **{f"fold_{n}": [(_FOLD, _FOLD.replace("WG_FOLD = 8", f"WG_FOLD = {n}"))]
       for n in (4, 16)},
    # the split's cap at one wave more than the unsplit launch, lifted
    "no_wave_cap": [(_CAP, _CAP.replace("waves > waves1 + 1", "false"))],
    **{f"dec_split_{n}": [(_DEC_SPLIT, f"  p->splits = p->nk < {n} ? p->nk "
                                       f": {n};")] for n in (2, 4, 8)},
    **{f"dec_fold_{n}": [(_DEC_FOLD, _DEC_FOLD.replace("12", str(n)))]
       for n in (4, 24)},
    # the ring's bytes a block; three or four blocks an SM on smaller rings
    "dec_ring_32": [_ring(32)],
    "dec_ring_48": [_ring(48)],
    "dec_ring_64": [_ring(64)],
    "dec_minb_3": [(_DEC_MINB, _DEC_MINB.replace("2;", "3;")), _ring(64)],
    "dec_minb_4": [(_DEC_MINB, _DEC_MINB.replace("2;", "4;")), _ring(44)],
    # the producer prefetches the three tensor maps during the barriers'
    # set-up
    "dec_tmap_prefetch": [(_DEC_SYNC, _DEC_SYNC.replace(
        "  __syncthreads();\n", "".join(
            f'  if (tid == 256) asm volatile("prefetch.tensormap [%0];" :: '
            f'"l"((uint64_t)&{m}) : "memory");\n' for m in
            ("tw", "txlo", "txhi")) + "  __syncthreads();\n"))],
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
    """Opcode counts and a digest of the SASS of each wo_ kernel in
    ``obj``; the SASS goes to wo_sass_<name>.txt in the output
    directory."""
    from paddle_tpu_torch.kernels import build
    dump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(dump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out = ROOT / "chiprun_out" / f"wo_sass_{name}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    counts, bodies, fn = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "wo_" in m.group(1) else None
            continue
        if fn:
            bodies.setdefault(fn, []).append(line)
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if fn and m:
            c = counts.setdefault(fn, {})
            op = m.group(2).split(".")[0]
            c[op] = c.get(op, 0) + 1
    return {k: {op: v.get(op, 0) for op in SASS_OPS} | {
        "total": sum(v.values()), "digest": hashlib.sha256(
            "\n".join(bodies[k]).encode()).hexdigest()[:16]}
            for k, v in counts.items()}


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
    version, the decode rows' calls also bit-identical to the first;
    raises on the first miss."""
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
        first = None
        for i in range(REPEATS):
            got = fn(x, codes, scale, group_size=gs)
            torch.cuda.synchronize()
            if M <= 16 and first is not None and not torch.equal(got, first):
                raise cs.SmokeFailure(f"{name} {width} M {M} [{K}, {N}] "
                                      f"group {gs}: call {i} differs from "
                                      f"call 0")
            first = got if first is None else first
            ratios = []
            cs.check_layer_out(f"{name} {width} M {M} [{K}, {N}] group {gs} "
                               f"call {i}", got, plain, truth,
                               cs.TOL["bfloat16"], ratios)
            worst = max(worst, ratios[0])
    return worst


# the chain's layer GEMMs at M 256 (wo_wgmma) and at the decode rows M 4
# (wo_dec): (family, width, group size, [(label, K, N, epilogue)]),
# epilogues as chip_smoke.py names them
CHAIN_M = 256
DEC_M = 4
CHAIN = [("llama_7b", w, -1, [(n, K, N, e) for (n, e), (_, K, N) in zip(
    cs.QUANT_MATMULS, cs.LAYER_MATMULS)]) for w in ("int8", "int4")] + [
    ("gpt_125m", w, g, list(cs.GPT_MATMULS)) for w, g in cs.GPT_WO_TIMED]


def chain_kw(epi, M, N, gen):
    """wo_layer_cuda's epilogue arguments for one of the chain's GEMMs."""
    import torch

    def t(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda",
                                    generator=gen)).to(torch.bfloat16)
    if epi == "resid":
        return {"residual": t(M, N)}
    if epi == "swiglu":
        return {"gate": t(M, N)}
    if epi == "bias":
        return {"bias": t(N, scale=0.1), "qkv_head_dim": 64}
    if epi == "bias_resid":
        return {"bias": t(N, scale=0.1), "residual": t(M, N)}
    if epi == "bias_gelu":
        return {"bias": t(N, scale=0.1), "gelu": True}
    return {}


def chain_weights(gen):
    """{(family, width, gs): [(label, K, N, epi, codes, scale, bf16 weight
    dequantized beforehand, {M: epilogue kw} at CHAIN_M and DEC_M)]}."""
    import torch
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.quant_linear import unpack_int4
    out = {}
    for fam, width, gs, mats in CHAIN:
        rows = []
        for label, K, N, epi in mats:
            codes, scale = weight_quantize(
                0.02 * torch.randn(K, N, device="cuda", generator=gen),
                f"weight_only_{width}", group_size=gs)
            w = (codes if width == "int8" else unpack_int4(codes, K)).float()
            wdq = (w * (scale if gs == -1 else scale.repeat_interleave(
                gs, 0)[:K])).to(torch.bfloat16)
            rows.append((label, K, N, epi, codes, scale, wdq,
                         {M: chain_kw(epi, M, N, gen)
                          for M in (CHAIN_M, DEC_M)}))
        out[(fam, width, gs)] = rows
    return out


def chain_out(got, plain, kw):
    """The qkv product comes back split: the plain version's split."""
    import torch
    from paddle_tpu_torch.ops.cuda import kernels as K
    if "qkv_head_dim" not in kw:
        return got, plain
    return (torch.cat(list(got), -1),
            torch.cat(K.qkv_split_ref(plain, kw["qkv_head_dim"]), -1))


def check_chain(name, weights, xs):
    """Each chain GEMM at M CHAIN_M and DEC_M through the layer entry
    against ``wo_layer_ref`` (the ratio rule), two calls bit-identical;
    raises on the first miss."""
    import torch
    from paddle_tpu_torch.ops.cuda import kernels as K
    for (fam, width, gs), rows in weights.items():
        for label, Kd, N, epi, codes, scale, _, kws in rows:
            for M, kw in kws.items():
                x = xs[M][Kd]
                ref_kw = {k: v for k, v in kw.items() if k != "qkv_head_dim"}
                a, b = (K.wo_layer_cuda(x, codes, scale, width=width,
                                        group_size=gs, **kw)
                        for _ in range(2))
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(
                        *(o if isinstance(o, tuple) else (o,)
                          for o in (a, b)))):
                    raise cs.SmokeFailure(f"{name} chain {fam} {width} g{gs} "
                                          f"{label} M {M}: a second call "
                                          f"differs")
                plain = K.wo_layer_ref(x, codes, scale, width=width,
                                       group_size=gs, **ref_kw)
                truth = K.wo_layer_ref(x.float(), codes, scale, width=width,
                                       group_size=gs, **{
                                           k: v.float() if hasattr(v, "float")
                                           else v for k, v in ref_kw.items()})
                got, plain = chain_out(a, plain, kw)
                _, truth = chain_out(a, truth, kw)
                cs.check_layer_out(f"{name} chain {fam} {width} g{gs} {label} "
                                   f"M {M}", got, plain, truth,
                                   cs.TOL["bfloat16"])


def _bm_splits(plan):
    """(x rows a tile, K splits) of a ``chip_smoke.wo_plan``, or None."""
    return plan and (plan["bm"], plan["splits"])


def time_chain(libs, order, weights, xs, report, M):
    """Each chain GEMM's device ms at M (CHAIN_M: wo_wgmma; DEC_M:
    wo_dec), every variant in ``order`` (their turns), beside the bound and
    cuBLAS on the weights dequantized beforehand (no epilogue), with the
    plan each took at CHAIN_M; a qkv product stored split is timed again
    stored row-major (``<label>_rowmajor``: the split store's cost)."""
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops.cuda import kernels as K
    for (fam, width, gs), rows in weights.items():
        label = f"chain {fam} {width} g{gs} M {M}"
        calls = []
        for lab, Kd, N, epi, codes, scale, wdq, kws in rows:
            kw = kws[M]
            calls.append((lab, Kd, N, epi, codes, scale, wdq, kw))
            if "qkv_head_dim" in kw:
                calls.append((f"{lab}_rowmajor", Kd, N, epi, codes, scale,
                              wdq, {k: v for k, v in kw.items()
                                    if k != "qkv_head_dim"}))
        per = {name: {c[0]: [] for c in calls} for name in libs}
        for name in order:
            build._lib = libs[name][0]
            for lab, Kd, N, epi, codes, scale, _, kw in calls:
                per[name][lab].append(cs.time_ms(
                    lambda: K.wo_layer_cuda(xs[M][Kd], codes, scale,
                                            width=width, group_size=gs,
                                            **kw), ITERS,
                    per_launch=True)[0])
        lib_ms, bounds = {}, {}
        for lab, Kd, N, epi, codes, scale, wdq, _ in calls:
            lib_ms[lab] = cs.time_ms(lambda: torch.matmul(xs[M][Kd], wdq),
                                     ITERS)[0]
            bounds[lab] = cs.bound_ms(*cs.wo_layer_bytes_ops(
                M, [((Kd, N), "none" if epi in ("bias", "bias_gelu",
                                                "none") else "resid")],
                width, gs))[0]
        layer_labs = [r[0] for r in rows]
        for name in libs:
            gemms = {}
            for lab, Kd, N, *_ in calls:
                ts = per[name][lab]
                gemms[lab] = dict(
                    ms=ts, mean_ms=sum(ts) / len(ts), bound_ms=bounds[lab],
                    cublas_ms=lib_ms[lab],
                    plan=cs.wo_plan(M, Kd, N, width, gs, lib=libs[name][0])
                    if M > 16 else None)
            total = sum(gemms[lab]["mean_ms"] for lab in layer_labs)
            report["variants"][name][label] = dict(
                gemms=gemms, total_ms=total,
                bound_ms=sum(bounds[lab] for lab in layer_labs),
                cublas_ms=sum(lib_ms[lab] for lab in layer_labs))
            cs.info(f"{label} {name}: {total:.5f} ms the layer's GEMMs "
                    f"(bound {sum(bounds[lab] for lab in layer_labs):.5f}, "
                    f"cuBLAS {sum(lib_ms[lab] for lab in layer_labs):.5f}); "
                    + "; ".join(
                        f"{lab} {g['mean_ms']:.5f} (cuBLAS "
                        f"{g['cublas_ms']:.5f}, plan {_bm_splits(g['plan'])})"
                        for lab, g in gemms.items()))


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
            calls = {name: [] for name in libs}
            for name in order:
                build._lib = libs[name][0]
                by = {}
                _, call = cs.time_ms(kernels, ITERS, by)
                dev = wo_device_ms(by)
                times[name].append(call if dev is None else dev)
                calls[name].append(call)
            lib_ms = cs.time_ms(library, ITERS)[0]
            # decode rows: the host time of one call (enqueue only, the
            # card idle before it; the median of 30), the q projection's
            hosts = {}
            if M <= 16:
                K, N, codes, scale, _ = lw[0]
                for name in order:
                    build._lib = libs[name][0]
                    hosts.setdefault(name, []).append(cs.host_ms(
                        lambda: fn(xs[K], codes, scale)))
            nbytes = ops = 0
            for K, N, *_ in lw:
                b, o = cs.wo_bytes_ops(M, K, N, width)
                nbytes, ops = nbytes + b, ops + o
            bms, bby = cs.bound_ms(nbytes, ops)
            label = f"layer {width} M {M}"
            if M > 16:
                tb = {bm: sum(tma_bytes(M, K, N, width, bm) for _, K, N in
                              cs.LAYER_MATMULS) for bm in (128, 256)}
                report.setdefault("tma_bytes", {})[label] = tb
                cs.info(f"{label}: TMA copies {tb[128] / 1e9:.3f} / "
                        f"{tb[256] / 1e9:.3f} GB at 128 / 256 x rows a "
                        f"block")
            for name, ts in times.items():
                mean = sum(ts) / len(ts)
                # the wrapper's host time a call beyond its kernel's:
                # back-to-back calls, so a host-bound call shows here
                host = [(c - d) / len(lw) for c, d in zip(calls[name], ts)]
                plans = None
                if M > 16:
                    plans = [cs.wo_plan(M, K, N, width, -1,
                                        lib=libs[name][0])
                             for K, N, *_ in lw]
                    cs.info(f"{label} {name}: plans (x rows a tile, K "
                            f"splits) {[_bm_splits(p) for p in plans]}")
                report["variants"][name][label] = dict(
                    plans=plans, ms=ts, mean_ms=mean, bound_ms=bms,
                    bound_by=bby, cublas_ms=lib_ms, of_bound=bms / mean,
                    x_cublas=mean / lib_ms, call_ms=calls[name],
                    call_minus_device_ms_per_call=host,
                    host_ms_one_call=hosts.get(name))
                cs.info(f"{label} {name}: {ts} ms (mean {mean:.4f}), bound "
                        f"{bms:.4f} ({bby}, {100 * bms / mean:.1f} %), "
                        f"cuBLAS on the dequantized weight {lib_ms:.4f} "
                        f"({mean / lib_ms:.2f}x); call - device a call "
                        f"{[round(h, 4) for h in host]} ms; host time of "
                        f"one call {[round(h, 4) for h in hosts.get(name, [])]}"
                        f" ms")
            del xs
        del lw
        torch.cuda.empty_cache()


def time_model(libs, order, report):
    """llama_7b x MODEL_LAYERS, B MODEL_B, int8 and int4: the prefill of a
    MODEL_S-token prompt and one decode step after it, each variant in
    ``order``: wall ms (CUDA events) and the ``wo_`` kernels' device ms."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models import generation as tgen
    from paddle_tpu_torch.models import llama as tllama
    cfg = tllama.llama_7b(num_layers=MODEL_LAYERS, dtype="bfloat16")
    params = tllama.init_params(cfg, make_generator(cs.SEED, "cuda"),
                                device="cuda")
    ids = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (MODEL_B, MODEL_S))).to("cuda")
    for width in ("int8", "int4"):
        quant = f"weight_only_{width}"
        p = tgen.quantize_llama_params(params, quant)
        prefill, step = tgen.build_llama_decoder(cfg, 2 * MODEL_S,
                                                 quant=quant)
        with torch.inference_mode():
            cache, logits = prefill(p, ids)
            token = logits.argmax(-1)
            runs = {"prefill": (lambda: prefill(p, ids), 3),
                    "decode step": (lambda: step(p, cache, token, MODEL_S),
                                    10)}
            for what, (fn, iters) in runs.items():
                times = {name: [] for name in libs}
                for name in order:
                    build._lib = libs[name][0]
                    by = {}
                    _, call = cs.time_ms(fn, iters, by)
                    times[name].append((call, wo_device_ms(by)))
                label = f"{what} llama_7b x {MODEL_LAYERS} {width}"
                for name, ts in times.items():
                    wall = sum(c for c, _ in ts) / len(ts)
                    wo = [d for _, d in ts if d is not None]
                    report["variants"][name][label] = dict(
                        wall_ms=[c for c, _ in ts], mean_wall_ms=wall,
                        wo_device_ms=[d for _, d in ts],
                        mean_wo_device_ms=sum(wo) / len(wo) if wo else None)
                    cs.info(f"{label} {name}: wall "
                            f"{[round(c, 3) for c, _ in ts]} ms (mean "
                            f"{wall:.3f}); wo_ kernels "
                            f"{[d and round(d, 4) for _, d in ts]} ms")
            del cache, logits
        del p, prefill, step
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--only", nargs="+", default=None)
    ap.add_argument("--no-model", action="store_true")
    ap.add_argument("--turns", type=int, default=1)
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
    for name, cuts in ({**TUNINGS, **ABLATIONS}.items() if args.ablate
                       else ()):
        srcs[name] = build.BUILD_DIR / "ab" / f"ql_{name}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(_ablated(srcs["change"].read_text(), cuts))
    if args.only:
        srcs = {k: v for k, v in srcs.items() if k in args.only}
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
    if args.sass and args.tree:
        # each kernel both builds have, SASS byte for byte
        base = args.tree[0].partition("=")[0]
        a, b = (report["variants"][n]["sass"] for n in (base, "change"))
        for k in sorted(set(a) & set(b)):
            same = a[k]["digest"] == b[k]["digest"]
            cs.info(f"sass change vs {base}: {k}: "
                    f"{'identical' if same else 'differs'}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    weights = chain_weights(gen)
    xs = {M: {K: torch.randn(M, K, device="cuda", generator=gen).to(
        torch.bfloat16) for K in {r[1] for rows in weights.values()
                                  for r in rows}} for M in (CHAIN_M, DEC_M)}
    for name, (lib, *_) in libs.items():
        if name in ABLATIONS:
            continue
        build._lib = lib
        report["variants"][name]["bf16_vs_fp32_ratio"] = check_variant(
            name, gen)
        check_chain(name, weights, xs)
    order = (list(libs) + list(reversed(libs))) * args.turns
    for M in (CHAIN_M, DEC_M):
        time_chain(libs, order, weights, xs, report, M)
    del weights, xs
    torch.cuda.empty_cache()
    time_layers(libs, order, gen, report)
    if not args.no_model:
        whole = [n for n in order if n not in ABLATIONS]
        time_model({n: libs[n] for n in whole}, whole, report)
    out = ROOT / "chiprun_out" / "wo_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
