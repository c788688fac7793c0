#!/usr/bin/env python3
"""Time builds of the port's linear-CE head kernels against each other on
one CUDA card.

    python3 tools/lce_ab.py [--tree NAME=DIR ...] [--ablate] [--sass]
                            [--only NAME,...] [--no-time] [--turns N]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is a ``linear_ce.cu`` linked with this tree's other sources'
objects into its own library under ``paddle_tpu_torch/kernels/_build/ab/``:
``change`` is this tree's ``paddle_tpu_torch/kernels/csrc/linear_ce.cu``;
``--tree NAME=DIR`` adds DIR's (another checkout's, e.g. the parent commit
unpacked by ``git archive`` into the git-ignored ``archive_check/``).
``--ablate`` adds this tree's file with the choices of ``TUNINGS``
(groups of 16 or 48 row blocks; each stage handed back as soon as its
wgmmas retire; dz stored evict-first; the split dw's ring as 2 stages of
64 rows of T, or 3 or 5 of 32), which are checked and timed like a tree,
and
with one part of the wgmma kernels cut out (``ABLATIONS``: the
epilogues; the exponentials; the forward's fold; all but the copies;
dz's stores; dx's reads and writes of its fp32 accumulator; the split
route's x_lo product, ``one_term``; the split dw without its K split,
``dw_no_split``, and with dz_hi x_hi alone, ``dw_one_term``; the split
dz storing fp32 dz in place of its low half, ``dz_store_f32``, the
parent's store volume), which compute something else and are timed
unchecked.  ``--only`` keeps the named variants.  All ``nvcc`` processes
start together.  Each ``--tree`` runs with its own tree's wrapper
(``paddle_tpu_torch/ops/cuda/linear_ce.py``, loaded beside this one's),
so a library gets the scratch layout it was written for (before the
split dw: dz_x fp32).

The script prints ptxas' registers, stack frame and spills of each
variant's ``linear_ce`` kernels and any note of serialized wgmmas or
ignored ``setmaxnreg`` (``--sass``: also the SASS opcode counts of each
kernel, the SASS itself written to ``chiprun_out/lce_sass_<variant>.txt``),
checks each checked variant on ``CASES`` (nll and lse within 1e-4 of
``lce_fwd_ref``, the first and last slab's dz, and dx and dw of the whole
backward, by ``chip_smoke.py``'s rules against ``lce_dz_ref`` /
``lce_bwd_ref``, and a second call of each bit-identical to the first;
bf16, and fp32 x with bf16 w, where ``chip_smoke.check_split`` also holds
nll, lse and dz (the halves' sum) to the split route's bounds and the
plain version on bf16-rounded x must miss them, and
``chip_smoke.split_dw_excess`` holds dw), then, unless ``--no-time``,
times at the
Llama head (T 8192, H 4096, V 32000, bf16; ``chip_smoke.py``'s
``LCE_CASES[0]``) and at the GPT head (T 8192, H 768, V 32768, fp32 x,
bf16 w; ``LCE_CASES[2]``), the variants in turns (a, b, ..., b, a):
``linear_ce_fwd`` (one call; at the GPT head also ``linear_ce_split_x``,
its pre-pass), ``linear_ce_dz`` over the 16 slabs of 2048 (the
backward's dz launches), and the whole backward call (dz, dx, dw) with
each kernel's device time over its 16 launches, each beside its bound,
the forward beside the dense chain (``x @ w.T`` then ``F.cross_entropy``)
and dz + dx + dw beside the dense chain's backward alone, dw beside one
``torch.matmul(dz.T, x)`` a slab (fp32 with TF32 off at the GPT head);
``--turns N`` runs that order N times.  At the GPT head ``change`` is also timed as
``reload_w``: the bf16 kernels on ``[x_hi | x_lo]`` and ``[w | w]`` (H
1536), the same sums with each w box loaded again for the lo product
(checked: nll within 1e-4 of the plain version).  It also prints the
bytes the wgmma kernels' TMA copies from L2 into shared memory a call,
and each kernel's grid.  A tree whose library does not size its scratch
(``pt_linear_ce_scratch``; its ``pt_linear_ce_fwd_scratch`` before the
split route, none before the bf16 kernels) is given that, and no split.

Writes ``chiprun_out/lce_ab.json``.  Imports nothing of the JAX package.
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

ITERS = 5                        # timed calls a variant and turn
# (T, H, V, chunk, ignore_index, label_smoothing, x dtype), w bf16: the
# GPU lane's tile edges, chip_smoke's small cases and the Llama head in
# bf16, then the split route (fp32 x) on tile edges, chip_smoke's
# smoothing case and the GPT head
CASES = [(300, 72, 513, 256, -100, 0.0, "bfloat16"),
         (200, 8, 100, 64, None, 0.1, "bfloat16"),
         (1000, 1024, 5000, 2048, -100, 0.0, "bfloat16"),
         (515, 768, 4999, 1024, None, 0.1, "bfloat16"),
         (8192, 4096, 32000, 2048, None, 0.0, "bfloat16"),
         (300, 72, 513, 256, -100, 0.0, "float32"),
         (515, 768, 4999, 1024, None, 0.1, "float32"),
         (8192, 768, 32768, 2048, None, 0.0, "float32")]
LLAMA, GPT = cs.LCE_CASES[0], cs.LCE_CASES[2]
_EPI = """    if constexpr (EPI == EPI_FWD)
      epi_fwd(a, acc, m0, n0, nb, NB, mb, tid, comb, flag);
    else if constexpr (EPI == EPI_DZ)
      epi_dz<SPLIT>(a, acc, m0, n0, tid);
    else if constexpr (EPI == EPI_DX)
      epi_dx(a, acc, m0, n0, tid);
    else
      epi_dw(a, acc, m0, n0, tid);"""
_NO_EPI = "    (void)nb; (void)flag; (void)comb;"
# in place of the epilogue: a sum of every accumulator and a store that
# never happens, so ptxas keeps the real wgmmas (with acc dead it swaps
# each for a dummy m64n8 one)
_SUM_ACC = """    {
      float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 128; ++i) z[i & 3] += acc[i];
      if (z[0] + z[1] + z[2] + z[3] == 1.2345e-30f) a.nll[0] = z[0];
    }
""" + _NO_EPI
_MMA = """        WgmmaSS256<MN_A, MN_B>::mma(acc, da + SA * kk, db + SB * kk,
                                    kb > 0 || kk > 0);"""
_EX2 = """  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));"""
_TICKET = "  if (*flag) merge_rows(a, part, comb, m0, NB, ctid);"
_GROUP = ("  static constexpr int GROUP = 32;           // row blocks a group "
          "of the order")
_HANDBACK = """      wg_wait<1>();
      // the wgmmas of the previous stage have retired: hand its slot back
      if (kb > 0) release((it - 1) % C::STAGES);
    }
    wg_wait<0>();
    fence_regs(acc);
    release((it - 1) % C::STAGES);"""
_DZ_STORE = "        pw[4 * i + tq] = q;"
_XS = "  static constexpr int XS = SPLIT ? 2 : 1;   // A tiles a stage"
_LO_MMA = """        if constexpr (SPLIT)                 // x_lo against the same w box
          WgmmaSS256<>::mma(acc, dl + 2 * kk, db + 2 * kk, 1);
"""
_DW_SHAPE = "using DwSplit = DwSplitOf<32, 4>;"
_DW_SPLITS = "  for (int s = 1; s <= C::MAX_SPLITS && s <= p.nk; ++s) {"
_DW_CROSS = """      WgmmaSS<192, 1, 1>::mma(acc, ah + 128 * kk, bl + 128 * kk, 1);
      WgmmaSS<192, 1, 1>::mma(acc, al + 128 * kk, bh + 128 * kk, 1);
"""
_DZ_LO_T = "      if constexpr (SPLIT) quad_transpose(l, tq);"
_DZ_LO_STORE = "          px[4 * i + tq] = make_uint4(l[0], l[1], l[2], l[3]);"
_DX_LOAD = "ok && !a.first ?"
_DX_STORE = """      if (!a.last)
        store8(row + c, v);"""
# linear_ce.cu with one choice of the bf16 kernels changed: (old, new)
# text pairs; checked and timed like a tree
TUNINGS = {f"group_{g}": [(_GROUP, _GROUP.replace("32", str(g)))]
           for g in (16, 48)}
TUNINGS.update({
    # each stage handed back as soon as its own wgmmas retire
    "handback_early": [(_HANDBACK, """      wg_wait<0>();
      release(s);
    }
    fence_regs(acc);""")],
    # dz stored with the evict-first hint (st.global.cs)
    "dz_evict_first": [(_DZ_STORE, "        __stcs(pw + 4 * i + tq, q);")],
    # the split dw's ring: 2 stages of 64 rows of T (80 KB each), or 3 or
    # 5 of 32 (40 KB; the change has 4)
    "dw_bk64": [(_DW_SHAPE, _DW_SHAPE.replace("<32, 4>", "<64, 2>"))],
    "dw_stages_3": [(_DW_SHAPE, _DW_SHAPE.replace("<32, 4>", "<32, 3>"))],
    "dw_stages_5": [(_DW_SHAPE, _DW_SHAPE.replace("<32, 4>", "<32, 5>"))],
})
# linear_ce.cu with one part of the bf16 kernels cut: (old, new) text
# pairs; timed unchecked
ABLATIONS = {
    # the mainloop and its TMA stream; no statistics, no dz, no stores
    "no_epilogue": [(_EPI, _SUM_ACC)],
    # the epilogues with exp(v) = v (the multi-function unit's share)
    "no_exp": [(_EX2, "  y = x;")],
    # the forward without the fold of the row blocks' partials
    "no_fold": [(_TICKET, "")],
    # the TMA stream and barriers alone: no wgmma, no epilogue
    "copies_only": [(_MMA, ""), (_EPI, _NO_EPI)],
    # dz's arithmetic and transposes, but stores only of a NaN pattern dz
    # never holds (so the arithmetic stays)
    "dz_no_store": [(_DZ_STORE, "        if (q.x == 0x7fc00001u && "
                                "q.y == q.x) pw[4 * i + tq] = q;")],
    # dx without its fp32 accumulator: no dx_acc read, no dx_acc write
    # (only the last slab's store of dx stays, so the wgmmas stay)
    "dx_no_acc": [(_DX_LOAD, "false ?", 2),
                  (_DX_STORE, "      if (!a.last)\n        ;")],
    # the split route with x_hi alone: one x box a stage (still 3
    # stages), no x_lo product; what x_lo costs
    "one_term": [(_XS, _XS.replace("SPLIT ? 2 : 1", "1")), (_LO_MMA, "")],
    # the split dw on one block a tile: no K split, no fold's partners
    "dw_no_split": [(_DW_SPLITS, _DW_SPLITS.replace("C::MAX_SPLITS", "1"))],
    # the split dw with dz_hi x_hi alone (its loads stay): what the two
    # cross products cost
    "dw_one_term": [(_DW_CROSS, "")],
    # the split dz storing fp32 dz (4 bytes an element, into the halves'
    # buffer) in place of its low half: the parent's 6 bytes an element
    "dz_store_f32": [
        (_DZ_LO_T, _DZ_LO_T + "\n      float f[8];\n"
                   "      if constexpr (SPLIT) row8(acc, h, i, tq, f);"),
        (_DZ_LO_STORE, "          store8((float *)a.dz_w + (size_t)t * "
                       "a.ldz + n0 + 8 * (4 * i + tq), f);")],
}
SASS_OPS = ("HGMMA", "MUFU", "FFMA", "FMNMX", "FADD", "SHFL", "STG", "LDG",
            "SYNCS", "UTMALDG", "BAR", "F2FP")


def _ptxas(text):
    """{kernel: {regs, stack, spill_st, spill_ld}} from ptxas -v output
    for the linear_ce kernels, and ptxas' notes of lost performance."""
    rows, name, notes = {}, None, []
    for line in text.splitlines():
        if "Performance Loss" in line or "setmaxnreg" in line:
            notes.append(line.strip())
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or "linear_ce" not in name:
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
    """Opcode counts of each linear_ce kernel in ``obj``; the SASS goes to
    chiprun_out/lce_sass_<name>.txt."""
    from paddle_tpu_torch.kernels import build
    dump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(dump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out = ROOT / "chiprun_out" / f"lce_sass_{name}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "linear_ce" in m.group(1) else None
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
    """linear_ce.cu's text with ``cuts`` applied: ``(old, new)`` where old
    occurs once, or ``(old, new, n)`` where it occurs n times."""
    for old, new, *n in cuts:
        if text.count(old) != (n[0] if n else 1):
            raise ValueError(f"variant text not found {n or [1]} times: "
                             f"{old!r}")
        text = text.replace(old, new)
    return text


def _compat(lib):
    """Give a library from before the split route the entry points this
    tree's wrapper calls: ``pt_linear_ce_scratch`` from its
    ``pt_linear_ce_fwd_scratch`` (none before the bf16 kernels: no
    scratch) with no ``xs``, and a ``pt_linear_ce_split_x`` that is then
    never called."""
    if hasattr(lib, "pt_linear_ce_scratch"):
        return
    fwd = getattr(lib, "pt_linear_ce_fwd_scratch", None)

    def scratch(args, sizes):
        sizes[0] = sizes[1] = sizes[2] = 0
        return fwd(args, sizes) if fwd is not None else 0

    def no_split(args, stream):
        return 1
    lib.pt_linear_ce_scratch = scratch
    lib.pt_linear_ce_split_x = no_split


def build_variants(srcs):
    """{name: (ctypes library, ptxas table, ptxas notes, object path)}
    for ``srcs`` {name: linear_ce.cu path}."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = build._sources()
    lce = build.CSRC / "linear_ce.cu"
    others = [f for f in cu if f != lce]
    cmds = [[nvcc, *build.NVCC_FLAGS, "-c", str(f), "-o",
             str(out_dir / (f.stem + ".o"))] for f in others]
    cmds += [[nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas",
              "-v", "-c", str(src), "-o", str(out_dir / f"lce_{name}.o")]
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
        so = out_dir / f"lib_lce_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(out_dir / (f.stem + ".o")) for f in others),
                        str(out_dir / f"lce_{name}.o"), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        _compat(lib)
        build._bind(lib)
        table, notes = _ptxas(logs[len(others) + i])
        libs[name] = (lib, table, notes, out_dir / f"lce_{name}.o")
    return libs


def tree_wrapper(name, tree):
    """``tree``'s linear-CE wrapper module, loaded beside this tree's as
    ``paddle_tpu_torch.ops.cuda._lce_<name>`` (its relative imports are
    this tree's ``build`` and ``layer``, so it launches whichever library
    ``build._lib`` holds)."""
    import importlib.util
    path = Path(tree).resolve() / "paddle_tpu_torch/ops/cuda/linear_ce.py"
    spec = importlib.util.spec_from_file_location(
        f"paddle_tpu_torch.ops.cuda._lce_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dz_of(dzx):
    """dz in x's dtype from ``linear_ce_dz_cuda``'s second output: fp32 as
    it is, the split route's bf16 halves ``[2, T, width]`` by their sum."""
    return dzx if dzx.ndim == 2 else dzx[0].float() + dzx[1].float()


def inputs(case, gen):
    """x ~ N(0, 1) in the case's dtype, bf16 w ~ N(0, 0.02), random labels
    with row 1's at V - 1 (every 7th ignored where the case has
    ignore_index), and an N(0, 1) nll cotangent, zero at ignored labels."""
    import torch
    T, H, V, _, ignore, _, xdn = case
    x = torch.randn(T, H, device="cuda", generator=gen).to(
        getattr(torch, xdn))
    w = (0.02 * torch.randn(V, H, device="cuda", generator=gen)).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (T,), device="cuda", generator=gen)
    lab[1] = V - 1
    g = torch.randn(T, device="cuda", generator=gen)
    if ignore is not None:
        lab[::7] = ignore
        g = torch.where(lab != ignore, g, 0.0)
    return x, w, lab, g


def check_variant(name, gen, lc):
    """Every case of CASES against the plain versions, and each call
    twice, through the wrapper ``lc``; raises on the first miss.  Returns
    the worst bf16 ratio of dz's, dx's and dw's distance from fp32 to the
    plain version's."""
    import torch
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    worst = 0.0
    for case in CASES:
        T, H, V, chunk, ignore, eps, xdn = case
        x, w, lab, g = inputs(case, gen)
        kw = dict(label_smoothing=eps)
        label = f"{name} T {T} H {H} V {V} chunk {chunk} x {xdn}"
        nll, lse = lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore, **kw)
        nll2, lse2 = lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore,
                                           **kw)
        torch.cuda.synchronize()
        if not (torch.equal(nll, nll2) and torch.equal(lse, lse2)):
            raise cs.SmokeFailure(f"{label}: two forward calls differ")
        nll_p, lse_p = fce.lce_fwd_ref(x, w, lab, chunk=chunk,
                                       ignore_index=ignore, **kw)
        e = max(cs.check_close(f"{label} nll", nll, nll_p, cs.TOL["float32"]),
                cs.check_close(f"{label} lse", lse, lse_p, cs.TOL["float32"]))
        for c0 in sorted({0, (V - 1) // chunk * chunk}):
            width = min(chunk, V - c0)
            dz, dzx = lc.linear_ce_dz_cuda(x, w, lab, lse, g, c0, width, **kw)
            dz2, dzx2 = lc.linear_ce_dz_cuda(x, w, lab, lse, g, c0, width,
                                             **kw)
            torch.cuda.synchronize()
            if not (torch.equal(dz, dz2) and torch.equal(dzx, dzx2)):
                raise cs.SmokeFailure(f"{label}: two dz calls differ")
            truth = fce.lce_dz_ref(x, w[c0:c0 + width], lab, lse, g, c0, V,
                                   eps)
            ratios = []
            e = max(e, cs.check_lce(f"{label} dz slab {c0}:{c0 + width}", dz,
                                    truth.to(dz.dtype), truth, True, ratios))
            worst = max(worst, ratios[0])
            if xdn == "float32":
                dzx = dz_of(dzx)
                e = max(e, cs.check_lce(f"{label} dz_x slab {c0}", dzx,
                                        truth, None, False, None))
                if c0 + width == V:          # the smoke's slab: the last
                    cs.check_split(label, (label, T, H, V, chunk, xdn,
                                           "bfloat16", ignore, eps),
                                   x, w, lab, lse, g, c0, (nll, lse, dzx),
                                   (nll_p, lse_p, truth))
            del dz, dz2, dzx, dzx2, truth
        dx, dw = lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk, **kw)
        dx2, dw2 = lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk,
                                         **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise cs.SmokeFailure(f"{label}: two backward calls differ")
        del dx2, dw2
        dx_p, dw_p = fce.lce_bwd_ref(x, w, lab, lse, g, chunk=chunk, **kw)
        dx_t, dw_t = fce.lce_bwd_ref(x.float(), w.float(), lab, lse, g,
                                     chunk=chunk, **kw)
        ratios = []
        e = max(e, cs.check_lce(f"{label} dx", dx, dx_p, dx_t, True, ratios),
                cs.check_lce(f"{label} dw", dw, dw_p, dw_t, True, ratios))
        worst = max(worst, *ratios)
        if xdn == "float32":
            d = cs.split_dw_excess((label, T, H, V, chunk, xdn, "bfloat16",
                                    ignore, eps), x, w, lab, lse, g, dw,
                                   dw_t)
            cs.info(f"{label}: split dw check, x the allowance past half "
                    f"an ulp: {d}")
            if d["kernels"] > 1.0:
                raise cs.SmokeFailure(f"{label}: dw misses the split dw "
                                      f"check ({d['kernels']:.3e})")
        cs.info(f"{label}: max |kernel - plain| {e:.3e}")
        del x, w, lab, g, nll, lse, nll2, lse2, nll_p, lse_p
        del dx, dw, dx_p, dw_p, dx_t, dw_t
        torch.cuda.empty_cache()
    return worst


def tma_bytes(T, H, V, chunk, split=False):
    """Bytes the wgmma kernels' TMA reads from L2 a call: the forward and
    the backward's dz, dx and dw over its slabs (each 128 x 256 output
    tile reads a 16 KB A box and a 32 KB B box every 64-deep K step; on
    the split route, fp32 x with bf16 w, fwd and dz read two A boxes, x_hi
    and x_lo, beside the one B box, and dw's 128 x 192 tiles read both
    halves of dz (8 KB each) and of x (12 KB each) every 32 rows of T,
    whatever the K split)."""
    def one(rows, cols, depth, a_boxes=1):
        return (-(-rows // 128) * -(-cols // 256) * -(-depth // 64)
                * (16384 * a_boxes + 32768))
    z = 2 if split else 1
    widths = [min(chunk, V - c0) for c0 in range(0, V, chunk)]
    dw = (sum(-(-c // 128) * -(-H // 192) * -(-T // 32) * 40960
              for c in widths) if split
          else sum(one(c, H, T) for c in widths))
    return {"fwd": one(T, V, H, z),
            "dz": sum(one(T, c, H, z) for c in widths),
            "dx": sum(one(T, H, c) for c in widths),
            "dw": dw}


def kernel_grids(fn, name):
    """{kernel name: grid} of the kernels one call of ``fn`` launches, from
    the profiler's trace (written to chiprun_out/lce_trace_<name>.json)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = ROOT / "chiprun_out" / f"lce_trace_{name}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"].split("(")[0]: e.get("args", {}).get("grid")
            for e in events if e.get("cat") == "kernel"}


def kernel_ms(breakdown, name):
    """Device ms a call of kernel ``name``'s instances in a breakdown."""
    hit = [(mean, n) for k, (mean, n) in breakdown.items()
           if cs.lce_route(k, name)]
    return sum(mean * n for mean, n in hit) if hit else None


def time_head(libs, wrappers, order, gen, report, case, key):
    """Each variant's times at one head (``case``, an entry of
    ``chip_smoke.LCE_CASES``) in the turns of ``order``, each through its
    wrapper (``wrappers``, else this tree's), beside the bounds and the
    dense chain, into ``report``'s ``key`` rows.  With fp32 x the
    forward's breakdown also gives the split pre-pass, and ``reload_w``
    (after each ``change``) times this tree's bf16 kernels on ``[x_hi |
    x_lo]`` and ``[w | w]``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    _, T, H, V, chunk, xdn, *_ = case
    x, w, lab, g = inputs((T, H, V, chunk, None, 0.0, xdn), gen)
    operands = {name: (x, w) for name in libs}
    first = next(iter(libs))
    build._lib = libs[first][0]
    _, lse = wrappers.get(first, lc).linear_ce_fwd_cuda(x, w, lab)
    if xdn == "float32" and "change" in libs:
        xs = fce.lce_split_x_ref(x)
        operands["reload_w"] = (torch.cat((xs[0], xs[1]), 1),
                                torch.cat((w, w), 1))
        del xs
        nll_r, _ = lc.linear_ce_fwd_cuda(*operands["reload_w"], lab)
        nll_p, _ = fce.lce_fwd_ref(x, w, lab, chunk=chunk)
        err = cs.max_err(nll_r, nll_p)
        if err > cs.LCE_ABS:
            raise cs.SmokeFailure(f"{key} reload_w: nll {err:.3e} from the "
                                  f"plain version")
        cs.info(f"{key} reload_w: max |nll - plain| {err:.3e}")
        del nll_r, nll_p
        order = [v for n in order for v in (
            (n, "reload_w") if n == "change" else (n,))]
    slabs = [(c0, min(chunk, V - c0)) for c0 in range(0, V, chunk)]
    libs = dict(libs, reload_w=libs["change"]) if "reload_w" in \
        operands else libs
    times = {name: {"fwd": [], "split_x": [], "dz": [], "dx": [], "dw": [],
                    "bwd": []} for name in libs}
    for name in libs:
        build._lib = libs[name][0]
        xx, ww = operands[name]
        m = wrappers.get(name, lc)
        grids = kernel_grids(lambda: (m.linear_ce_fwd_cuda(xx, ww, lab),
                                      m.linear_ce_dz_cuda(xx, ww, lab, lse,
                                                          g, 0, chunk)),
                             f"{key}_{name}")
        report["variants"].setdefault(name, {})[f"{key}_grids"] = grids
        cs.info(f"grids {key} {name}: {grids}")
    for name in order:
        build._lib = libs[name][0]
        xx, ww = operands[name]
        m = wrappers.get(name, lc)

        def dz_all():
            for c0, width in slabs:
                m.linear_ce_dz_cuda(xx, ww, lab, lse, g, c0, width)
        by = {}
        _, call = cs.time_ms(lambda: m.linear_ce_fwd_cuda(xx, ww, lab),
                             ITERS, by)
        times[name]["fwd"].append(kernel_ms(by, "linear_ce_fwd") or call)
        times[name]["split_x"].append(kernel_ms(by, "linear_ce_split_x"))
        by = {}
        _, call = cs.time_ms(dz_all, 2, by)
        times[name]["dz"].append(kernel_ms(by, "linear_ce_dz") or call)
        by = {}
        if name == "reload_w":               # fwd and dz only: another dx, dw
            dev = call = None
        else:
            dev, call = cs.time_ms(lambda: m.linear_ce_bwd_cuda(
                xx, ww, lab, lse, g, chunk=chunk), 2, by)
        per = {k: kernel_ms(by, k) for k in cs.LCE_NAMES[1:]}
        times[name]["bwd"].append(dict(device_ms=dev, call_ms=call, **per))
        for k in ("dx", "dw"):
            times[name][k].append(per[f"linear_ce_{k}"])
        cs.info(f"{key} {name}: fwd {times[name]['fwd'][-1]:.4f} ms (split "
                f"{times[name]['split_x'][-1]}), dz x {len(slabs)} "
                f"{times[name]['dz'][-1]:.4f} ms, bwd "
                f"{times[name]['bwd'][-1]}")
    lib_fwd = cs.time_ms(lambda: F.cross_entropy(
        (x @ w.to(x.dtype).t()).float(), lab, reduction="none"), ITERS)[0]
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
    saved = (F.cross_entropy((xr @ wr.to(x.dtype).t()).float(), lab,
                             reduction="none") * g).sum()
    lib_bwd = cs.time_ms(lambda: torch.autograd.grad(
        saved, (xr, wr), retain_graph=True), 3)[0]
    del saved, xr, wr
    # dw's yardstick: one torch.matmul(dz.T, x) a slab in x's dtype (TF32
    # off), summed over the slabs
    dzl = torch.randn(T, chunk, device="cuda", generator=gen).to(x.dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        per = {c: cs.time_ms(lambda: torch.matmul(dzl[:, :c].t(), x),
                             ITERS)[0] for c in {c for _, c in slabs}}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lib_dw = sum(per[c] for _, c in slabs)
    del dzl
    bo = cs.lce_bytes_ops(T, H, V, chunk, x.element_size(), 2)
    bound = {k: cs.bound_ms(*bo[f"linear_ce_{k}"])
             for k in ("fwd", "dz", "dx", "dw", "split_x")}
    report[key] = dict(bound_ms=bound, library_fwd_ms=lib_fwd,
                       library_bwd_ms=lib_bwd, library_dw_ms=lib_dw,
                       tma_bytes=tma_bytes(T, H, V, chunk,
                                           xdn == "float32"))
    cs.info(f"{key}: bound {bound}; dense chain forward {lib_fwd:.4f} ms, "
            f"backward alone {lib_bwd:.4f} ms; torch.matmul(dz.T, x) over "
            f"the slabs {lib_dw:.4f} ms; TMA bytes from L2 a call "
            f"{report[key]['tma_bytes']}")
    for name, ts in times.items():
        row = report["variants"][name][key] = dict(ts)
        for k in ("fwd", "split_x", "dz", "dx", "dw"):
            got = [v for v in ts[k] if v is not None]
            if not got:
                continue
            mean = sum(got) / len(got)
            row[f"{k}_mean_ms"] = mean
            row[f"{k}_of_bound"] = bound[k][0] / mean
            cs.info(f"{key} {name}: {k} {ts[k]} ms (mean {mean:.4f}, "
                    f"{100 * row[f'{k}_of_bound']:.1f} % of bound)")
        if all(f"{k}_mean_ms" in row for k in ("dz", "dx", "dw")):
            bwd = sum(row[f"{k}_mean_ms"] for k in ("dz", "dx", "dw"))
            cs.info(f"{key} {name}: fwd {row['fwd_mean_ms'] / lib_fwd:.2f}"
                    f"x the dense chain's forward; dz + dx + dw {bwd:.4f} ms, "
                    f"{bwd / lib_bwd:.2f}x its backward alone; dw "
                    f"{row['dw_mean_ms'] / lib_dw:.2f}x torch.matmul's")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--turns", type=int, default=1,
                    help="times the order a, b, ..., b, a is run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import build
    card = cs.phase_device()
    srcs, unchecked, wrappers = {}, set(), {}
    for item in args.tree:
        name, _, tree = item.partition("=")
        srcs[name] = (Path(tree).resolve()
                      / "paddle_tpu_torch/kernels/csrc/linear_ce.cu")
        wrappers[name] = tree_wrapper(name, tree)
    srcs["change"] = build.CSRC / "linear_ce.cu"
    text = srcs["change"].read_text()
    edits = {}
    if args.ablate:
        edits.update(TUNINGS)
        edits.update(ABLATIONS)
        unchecked = set(ABLATIONS)
    for name, cuts in edits.items():
        srcs[name] = build.BUILD_DIR / "ab" / f"lce_{name}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(_edited(text, cuts))
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
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    for name, (lib, *_) in libs.items():
        if name in unchecked:
            continue
        build._lib = lib
        report["variants"][name]["bf16_vs_fp32_ratio"] = check_variant(
            name, gen, wrappers.get(name, lc))
    if not args.no_time:
        order = (list(libs) + list(reversed(libs))) * args.turns
        time_head(libs, wrappers, order, gen, report, LLAMA, "llama_head")
        torch.cuda.empty_cache()
        time_head(libs, wrappers, order, gen, report, GPT, "gpt_head")
    out = ROOT / "chiprun_out" / "lce_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
