#!/usr/bin/env python3
"""Time builds of the serving chain's RoPE / KV-write kernel and the fused
API's softmax-mask kernel (``rope_kv.cu``, ``fused_ops.cu``) against each
other on one CUDA card.

    python3 tools/rope_softmax_ab.py [--tree NAME=DIR ...] [--tune]
                                     [--ablate] [--only NAME,...]
                                     [--turns N] [--no-time]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is the two files of one tree, linked with this tree's other
sources' objects into its own library under
``paddle_tpu_torch/kernels/_build/ab/``: ``change`` is this tree's;
``--tree NAME=DIR`` adds DIR's (another checkout's, e.g. the parent commit
unpacked by ``git archive`` into the git-ignored ``archive_check/``).
``--tune`` adds this tree's two files with the choices of ``TUNINGS``,
each checked and timed like a tree: for the softmax, a whole
mask-sharing group a warp in passes; at most 4 or 2 rows a lane group;
rows of 9..16 chunks on 16 lanes of one chunk or on 4 of four; 4 blocks
an SM; a grid of one item a warp; the IEEE division of every value,
zeros too, or of every nonzero value, or (a diagnostic: not the rounded
quotient) the product with the reciprocal alone; for rope_kv_write, 128
or 256 threads a block; for its int8-pool kernel (``rope_kv_write_q8``)
16 values a half a lane, k and v on the same lanes without RoPE or on
lanes of their own with it, 128 threads a block,
and the IEEE division of every code (``q8_div_ieee``, compared bit for
bit).  ``--ablate`` adds cut-down int8-pool kernels, checked but timed
whatever the checks say (``ABLATIONS``: no division, no shuffle, no scale
store, and the reciprocal product alone as the quotient, a diagnostic).
``--only`` keeps the named variants and limits the edits made to them.
All ``nvcc`` processes start together.

The script prints ptxas' registers, stack frame and spills of each
variant's kernels, then checks each variant: ``rope_kv_write`` at
head_dim 32 / 64 / 128 with 1, 2, 4 and 8 q heads a kv head (decode with
a slot whose page is -1, a length past the table and a page >= NB;
prefill through blk / off with a padded tail routed to page NB) and at
``chip_smoke.py``'s llama_7b cases, in fp32 and bf16, each call twice,
bit-identical, one launch, and bit-equal to ``rope_kv_write_ref`` (a
variant that is not, such as a build whose fp32 products contract into
FMAs, must still meet the 1e-4 / 2e-2 tolerance, and the report says
which); the same cases into int8 pools and ``chip_smoke.py``'s hard rows
(``q8_hard_rows``: ties, clips, zero and tiny rows) rotated and not, and
the GPT-125M cases (12 kv heads, D 64, unrotated), each bit-equal to the
plain version or reported not; ``softmax_mask_fwd`` on ``SOFTMAX_CASES`` (every row width of the
register path and the long rows; masks broadcast over heads, rows, both,
along the row, full and strided) with fp32 and bf16 x and mask, by
``chip_smoke.py``'s rule (1e-4, or 2e-2 / the bf16 ratio rule), each call
twice, bit-identical, one launch, and an all -inf row NaN.  Then, unless
``--no-time``, it times the variants in turns (a, b, ..., b, a;
``--turns N`` runs that order N times): ``rope_kv_write`` at llama_7b's
widths at decode B 4 (lengths 1000/37/0/517) and at prefill chunks of Ts
16 and 256 after 300 positions, unrotated at GPT-125M's (decode, Ts 256),
and ``rope_kv_write_q8``'s four instances (llama_7b rotated and GPT-125M
unrotated, decode and Ts 256; bound: a byte a code and 4 bytes a scale
stored); the softmax at BERT-base's logits
[32, 12, 128, 128] bf16 with a [32, 1, 128, 128] fp32 padding mask and at
``chip_smoke.py``'s S 1000 and S 5000 cases, each beside one
``torch.softmax(x + mask, -1)`` (the main mask ``chip_smoke.py``'s
padding mask, the others with a fifth of the values masked); and one
bf16 ``decode_block`` and
``prefill_block`` (Ts 256) layer call's device time (the chain's
kernels, profiler), each beside its bound.

Where ``change`` and ``sm_div_all`` are both built, it also counts the
softmax values whose bits differ between the two on every case, x at
scales 3 and 30 (the division by a reciprocal taken once a row must give
the IEEE quotient); ``change`` and ``q8_div_ieee`` (the IEEE division of
every code) are each held bit for bit to the same plain version.

Writes ``chiprun_out/rope_softmax_ab.json``.  Imports nothing of the JAX
package.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import pattn_ab  # noqa: E402
from dattn_ab import _edited, _ptxas  # noqa: E402

FILES = ("rope_kv.cu", "fused_ops.cu")
ITERS = 50                       # timed calls a variant, shape and turn
# rope_kv_write checks: head_dim and q heads a kv head
ROPE_GD = [(D, G) for D in (32, 64, 128) for G in (1, 2, 4, 8)]
# timed rope_kv_write calls at llama_7b's widths (chip_smoke.rope_kv_cases)
ROPE_CHUNKS = (16, 256)
# softmax checks: (label, x shape, mask shape, extra mask columns sliced
# off: a strided mask)
SOFTMAX_CASES = [
    ("S1 heads", (4, 3, 1), (4, 1, 1), 0),
    ("S7 heads", (2, 3, 5, 7), (2, 1, 5, 7), 0),
    ("S127 heads", (3, 5, 9, 127), (3, 1, 9, 127), 0),
    ("S128 heads", (2, 12, 17, 128), (2, 1, 17, 128), 0),
    ("S129 rows", (2, 3, 7, 129), (2, 3, 1, 129), 0),
    ("S300 heads rows", (2, 3, 300), (300,), 0),
    ("S1000 heads rows", (2, 3, 7, 1000), (2, 1, 1, 1000), 0),
    ("S5000 heads", (3, 2, 5000), (3, 1, 5000), 0),
    ("S128 columns", (2, 4, 5, 128), (2, 4, 5, 1), 0),
    ("S128 full", (3, 5, 128), (3, 5, 128), 0),
    ("S127 full", (2, 3, 7, 127), (2, 3, 7, 127), 0),
    ("S128 heads strided", (2, 3, 6, 128), (2, 1, 6, 128), 3),
    ("S64 full strided", (4, 6, 64), (4, 6, 64), 6),
    ("main", *cs.SOFTMAX_MAIN, 0)]
# timed softmax calls: (label, x shape, mask shape), bf16 x, fp32 mask
SOFTMAX_TIMED = [("main", *cs.SOFTMAX_MAIN)] + [
    (label, xs, ms) for label, xs, ms in cs.SOFTMAX_SMALL
    if label in ("S 1000", "S 5000")]
DTYPES = (("float32", "float32"), ("bfloat16", "bfloat16"))
# rope_kv.cu's lines the int8-pool variants edit: a code's quotient, the
# absmax shuffle
Q8_CODE = ("  return __float_as_uint(__fadd_rn(div_rn(x, s, y), "
           "0x1.8p23f));")
Q8_SHUFFLE = ("    for (int w = L / 2; w > 0; w >>= 1)\n#pragma unroll\n"
              "      for (int t = 0; t < NT; ++t)\n"
              "        m[t] = fmaxf(m[t], __shfl_xor_sync(live, m[t], w));\n")
Q8_SHUFFLE_PACKED = ("    for (int w = L / 2; w > 0; w >>= 1)\n"
                     "      mm = __hmax2(mm, __shfl_xor_sync(live, mm, w));\n")
# GPT-125M's unrotated instances: kv heads (one q head each) and head_dim
GPT_HEADS, GPT_D = 12, 64
# this tree's files with one choice changed: (old, new) text pairs
TUNINGS = {
    "sm_one_read": [("    p.parts = (p.share + BATCH - 1) / BATCH;",
                     "    p.parts = 1;")],
    "sm_rows_4": [("  return 32 / regs > 8 ? 8 :",
                   "  return 32 / regs > 4 ? 4 :")],
    "sm_rows_2": [("  return 32 / regs > 8 ? 8 :",
                   "  return 32 / regs > 2 ? 2 :")],
    # rows of 9..16 chunks (65..128 bf16 values) on 16 lanes of one chunk
    # or 4 lanes of four
    "sm_lpr16": [("case 1: return softmax_rows_launch<T, M, 8, 2, SHARED>",
                  "case 1: return softmax_rows_launch<T, M, 16, 1, SHARED>")],
    "sm_lpr4": [("case 1: return softmax_rows_launch<T, M, 8, 2, SHARED>",
                 "case 1: return softmax_rows_launch<T, M, 4, 4, SHARED>")],
    "sm_minb_4": [("__global__ void __launch_bounds__(THREADS)\n"
                   "    softmax_mask_fwd_rows(",
                   "__global__ void __launch_bounds__(THREADS, 4)\n"
                   "    softmax_mask_fwd_rows(")],
    "sm_no_cap": [("kern<<<want < (unsigned)cap ? want : (unsigned)cap,",
                   "kern<<<want,")],
    # the division on every value, or (not the contract's arithmetic: a
    # diagnostic) a product with the reciprocal
    "sm_div_all": [("  if (v >= 0x1p-90f) {", "  if (false) {"),
                   ("  return v == 0.f ? 0.f : v / sum;",
                    "  return v / sum;")],
    "sm_div_skip0": [("  if (v >= 0x1p-90f) {", "  if (false) {")],
    "sm_div_rcp": [("    return __fmaf_rn(__fmaf_rn(-sum, q, v), y, q);",
                    "    return q;")],
    "rope_128": [("constexpr int ROPE_THREADS = 64;",
                  "constexpr int ROPE_THREADS = 128;")],
    "rope_256": [("constexpr int ROPE_THREADS = 64;",
                  "constexpr int ROPE_THREADS = 256;")],
    # the int8-pool kernel: 16 values a half a lane; k and v on the same
    # lanes without RoPE, or apart with it; 128 threads a block; the IEEE
    # division of every code
    "q8_v16": [("constexpr int Q8_V = 8;", "constexpr int Q8_V = 16;")],
    "q8_kv_together": [("Q8_KVS_PLAIN = true,", "Q8_KVS_PLAIN = false,")],
    "q8_kv_apart": [("Q8_KVS_ROPE = false;", "Q8_KVS_ROPE = true;")],
    "q8_128": [("constexpr int Q8_THREADS = 64;",
                "constexpr int Q8_THREADS = 128;")],
    "q8_div_ieee": [(Q8_CODE, Q8_CODE.replace("div_rn(x, s, y)",
                                              "__fdiv_rn(x, s)"))]}
# cut-down int8-pool kernels (--ablate), checked but timed whatever the
# checks say: no division (the value itself rounded), no shuffle (the
# lane's own absmax), no scale store, and (not the rounded quotient) the
# product with the reciprocal alone
ABLATIONS = {
    "q8_no_div": [(Q8_CODE, Q8_CODE.replace("div_rn(x, s, y)", "x"))],
    "q8_no_shuffle": [(Q8_SHUFFLE, ""), (Q8_SHUFFLE_PACKED, "")],
    "q8_no_scale_store": [
        ("    if (d == 0) (tv ? ks.v : ks.k)[row] = sc;\n", "")],
    "q8_rcp_only": [(Q8_CODE, Q8_CODE.replace("div_rn(x, s, y)",
                                              "__fmul_rn(x, y)"))]}


def tuned_file(name):
    """The file a tuning or an ablation edits."""
    return FILES[0] if name.startswith(("rope", "q8")) else FILES[1]


def softmax_bytes_ops(xs, ms, itemsize=2, mask_itemsize=4):
    """x read and out written once, the mask read once; add, max,
    subtract, exp, sum, divide: 6 fp32 operations an element."""
    n = math.prod(xs)
    return 2 * n * itemsize + math.prod(ms) * mask_itemsize, 6 * n


def q8_bytes_ops(M, Hq, Hkv, D, writes, rotated, itemsize=2):
    """Bytes and operations of one rope_kv_write_q8 call (chip_smoke.py's
    count): rotated, rope_kv_write's reads and its q and k stores; else k
    and v read; then a byte a code and 4 bytes a scale of k and v for each
    of the ``writes`` rows kept; absmax, divide and round a stored value
    (and the rotation's 3 operations a value of q and k)."""
    if rotated:
        nbytes, ops = cs.rope_kv_bytes_ops(M, Hq, Hkv, D, 0, itemsize)
    else:
        nbytes, ops = 2 * M * Hkv * D * itemsize, 0
    return (nbytes + writes * 2 * Hkv * (D + 4),
            ops + writes * 2 * Hkv * 3 * D)


def build_variants(trees):
    """{name: (ctypes library, ptxas table)} for ``trees`` {name: csrc
    directory}."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = build._sources()
    others = [f for f in cu if f.name not in FILES]
    cmds = [[nvcc, *build.NVCC_FLAGS, "-c", str(f), "-o",
             str(out_dir / (f.stem + ".o"))] for f in others]
    objs = {}
    for name, csrc in trees.items():
        objs[name] = [out_dir / f"{Path(f).stem}_rs_{name}.o" for f in FILES]
        cmds += [[nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas",
                  "-v", "-c", str(csrc / f), "-o", str(o)]
                 for f, o in zip(FILES, objs[name])]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise build.KernelBuildError(f"$ {' '.join(c)}\n{log}")
    libs = {}
    for i, name in enumerate(trees):
        so = out_dir / f"lib_rs_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(out_dir / (f.stem + ".o")) for f in others),
                        *map(str, objs[name]), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        build._bind(lib)
        first = len(others) + len(FILES) * i
        libs[name] = (lib, _ptxas("\n".join(logs[first:first + len(FILES)])))
    return libs


def rope_check_inputs(D, G, mode, dt, gen, Hkv=2, BS=4, NB=24, MB=3):
    """([q, k, v, cos, sin, pool_k, pool_v], target keywords) of one small
    case.  Decode: slots that write (lengths 5 and 0), an inactive slot
    (table all -1), a length past the table, a page >= NB.  Prefill: 7
    rows through blk / off, the last 2 routed to page NB."""
    import torch
    if mode == "decode":
        bt = torch.full((5, MB), -1, dtype=torch.int32)
        bt[0, :2] = torch.tensor([3, 7])
        bt[1, 0] = 9
        bt[3] = torch.tensor([1, 2, 4])
        bt[4, 0] = NB + 3
        tgt = dict(block_table=bt.cuda(), lengths=torch.tensor(
            [5, 0, 0, MB * BS, 2], dtype=torch.int32, device="cuda"))
    else:
        pos = 6 + torch.arange(7)
        bt = torch.tensor([11, 5, 8, 2], dtype=torch.int32)
        blk = bt[pos // BS]
        blk[5:] = NB
        tgt = dict(block_table=bt.cuda(), blk=blk.cuda(),
                   off=(pos % BS).to(torch.int32).cuda())
    M = 5 if mode == "decode" else 7
    args = cs.rope_kv_inputs(M, Hkv * G, Hkv, D, dt, gen, "cuda") + [
        torch.randn(*shape, device="cuda", generator=gen).to(dt)
        for shape in ((M, D), (M, D), (NB, BS, Hkv, D), (NB, BS, Hkv, D))]
    return args, tgt


def check_rope(variant, gen, L):
    """Every rope_kv_write case in fp32 and bf16; raises on a miss of the
    tolerance.  Returns {dtype: bit-equal on every case}."""
    import torch
    from paddle_tpu_torch.ops.cuda import kernels as K
    cfg = L["cfg"]
    cases = [(f"D{D} G{G} {mode}", D, G, mode) for D, G in ROPE_GD
             for mode in ("decode", "prefill")]
    big = cs.rope_kv_cases(L["lengths"], L["bt"], L["bt_row"], L["cos_t"],
                           L["sin_t"], L["BS"], ROPE_CHUNKS)
    bit = {}
    for dtn, _ in DTYPES:
        dt = getattr(torch, dtn)
        for label, D, G, mode in cases + [(k, None, None, None)
                                          for k in big]:
            if D is not None:
                args, tgt = rope_check_inputs(D, G, mode, dt, gen)
            else:
                M, tgt, c, s = big[label]
                args = cs.rope_kv_inputs(
                    M, cfg.num_heads, cfg.kv_heads, cfg.head_dim, dt, gen,
                    "cuda") + [c.to(dt), s.to(dt), L["pk"].to(dt),
                               L["pv"].to(dt)]
            what = f"{variant} rope_kv_write {label} {dtn}"
            try:
                cs.check_rope_kv_bitwise(what, args, tgt)
                ok = True
            except cs.SmokeFailure as e:
                if "bit-equal" not in str(e):
                    raise
                ok = False
                q, k, v, c, s, pk, pv = args
                gq, gk, gpk, gpv = q.clone(), k.clone(), pk.clone(), pv.clone()
                K.rope_kv_write_cuda(gq, gk, v, c, s, gpk, gpv, **tgt)
                rpk, rpv = pk.clone(), pv.clone()
                rq, rk = K.rope_kv_write_ref(q, k, v, c, s, rpk, rpv,
                                             head_dim=pk.shape[-1], **tgt)
                for g, r in ((gq, rq), (gk, rk), (gpk, rpk), (gpv, rpv)):
                    cs.check_close(what, g, r, cs.TOL[dtn])
            bit[dtn] = bit.get(dtn, True) and ok
    return bit


def q8_check_cases(L, dt, gen):
    """[(label, [q, k, v, cos, sin], int8 pool_k, pool_v, target
    keywords)] of rope_kv_write into int8 pools in ``dt``: the small cases
    rotated (and unrotated at one q head a kv head), random and hard rows;
    the llama_7b cases (rotated) and GPT-125M's (12 kv heads, D 64,
    unrotated), random and hard rows."""
    import torch
    cfg, out, seed = L["cfg"], [], cs.SEED + 28
    for D, G in ROPE_GD:
        for mode in ("decode", "prefill"):
            args, tgt = rope_check_inputs(D, G, mode, dt, gen)
            q, k, v, c, s, pk, pv = args
            pk, pv = cs.q8_pool(pk, dt), cs.q8_pool(pv, dt)
            M, Hkv = q.shape[0], pk.data.shape[2]
            hard = cs.rope_q8_hard_inputs(M, Hkv * G, Hkv, D, dt, seed, "cuda")
            label = f"D{D} G{G} {mode}"
            out += [(label, [q, k, v, c, s], pk, pv, tgt),
                    (label + " hard", hard, pk, pv, tgt)]
            if G == 1:
                out += [(label + " unrotated", [q, k, v, None, None], pk, pv,
                         tgt),
                        (label + " unrotated hard", hard[:3] + [None, None],
                         pk, pv, tgt)]
    for fam, Hq, Hkv, D, rotated in (
            ("llama", cfg.num_heads, cfg.kv_heads, cfg.head_dim, True),
            ("gpt", GPT_HEADS, GPT_HEADS, GPT_D, False)):
        pools = [cs.q8_pool(torch.randn(L["NB"], L["BS"], Hkv, D,
                                        device="cuda", generator=gen), dt)
                 for _ in range(2)]
        for label, (M, tgt, c, s) in cs.rope_kv_cases(
                L["lengths"], L["bt"], L["bt_row"], L["cos_t"], L["sin_t"],
                L["BS"], ROPE_CHUNKS).items():
            rnd = cs.rope_kv_inputs(M, Hq, Hkv, D, dt, gen, "cuda")
            hard = cs.rope_q8_hard_inputs(M, Hq, Hkv, D, dt, seed + M, "cuda")
            if rotated:
                rnd += [c[:, :D].to(dt), s[:, :D].to(dt)]
            else:
                rnd += [None, None]
                hard = hard[:3] + [None, None]
            out += [(f"{fam} {label}", rnd, *pools, tgt),
                    (f"{fam} {label} hard", hard, *pools, tgt)]
    return out


def check_rope_q8(variant, gen, L):
    """Every int8-pool case in fp32 and bf16; raises on a failed launch.
    Returns {dtype: bit-equal to the plain version on every case} and the
    first case that was not."""
    bit, first = {}, None
    for dtn, _ in DTYPES:
        import torch
        dt = getattr(torch, dtn)
        ok = True
        for label, (q, k, v, c, s), pk, pv, tgt in q8_check_cases(L, dt,
                                                                  gen):
            try:
                cs.check_rope_q8_bitwise(f"{variant} rope_kv_write_q8 "
                                         f"{label} {dtn}", q, k, v, c, s, pk,
                                         pv, tgt)
            except cs.SmokeFailure as e:
                if "bit-equal" not in str(e):
                    raise
                ok = False
                first = first or str(e)
        bit[dtn] = ok
    return bit, first


def check_softmax(variant, gen):
    """Every softmax case, x and mask in fp32 and bf16; raises on the
    first miss.  Returns the largest |kernel - plain| by x dtype."""
    import torch
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    err, ratios = {}, []
    for label, xs, ms, extra in SOFTMAX_CASES:
        x32 = torch.randn(xs, device="cuda", generator=gen) * 3
        wide = ms[:-1] + (ms[-1] + extra,)
        keep = torch.rand(wide, device="cuda", generator=gen) > 0.2
        for mdn, _ in DTYPES:
            mask = torch.where(keep, 0.0, -1e4).to(getattr(torch, mdn))[
                ..., :ms[-1]]
            for dtn, _ in DTYPES:
                x = x32.to(getattr(torch, dtn))
                outs = [cs.one_launch("softmax_mask_fwd", lambda:
                                      cf.softmax_mask_fwd_cuda(x, mask))
                        for _ in range(2)]
                if not torch.equal(outs[0], outs[1]):
                    raise cs.SmokeFailure(f"{variant} softmax {label}: a "
                                          "second call differs")
                cs.check_pair(f"{variant} softmax {label} mask {mdn} {dtn}",
                              dtn, outs[0], tf.softmax_mask_ref(x, mask),
                              tf.softmax_mask_ref(x.float(), mask), err,
                              ratios)
    x = torch.ones(2, 3, device="cuda")
    mask = torch.tensor([[-float("inf")] * 3, [0.0] * 3], device="cuda")
    got = cs.one_launch("softmax_mask_fwd",
                        lambda: cf.softmax_mask_fwd_cuda(x, mask))
    if not (torch.isnan(got[0]).all() and not torch.isnan(got[1]).any()):
        raise cs.SmokeFailure(f"{variant} softmax all-masked row: {got}")
    return err


def softmax_bits_match(libs, a, b, gen):
    """Run every softmax case (x at scales 3 and 30: the latter gives
    exps down to 0 through the subnormals) on variants ``a`` and ``b``;
    returns the number of values whose bits differ."""
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops.cuda import fused as cf
    differ = 0
    for label, xs, ms, extra in SOFTMAX_CASES:
        wide = ms[:-1] + (ms[-1] + extra,)
        keep = torch.rand(wide, device="cuda", generator=gen) > 0.2
        for scale in (3.0, 30.0):
            x32 = torch.randn(xs, device="cuda", generator=gen) * scale
            for mdn, _ in DTYPES:
                mask = torch.where(keep, 0.0, -1e4).to(getattr(torch, mdn))[
                    ..., :ms[-1]]
                for dtn, _ in DTYPES:
                    x, outs = x32.to(getattr(torch, dtn)), []
                    for name in (a, b):
                        build._lib = libs[name][0]
                        outs.append(cf.softmax_mask_fwd_cuda(x, mask))
                    differ += int((outs[0] != outs[1]).sum())
    return differ


def timed_shapes(L, gen):
    """{label: (kernel fn, library fn or None, (bytes, ops), 'launch' |
    'layer' GEMM kernel name)} of every timed shape."""
    import torch
    from paddle_tpu_torch.ops.cuda import fused as cf
    from paddle_tpu_torch.ops.cuda import kernels as K
    bf, cfg = torch.bfloat16, L["cfg"]
    Hq, Hkv, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    out = {}
    for label, (M, tgt, c, s) in cs.rope_kv_cases(
            L["lengths"], L["bt"], L["bt_row"], L["cos_t"], L["sin_t"],
            L["BS"], ROPE_CHUNKS).items():
        q, k, v = cs.rope_kv_inputs(M, Hq, Hkv, D, bf, gen, "cuda")
        c, s = c.to(bf), s.to(bf)
        out[f"rope_kv_write {label}"] = (
            lambda q=q, k=k, v=v, c=c, s=s, tgt=tgt: K.rope_kv_write_cuda(
                q, k, v, c, s, L["pk"], L["pv"], **tgt), None,
            cs.rope_kv_bytes_ops(M, Hq, Hkv, D,
                                 cs.rope_kv_writes(tgt, L["pk"])), "launch")
    for label, (M, tgt, c, s) in cs.rope_kv_cases(
            L["lengths"], L["bt"], L["bt_row"], None, None, L["BS"],
            (256,)).items():
        gp = [torch.randn(L["NB"], L["BS"], GPT_HEADS, GPT_D, device="cuda",
                          generator=gen).to(bf) for _ in range(2)]
        q, k, v = cs.rope_kv_inputs(M, GPT_HEADS, GPT_HEADS, GPT_D, bf, gen,
                                    "cuda")
        writes = cs.rope_kv_writes(tgt, gp[0])
        out[f"rope_kv_write unrotated gpt {label}"] = (
            lambda q=q, k=k, v=v, tgt=tgt, gp=gp: K.rope_kv_write_cuda(
                q, k, v, None, None, *gp, **tgt), None,
            ((2 * M + 2 * writes) * GPT_HEADS * GPT_D * 2, 0), "launch")
        gq = [cs.q8_pool(t, bf) for t in gp]
        out[f"rope_kv_write_q8 gpt {label}"] = (
            lambda q=q, k=k, v=v, tgt=tgt, gq=gq: K.rope_kv_write_cuda(
                q, k, v, None, None, *gq, **tgt), None,
            q8_bytes_ops(M, GPT_HEADS, GPT_HEADS, GPT_D, writes, False),
            "launch")
    lq = [cs.q8_pool(t, bf) for t in (L["pk"], L["pv"])]
    for label, (M, tgt, c, s) in cs.rope_kv_cases(
            L["lengths"], L["bt"], L["bt_row"], L["cos_t"], L["sin_t"],
            L["BS"], (256,)).items():
        q, k, v = cs.rope_kv_inputs(M, Hq, Hkv, D, bf, gen, "cuda")
        c, s = c.to(bf), s.to(bf)
        out[f"rope_kv_write_q8 llama {label}"] = (
            lambda q=q, k=k, v=v, c=c, s=s, tgt=tgt: K.rope_kv_write_cuda(
                q, k, v, c, s, *lq, **tgt), None,
            q8_bytes_ops(M, Hq, Hkv, D, cs.rope_kv_writes(tgt, L["pk"]),
                         True), "launch")
    for label, xs, ms in SOFTMAX_TIMED:
        x = (torch.randn(xs, device="cuda", generator=gen) * 3).to(bf)
        keep = torch.rand(ms, device="cuda", generator=gen) > 0.2
        mask = (cs.padding_mask(xs, ms, gen, "cuda") if label == "main"
                else torch.where(keep, 0.0, -1e4))
        out[f"softmax_mask_fwd {label} {list(xs)}"] = (
            lambda x=x, mask=mask: cf.softmax_mask_fwd_cuda(x, mask),
            lambda x=x, mask=mask: torch.softmax(x + mask, -1),
            softmax_bytes_ops(xs, ms), "launch")
    layers = pattn_ab.shapes_to_time(L)
    for key in ("decode_block", "prefill_block Ts 256"):
        fn, _, bo, _, gemm = layers[key]
        out[key] = (fn, None, bo, gemm)
    return out


def time_all(libs, order, report, gen):
    """Device ms a call of each timed shape, the variants in ``order``;
    the library calls once a turn."""
    from paddle_tpu_torch.kernels import build
    shapes = timed_shapes(pattn_ab.smoke_layer(), gen)
    for key, (fn, lib_fn, (nbytes, ops), how) in shapes.items():
        times = {name: [] for name in libs}
        lib_times = []
        for i, name in enumerate(order):
            build._lib = libs[name][0]
            if how == "launch":
                ms, call_ms = cs.time_ms(fn, ITERS, per_launch=True)
            else:                           # a layer call: its chain
                by = {}
                cs.time_ms(fn, 10, by)
                ms, call_ms = cs.chain_ms(by, how), None
            times[name].append(call_ms if ms is None else ms)
            if lib_fn is not None and i % len(libs) == 0:
                lib_times.append(cs.time_ms(lib_fn, ITERS)[0])
        bms, bby = cs.bound_ms(nbytes, ops, dtype="float32"
                               if key.startswith("softmax") else "bfloat16")
        lib_mean = (sum(lib_times) / len(lib_times)) if lib_times else None
        report["library"][key] = lib_times
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            report["variants"][name][key] = dict(
                ms=ts, mean_ms=mean, bound_ms=bms, bound_by=bby,
                library_ms=lib_times, of_bound=bms / mean,
                x_library=mean / lib_mean if lib_mean else None)
            cs.info(f"{key} {name}: {ts} ms (mean {mean:.6f}), bound "
                    f"{bms:.6f} ({bby}, {100 * bms / mean:.1f} %), library "
                    f"{lib_times}"
                    + (f" ({mean / lib_mean:.3f}x)" if lib_mean else ""))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import build
    card = cs.phase_device()
    trees = {}
    for item in args.tree:
        name, _, tree = item.partition("=")
        trees[name] = Path(tree).resolve() / "paddle_tpu_torch/kernels/csrc"
    trees["change"] = build.CSRC
    keep = args.only.split(",") if args.only else None
    edits = {**(TUNINGS if args.tune else {}),
             **(ABLATIONS if args.ablate else {})}
    for name, cuts in edits.items():
        if keep and name not in keep:
            continue
        d = trees[name] = build.BUILD_DIR / "ab" / f"src_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            text = (build.CSRC / f).read_text()
            (d / f).write_text(_edited(text, cuts) if tuned_file(name) == f
                               else text)
    if keep:
        trees = {k: v for k, v in trees.items() if k in keep}
    report = {"card": card, "variants": {}, "library": {}}
    libs = build_variants(trees)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for name, (lib, table) in libs.items():
        report["variants"][name] = {"ptxas": table}
        for k, v in table.items():
            cs.info(f"ptxas {name}: {k}: {v}")
    L = pattn_ab.smoke_layer()
    for name, (lib, _) in list(libs.items()):
        build._lib = lib
        try:
            q8_bit, q8_first = check_rope_q8(name, gen, L)
            bit = check_rope(name, gen, L)
            err = check_softmax(name, gen)
        except (cs.SmokeFailure, RuntimeError, ValueError) as e:
            cs.info(f"{name}: FAILED its checks, not timed: {e}")
            report["variants"][name]["failed"] = str(e)
            del libs[name]
            continue
        report["variants"][name].update(rope_bit_equal=bit,
                                        rope_q8_bit_equal=q8_bit,
                                        rope_q8_first_miss=q8_first,
                                        softmax_max_abs_err=err)
        cs.info(f"{name}: every case within tolerance, calls bit-identical, "
                f"one launch each; rope_kv_write bit-equal to its plain "
                f"version {bit}; rope_kv_write_q8 {q8_bit}"
                + (f" (first miss: {q8_first})" if q8_first else "")
                + f"; softmax max |kernel - plain| {err}")
        if q8_first and name not in ABLATIONS:
            cs.info(f"{name}: FAILED the int8-pool bitwise checks, not timed")
            report["variants"][name]["failed"] = q8_first
            del libs[name]
    if "change" in libs and "sm_div_all" in libs:
        n = softmax_bits_match(libs, "change", "sm_div_all", gen)
        report["softmax_bits_vs_div_all"] = n
        cs.info(f"softmax: change against sm_div_all (the IEEE division of "
                f"every value): {n} values differ in their bits")
    if not args.no_time and libs:
        order = (list(libs) + list(reversed(libs))) * args.turns
        time_all(libs, order, report, gen)
    out = ROOT / "chiprun_out" / "rope_softmax_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
