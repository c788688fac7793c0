#!/usr/bin/env python3
"""Time builds of the paged-attention and row-norm kernels
(``paged_attention.cu``, ``norms.cu``) against each other on one CUDA
card.

    python3 tools/pattn_ab.py [--tree NAME=DIR ...] [--tune]
                              [--only NAME,...] [--turns N] [--no-time]
                              [--sass]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is the two files of one tree, linked with this tree's other
sources' objects into its own library under
``paddle_tpu_torch/kernels/_build/ab/``: ``change`` is this tree's;
``--tree NAME=DIR`` adds DIR's (another checkout's, e.g. the parent commit
unpacked by ``git archive`` into the git-ignored ``archive_check/``).
``--tune`` adds this tree's ``paged_attention.cu`` with the choices of
``TUNINGS`` (ring depth and chunk size, splits, the prefill ring over
full-width and over int8 pools, the rows body for chunks of <= 16 rows;
and ``norms.cu``'s RMSNorm with 256-thread blocks, plain loads or plain
stores), each checked and timed like a tree.  ``--only`` keeps the named
variants.  All ``nvcc`` processes start together.

The script prints ptxas' registers, stack frame and spills of each
variant's kernels and this tree's launch plans (``pt_paged_attention_plan``)
at the timed shapes; with ``--sass`` it also says, for each ``--tree``,
whether each kernel of ``norms.cu`` and ``flash_attention.cu`` has the
same SASS in that tree as in this one.  It checks each variant on
``PATTN_CASES`` (decode and prefill, bf16 and fp32, against
``paged_attention_ref`` by ``chip_smoke.py``'s rule: 1e-4 / 2e-2 or the
bf16 ratio rule; over full-width pools and, the ``q8`` cases, over int8
pools as ``paged_attention_q8``) and ``NORM_CASES`` (``rms_norm_fwd``,
``layer_norm_fwd``,
``bias_residual_ln_fwd`` against their plain versions), each call twice,
bit-identical, one launch each; then, unless ``--no-time``, times the
variants in turns (a, b, ..., b, a; ``--turns N`` runs that order N
times): paged attention alone at ``chip_smoke.py``'s decode case
(llama_7b, B 4, lengths 1000/37/0/517) and at prefill chunks (Ts 16
after 37, 300 and 1000, Ts 64 after 21, Ts 256 after 300), each beside its bound and one
``scaled_dot_product_attention`` call on K / V gathered beforehand;
``paged_attention_q8`` over int8 pools at the decode case and the Ts 256
chunk, at llama_7b's D 128 (32 heads) and GPT-125M's D 64 (12 heads), one
q head a kv head, beside SDPA on K / V dequantized to bf16 and gathered
beforehand; the
three norms at the eager steps' shapes beside ``F.rms_norm`` /
``F.layer_norm``; and one bf16 ``decode_block`` and ``prefill_block``
(Ts 256) layer call's device time (the chain's kernels, profiler).

Writes ``chiprun_out/pattn_ab.json``.  Imports nothing of the JAX package.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from dattn_ab import _edited, _ptxas  # noqa: E402

FILES = ("paged_attention.cu", "norms.cu")
ITERS = 40                       # timed calls a variant, shape and turn
# (label, G, D, lengths or None, Ts, start): decode rows around a
# page and at the table's end; prefill chunks on both bodies
PATTN_CASES = [("decode G1 D128", 1, 128, (1000, 37, 0, 517), 4, 0),
               ("decode G4 D64", 4, 64, (0, 15, 16, 17, 2047), 5, 0),
               ("decode G8 D128", 8, 128, (300, 1), 2, 0),
               ("prefill Ts16", 1, 128, None, 16, 37),
               ("prefill Ts16 start 600", 1, 128, None, 16, 600),
               ("prefill Ts100 G4 D64", 4, 64, None, 100, 5),
               ("prefill Ts256", 1, 128, None, 256, 300),
               ("q8 decode G1 D128", 1, 128, (1000, 37, 0, 517), 4, 0),
               ("q8 prefill Ts256 G1 D128", 1, 128, None, 256, 300),
               ("q8 decode G1 D64", 1, 64, (1000, 37, 0, 517), 4, 0),
               ("q8 prefill Ts256 G1 D64", 1, 64, None, 256, 300),
               ("q8 decode G8 D128", 8, 128, (300, 1), 2, 0),
               ("q8 prefill Ts16 start 600", 1, 128, None, 16, 600),
               ("q8 prefill Ts100 G4 D64", 4, 64, None, 100, 5)]
# the int8-pool shapes timed: (label, q heads = kv heads, D, decode?)
Q8_TIMED = (("llama_7b", 32, 128), ("gpt_125m", 12, 64))
NORM_CASES = [(8192, 4096), (3, 4096), (300, 4097), (64, 768)]
# paged_attention.cu with one choice changed: (old, new) text pairs
TUNINGS = {
    # the rows body's first ring: 3 chunks of 16 KB
    "ring_3_steps_4": [("constexpr int NSTG = 4, STEPS = 2;",
                        "constexpr int NSTG = 3, STEPS = 4;")],
    "ring_3": [("constexpr int NSTG = 4, STEPS = 2;",
                "constexpr int NSTG = 3, STEPS = 2;")],
    "splits_4": [("constexpr int MAXS = 8, MINP = 2;",
                  "constexpr int MAXS = 4, MINP = 2;")],
    "pre_ring_3": [("static constexpr int BK = 64, NSTG = Q8 ? 3 : 2, "
                    "LD = D + 8, LDC = D + 16;",
                    "static constexpr int BK = 64, NSTG = 3, LD = D + 8, "
                    "LDC = D + 16;")],
    # the prefill ring over int8 pools: 2 tiles of codes
    "q8_pre_ring_2": [("static constexpr int BK = 64, NSTG = Q8 ? 3 : 2, "
                       "LD = D + 8, LDC = D + 16;",
                       "static constexpr int BK = 64, NSTG = 2, LD = D + 8, "
                       "LDC = D + 16;")],
    # chunks of <= 16 rows on the rows body
    "ts16_rows": [("constexpr int MMA16_MAX = 512;",
                   "constexpr int MMA16_MAX = 0;")],
    # rms_norm_fwd at 256 threads a block (two chunks a thread at H 4096),
    # x with plain loads, out with plain stores
    "rms_256": [("constexpr int RMS_PER = 512;", "constexpr int RMS_PER = 256;")],
    "rms_ld_plain": [("nxt[k] = __ldcs(reinterpret_cast<const uint4 *>(x + "
                      "(size_t)r * H +\n                                     "
                      "                   e0));",
                      "nxt[k] = *reinterpret_cast<const uint4 *>(x + "
                      "(size_t)r * H + e0);")],
    "rms_st_plain": [("__stcs(reinterpret_cast<uint4 *>(orow + c * VEC), u);",
                      "*reinterpret_cast<uint4 *>(orow + c * VEC) = u;")]}
# the file each tuning edits
TUNED_FILE = {k: "norms.cu" for k in TUNINGS if k.startswith("rms_")}
SASS_FILES = ("norms.cu", "flash_attention.cu")


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
        objs[name] = []
        for f in FILES:
            o = out_dir / f"{Path(f).stem}_p_{name}.o"
            objs[name].append(o)
            cmds.append([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC),
                         "-Xptxas", "-v", "-c", str(csrc / f), "-o", str(o)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise build.KernelBuildError(f"$ {' '.join(c)}\n{log}")
    libs = {}
    for i, name in enumerate(trees):
        so = out_dir / f"lib_pattn_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(out_dir / (f.stem + ".o")) for f in others),
                        *map(str, objs[name]), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        build._bind(lib)
        first = len(others) + len(FILES) * i
        libs[name] = (lib, _ptxas("\n".join(logs[first:first + len(FILES)])))
    return libs


def sass_of(csrc, name, out_dir):
    """{kernel: SASS text} of each file of SASS_FILES built from csrc."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out = {}
    for f in SASS_FILES:
        cubin = out_dir / f"{Path(f).stem}_{name}.cubin"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC),
                        "-cubin", str(csrc / f), "-o", str(cubin)],
                       check=True, capture_output=True, text=True)
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        fn = None
        for line in text.splitlines():
            if line.strip().startswith("Function :"):
                fn = line.split(":", 1)[1].strip()
                out[fn] = []
            elif fn and "/*" in line:      # instructions and encodings
                out[fn].append(line.strip())
    return {k: "\n".join(v) for k, v in out.items()}


PLAN_KEYS = ("body", "splits", "grid_x", "grid_y", "grid_z", "threads",
             "smem_bytes")


def plan(lib, a):
    """The library's launch plan of one call, or None where it has no
    ``pt_paged_attention_plan`` (a tree before it)."""
    from paddle_tpu_torch.kernels import build
    try:
        fn = lib.pt_paged_attention_plan
    except AttributeError:
        return None
    fn.argtypes = [ctypes.POINTER(build.LayerArgs),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    build.check(fn(ctypes.byref(a), out), "pt_paged_attention_plan")
    return dict(zip(PLAN_KEYS, out))


def pattn_inputs(G, D, lengths, Ts, start, dt, gen, BS=16, NB=400, MB=128,
                 q8=False, Hkv=None):
    """(q, pool_k, pool_v, keyword arguments) of one case: pages of a
    permutation, unmapped (-1) entries past each row's pages; ``q8``: the
    pools' int8 export (``chip_smoke.q8_pool``)."""
    import torch
    Hkv = Hkv or (32 if G == 1 else 2)
    perm = torch.randperm(NB, generator=gen, device="cuda").to(torch.int32)
    pk, pv = (torch.randn(NB, BS, Hkv, D, device="cuda", generator=gen)
              .to(dt) for _ in range(2))
    if q8:
        pk, pv = cs.q8_pool(pk, dt), cs.q8_pool(pv, dt)
    if lengths is not None:
        bt = torch.full((len(lengths), MB), -1, dtype=torch.int32,
                        device="cuda")
        used = 0
        for b, n in enumerate(lengths):
            need = -(-(n + 1) // BS)
            bt[b, :need] = perm[used:used + need]
            used += need
        kw = dict(block_table=bt, lengths=torch.tensor(
            lengths, dtype=torch.int32, device="cuda"))
        rows = len(lengths)
    else:
        bt = torch.full((MB,), -1, dtype=torch.int32, device="cuda")
        need = -(-(start + Ts) // BS)
        bt[:need] = perm[:need]
        kw = dict(block_table=bt, start=start)
        rows = Ts
    q = torch.randn(rows, Hkv * G * D, device="cuda", generator=gen).to(dt)
    return q, pk, pv, kw


def check_variant(variant, gen):
    """Every case in bf16 and fp32; raises on the first miss.  Returns the
    largest |kernel - plain| of each kernel in bf16."""
    import torch
    from paddle_tpu_torch.ops import norms as tno
    from paddle_tpu_torch.ops.cuda import kernels as K
    from paddle_tpu_torch.ops.cuda import norms as cno
    worst = {}
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for label, G, D, lengths, Ts, start in PATTN_CASES:
            q8 = label.startswith("q8")
            q, pk, pv, kw = pattn_inputs(G, D, lengths, Ts, start, dt, gen,
                                         q8=q8)
            kern = "paged_attention_q8" if q8 else "paged_attention"
            got = cs.one_launch_bitwise(kern, lambda:
                                        K.paged_attention_cuda(q, pk, pv,
                                                               **kw))
            what = f"{variant} {kern} {label} {dtn}"
            plain = K.paged_attention_ref(q, pk, pv, **kw)
            e = (cs.check_close(what, got, plain, cs.TOL[dtn])
                 if dt == torch.float32 else cs.check_layer_out(
                     what, got, plain, K.paged_attention_ref(
                         q.float(), pk if q8 else pk.float(),
                         pv if q8 else pv.float(), **kw),
                     cs.TOL[dtn]))
            worst[f"{kern} {dtn}"] = max(worst.get(f"{kern} {dtn}", 0.0), e)
        for R, H in NORM_CASES:
            x = torch.randn(R, H, device="cuda", generator=gen).to(dt)
            res = torch.randn(R, H, device="cuda", generator=gen).to(dt)
            w, b, bias = ((1 + 0.1 * torch.randn(H, device="cuda",
                                                 generator=gen)).to(dt)
                          for _ in range(3))
            for name, fn, ref in (
                    ("rms_norm_fwd", lambda: cno.rms_norm_fwd_cuda(
                        x, w, 1e-5), lambda: tno.rms_norm_ref(x, w, 1e-5)),
                    ("layer_norm_fwd", lambda: cno.layer_norm_fwd_cuda(
                        x, w, b, 1e-5),
                     lambda: tno.layer_norm_ref(x, w, b, 1e-5)),
                    ("bias_residual_ln_fwd",
                     lambda: cno.bias_residual_ln_fwd_cuda(
                         x, res, bias.float(), w.float(), b.float(), 1e-5),
                     lambda: tno.bias_residual_ln_ref(
                         x, res, bias.float(), w.float(), b.float(), 1e-5))):
                got = cs.one_launch_bitwise(name, fn)
                for g, r in zip(got, ref()):
                    tol = cs.TOL["float32" if r.dtype == torch.float32
                                 else dtn]
                    e = cs.check_close(f"{variant} {name} [{R}, {H}] {dtn}",
                                       g, r, tol)
                    worst[f"{name} {dtn}"] = max(
                        worst.get(f"{name} {dtn}", 0.0), e)
    cs.info(f"{variant}: every case correct, bit-identical twice, one launch "
            f"each; max |kernel - plain| {worst}")
    return worst


def smoke_layer():
    """chip_smoke.py's kernels-phase layer inputs (llama_7b, bf16): decode
    at B 4, lengths 1000/37/0/517, and one prefill chunk per case."""
    import torch
    from paddle_tpu_torch.models.llama import _rope_cos_sin, llama_7b
    from paddle_tpu_torch.ops import decode_block as db
    cfg = llama_7b(dtype="bfloat16")
    spec = db.decode_block_spec(cfg, 16)
    BS, NB, MB = 16, 256, cfg.max_position_embeddings // 16
    Hkv, D, H = cfg.kv_heads, cfg.head_dim, cfg.hidden_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    perm = torch.randperm(NB, device="cuda", generator=gen).to(torch.int32)
    lp = cs.make_layer(cfg, gen, torch.bfloat16, "cuda")
    pk, pv = (torch.randn(NB, BS, Hkv, D, device="cuda", generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    cos_t, sin_t = _rope_cos_sin(cfg.max_position_embeddings, D,
                                 cfg.rope_theta, torch.float32, device="cuda")
    lengths = torch.tensor([1000, 37, 0, 517], dtype=torch.int32,
                           device="cuda")
    bt = torch.full((4, MB), -1, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lengths.tolist()):
        if b == 2:
            continue
        need = -(-(n + 1) // BS)
        bt[b, :need] = perm[used:used + need]
        used += need
    bt_row = torch.full((MB,), -1, dtype=torch.int32, device="cuda")
    bt_row[:38] = perm[used:used + 38]
    x = torch.randn(4, H, device="cuda", generator=gen).to(torch.bfloat16)
    cos = cos_t[lengths.long()].to(torch.bfloat16).contiguous()
    sin = sin_t[lengths.long()].to(torch.bfloat16).contiguous()
    return dict(cfg=cfg, spec=spec, lp=lp, pk=pk, pv=pv, bt=bt,
                bt_row=bt_row, lengths=lengths, x=x, cos=cos, sin=sin,
                cos_t=cos_t, sin_t=sin_t, gen=gen, NB=NB, BS=BS)


def q8_shapes(fam, Hn, D, gen):
    """The int8-pool shapes of :func:`shapes_to_time` at ``Hn`` heads (one
    q head a kv head) of ``D``: the decode case and the Ts 256 chunk after
    300, SDPA on K / V dequantized to bf16 and gathered beforehand; bytes
    a code and a 4-byte scale a (position, kv head) of K and of V."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops.cuda import kernels as K
    bf, dev, BS = torch.bfloat16, "cuda", 16
    sdpa = tF.scaled_dot_product_attention
    out = {}
    lengths = (1000, 37, 0, 517)
    for what, (lens, Ts, start) in (("decode", (lengths, 4, 0)),
                                    ("prefill Ts 256 start 300",
                                     (None, 256, 300))):
        q, pk, pv, kw = pattn_inputs(1, D, lens, Ts, start, bf, gen,
                                     q8=True, Hkv=Hn)
        if lens is not None:
            live = [n + 1 for n in lens]
            table, n = kw["block_table"], max(live)
            mask = (torch.arange(n, device=dev)[None] <= kw["lengths"].long()[
                :, None])[:, None, None]
            qs = q.reshape(len(lens), Hn, 1, D)
            pairs, rows = sum(live), len(lens)
        else:
            live = [start + Ts]
            table, n = kw["block_table"][None], start + Ts
            mask = (torch.arange(n, device=dev)[None]
                    <= start + torch.arange(Ts, device=dev)[:, None])
            qs = q.reshape(1, Ts, Hn, D).transpose(1, 2)
            pairs, rows = sum(start + r + 1 for r in range(Ts)), Ts
        idx = table.long().clamp(min=0)[:, :-(-n // BS)]
        kd, vd = (K._kv_rows(p, idx, bf).to(bf).flatten(1, 2)[:, :n]
                  .transpose(1, 2).contiguous() for p in (pk, pv))
        out[f"paged_attention_q8 {fam} {what}"] = (
            lambda q=q, pk=pk, pv=pv, kw=kw: K.paged_attention_cuda(
                q, pk, pv, **kw),
            lambda qs=qs, kd=kd, vd=vd, mask=mask: sdpa(qs, kd, vd,
                                                        attn_mask=mask),
            (sum(live) * 2 * Hn * (D + 4) + 2 * rows * Hn * D * 2,
             4 * Hn * D * pairs), "bfloat16", "launch")
    return out


def shapes_to_time(L):
    """{label: (kernel fn, library fn or None, (bytes, ops), dtype name,
    'launch' | 'layer')} of every timed shape."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops.cuda import kernels as K
    from paddle_tpu_torch.ops.cuda import norms as cno
    bf, gen, dev = torch.bfloat16, L["gen"], "cuda"
    cfg, BS = L["cfg"], L["BS"]
    Hq, Hkv, D, H = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_size
    kv_row = Hkv * D * 2 * 2
    sdpa = tF.scaled_dot_product_attention
    pk, pv = L["pk"], L["pv"]

    def gathered(table, n):
        idx = table.long().clamp(min=0)[:, :-(-n // BS)]
        return [p[idx].flatten(1, 2)[:, :n].transpose(1, 2).contiguous()
                for p in (pk, pv)]
    out = {}
    lengths = L["lengths"]
    live = [int(n) + 1 for n in lengths.tolist()]
    qd = torch.randn(4, Hq * D, device=dev, generator=gen).to(bf)
    kd, vd = gathered(L["bt"], max(live))
    dmask = (torch.arange(max(live), device=dev)[None]
             <= lengths.long()[:, None])[:, None, None]
    out["paged_attention decode"] = (
        lambda: K.paged_attention_cuda(qd, pk, pv, block_table=L["bt"],
                                       lengths=lengths),
        lambda: sdpa(qd.reshape(4, Hq, 1, D), kd, vd, attn_mask=dmask),
        (sum(live) * kv_row + 2 * 4 * Hq * D * 2, 4 * Hq * D * sum(live)),
        "bfloat16", "launch")
    for Ts, start in ((16, 37), (16, 300), (16, 1000), (64, 21),
                      (256, 300)):
        qp = torch.randn(Ts, Hq * D, device=dev, generator=gen).to(bf)
        kp, vp = gathered(L["bt_row"][None], start + Ts)
        pmask = (torch.arange(start + Ts, device=dev)[None]
                 <= start + torch.arange(Ts, device=dev)[:, None])
        out[f"paged_attention prefill Ts {Ts} start {start}"] = (
            lambda qp=qp, start=start: K.paged_attention_cuda(
                qp, pk, pv, block_table=L["bt_row"], start=start),
            lambda qp=qp, kp=kp, vp=vp, pmask=pmask, Ts=Ts: sdpa(
                qp.reshape(1, Ts, Hq, D).transpose(1, 2), kp, vp,
                attn_mask=pmask),
            ((start + Ts) * kv_row + 2 * Ts * Hq * D * 2,
             4 * Hq * D * sum(start + r + 1 for r in range(Ts))),
            "bfloat16", "launch")
    for fam, Hn, Dn in Q8_TIMED:
        out.update(q8_shapes(fam, Hn, Dn, gen))
    for name, R, Hn in (("rms_norm_fwd", 8192, 4096),
                        ("layer_norm_fwd", 8192, 768),
                        ("bias_residual_ln_fwd", 8192, 768)):
        gen.manual_seed(cs.SEED)
        inp = cs.norm_inputs(name, R, Hn, bf, gen, dev)
        out[f"{name} [{R}, {Hn}]"] = (
            lambda name=name, inp=inp: cs.norm_call(name, "kernel", inp),
            lambda name=name, inp=inp: cs.norm_call(name, "library", inp),
            cs.norm_bytes_ops(name, R, Hn, 2), "float32", "launch")
    wbytes, n_mm = cs.layer_bytes_ops(cfg, 2)
    spec, lp = L["spec"], L["lp"]
    out["decode_block"] = (
        lambda: db.decode_block(L["x"], lp, pk, pv, L["bt"], lengths,
                                L["cos"], L["sin"], spec=spec), None,
        (wbytes + sum(live) * kv_row + 3 * kv_row + 2 * 4 * H * 2
         + 2 * 4 * D * 2, 2 * 4 * n_mm + 4 * Hq * D * sum(live)),
        "bfloat16", "gemm_xw_small_m_tma")
    Ts, start, valid = 256, 300, 200
    xp = torch.randn(1, Ts, H, device=dev, generator=gen).to(bf)
    pos = start + torch.arange(Ts, device=dev)
    c, s = (t[pos].to(bf).contiguous() for t in (L["cos_t"], L["sin_t"]))
    blk = L["bt_row"].clamp(min=0)[pos // BS]
    blk[valid:] = L["NB"]
    blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
    out["prefill_block Ts 256"] = (
        lambda: db.prefill_block(xp, lp, pk, pv, blk, off, L["bt_row"], c, s,
                                 spec=spec, start=start), None,
        (wbytes + (start + Ts) * kv_row + valid * kv_row + 2 * Ts * H * 2
         + 2 * Ts * D * 2, 2 * Ts * n_mm + 4 * Hq * D * sum(
             start + i + 1 for i in range(Ts))),
        "bfloat16", "gemm_xw_tiled_wg")
    return out


def time_all(libs, order, report):
    """Device ms a call of each timed shape, the variants in ``order``;
    the library calls once a turn."""
    from paddle_tpu_torch.kernels import build
    L = smoke_layer()
    shapes = shapes_to_time(L)
    for key, (fn, lib_fn, (nbytes, ops), dtn, how) in shapes.items():
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
        bms, bby = cs.bound_ms(nbytes, ops, dtype=dtn)
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
    ap.add_argument("--only", default="")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--sass", action="store_true")
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
    for name, cuts in (TUNINGS.items() if args.tune else ()):
        d = trees[name] = build.BUILD_DIR / "ab" / f"src_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            text = (build.CSRC / f).read_text()
            (d / f).write_text(_edited(text, cuts)
                               if TUNED_FILE.get(name, FILES[0]) == f
                               else text)
    if args.only:
        keep = args.only.split(",")
        trees = {k: v for k, v in trees.items() if k in keep}
    report = {"card": card, "variants": {}, "library": {}, "sass": {}}
    if args.sass:
        out_dir = build.BUILD_DIR / "ab"
        out_dir.mkdir(parents=True, exist_ok=True)
        mine = sass_of(build.CSRC, "change", out_dir)
        for item in args.tree:
            name = item.partition("=")[0]
            other = sass_of(trees[name], name, out_dir)
            same = {k: other.get(k) == v for k, v in mine.items()}
            report["sass"][name] = same
            for k, v in same.items():
                how = "identical"
                if not v:
                    a_, b_ = mine[k].splitlines(), (other.get(k) or
                                                    "").splitlines()
                    i = next((i for i, (x, y) in enumerate(zip(a_, b_))
                              if x != y), min(len(a_), len(b_)))
                    how = (f"DIFFERS: {len(a_)} / {len(b_)} lines, first at "
                           f"{i}: {a_[i:i + 1]} / {b_[i:i + 1]}")
                cs.info(f"sass {name} vs change: {k}: {how}")
    libs = build_variants(trees)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for name, (lib, table) in libs.items():
        report["variants"][name] = {"ptxas": table}
        for k, v in table.items():
            cs.info(f"ptxas {name}: {k}: {v}")
    build._lib = libs["change"][0] if "change" in libs else None
    if build._lib is not None:
        from paddle_tpu_torch.ops.cuda import layer
        for label, G, D, lengths, Ts, start in PATTN_CASES:
            q, pk, pv, kw = pattn_inputs(G, D, lengths, Ts, start,
                                         torch.bfloat16, gen)
            a, _ = layer.layer_args(pk, pv, kw["block_table"],
                                    M=q.shape[0], q=q, attn=q,
                                    lengths=kw.get("lengths"),
                                    start=kw.get("start", 0))
            p = plan(build._lib, a)
            report.setdefault("plans", {})[label] = p
            cs.info(f"plan {label} bf16: {p}")
    for name, (lib, _) in list(libs.items()):
        build._lib = lib
        try:
            report["variants"][name]["max_abs_err"] = check_variant(name,
                                                                    gen)
        except (cs.SmokeFailure, RuntimeError, ValueError) as e:
            cs.info(f"{name}: FAILED its checks, not timed: {e}")
            report["variants"][name]["failed"] = str(e)
            del libs[name]
    if not args.no_time and libs:
        order = (list(libs) + list(reversed(libs))) * args.turns
        time_all(libs, order, report)
    out = ROOT / "chiprun_out" / "pattn_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
