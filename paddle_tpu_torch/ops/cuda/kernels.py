"""The layer chain's kernels one at a time, each beside its plain version.

``decode_block`` / ``prefill_block`` launch these kernels from one C
entry point; the wrappers here launch one kernel each so that it can be
checked and timed on its own (``chip_smoke.py``, the card's tests).  The
serving path does not call them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ...kernels import build
from ..decode_block import DecodeBlockSpec, make_mm, make_norm, rotate_half
from ..paged_kv import dequantize_kv, is_quantized_pool, quantize_kv
from . import layer

__all__ = ["rms_norm_rows_cuda", "rms_norm_rows_ref", "layer_norm_rows_cuda",
           "layer_norm_rows_ref", "gemm_xw_cuda", "gemm_xw_ref",
           "qkv_split_ref", "wo_layer_cuda", "wo_layer_ref",
           "rope_kv_write_cuda", "rope_kv_write_ref", "paged_attention_cuda",
           "paged_attention_ref", "paged_attention_split_ref"]


def _cuda(t, name):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernels need CUDA tensors")
    return t


# ---------------------------------------------------------------- rms norm
def rms_norm_rows_ref(x, w, eps: float):
    ms = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps).to(x.dtype)) * w


def rms_norm_rows_cuda(x, w, eps: float):
    """``x`` [M, H], ``w`` [H] -> [M, H]."""
    _cuda(x, "rms_norm_rows")
    M, H = x.shape
    layer.check_tensor(x, "x", (M, H), x.dtype, x.device)
    layer.check_tensor(w, "w", (H,), x.dtype, x.device)
    out = torch.empty_like(x)
    build.check(build.library().pt_rms_norm_rows(
        layer.dtype_code(x.dtype), M, H, x.data_ptr(), w.data_ptr(),
        out.data_ptr(), float(eps), layer.stream_handle()),
        "pt_rms_norm_rows")
    return out


# ---------------------------------------------------------- layer norm
def layer_norm_rows_ref(x, w, b, eps: float):
    """The GPT layer's LayerNorm (``make_norm`` "ln"): mean and variance in
    fp32, ``(x - mean) * rsqrt(var + eps)`` rounded to x's dtype, then
    ``* w + b`` in x's dtype."""
    spec = DecodeBlockSpec(hidden=x.shape[-1], num_heads=1, kv_heads=1,
                           head_dim=x.shape[-1], block_size=1, norm="ln",
                           eps=eps)
    return make_norm(spec)(x, w, b)


def layer_norm_rows_cuda(x, w, b, eps: float):
    """``x`` [M, H], ``w``/``b`` [H] -> [M, H]: one ``layer_norm_rows``
    launch."""
    _cuda(x, "layer_norm_rows")
    M, H = x.shape
    layer.check_tensor(x, "x", (M, H), x.dtype, x.device)
    layer.check_tensor(w, "w", (H,), x.dtype, x.device)
    layer.check_tensor(b, "b", (H,), x.dtype, x.device)
    out = torch.empty_like(x)
    build.check(build.library().pt_layer_norm_rows(
        layer.dtype_code(x.dtype), M, H, x.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), float(eps), layer.stream_handle()),
        "pt_layer_norm_rows")
    return out


# -------------------------------------------------------------------- gemm
def _epilogue_ref(y, residual, bias, gelu):
    """``y + bias`` when ``bias`` is given, then ``gelu(., tanh)`` when
    ``gelu``, then ``residual + .`` when ``residual`` is; each op rounded
    to y's dtype."""
    if bias is not None:
        y = y + bias
    if gelu:
        y = F.gelu(y, approximate="tanh")
    return y if residual is None else residual + y


def gemm_xw_ref(x, w, w2=None, residual=None, bias=None, gelu=False):
    """``x @ w`` with the chain's epilogues: ``silu(x @ w) * (x @ w2)``
    when ``w2`` is given; else ``+ bias`` when ``bias`` is given, then
    ``gelu(., tanh)`` when ``gelu``, then ``residual + .`` when
    ``residual`` is; each op rounded to x's dtype."""
    if w2 is not None:
        return F.silu(x @ w) * (x @ w2)
    return _epilogue_ref(x @ w, residual, bias, gelu)


def qkv_split_ref(qkv, head_dim: int):
    """The fused qkv product ``[M, 3 H D]`` split per head as ``[q | k |
    v]`` (``ops.decode_block._qkv``): ``(q, k, v)``, each ``[M, H D]``."""
    M = qkv.shape[0]
    parts = qkv.reshape(M, -1, 3 * head_dim).split(head_dim, dim=-1)
    return tuple(p.reshape(M, -1).contiguous() for p in parts)


def _gemm_epi(w2, residual, bias, gelu, op="gemm_xw") -> int:
    """The ``EPI_*`` of one ``op`` call's arguments."""
    if w2 is not None:
        if residual is not None or bias is not None or gelu:
            raise ValueError(f"{op}: the SwiGLU epilogue takes no "
                             "residual, bias or GELU")
        return build.EPI_SWIGLU
    if gelu and (bias is None or residual is not None):
        raise ValueError(f"{op}: GELU comes with a bias and no residual")
    if bias is None:
        return build.EPI_NONE if residual is None else build.EPI_RESID
    if gelu:
        return build.EPI_BIAS_GELU
    return build.EPI_BIAS if residual is None else build.EPI_BIAS_RESID


def gemm_xw_cuda(x, w, w2=None, residual=None, bias=None, gelu=False,
                 qkv_head_dim: Optional[int] = None):
    """``x`` [M, K], ``w``/``w2`` [K, N], ``residual`` [M, N], ``bias`` [N]
    -> [M, N], the epilogues of :func:`gemm_xw_ref`.  ``qkv_head_dim`` D:
    the product is a fused qkv and comes back split as
    :func:`qkv_split_ref` splits it, ``(q, k, v)`` each [M, N / 3] (three
    slabs of one buffer, stored by the kernel's epilogue)."""
    _cuda(x, "gemm_xw")
    epi = _gemm_epi(w2, residual, bias, gelu)
    M, K = x.shape
    N = w.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"gemm_xw: K ({K}) and N ({N}) must be multiples "
                         "of 8")
    D = qkv_head_dim or 0
    if D and (D % 2 or N % (3 * D) or epi == build.EPI_SWIGLU):
        raise ValueError(f"gemm_xw: the qkv split takes an even head_dim "
                         f"dividing N / 3 ({N} / 3, head_dim {D})")
    dt, dev = x.dtype, x.device
    layer.check_tensor(x, "x", (M, K), dt, dev)
    layer.check_tensor(w, "w", (K, N), dt, dev)
    for name, t, shape in (("w2", w2, (K, N)), ("residual", residual, (M, N)),
                           ("bias", bias, (N,))):
        if t is not None:
            layer.check_tensor(t, name, shape, dt, dev)
    out = torch.empty((3, M, N // 3) if D else (M, N), dtype=dt, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.check(build.library().pt_gemm_xw(
        layer.dtype_code(dt), M, K, N, epi, x.data_ptr(), w.data_ptr(),
        ptr(w2), ptr(residual), ptr(bias), out.data_ptr(), D,
        layer.stream_handle()), "pt_gemm_xw")
    return tuple(out) if D else out


# ------------------------------------------------- weight-only layer GEMM
def _wo_epi(residual, gate, bias, gelu):
    """``(EPI_*, its [M, N] operand)`` of one layer GEMM's epilogue: the
    Llama layer's (residual, or SwiGLU on the gate) or the GPT layer's
    (bias, with a residual or GELU), as :func:`_gemm_epi` picks them."""
    if gate is None:
        return _gemm_epi(None, residual, bias, gelu, "wo_layer"), residual
    if residual is not None or bias is not None or gelu:
        raise ValueError("wo_layer: the gate epilogue takes no residual, "
                         "bias or GELU")
    return build.EPI_SWIGLU_R, gate


def wo_layer_ref(x, codes, scale, *, width: str, group_size: int = -1,
                 residual=None, gate=None, bias=None, gelu=False):
    """Plain version of one weight-only layer GEMM: ``make_mm``'s
    arithmetic (y in fp32 times the fp32 codes, then the per-channel scale;
    grouped scales dequantize the fp32 weight first; rounded to x's dtype),
    then in x's dtype ``silu(gate) * y``, or ``y + bias``, then
    ``gelu(., tanh)`` when ``gelu``, then ``residual + .`` (the epilogues
    of :func:`gemm_xw_ref`).  The qkv product comes back unsplit:
    :func:`qkv_split_ref` splits it."""
    K = x.shape[-1]
    spec = DecodeBlockSpec(hidden=K, num_heads=1, kv_heads=1, head_dim=K,
                           block_size=1, weight_dtype=width,
                           group_size=group_size)
    epi, r = _wo_epi(residual, gate, bias, gelu)
    y = make_mm(spec)({"w__q": codes, "w__s": scale}, "w", x)
    if epi == build.EPI_SWIGLU_R:
        return F.silu(r) * y
    return _epilogue_ref(y, residual, bias, gelu)


def wo_layer_cuda(x, codes, scale, *, width: str, group_size: int = -1,
                  residual=None, gate=None, bias=None, gelu=False,
                  qkv_head_dim: Optional[int] = None):
    """``x`` [M, K] CUDA tensor, ``codes`` int8 [K, N] (int4: [K/2, N]),
    ``scale`` fp32 [N] or [ceil(K / group_size), N]; ``residual`` or
    ``gate`` [M, N] and ``bias`` [N] in x's dtype -> [M, N]: one
    ``wo_layer_*`` launch with the epilogue of :func:`wo_layer_ref`.
    ``qkv_head_dim`` D (no residual, gate or GELU): the product is a fused
    qkv and comes back split as :func:`qkv_split_ref` splits it, ``(q, k,
    v)`` each [M, N / 3] (three slabs of one buffer, stored by the
    kernel's epilogue)."""
    _cuda(x, "wo_layer")
    M, K = x.shape
    N = codes.shape[1]
    dt, dev = x.dtype, x.device
    cshape, sshape, gs = layer.wo_layout(K, N, width, group_size)
    layer.check_tensor(x, "x", (M, K), dt, dev)
    layer.check_tensor(codes, "codes", cshape, torch.int8, dev)
    layer.check_tensor(scale, "scale", sshape, torch.float32, dev)
    epi, R = _wo_epi(residual, gate, bias, gelu)
    if R is not None:
        layer.check_tensor(R, "residual" if gate is None else "gate",
                           (M, N), dt, dev)
    if bias is not None:
        layer.check_tensor(bias, "bias", (N,), dt, dev)
    D = qkv_head_dim or 0
    if D and (D % 2 or N % (3 * D) or epi not in (build.EPI_NONE,
                                                   build.EPI_BIAS)):
        raise ValueError(f"wo_layer: the qkv split takes an even head_dim "
                         f"dividing N / 3 ({N} / 3, head_dim {D}) and no "
                         "residual, gate or GELU")
    y = torch.empty((3, M, N // 3) if D else (M, N), dtype=dt, device=dev)
    half = K // 2 if width == "int4" else 0
    a = build.WoArgs(int4=int(width == "int4"), x_dtype=layer.dtype_code(dt),
                     M=M, K=K, N=N, half=half, ldx=K, xhi=half, gs=gs,
                     G=sshape[0] if len(sshape) == 2 else 1, tile_dq=0,
                     epi=epi, qkv_d=D, x=x.data_ptr(), w=codes.data_ptr(),
                     scale=scale.data_ptr(), y=y.data_ptr(),
                     R=None if R is None else R.data_ptr(),
                     B=None if bias is None else bias.data_ptr())
    build.check(build.library().pt_wo_layer(ctypes.byref(a),
                                            layer.stream_handle()),
                "pt_wo_layer")
    return tuple(y) if D else y


# --------------------------------------------------------- rope + kv write
def _targets(block_table, lengths, blk, off, BS, NB):
    """Per-row (page, offset) write targets and whether each row writes."""
    if lengths is not None:
        MB = block_table.shape[1]
        pos = lengths.long()
        pi = pos // BS
        page = torch.gather(block_table.long(), 1,
                            pi.clamp(max=MB - 1)[:, None])[:, 0]
        page = torch.where(pi < MB, page, torch.full_like(page, -1))
        o = pos % BS
    else:
        page, o = blk.long(), off.long()
    return page, o, (page >= 0) & (page < NB)


def rope_kv_write_ref(q, k, v, cos, sin, pool_k, pool_v, *, head_dim,
                      block_table, lengths=None, blk=None, off=None):
    """Plain version: returns roped ``(q, k)`` and writes roped k and v
    into the pools in place (dropped where the page is unmapped or out of
    the pool); an int8 ``QuantizedKVPool`` takes the rows' ``quantize_kv``
    codes and scales.  ``cos`` / ``sin`` None (a layer without RoPE): q
    and k as they are, k and v written unrotated."""
    M, D = q.shape[0], head_dim

    def rope(t):
        t = t.reshape(M, -1, D)
        return (t * cos[:, None] + rotate_half(t) * sin[:, None]).reshape(M, -1)
    if cos is not None:
        q, k = rope(q), rope(k)
    quant = is_quantized_pool(pool_k)
    NB, BS = (pool_k.data if quant else pool_k).shape[:2]
    page, o, keep = _targets(block_table, lengths, blk, off, BS, NB)
    n = int(keep.sum())
    for pool, rows in ((pool_k, k), (pool_v, v)):
        rows = rows[keep].reshape(n, -1, D)
        if quant:
            codes, scale = quantize_kv(rows)
            pool.data[page[keep], o[keep]] = codes
            pool.scale[page[keep], o[keep]] = scale
        else:
            pool[page[keep], o[keep]] = rows
    return q, k


def rope_kv_write_cuda(q, k, v, cos, sin, pool_k, pool_v, *, block_table,
                       lengths=None, blk=None, off=None):
    """``q`` [M, Hq*D], ``k``/``v`` [M, Hkv*D]: ropes q and k IN PLACE and
    writes k/v rows into the pools; returns ``(q, k)``.  ``cos`` / ``sin``
    None: no rotation (q and k untouched), k and v written as they are."""
    _cuda(q, "rope_kv_write")
    if (lengths is None) == (blk is None):
        raise ValueError("rope_kv_write: pass lengths (decode) or blk/off "
                         "(prefill)")
    a, _ = layer.layer_args(pool_k, pool_v, block_table, M=q.shape[0],
                            lengths=lengths, blk=blk, off=off, cos=cos,
                            sin=sin, q=q, k=k, v=v)
    build.check(build.library().pt_rope_kv_write(ctypes.byref(a),
                                                  layer.stream_handle()),
                "pt_rope_kv_write")
    return q, k


# --------------------------------------------------------- paged attention
def _kv_rows(pool, idx, prefill_dtype):
    """``pool[idx]`` in fp32: an int8 pool's codes x scales in fp32, rounded
    to ``prefill_dtype`` first when one is given (a prefill chunk: the
    reference dequantizes the gathered pages to the model dtype)."""
    if not is_quantized_pool(pool):
        return pool[idx].float()
    return dequantize_kv(pool.data[idx], pool.scale[idx],
                         prefill_dtype or torch.float32).float()


def paged_attention_ref(q, pool_k, pool_v, *, block_table, lengths=None,
                        start: int = 0, scale: Optional[float] = None):
    """Plain version in fp32: row r attends positions 0..p_r of its
    sequence (``p_r = lengths[r]`` with a [M, MB] table, else
    ``start + r`` over one table row); ``-1`` entries read page 0.  An
    int8 pool is dequantized to fp32 at decode and to q's dtype at
    prefill, as the layer's plain versions do."""
    M = q.shape[0]
    NB, BS, Hkv, D = (pool_k.data if is_quantized_pool(pool_k)
                      else pool_k).shape
    Hq = q.shape[1] // D
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = block_table.long().clamp(min=0)
    if lengths is None:
        bt = bt[None].expand(M, -1)
        pos = start + torch.arange(M, device=q.device)
    else:
        pos = lengths.long()
    MB = bt.shape[1]
    pre = q.dtype if lengths is None else None
    kk = _kv_rows(pool_k, bt, pre).reshape(M, MB * BS, Hkv, D)
    vv = _kv_rows(pool_v, bt, pre).reshape(M, MB * BS, Hkv, D)
    qg = q.reshape(M, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("mkgd,mtkd->mkgt", qg, kk) * s
    live = torch.arange(MB * BS, device=q.device)[None] <= pos[:, None]
    logits = logits.masked_fill(~live[:, None, None, :], -1e30)
    out = torch.einsum("mkgt,mtkd->mkgd", torch.softmax(logits, -1), vv)
    return out.reshape(M, Hq * D).to(q.dtype)


def paged_attention_split_ref(q, pool_k, pool_v, *, block_table,
                              lengths=None, start: int = 0,
                              scale: Optional[float] = None, splits: int = 8):
    """Plain version of the card kernel's split and fold, in fp32: row r's
    live pages (positions ``0..p_r`` as :func:`paged_attention_ref`) cut
    into ``splits`` contiguous ranges of ``ceil(pages / splits)`` whole
    pages (a range past the row's end is empty), each range's softmax state
    ``(m, l, acc)`` taken alone, then the ranges folded in rank order,
    each rescaled to the largest ``m``.  Equal to
    :func:`paged_attention_ref` up to the order of fp32 sums."""
    M = q.shape[0]
    NB, BS, Hkv, D = pool_k.shape
    Hq = q.shape[1] // D
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = block_table.long().clamp(min=0)
    if lengths is None:
        bt = bt[None].expand(M, -1)
        pos = start + torch.arange(M, device=q.device)
    else:
        pos = lengths.long()
    MB = bt.shape[1]
    n = (pos.clamp(min=0) + 1).clamp(max=MB * BS).tolist()
    out = []
    for r in range(M):
        kk = pool_k[bt[r]].reshape(MB * BS, Hkv, D).float()
        vv = pool_v[bt[r]].reshape(MB * BS, Hkv, D).float()
        qg = q[r].reshape(Hkv, Hq // Hkv, D).float()
        pages = -(-n[r] // BS)
        per = -(-pages // splits)
        parts = []
        for k in range(splits):
            lo = min(k * per, pages) * BS
            hi = min(lo + per * BS, n[r])
            if hi <= lo:
                continue
            logits = torch.einsum("kgd,tkd->kgt", qg, kk[lo:hi]) * s
            m = logits.amax(-1, keepdim=True)
            p = torch.exp(logits - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgt,tkd->kgd", p, vv[lo:hi])))
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        num = sum(acc * torch.exp(m - mx) for m, _, acc in parts)
        den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        out.append((num / den).reshape(Hq * D))
    return torch.stack(out).to(q.dtype)


def paged_attention_cuda(q, pool_k, pool_v, *, block_table, lengths=None,
                         start: int = 0, scale: Optional[float] = None):
    """``q`` [M, Hq*D] (already roped) -> attention output [M, Hq*D]; the
    pools full-width or int8 ``QuantizedKVPool``s."""
    _cuda(q, "paged_attention")
    D = (pool_k.data if is_quantized_pool(pool_k) else pool_k).shape[3]
    attn = torch.empty_like(q)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    a, _ = layer.layer_args(pool_k, pool_v, block_table, M=q.shape[0],
                            lengths=lengths, start=start, scale=s, q=q,
                            attn=attn)
    build.check(build.library().pt_paged_attention(ctypes.byref(a),
                                                   layer.stream_handle()),
                "pt_paged_attention")
    return attn
