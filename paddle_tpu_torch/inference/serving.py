"""Continuous-batching serving engine over the paged KV pool
(counterpart of ``paddle_tpu/inference/serving.py``, restricted to
greedy Llama serving with declared-bucket prefill).

Iteration-level scheduling: ONE decode step advances every active
sequence in a fixed-size batch; between steps the host scheduler admits
queued requests into free slots, maps pages from the shared pool and
retires finished sequences.  Prompts run through declared-bucket chunk
fills (``prefill_block`` per layer), tokens come out of the batched
paged decode step (``decode_block`` per layer); on the card both ops
launch the hand-written CUDA kernels.

Differences from the JAX engine, by design:

* ``jax.lax.scan`` over layers is a Python loop;
* the pools are one ``[L, NB, BS, Hkv, D]`` tensor per K and V, updated
  IN PLACE layer by layer (the JAX engine donates and replaces them);
* quantized serving (``quant_config=ServeQuantConfig(...)``): int8 / int4
  weight-only layer matmuls and / or an int8 paged-KV pool; a full-width
  tree is PTQ-exported at construction, on the parameters' device;
* features outside this slice raise ``NotImplementedError`` naming the
  ROADMAP item: sampling, dense (unbucketed) prefill, prefix caching,
  preemption and spill, speculative decoding, AOT artifacts and MoE —
  quantized or not;
* GPT-family configs raise as well: the JAX engine serves Llama configs
  only, and a GPT layer reaches the serving kernels through the ops
  (``ops.decode_block``).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..aot.buckets import DEFAULT_CHUNK_BUCKETS, ShapeBucketRegistry
from ..device import resolve_device
from ..models.llama import _rope_cos_sin, block_shapes, torch_dtype
from ..ops.decode_block import (decode_block, decode_block_spec, make_norm,
                                prefill_block)
from ..ops.paged_kv import layer_pool, zeros_kv_pool
from ..quantization.serve import (ServeQuantConfig,
                                  quantize_params_for_serving,
                                  quantized_leaf_names)

__all__ = ["ContinuousBatchingEngine", "GenRequest"]

_LATER = "not ported yet — ROADMAP.md queue 1"


class _RefPool:
    """Refcounted page pool (free list + per-page reference counts)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self.ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def acquire(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def release(self, phys: List[int]) -> None:
        for p in phys:
            r = self.ref.get(p, 0)
            if r <= 0:
                raise RuntimeError(
                    f"KV-pool accounting bug: release() of block {p} "
                    "with no live reference (double free)")
            if r == 1:
                del self.ref[p]
                self._free.append(p)
            else:
                self.ref[p] = r - 1


@dataclass
class GenRequest:
    req_id: int
    prompt: np.ndarray                 # [T0] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    out: List[int] = field(default_factory=list)
    # index of the first EOS in ``out``
    eos_pos: Optional[int] = None


class ContinuousBatchingEngine:
    """Greedy Llama continuous-batching engine.

    Args:
      cfg: ``models.llama.LlamaConfig`` (dense; ``cfg.dtype`` float32 or
        bfloat16).
      params: ``{"wte", "head", "lnf_w", "blocks": {name: [L, ...]}}`` —
        ``models.llama.init_params`` or ``bridge.params_from_numpy``.
      max_batch: decode-batch slots.
      block_size / num_blocks: shared KV page pool geometry.
      max_blocks_per_seq: page-table width per slot (default
        ``ceil(max_position_embeddings / block_size)``).
      prefill_buckets: declared prefill chunk lengths; every prompt is
        decomposed into these fixed-size chunk fills (last chunk padded).
      quant_config: a :class:`~paddle_tpu_torch.quantization.
        ServeQuantConfig`, or None.  Weight quantization takes an exported
        tree (``<name>__q`` / ``<name>__s`` leaves, from
        ``quantize_params_for_serving``) as it is, and PTQ-exports a
        full-width one here; ``kv_dtype="int8"`` builds int8 pools with
        per-(token, head) fp32 scales.
      device: ``None`` = CUDA (raises without it); ``"cpu"`` runs the
        plain PyTorch versions of the ops.
    """

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 block_size: int = 16, num_blocks: int = 256,
                 max_blocks_per_seq: Optional[int] = None,
                 prefill_buckets=DEFAULT_CHUNK_BUCKETS,
                 enable_prefix_caching: bool = False,
                 enable_preemption: bool = False, spill_tier=None,
                 prefix_cache_config=None, spec_config=None,
                 quant_config=None, aot_dir: Optional[str] = None,
                 device=None):
        if quant_config is not None and \
                not isinstance(quant_config, ServeQuantConfig):
            raise TypeError(f"quant_config must be a ServeQuantConfig or "
                            f"None, got {type(quant_config).__name__}")
        refused = {"enable_prefix_caching": enable_prefix_caching,
                   "enable_preemption": enable_preemption,
                   "spill_tier": spill_tier,
                   "prefix_cache_config": prefix_cache_config,
                   "spec_config": spec_config, "aot_dir": aot_dir}
        for name, val in refused.items():
            if val not in (None, False):
                raise NotImplementedError(f"{name}: {_LATER}")
        if prefill_buckets is None:
            raise NotImplementedError(
                f"prefill_buckets=None (dense cold prefill): {_LATER}")
        qw = quant_config is not None and quant_config.quantized_weights
        if qw and getattr(cfg, "moe_num_experts", 0):
            raise NotImplementedError(
                "weight-quantized serving covers dense FFNs only — the "
                "MoE expert matmuls keep full-width weights (ROADMAP)")
        if getattr(cfg, "moe_num_experts", 0):
            raise NotImplementedError(f"MoE configs: {_LATER}")
        if not hasattr(cfg, "rms_norm_eps"):
            raise NotImplementedError(
                "GPT-family configs: the JAX engine serves Llama configs only "
                "(it reads cfg.kv_heads, cfg.rope_theta and params['head']); "
                "a GPT layer reaches the serving kernels through the ops, "
                "ops.decode_block.decode_block / prefill_block with "
                "decode_block_spec(gpt_cfg, block_size)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.quant_config = quant_config
        self._wq = quant_config.weight_dtype if qw else None
        self._gs = quant_config.group_size if qw else -1
        kv_quant = quant_config is not None and quant_config.quantized_kv
        if qw and not any(k.endswith("__q") for k in params["blocks"]):
            # a full-width tree handed to a weight-quantized engine: the
            # PTQ export (absmax scales) on the parameters' device
            params = quantize_params_for_serving(params, quant_config)
        self.params = self._check_params(params)
        self.B = max_batch
        self.BS = block_size
        self.MB = max_blocks_per_seq or \
            -(-cfg.max_position_embeddings // block_size)
        self.NB = num_blocks
        L, kvh, hd = cfg.num_layers, cfg.kv_heads, cfg.head_dim
        self.pool_k = zeros_kv_pool((L, num_blocks, block_size, kvh, hd),
                                    self.dtype, self.device,
                                    kv_quant=kv_quant)
        self.pool_v = zeros_kv_pool((L, num_blocks, block_size, kvh, hd),
                                    self.dtype, self.device,
                                    kv_quant=kv_quant)
        self.block_table = np.full((max_batch, self.MB), -1, np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.tokens = np.zeros((max_batch,), np.int32)
        self.alloc = _RefPool(num_blocks)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.slots: List[Optional[GenRequest]] = [None] * max_batch
        self.queue: "collections.deque[GenRequest]" = collections.deque()
        self.finished: Dict[int, np.ndarray] = {}
        self._next_id = 0
        self._buckets = ShapeBucketRegistry(prefill_buckets,
                                            max_batch=max_batch)
        self.spec = decode_block_spec(cfg, block_size, self._wq, self._gs)
        self._norm = make_norm(self.spec)
        self._cos, self._sin = _rope_cos_sin(
            cfg.max_position_embeddings, hd, cfg.rope_theta, self.dtype,
            getattr(cfg, "rope_scaling", None), device=self.device)
        # the LM head runs outside any kernel, with fp32 logits as the JAX
        # engine's preferred_element_type=float32 einsum gives them
        self._head32 = self.params["head"].float()
        self._layers = [{k: self.params["blocks"][k][i]
                         for k in self._leaf_shapes()} for i in range(L)]
        self.decode_tokens = 0
        self.last_logits: Optional[np.ndarray] = None        # [B, V]
        self.last_prefill_logits: Optional[np.ndarray] = None   # [V]

    def _leaf_shapes(self):
        """{block leaf: (per-layer shape, dtype)}: the block weights, or
        under weight quantization each matmul's codes and scales."""
        out = {}
        for k, shape in block_shapes(self.cfg).items():
            if self._wq is None or k.startswith("ln"):
                out[k] = (shape, self.dtype)
                continue
            K, N = shape
            qn, sn = quantized_leaf_names(k)
            out[qn] = ((-(-K // 2) if self._wq == "int4" else K, N),
                       torch.int8)
            out[sn] = (((N,) if self._gs == -1 else (-(-K // self._gs), N)),
                       torch.float32)
        return out

    def _check_params(self, params):
        cfg = self.cfg
        want = {"wte": ((cfg.vocab_size, cfg.hidden_size), self.dtype),
                "head": ((cfg.hidden_size, cfg.vocab_size), self.dtype),
                "lnf_w": ((cfg.hidden_size,), self.dtype)}
        want.update({f"blocks.{k}": ((cfg.num_layers,) + s, dt)
                     for k, (s, dt) in self._leaf_shapes().items()})
        for key, (shape, dt) in want.items():
            if key.startswith("blocks."):
                if key[7:] not in params["blocks"]:
                    raise ValueError(
                        f"params[{key}] is missing (a weight-quantized "
                        "engine takes a full-width tree or the export of "
                        "quantize_params_for_serving under the same "
                        "config)")
                t = params["blocks"][key[7:]]
            else:
                t = params[key]
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"params[{key}] has shape {tuple(t.shape)}, expected "
                    f"{shape} (a JAX tree with [S, per, ...] blocks goes "
                    "through bridge.params_from_numpy)")
            if t.dtype != dt or t.device != self.device:
                raise ValueError(
                    f"params[{key}] is {t.dtype} on {t.device}, the engine "
                    f"serves {dt} on {self.device}")
        return params

    # ------------------------------------------------------------------
    # device programs: one decode step, one bucketed chunk fill
    # ------------------------------------------------------------------
    def _logits(self, x):
        xf = self._norm(x, self.params["lnf_w"])
        return xf.float() @ self._head32

    def _decode_step(self) -> torch.Tensor:
        dev = self.device
        tokens = torch.from_numpy(self.tokens).to(dev, torch.long)
        lengths = torch.from_numpy(self.lengths).to(dev)
        bt = torch.from_numpy(self.block_table).to(dev)
        x = self.params["wte"][tokens]                        # [B, H]
        pos = lengths.long()
        cos, sin = self._cos[pos].contiguous(), self._sin[pos].contiguous()
        for i, lp in enumerate(self._layers):
            x, _, _ = decode_block(x, lp, layer_pool(self.pool_k, i),
                                   layer_pool(self.pool_v, i), bt, lengths,
                                   cos, sin, spec=self.spec)
        return self._logits(x)

    def _chunk_fill(self, bt_row: torch.Tensor, start: int,
                    toks: np.ndarray, valid: int) -> torch.Tensor:
        """One declared-bucket chunk: ``len(toks)`` rows at positions
        ``start + i``, the first ``valid`` real.  Padded rows write their
        KV to page ``NB`` (dropped), so stale pages stay intact; the
        logits come from row ``valid - 1``."""
        dev, Ts = self.device, len(toks)
        pos = start + torch.arange(Ts, device=dev)
        # padded rows may run past the tables; they are never read
        posc = pos.clamp(max=self.cfg.max_position_embeddings - 1)
        x = self.params["wte"][torch.from_numpy(toks).to(dev, torch.long)]
        x = x[None]                                          # [1, Ts, H]
        cos, sin = self._cos[posc].contiguous(), self._sin[posc].contiguous()
        page = (pos // self.BS).clamp(max=self.MB - 1)
        blk = bt_row.clamp(min=0)[page]
        blk = torch.where(torch.arange(Ts, device=dev) < valid, blk,
                          torch.full_like(blk, self.NB)).to(torch.int32)
        off = (pos % self.BS).to(torch.int32)
        for i, lp in enumerate(self._layers):
            x, _, _ = prefill_block(x, lp, layer_pool(self.pool_k, i),
                                    layer_pool(self.pool_v, i), blk, off,
                                    bt_row, cos, sin, spec=self.spec,
                                    start=start)
        return self._logits(x[:, valid - 1])

    def _fill_prompt_bucketed(self, slot: int, req: GenRequest,
                              start: int = 0) -> torch.Tensor:
        """Run the prompt through declared-bucket chunk fills; returns the
        logits at the prompt's final token (the last chunk's
        ``valid - 1`` row) as ``[1, V]``."""
        suffix = req.prompt[start:]
        bt_row = torch.from_numpy(self.block_table[slot]).to(self.device)
        pos, off = start, 0
        logits = None
        for size, valid in self._buckets.plan_chunks(len(suffix)):
            toks = np.zeros((size,), np.int32)
            toks[:valid] = suffix[off:off + valid]
            logits = self._chunk_fill(bt_row, pos, toks, valid)
            pos += valid
            off += valid
        return logits

    # ------------------------------------------------------------------
    # host-side scheduler
    # ------------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int,
                    eos_token_id: Optional[int] = None, *,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, seed: int = 0,
                    priority: int = 0) -> int:
        if (temperature or 0.0) > 0.0 or top_k or top_p:
            raise NotImplementedError(
                "sampled decoding (temperature/top_k/top_p): the JAX "
                f"sampler is threefry-keyed; {_LATER}")
        if priority:
            raise NotImplementedError(f"priority classes: {_LATER}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "argmax is already one generated token)")
        total = len(prompt) + max_new_tokens
        if total > self.MB * self.BS:
            raise ValueError(f"request needs {total} tokens, engine caps "
                             f"at {self.MB * self.BS} per sequence")
        if self._blocks_needed(total) > self.alloc.num_blocks:
            raise ValueError(
                f"request needs {self._blocks_needed(total)} pages, the "
                f"whole pool has {self.alloc.num_blocks}")
        if total > self.cfg.max_position_embeddings:
            raise ValueError("request exceeds max_position_embeddings")
        req = GenRequest(self._next_id, prompt, max_new_tokens,
                         eos_token_id)
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def _blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.BS)

    def _admit(self) -> None:
        """Admit waiting requests FIFO into free slots while pages allow;
        each admission prefills its prompt through the bucketed fills."""
        for slot in range(self.B):
            if self.slots[slot] is not None:
                continue
            if not self.queue:
                break
            req = self.queue[0]
            T0 = len(req.prompt)
            need = self._blocks_needed(T0 + req.max_new_tokens)
            table = self.alloc.acquire(need)
            if table is None:
                break                      # head-of-line waits for pages
            self.queue.popleft()
            self.block_table[slot, :] = -1
            self.block_table[slot, :need] = table
            self.slot_pages[slot] = table
            try:
                logits = self._fill_prompt_bucketed(slot, req)
                row = logits[0].cpu().numpy()
            except BaseException:
                # the slot never went live: release its pages exactly
                # once and keep the request waiting
                self.alloc.release(table)
                self.slot_pages[slot] = []
                self.block_table[slot, :] = -1
                self.queue.appendleft(req)
                raise
            self.last_prefill_logits = row
            self._append_tok(req, int(row.argmax()))
            self.slots[slot] = req
            self.lengths[slot] = T0
            self.tokens[slot] = req.out[-1]

    @staticmethod
    def _append_tok(req: GenRequest, tok: int) -> None:
        req.out.append(tok)
        if req.eos_token_id is not None and req.eos_pos is None \
                and tok == req.eos_token_id:
            req.eos_pos = len(req.out) - 1

    def _retire_done(self) -> None:
        for s in range(self.B):
            req = self.slots[s]
            if req is not None and (len(req.out) >= req.max_new_tokens
                                    or req.eos_pos is not None):
                if req.eos_pos is not None:
                    req.out = req.out[:req.eos_pos + 1]
                self._retire(s)

    def _free_slot(self, slot: int) -> None:
        self.alloc.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.block_table[slot, :] = -1
        self.lengths[slot] = 0
        self.tokens[slot] = 0
        self.slots[slot] = None

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        self.finished[req.req_id] = np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])
        self._free_slot(slot)

    def cancel(self, req_id: int) -> bool:
        """Abort a queued or in-flight request; its pages free at once and
        no result is reported.  False when the id is unknown or already
        finished."""
        for i, req in enumerate(self.queue):
            if req.req_id == req_id:
                del self.queue[i]
                return True
        for slot in range(self.B):
            req = self.slots[slot]
            if req is not None and req.req_id == req_id:
                self._free_slot(slot)
                return True
        return False

    def step(self) -> Dict[int, np.ndarray]:
        """One scheduler iteration: retire, admit, retire again, decode
        every active slot greedily.  Returns newly finished
        {req_id: prompt + generated ids}."""
        self._retire_done()
        self._admit()
        self._retire_done()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            self.last_logits = None
            out, self.finished = self.finished, {}
            return out
        logits = self._decode_step()
        self.last_logits = logits.cpu().numpy()
        for s in active:
            self.lengths[s] += 1            # the fed token's KV is stored
            tok = int(self.last_logits[s].argmax())
            self._append_tok(self.slots[s], tok)
            self.tokens[s] = tok
        self.decode_tokens += len(active)
        out, self.finished = self.finished, {}
        return out

    def run_to_completion(self) -> Dict[int, np.ndarray]:
        """Drive steps until queue and batch drain; returns all results."""
        results: Dict[int, np.ndarray] = {}
        while self.queue or self.finished \
                or any(s is not None for s in self.slots):
            results.update(self.step())
        return results

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active_requests(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def kv_leak_report(self) -> Dict[str, int]:
        """Cross-check the refcount pool against the slot tables:
        ``leaked`` and ``unaccounted`` must be zero after any drain."""
        held: Dict[int, int] = {}
        for pages in self.slot_pages:
            for p in pages:
                held[p] = held.get(p, 0) + 1
        leaked = sum(1 for p, r in self.alloc.ref.items()
                     if held.get(p, 0) != r)
        leaked += sum(1 for p in held if p not in self.alloc.ref)
        return {
            "free_blocks": self.alloc.free_blocks,
            "index_blocks": 0,
            "slot_blocks": sum(len(p) for p in self.slot_pages),
            "leaked": leaked,
            "unaccounted": (self.alloc.num_blocks - self.alloc.free_blocks
                            - len(self.alloc.ref)),
        }

    def bucket_stats(self) -> Dict[str, int]:
        return self._buckets.stats()
