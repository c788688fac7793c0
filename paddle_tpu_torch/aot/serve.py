"""Export and warm start of the continuous-batching engine's programs
(counterpart of ``paddle_tpu/aot/serve.py``).

One process exports once::

    eng = ContinuousBatchingEngine(cfg, params, prefill_buckets=(16, 64))
    aot.export_engine(eng, "artifacts/serve")

and every other process warm-starts::

    eng = ContinuousBatchingEngine(cfg, params, aot_dir="artifacts/serve")

The JAX export serializes compiled executables; a CUDA graph cannot be
serialized, so this one writes, per program the JAX export writes
(``decode``, ``chunk_fill_{c}`` per declared bucket, ``sampler``, and
for a speculating engine ``spec_draft`` and ``spec_verify``), a record
with its call signature and, on CUDA, a CRC-checked copy of the built
kernel library.  A warm CUDA engine loads that library (no ``nvcc``) and
captures its programs at construction, so nothing is built or captured
under traffic.  The manifest's config hash covers the model config, the
batch and pool geometry, the weight-tree signature, the quantization and
the spec geometry, and its environment the torch and CUDA versions, the
device and the kernel sources' digest: a mismatched engine falls back to
a fresh build and capture instead of running a wrong program.

The chunk fills stay eager launches on the card: the prefill kernels
take the chunk's ``start`` as a host int and plan by it (ROADMAP.md queue
1 item 16).  They keep their records all the same, so a manifest names
the programs the JAX package's names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .artifact import (ArtifactStore, AotManifestMismatchError,
                       args_signature, new_generation, resolve_artifact_dir)
from .buckets import DEFAULT_CHUNK_BUCKETS, ShapeBucketRegistry

__all__ = ["export_engine", "load_engine_artifacts", "engine_config",
           "warm_engine_factory", "check_captured", "DECODE", "SAMPLER",
           "SPEC_DRAFT", "SPEC_VERIFY"]

DECODE = "decode"
_FILL = "chunk_fill_{c}"
SAMPLER = "sampler"
SPEC_DRAFT = "spec_draft"
SPEC_VERIFY = "spec_verify"


def engine_config(engine) -> Dict[str, Any]:
    """Everything the engine's programs are specialised to: model config,
    batch and pool geometry, the weight-tree signature, the quantization,
    the fusion knobs, the prefix cache's key scheme and (when
    speculating) the draft and verify geometry — the JAX engine's keys."""
    from ..ops.paged_kv import is_quantized_pool
    params_td, params_leaves = args_signature((engine.params,))
    pool_k = engine.pool_k
    pool_dtype = (f"{pool_k.data.dtype}+{pool_k.scale.dtype}-scale"
                  if is_quantized_pool(pool_k) else str(pool_k.dtype))
    qc = engine.quant_config
    cfg = {
        "kind": "continuous_batching_engine",
        "model": dataclasses.asdict(engine.cfg),
        "max_batch": engine.B,
        "block_size": engine.BS,
        "max_blocks_per_seq": engine.MB,
        "num_blocks": engine.alloc.num_blocks,
        "pool_dtype": pool_dtype,
        "quant": qc.describe() if qc is not None else None,
        "decode_block_fused": engine.fused_decode_block,
        "prefill_block_fused": engine.fused_prefill,
        "prefix_scheme": type(engine.prefix_cache).SCHEME,
        "params_treedef": params_td,
        "params_leaves": params_leaves,
    }
    if engine.spec_config is not None:
        spec = dict(engine.spec_config.manifest())
        dtd, dleaves = args_signature((engine.spec_config.draft_params,))
        spec["draft_params_treedef"] = dtd
        spec["draft_params_leaves"] = dleaves
        cfg["spec"] = spec
    return cfg


def _program_args(engine, name: str) -> Tuple:
    """The exact call signature of one of the engine's captured programs:
    the weights and pools it reads, then its static inputs."""
    inputs = engine._program_table()[name][1]
    pre = (engine.spec_config.draft_params,) if name == SPEC_DRAFT else \
        () if name == SAMPLER else \
        (engine.params, engine.pool_k, engine.pool_v)
    return pre + tuple(inputs[k] for k in sorted(inputs))


def _fill_args(engine, size: int) -> Tuple:
    """The bucketed chunk-fill call signature the scheduler uses."""
    return (engine.params, engine.pool_k, engine.pool_v,
            torch.zeros((engine.MB,), dtype=torch.int32), 0,
            torch.zeros((size,), dtype=torch.int32), 1)


def _programs(engine, breg: ShapeBucketRegistry):
    """``[(name, call args, captured as a graph on CUDA)]``: the programs
    the JAX export writes."""
    out = [(DECODE, _program_args(engine, DECODE), True)]
    out += [(_FILL.format(c=c), _fill_args(engine, c), False)
            for c in breg.chunk_sizes]
    out.append((SAMPLER, _program_args(engine, SAMPLER), True))
    if engine.spec_config is not None:
        out += [(SPEC_DRAFT, _program_args(engine, SPEC_DRAFT), True),
                (SPEC_VERIFY, _program_args(engine, SPEC_VERIFY), True)]
    return out


def export_engine(engine, directory: str, *,
                  buckets: Optional[ShapeBucketRegistry] = None,
                  rotate: bool = False,
                  keep_last: Optional[int] = None) -> ArtifactStore:
    """Write the engine's program records (the decode step, one chunk fill
    per declared bucket, the fixed-width sampler and, when speculating,
    the draft and the verify) and, on CUDA, the kernel library's copy.  On
    CUDA the engine's graphs are captured first (if they are not yet), and
    each record keeps its program's launches a replay.

    With ``rotate=True``, ``directory`` is a rotation ROOT: the export
    lands in a fresh ``gen-NNNN`` subdirectory and is published through
    the atomic ``latest`` pointer once complete (``keep_last`` prunes
    older generations); loaders passing the root follow the pointer."""
    from ..kernels import build
    breg = buckets or engine._buckets or \
        ShapeBucketRegistry(DEFAULT_CHUNK_BUCKETS)
    if breg.max_batch is None:
        breg = ShapeBucketRegistry(breg.chunk_sizes, max_batch=engine.B)
    store = new_generation(directory) if rotate else \
        ArtifactStore(directory)
    store.begin(config=engine_config(engine), buckets=breg.to_manifest(),
                device=engine.device)
    cuda = engine.device.type == "cuda"
    if cuda:
        engine._capture_all()
    for name, args, graph in _programs(engine, breg):
        prog = engine._graphs.get(name) if cuda and graph else None
        store.put(name, {"graph": graph,
                         "launches": None if prog is None
                         else prog.launches}, args)
    if cuda:
        store.put_library(build.library_path(), build.source_digest())
    if rotate:
        store.publish(keep_last=keep_last)
    return store


def warm_engine_factory(cfg, params, *, aot_dir: str,
                        require_warm: bool = True, **engine_kwargs):
    """Zero-arg engine factory: every call constructs a
    ``ContinuousBatchingEngine`` warm-started from ``aot_dir``.  With
    ``require_warm`` (the default), a fallback to a fresh build raises
    instead of building under traffic."""
    def factory():
        from ..inference.serving import ContinuousBatchingEngine
        eng = ContinuousBatchingEngine(cfg, params, aot_dir=aot_dir,
                                       **engine_kwargs)
        if require_warm and not eng.aot_loaded:
            raise RuntimeError(
                f"warm engine factory fell back to a fresh build: "
                f"{eng.aot_error}")
        return eng

    return factory


def load_engine_artifacts(engine, directory: str):
    """Verify the serve artifacts for ``engine`` and, on CUDA, make the
    artifact's kernel library this process's library.

    Returns ``(records, ShapeBucketRegistry)``: ``records`` maps each
    program name of the export to its CRC-checked record.  Raises an
    :class:`~paddle_tpu_torch.aot.artifact.AotError` subclass on version
    or device skew, geometry mismatch, changed kernel sources or
    corruption — the engine falls back to a fresh build and capture.  An
    export without the sampler (or, for a speculating engine, the spec
    programs) is a manifest mismatch, not a half-warm start."""
    from ..kernels import build
    directory = resolve_artifact_dir(directory)
    store = ArtifactStore(directory)
    store.check_env(engine.device)
    store.check_config(engine_config(engine))
    bm = store.buckets()
    if not bm:
        raise AotManifestMismatchError(
            f"{directory}: manifest declares no serve buckets")
    breg = ShapeBucketRegistry.from_manifest(bm)
    if breg.max_batch is not None and breg.max_batch != engine.B:
        raise AotManifestMismatchError(
            f"{directory}: exported for max_batch={breg.max_batch}, "
            f"engine has {engine.B}")
    records = {}
    for name, args, _graph in _programs(engine, breg):
        if not store.matches_signature(name, args):
            raise AotManifestMismatchError(
                f"{directory}: {name} signature drifted from this "
                "engine's call shapes — re-export")
        records[name] = store.get(name)
    if engine.device.type == "cuda":
        build.load_library(*store.library())
    return records, breg


def check_captured(records, graphs) -> None:
    """A warm CUDA engine's captures against its export: each program
    launches, a replay, what the export's capture launched.  Raises
    :class:`AotManifestMismatchError` naming the program that differs
    (the export ran other code)."""
    for name, prog in graphs.items():
        want = records.get(name, {}).get("launches")
        if want is not None and want != prog.launches:
            raise AotManifestMismatchError(
                f"{name}: a replay launches {prog.launches}, the export "
                f"recorded {want} — re-export")
