"""The port's AOT serve half (``paddle_tpu_torch/aot/``, the engine's
``aot_dir``) against the JAX package on ``llama_tiny``, mirroring the
serve cases of ``tests/test_aot.py`` at its geometry: ``max_batch=2``,
``block_size=8``, ``num_blocks=64``, buckets ``(8,)``, prompts of 5, 9
and 17 tokens, 4 new tokens each, the engine defaults otherwise.

Pinned here: a port engine warm-started from ``export_engine``'s
directory (``aot_loaded`` True) gives the fresh JAX engine's greedy ids
in fp32 and bf16, with buckets and under ``spec_config`` (a self-draft:
speculation keeps the baseline's ids); the fixed-width sampler draws the
JAX engine's ids for sub-batches of 1 to ``max_batch`` rows, in a warm
engine's traffic too; every way an artifact cannot be used (another
config, another ``max_batch``, version skew, another magic, a CRC
failure, no manifest, bit-rot under a rotation root, a dangling pointer)
falls back with its typed error's message on ``aot_error`` and serves the
same ids; rotation roots publish, resolve and gc as JAX's do, a crash
while publishing keeps the previous generation live;
``warm_engine_factory`` raises on a fallback; and the launch tally's
arithmetic over fake counter vectors.

On the CPU the engine runs its programs as plain functions (nothing is
captured) and an export holds no kernel library; the card's half (graph
ids equal to the eager chain's, pools unchanged by capture, a failed
capture raising) is in ``tests/test_torch_cuda_kernels.py``.
"""

import gc
import json
import os
import shutil
import weakref

import jax
import numpy as np
import pytest

from paddle_tpu import parallel as dist
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenRequest as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu_torch import aot
from paddle_tpu_torch.aot import artifact as tartifact
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                GenRequest)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.cuda.layer import LaunchTally
from paddle_tpu_torch.spec_decode import SpecDecodeConfig

from faults import SimulatedCrash, corrupt_file

GEOM = dict(max_batch=2, block_size=8, num_blocks=64, prefill_buckets=(8,))
PROMPT_LENS = (5, 9, 17)
NEW = 4
SAMPLING = dict(temperature=0.8, top_k=16, top_p=0.9)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(eng, prompts, sampled=()):
    """Ids in request order; requests whose index is in ``sampled`` draw
    with ``SAMPLING`` under seed ``index + 1``, the others are greedy."""
    rids = [eng.add_request(p, NEW, **(dict(SAMPLING, seed=i + 1)
                                       if i in sampled else {}))
            for i, p in enumerate(prompts)]
    out = eng.run_to_completion()
    return [out[r] for r in rids]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per dtype: the JAX fresh engine's ids (greedy, and mixed greedy /
    sampled in fp32), the port's trees and an exported directory."""
    prompts = _prompts(jllama.llama_tiny().vocab_size)
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jcfg = jllama.llama_tiny(dtype=dtype)
            topo = dist.init_topology(devices=jax.devices()[:1])
            _, init_fn = jllama.build_llama_train_step(jcfg, topo,
                                                       num_microbatches=1)
            jp = init_fn(0)["params"]
            set_topology(HybridTopology())
            np_tree = jax.tree_util.tree_map(np.asarray, jp)
            jeng = JEngine(jcfg, jp, **GEOM)
            m = dict(tcfg=tllama.llama_tiny(dtype=dtype),
                     tp=params_from_numpy(np_tree, dtype, "cpu"),
                     greedy=_serve(jeng, prompts))
            if dtype == "float32":
                m["jeng"] = jeng
                m["sampled"] = _serve(JEngine(jcfg, jp, **GEOM), prompts,
                                      sampled=(0, 2))
            d = str(tmp_path_factory.mktemp(f"aot_{dtype}"))
            aot.export_engine(_tengine(m), d)
            m["dir"] = d
            cache[dtype] = m
        return cache[dtype]
    return get, prompts


def _tengine(m, **kw):
    return ContinuousBatchingEngine(m["tcfg"], m["tp"], device="cpu",
                                    **{**GEOM, **kw})


def _spec(m):
    return SpecDecodeConfig(draft_cfg=m["tcfg"], draft_params=m["tp"], k=3,
                            window=12)


# ---------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warm_engine_greedy_ids_match_jax(setup, dtype):
    get, prompts = setup
    m = get(dtype)
    eng = _tengine(m, aot_dir=m["dir"])
    assert eng.aot_loaded, eng.aot_error
    _same(_serve(eng, prompts), m["greedy"])
    stats = eng.aot_stats()
    assert stats["aot_loaded"] and stats["bucket_hits"] >= 1
    assert "graphs" not in stats and "aot_error" not in stats
    if dtype == "float32":
        jstats = m["jeng"].aot_stats()
        assert {k: stats[k] for k in jstats if k != "aot_loaded"} == \
            {k: v for k, v in jstats.items() if k != "aot_loaded"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warm_spec_engine_greedy_ids_match_jax(setup, dtype, tmp_path):
    """A speculating engine's export holds the draft and the verify; a
    warm start serves the baseline's greedy ids, and an artifact exported
    without speculation does not warm a speculating engine."""
    get, prompts = setup
    m = get(dtype)
    aot.export_engine(_tengine(m, spec_config=_spec(m)), str(tmp_path))
    names = set(json.loads((tmp_path / "manifest.json").read_text())
                ["executables"])
    assert names == {"decode", "chunk_fill_8", "sampler", "spec_draft",
                     "spec_verify"}
    eng = _tengine(m, spec_config=_spec(m), aot_dir=str(tmp_path))
    assert eng.aot_loaded, eng.aot_error
    _same(_serve(eng, prompts), m["greedy"])
    assert eng.spec_stats()["spec_steps"] > 0
    cold = _tengine(m, spec_config=_spec(m), aot_dir=m["dir"])
    assert not cold.aot_loaded and "config hash" in cold.aot_error


def test_fixed_width_sampler_matches_jax(setup):
    """Sub-batches of 1 and 2 rows through ``_sample_rows`` (padded to
    ``max_batch``) against the JAX engine's, and a warm engine's mixed
    greedy / sampled traffic against the JAX engine's."""
    get, prompts = setup
    m = get("float32")
    eng = _tengine(m, aot_dir=m["dir"])
    assert eng.aot_loaded, eng.aot_error
    g = np.random.default_rng(3)
    V = m["tcfg"].vocab_size
    specs = [(0.8, 16, 0.9, 1), (1.2, None, 0.95, 7)]
    for n in range(1, eng.B + 1):
        lg = (g.standard_normal((n, V)) * 2).astype(np.float32)
        pos = g.integers(0, 64, n).tolist()
        jreqs = [JRequest(i, np.zeros(1, np.int32), 4, temperature=t,
                          top_k=k, top_p=p, seed=s)
                 for i, (t, k, p, s) in enumerate(specs[:n])]
        treqs = [GenRequest(i, np.zeros(1, np.int32), 4, temperature=t,
                            top_k=k, top_p=p, seed=s)
                 for i, (t, k, p, s) in enumerate(specs[:n])]
        np.testing.assert_array_equal(
            eng._sample_rows(treqs, lg, pos),
            m["jeng"]._sample_rows(jreqs, lg, pos))
    _same(_serve(eng, prompts, sampled=(0, 2)), m["sampled"])


# ---------------------------------------------------------------------
# fallbacks: typed, and the same ids
# ---------------------------------------------------------------------
def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _edit_manifest(d, fn):
    path = os.path.join(d, "manifest.json")
    with open(path) as f:
        man = json.load(f)
    fn(man)
    with open(path, "w") as f:
        json.dump(man, f)


def _max_batch_3(man):
    man["buckets"]["max_batch"] = 3


def _torch_skew(man):
    man["env"]["torch"] = "0.0.1"


def _old_magic(man):
    man["magic"] = "paddle_tpu_torch.aot.v0"


def _rot_decode(d):
    corrupt_file(os.path.join(d, "decode.prog"), offset=8)


FALLBACKS = {
    "config": (None, aot.AotManifestMismatchError, "config hash"),
    "max_batch": (lambda d: _edit_manifest(d, _max_batch_3),
                  aot.AotManifestMismatchError, "exported for max_batch=3"),
    "version_skew": (lambda d: _edit_manifest(d, _torch_skew),
                     aot.AotManifestMismatchError, "skew"),
    "magic": (lambda d: _edit_manifest(d, _old_magic),
              aot.AotManifestMismatchError, "not a paddle_tpu_torch"),
    "crc": (_rot_decode, aot.AotArtifactCorruptError, "CRC"),
    "no_manifest": (lambda d: os.remove(os.path.join(d, "manifest.json")),
                    aot.AotManifestMismatchError, "no AOT manifest"),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_unusable_artifact_falls_back_typed(setup, case, tmp_path):
    """Each refusal is the typed error ``load_engine_artifacts`` raises,
    its message on ``aot_error``; the engine then serves the fresh JAX
    engine's ids (``config``: an engine of another pool size)."""
    get, prompts = setup
    m = get("float32")
    d = _copy(m["dir"], str(tmp_path / "art"))
    edit, err, match = FALLBACKS[case]
    kw = {"num_blocks": 32} if edit is None else {}
    if edit is not None:
        edit(d)
    eng = _tengine(m, aot_dir=d, **kw)
    assert not eng.aot_loaded
    with pytest.raises(err, match=match) as e:
        aot.load_engine_artifacts(eng, d)
    assert eng.aot_error == str(e.value)
    assert eng.aot_stats()["aot_error"] == eng.aot_error
    _same(_serve(eng, prompts), m["greedy"])


def test_crc_is_checked_by_the_store(setup, tmp_path):
    get, _ = setup
    d = _copy(get("float32")["dir"], str(tmp_path / "rot"))
    _rot_decode(d)
    with pytest.raises(aot.AotArtifactCorruptError, match="CRC"):
        aot.ArtifactStore(d).get("decode")
    store = aot.ArtifactStore(str(tmp_path / "nowhere"))
    assert not store.exists()
    with pytest.raises(aot.AotManifestMismatchError,
                       match="no AOT manifest"):
        store.manifest()


# ---------------------------------------------------------------------
# rotation roots
# ---------------------------------------------------------------------
def _generation(src, root, name):
    return aot.ArtifactStore(_copy(src, os.path.join(str(root), name)))


def test_rotation_publish_resolve_and_gc(setup, tmp_path):
    get, prompts = setup
    m = get("float32")
    root = tmp_path / "root"
    root.mkdir()
    _generation(m["dir"], root, "gen-0001").publish()
    eng = _tengine(m, aot_dir=str(root))
    assert eng.aot_loaded, eng.aot_error
    _same(_serve(eng, prompts[:1]), m["greedy"][:1])
    _generation(m["dir"], root, "gen-0002").publish(keep_last=2)
    _generation(m["dir"], root, "gen-0003").publish(keep_last=2)
    assert sorted(os.listdir(root)) == ["gen-0002", "gen-0003", "latest"]
    assert (root / "latest").read_text().strip() == "gen-0003"
    assert _tengine(m, aot_dir=str(root)).aot_loaded
    # export_engine(rotate=True) writes the next generation and publishes
    aot.export_engine(_tengine(m), str(root), rotate=True, keep_last=1)
    assert sorted(os.listdir(root)) == ["gen-0004", "latest"]
    assert _tengine(m, aot_dir=str(root)).aot_loaded


def test_gc_never_removes_pointed_generation(setup, tmp_path):
    get, _ = setup
    m = get("float32")
    root = tmp_path / "root"
    root.mkdir()
    oldest = _generation(m["dir"], root, "gen-0001")
    _generation(m["dir"], root, "gen-0002")
    _generation(m["dir"], root, "gen-0003")
    oldest.publish()
    removed = aot.ArtifactStore(str(root)).gc(keep_last=1)
    assert [os.path.basename(r) for r in removed] == ["gen-0002"]
    assert sorted(os.listdir(root)) == ["gen-0001", "gen-0003", "latest"]
    assert _tengine(m, aot_dir=str(root)).aot_loaded
    with pytest.raises(ValueError, match="keep_last"):
        aot.ArtifactStore(str(root)).gc(keep_last=0)


def test_pointer_publish_crash_keeps_previous_live(setup, tmp_path,
                                                   monkeypatch):
    get, _ = setup
    m = get("float32")
    root = tmp_path / "root"
    root.mkdir()
    _generation(m["dir"], root, "gen-0001").publish()
    gen2 = _generation(m["dir"], root, "gen-0002")
    real = tartifact._replace

    def crash(tmp, path):
        raise SimulatedCrash(f"simulated crash before rename {tmp!r}")
    monkeypatch.setattr(tartifact, "_replace", crash)
    with pytest.raises(SimulatedCrash):
        gen2.publish()
    monkeypatch.setattr(tartifact, "_replace", real)
    assert (root / "latest").read_text().strip() == "gen-0001"
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
    assert _tengine(m, aot_dir=str(root)).aot_loaded
    gen2.publish()
    assert (root / "latest").read_text().strip() == "gen-0002"


def test_rotation_bitrot_and_dangling_pointer_fall_back_typed(setup,
                                                              tmp_path):
    get, prompts = setup
    m = get("float32")
    root = tmp_path / "root"
    root.mkdir()
    gen = _generation(m["dir"], root, "gen-0001")
    gen.publish()
    corrupt_file(os.path.join(gen.directory, "manifest.json"), offset=8)
    eng = _tengine(m, aot_dir=str(root))
    assert not eng.aot_loaded and "manifest" in eng.aot_error
    _same(_serve(eng, prompts[:1]), m["greedy"][:1])
    root2 = tmp_path / "root2"
    root2.mkdir()
    (root2 / "latest").write_text("gen-0042")
    eng2 = _tengine(m, aot_dir=str(root2))
    assert not eng2.aot_loaded
    assert "deleted out from under" in eng2.aot_error
    with pytest.raises(aot.AotArtifactCorruptError):
        aot.resolve_artifact_dir(str(root2))


def test_warm_engine_factory_requires_warm(setup, tmp_path):
    get, _ = setup
    m = get("float32")
    kw = dict(device="cpu", **GEOM)
    eng = aot.warm_engine_factory(m["tcfg"], m["tp"], aot_dir=m["dir"],
                                  **kw)()
    assert eng.aot_loaded
    with pytest.raises(RuntimeError, match="fell back"):
        aot.warm_engine_factory(m["tcfg"], m["tp"],
                                aot_dir=str(tmp_path), **kw)()
    cold = aot.warm_engine_factory(m["tcfg"], m["tp"], aot_dir=str(tmp_path),
                                   require_warm=False, **kw)()
    assert not cold.aot_loaded and "no AOT manifest" in cold.aot_error


@pytest.mark.parametrize("spec", [False, True], ids=["base", "spec"])
def test_engine_is_freed_without_a_gc_pass(setup, spec):
    """Neither the program table nor the spec runner makes the engine a
    reference cycle: its last ``del`` frees it (on the card its pools and
    graphs, GBs), with the garbage collector off."""
    get, prompts = setup
    m = get("float32")
    gc.disable()
    try:
        eng = _tengine(m, **({"spec_config": _spec(m)} if spec else {}))
        _serve(eng, prompts[:2], sampled=(1,))
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------
# the launch tally of graph replays
# ---------------------------------------------------------------------
def test_launch_tally_arithmetic():
    """A capture's counter delta is subtracted once and added once per
    replay; a reset zeroes the tally.  Fake library counters stand in for
    ``layer.raw_counts()``."""
    tally = LaunchTally()
    lib = {"decode_block": 0, "rms_norm_rows": 0, "flash_fwd": 0}
    # a warm-up call ran: 2 layers, one norm a layer; counted as it is
    lib.update(decode_block=2, rms_norm_rows=2)
    before = dict(lib)
    # the capture returned success for 2 + 2 launches that did not run
    lib.update(decode_block=4, rms_norm_rows=4)
    delta = tally.captured(before, lib)
    assert delta == {"decode_block": 2, "rms_norm_rows": 2}
    assert tally.read(lib) == before
    for _ in range(3):
        tally.replayed(delta)
    assert tally.read(lib) == {"decode_block": 8, "rms_norm_rows": 8,
                               "flash_fwd": 0}
    # a reset zeroes the library's counters and the tally; replays after
    # it count from zero
    lib = dict.fromkeys(lib, 0)
    tally.reset()
    tally.replayed(delta)
    assert tally.read(lib) == {"decode_block": 2, "rms_norm_rows": 2,
                               "flash_fwd": 0}


def test_warm_captures_are_held_to_the_export():
    """A warm CUDA engine's captures must launch, a replay, what the
    export's captures recorded; ``check_captured`` names the program that
    differs (fake programs stand in for captured graphs)."""
    from types import SimpleNamespace
    from paddle_tpu_torch.aot.serve import check_captured
    records = {"decode": {"launches": {"decode_block": 2}},
               "chunk_fill_8": {"launches": None},
               "sampler": {"launches": {}}}
    graphs = {"decode": SimpleNamespace(launches={"decode_block": 2}),
              "sampler": SimpleNamespace(launches={})}
    check_captured(records, graphs)
    graphs["decode"] = SimpleNamespace(launches={"decode_block": 3})
    with pytest.raises(aot.AotManifestMismatchError, match="decode"):
        check_captured(records, graphs)
