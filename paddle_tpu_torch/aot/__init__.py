"""Ahead-of-time programs of the serving engine (counterpart of
``paddle_tpu/aot/``, its serving half).

* :mod:`~paddle_tpu_torch.aot.graphs` — :class:`CapturedProgram`, a
  fixed-geometry program captured as a CUDA graph (the counterpart of a
  jitted XLA program);
* :mod:`~paddle_tpu_torch.aot.artifact` — the versioned, CRC'd store of
  program records and the kernel library's copy, with an environment and
  config manifest and rotation roots;
* :mod:`~paddle_tpu_torch.aot.buckets` — declared prefill chunk buckets;
* :mod:`~paddle_tpu_torch.aot.serve` — export and warm start of the
  continuous-batching engine (``ContinuousBatchingEngine(aot_dir=...)``).

Not ported yet (ROADMAP.md queue 1 item 16): the train-step half
(``paddle_tpu/aot/train.py``) and the compile-budget ratchet.
"""

from .artifact import (LATEST_POINTER, AotArtifactCorruptError,
                       AotDonationError, AotError,
                       AotManifestMismatchError, ArtifactStore,
                       args_signature, config_hash, environment_fingerprint,
                       new_generation, read_latest, resolve_artifact_dir)
from .buckets import DEFAULT_CHUNK_BUCKETS, ShapeBucketRegistry
from .graphs import CapturedProgram, GraphCaptureError
from .serve import (engine_config, export_engine, load_engine_artifacts,
                    warm_engine_factory)

__all__ = [
    "AotError", "AotArtifactCorruptError", "AotManifestMismatchError",
    "AotDonationError", "ArtifactStore", "args_signature", "config_hash",
    "environment_fingerprint", "new_generation", "read_latest",
    "resolve_artifact_dir", "LATEST_POINTER", "DEFAULT_CHUNK_BUCKETS",
    "ShapeBucketRegistry", "CapturedProgram", "GraphCaptureError",
    "engine_config", "export_engine", "load_engine_artifacts",
    "warm_engine_factory",
]
