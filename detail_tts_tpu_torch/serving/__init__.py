"""Serving layer: the batched synthesis engine and its front-ends.

Public surface:
* :class:`TTSEngine` / :class:`EngineConfig` - the batched synthesis engine
  (reference api.py + SynthesizerTrn.infer*, model_24k.py:774-876);
* :class:`TTSServer` - microbatching request server;
* :func:`synthesize_long` / :func:`synthesize_long_stream` - long-form
  chunking with prompt reuse and crossfades;
* ``http_api`` (HTTP endpoint) and ``api`` (command line).
"""
from detail_tts_tpu_torch.serving.longform import (synthesize_long,  # noqa: F401
                                                   synthesize_long_stream)
from detail_tts_tpu_torch.serving.pipeline import (EngineConfig,  # noqa: F401
                                                   TTSEngine, random_engine)
from detail_tts_tpu_torch.serving.server import TTSServer  # noqa: F401
