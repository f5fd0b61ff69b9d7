"""The port's models: motion tokenizer, AR generator, audio encoders
(wav2vec2, HuBERT, Mimi), style encoder, FLAME geometry, mesh renderer, debug point and texture
renderers.

The names of the JAX package's ``models/__init__.py`` are exported lazily:
importing a submodule runs this file, and the encoders import the ops that
import ``models.nn``, so eager imports here would be circular.
"""

_EXPORTS = {
    "BitwiseVAE": ".bitwise_vae",
    "StyleEncoder": ".style_encoder",
    "Wav2VecEncoder": ".wav2vec",
    "HubertEncoder": ".hubert",
    "MimiEncoder": ".mimi",
    "BitwiseARModel": ".ar_model",
    "FlameModel": ".flame",
    "MeshRenderer": ".renderer",
    "PointRenderer": ".renderer_extras",
    "TextureRenderer": ".renderer_extras",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
