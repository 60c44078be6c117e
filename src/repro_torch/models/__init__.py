"""The port's LM stack (dense ``attn`` decoders and xLSTM stacks so far):
``build_model(cfg, parallel)`` returns a :class:`ModelBundle` of closures
over a parameter module."""
from repro_torch.models.api import ModelBundle, build_model

__all__ = ["build_model", "ModelBundle"]
