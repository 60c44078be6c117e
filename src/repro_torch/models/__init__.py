"""The port's LM stack (dense ``attn`` decoders so far)."""
