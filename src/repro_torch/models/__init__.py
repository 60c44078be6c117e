"""The port's LM stack (dense ``attn`` decoders and xLSTM stacks so far)."""
