"""LM transformer (GQA attention, dense SwiGLU) for prefill and decode."""
