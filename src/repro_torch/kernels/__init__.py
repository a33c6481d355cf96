"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``lane_probe``      — one fused compacted-lane probe level (the serve path);
* ``spmm_ell``        — ELL SpMM (the push of the tree / telescoped variants);
* ``probe_push``      — prune + ELL push + exclusion in one pass (standalone op);
* ``flash_attention`` — FlashAttention-2 forward, causal, GQA (LM prefill).

``_build`` compiles ``csrc/*.cu`` with nvcc on first use.  A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.
"""
