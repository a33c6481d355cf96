"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``lane_probe``      — one fused compacted-lane probe level (the serve path);
* ``spmm_ell``        — ELL SpMM (the push of the tree / telescoped variants);
* ``probe_push``      — prune + ELL push + exclusion in one pass (standalone op);
* ``flash_attention`` — FlashAttention-2 forward, causal, GQA (LM prefill).

``lane_probe``, ``spmm_ell`` and ``probe_push`` read each ELL row only up
to ``row_len`` (the rows' in-degree) over the chunk plan of ``ell_plan``,
which packs short rows and splits long ones across blocks.  ``_build`` compiles
``csrc/*.cu`` with nvcc on first use.  A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.
"""
