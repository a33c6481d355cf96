"""repro_torch — the PyTorch/CUDA port of ``repro`` (ProbeSim SimRank serving).

It mirrors ``repro``'s layout (``graph``, ``core``, ``kernels``, ``api``)
and imports neither ``jax`` nor ``repro``.  Entry points that build graph
state take ``device=`` and default to ``"cuda"``; on CUDA tensors the
probe levels run the hand-written kernels of ``repro_torch.kernels``.
"""
