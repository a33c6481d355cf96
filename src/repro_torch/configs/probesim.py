"""ProbeSim serving config — the paper's own architecture (copy of
``repro.configs.probesim``, pinned equal by ``tests/test_torch_production.py``).

The Twitter graph of the paper's Table 3 at full scale; the serving step is
a batched single-source top-k query against the row-blocked graph
(``core/distributed.py::make_serve_step``, ``core/ring.py``).
"""
from repro_torch.configs.base import ProbeSimConfig

CONFIG = ProbeSimConfig(
    name="probesim",
    n=41_652_230,
    m=1_468_365_182,
    c=0.6,
    eps_a=0.1,
    delta=0.01,
    k_max_ell=64,
)
SMOKE = ProbeSimConfig(
    name="probesim-smoke", n=512, m=4096, c=0.6, eps_a=0.1, delta=0.1,
    k_max_ell=32,
)
