"""repro_torch's GNN train bundles (``arch.py``'s GNN family) held against
repro's on the CPU for GCN, GIN and GAT at every shape (GatedGCN and
NequIP: ``test_torch_gnn_bundles_deep.py``), at smoke size:
``input_specs`` (shapes and dtypes), ``model_flops`` and the shrunk shape
equal, then three train steps from repro's ``init`` state (carried in by
``launch.train.load_state_tree``) on the launcher's batches of both
packages (equal arrays): each step's loss at 1e-5 and gradient norm at
1e-4, and the parameters after the third step at 1e-5 of each leaf's
largest magnitude, the step count exact.  The moments are not held leaf by leaf
(``torch_port_helpers.gnn_bundle_steps_equal_repro`` says why).
"""
import pytest

from repro.configs import base as JCB

from torch_port_helpers import gnn_bundle_steps_equal_repro, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch,shape", [(a, s.name)
                                        for a in ("gcn-cora", "gin-tu", "gat-bonus")
                                        for s in JCB.shapes_for(a)])
def test_bundle_steps_equal_repro(arch, shape):
    gnn_bundle_steps_equal_repro(arch, shape)
