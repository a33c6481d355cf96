"""repro_torch's GatedGCN and NequIP train bundles held against repro's on
the CPU at every shape, at smoke size: the checks of
``test_torch_gnn_bundles.py`` (a file of its own: their reference steps
take most of the compile time)."""
import pytest

from repro.configs import base as JCB

from torch_port_helpers import gnn_bundle_steps_equal_repro, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch,shape", [(a, s.name) for a in ("gatedgcn", "nequip")
                                        for s in JCB.shapes_for(a)])
def test_bundle_steps_equal_repro(arch, shape):
    gnn_bundle_steps_equal_repro(arch, shape)
