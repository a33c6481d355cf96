"""repro_torch's NequIP (``models/gnn/nequip.py``) held against repro on
the CPU: the Bessel basis, energies and forces (-dE/dpos through
``torch.autograd`` against ``jax.grad``), and the parameter gradients;
then, in the port alone, the energy's invariance and the forces'
equivariance under a random rotation (repro's own property test).

The port contracts Y with the coupling table before the per-edge product
(the reference's three-operand einsum in another order): energies are held
at 1e-5 and forces and gradients at 1e-4 of each tensor's largest
magnitude.  A self-loop edge (r = 0) is a case of its own: its r_hat is
rvec / 1e-6, so its two endpoints' force terms are 1e6 x the message
gradient and cancel on the one atom, leaving rounding of that size in
both packages; there the other atoms' forces are held, and the loop's
atom is not.  (The loop's Y^2 also keeps a constant m = 0 term, so it is
not equivariant in either package; ``synthetic.molecule_batch`` draws such
loops.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.nequip import SMOKE as J_SMOKE
from repro.models.gnn import model as JG
from repro.models.gnn import nequip as JN

from repro_torch.configs.nequip import SMOKE as T_SMOKE
from repro_torch.models.gnn import model as TG
from repro_torch.models.gnn import nequip as TN
from repro_torch.training.tree import leaves
from torch_port_helpers import gnn_params, one_thread, rel_close  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N, E, G, D_FEAT = 20, 60, 2, 8


def batch(seed=0, graph_ids=True, self_loop=False):
    """Two molecules of 10 atoms; edges inside each, three of them masked;
    no self loop, or (``self_loop``) exactly one, edge 0."""
    rng = np.random.default_rng(seed)
    per = N // G
    offs = np.repeat(np.arange(G) * per, E // G)
    src = (rng.integers(0, per, E) + offs).astype(np.int32)
    dst = (rng.integers(1, per, E) + src - offs) % per + offs  # never src
    dst = dst.astype(np.int32)
    if self_loop:
        dst[0] = src[0]
    mask = np.ones(E, bool)
    mask[[5, 17, 40]] = False
    b = dict(feats=rng.normal(size=(N, D_FEAT)).astype(np.float32),
             pos=(rng.normal(size=(N, 3)) * 1.5).astype(np.float32),
             src=src, dst=dst, mask=mask,
             energy=rng.normal(size=(G,)).astype(np.float32))
    if graph_ids:
        b["graph_ids"] = np.repeat(np.arange(G), per).astype(np.int32)
    return b


def test_bessel_basis_equals_repro():
    r = np.linspace(0.0, 6.0, 97).astype(np.float32)  # 0, past the cutoff
    got = TN.bessel_basis(torch.from_numpy(r), 8, 5.0)
    rel_close(got, JN.bessel_basis(jnp.asarray(r), 8, 5.0), 1e-5)


@pytest.mark.parametrize("graph_ids,self_loop", [(True, False), (False, False),
                                                 (True, True)],
                         ids=["per_graph", "summed", "self_loop"])
def test_energy_forces_and_gradients_equal_repro(graph_ids, self_loop):
    assert T_SMOKE == T_SMOKE.__class__(**J_SMOKE.__dict__)
    jp = JG.init_gnn(jax.random.key(0), J_SMOKE, D_FEAT)
    b = batch(graph_ids=graph_ids, self_loop=self_loop)
    n_graphs = G if graph_ids else 1
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jenergy(pos):
        return JG.gnn_forward(jp, dict(jb, pos=pos), J_SMOKE, n_graphs=n_graphs)

    # jitted: op by op the reference takes about 30 s here
    je = jax.jit(jenergy)(jb["pos"])
    jforce = -jax.jit(jax.grad(lambda pos: jenergy(pos).sum()))(jb["pos"])

    tp = gnn_params(jp, T_SMOKE)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    pos = tb["pos"].clone().requires_grad_(True)
    te = TG.gnn_forward(tp, dict(tb, pos=pos), T_SMOKE, n_graphs=n_graphs)
    tforce = -torch.autograd.grad(te.sum(), pos)[0]
    assert te.shape == (n_graphs,)
    rel_close(te, je, 1e-5, "energy")
    others = np.arange(N) != (b["src"][0] if self_loop else -1)
    rel_close(tforce[others], np.asarray(jforce)[others], 1e-4, "forces")

    def jloss(p):
        return JG.gnn_loss(p, jb, J_SMOKE, n_graphs=n_graphs)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, _ = TG.gnn_loss(tp, tb, T_SMOKE, n_graphs=n_graphs)
    # the last layer's l > 0 outputs reach no readout: zero gradients, as jax's
    tg = torch.autograd.grad(tl, leaves(tp), allow_unused=True, materialize_grads=True)
    rel_close(tl, jl, 1e-5, "loss")
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for path, a, w in zip(paths, tg, jax.tree_util.tree_leaves(jg)):
        if float(np.abs(np.asarray(w)).max()) == 0.0:
            assert float(a.abs().max()) == 0.0, path
        else:
            rel_close(a, w, 1e-4, path)


def test_energy_invariant_forces_equivariant():
    """repro's ``test_nequip_energy_invariant_forces_equivariant`` on the
    port: its graph (20 atoms, 60 random edges, seed 0), its limits."""
    rng = np.random.default_rng(0)
    cfg = T_SMOKE.__class__(name="nq", conv="nequip", n_layers=2, d_hidden=8, l_max=2,
                            n_rbf=4, cutoff=5.0)
    p = TG.init_gnn(torch.Generator().manual_seed(0), cfg, 8)
    b = dict(
        feats=torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32)),
        pos=torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)),
        src=torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
        dst=torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
        mask=torch.ones(E, dtype=torch.bool),
        graph_ids=None,
    )
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    Qt = torch.from_numpy(Q.T.astype(np.float32))

    def energy_and_force(pos):
        pos = pos.clone().requires_grad_(True)
        e = TG.gnn_forward(p, dict(b, pos=pos), cfg)
        return e.detach(), -torch.autograd.grad(e.sum(), pos)[0]

    e0, f0 = energy_and_force(b["pos"])
    e1, f1 = energy_and_force(b["pos"] @ Qt)
    assert abs(float(e0[0] - e1[0])) < 5e-3  # invariant energy
    # forces rotate with the frame: F(Rx) = R F(x)
    np.testing.assert_allclose(f1.numpy(), (f0 @ Qt).numpy(), atol=5e-3)
