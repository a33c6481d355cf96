"""NequIP (Batzner et al., arXiv:2101.03164) — E(3)-equivariant interatomic
potential (port of ``repro.models.gnn.nequip``).

Node features are a stack of real irreps with a uniform channel count:
``h = {l: [N, C, 2l+1] for l in 0..l_max}``.  An interaction layer:

1. edge geometry: r_ij = x_j - x_i, Bessel radial basis with a smooth
   polynomial cutoff envelope, real spherical harmonics Y^l(r_hat),
2. per-path radial weights  R^{(l1,l2,l3)}(|r|) = MLP(bessel)  (per channel),
3. tensor-product message  m^{l3}_i = sum_j sum_paths R * CG(h_j^{l1}, Y^{l2}),
4. scatter-sum over in-edges + linear self-interaction mix per l,
5. gated nonlinearity: scalars -> SiLU; l>0 gated by sigmoid(scalar gates).

Energy readout: per-atom MLP on the l=0 channels, summed per graph; forces
are -dE/dpos through ``torch.autograd``.

The reference's three-operand product ``einsum("eca,eb,abm->ecm")``
contracts Y with the coupling table first here (``[E, 2l1+1, 2l3+1]``, then
one batched product per edge), so it agrees with the reference to fp32
rounding, not bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import repro_torch.models.common as cm
from repro_torch.models.gnn.layers import gather_rows, scatter_sum
from repro_torch.models.gnn.so3 import cg_real, real_sh, tp_paths

Tensor = torch.Tensor


def bessel_basis(r: Tensor, n_rbf: int, cutoff: float) -> Tensor:
    """Sine-Bessel radial basis [E, n_rbf] with smooth cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    ks = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = (math.sqrt(2.0 / cutoff) * torch.sin(ks * math.pi * r[:, None] / cutoff)
             / r[:, None])
    # polynomial envelope (p = 6)
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 28.0 * x**6 + 48.0 * x**7 - 21.0 * x**8
    return basis * env[:, None]


def init_nequip(gen, cfg, d_feat: int, dtype) -> dict:
    C = cfg.d_hidden
    lmax = cfg.l_max
    layers = []
    for _ in range(cfg.n_layers):
        radial = {
            f"{l1}_{l2}_{l3}": dict(w1=cm.dense_init(gen, cfg.n_rbf, 16, dtype),
                                    w2=cm.dense_init(gen, 16, C, dtype))
            for (l1, l2, l3) in tp_paths(lmax)
        }
        self_mix = {str(l): cm.dense_init(gen, C, C, dtype) for l in range(lmax + 1)}
        gates = {str(l): cm.dense_init(gen, C, C, dtype) for l in range(1, lmax + 1)}
        layers.append(dict(radial=radial, self_mix=self_mix, gates=gates))
    return dict(
        embed=cm.dense_init(gen, d_feat, C, dtype),
        layers=layers,
        out_w1=cm.dense_init(gen, C, C, dtype),
        out_w2=cm.dense_init(gen, C, 1, dtype),
    )


def nequip_forward(
    params: dict,
    feats: Tensor,  # [N, d_feat] scalar node attributes
    pos: Tensor,  # [N, 3]
    src: Tensor,
    dst: Tensor,
    mask: Tensor,
    cfg,
    graph_ids: Tensor | None = None,
    n_graphs: int = 1,
) -> Tensor:
    """Returns per-graph energies [n_graphs]."""
    N = feats.shape[0]
    C = cfg.d_hidden
    lmax = cfg.l_max
    s = src.clamp(0, N - 1)
    d_ = dst.clamp(0, N - 1)

    # edge geometry
    rvec = gather_rows(pos, s) - gather_rows(pos, d_)
    r = torch.linalg.norm(rvec + 1e-12, dim=-1)
    rhat = rvec / torch.clamp(r, min=1e-6)[:, None]
    rb = bessel_basis(r, cfg.n_rbf, cfg.cutoff)  # [E, n_rbf]
    rb = torch.where(mask[:, None], rb, 0.0)
    Y = {l: real_sh(l, rhat) for l in range(lmax + 1)}  # [E, 2l+1]

    # initial features: scalars only
    h = {0: (feats @ params["embed"])[:, :, None]}
    for l in range(1, lmax + 1):
        h[l] = feats.new_zeros((N, C, 2 * l + 1))

    paths = tp_paths(lmax)
    # Y^{l2} contracted with each path's coupling table: [E, 2l1+1, 2l3+1]
    yc = {
        (l1, l2, l3): torch.einsum(
            "eb,abm->eam", Y[l2],
            torch.as_tensor(cg_real(l1, l2, l3), dtype=feats.dtype, device=feats.device))
        for (l1, l2, l3) in paths
    }
    for layer in params["layers"]:
        msgs: dict = {l: 0.0 for l in range(lmax + 1)}
        for (l1, l2, l3) in paths:
            rp = layer["radial"][f"{l1}_{l2}_{l3}"]
            R = F.silu(rb @ rp["w1"]) @ rp["w2"]  # [E, C]
            hj = gather_rows(h[l1], s)  # [E, C, 2l1+1]
            edge_msg = torch.bmm(hj, yc[(l1, l2, l3)])  # [E, C, 2l3+1]
            edge_msg = edge_msg * R[:, :, None]
            msgs[l3] = msgs[l3] + scatter_sum(
                edge_msg.reshape(edge_msg.shape[0], -1), dst, N
            ).reshape(N, C, 2 * l3 + 1)
        # self-interaction + residual + gated nonlinearity
        new_h = {}
        scal = None
        for l in range(lmax + 1):
            z = h[l] + msgs[l]
            z = torch.einsum("ncm,cf->nfm", z, layer["self_mix"][str(l)])
            if l == 0:
                z = F.silu(z)
                scal = z[:, :, 0]
            else:
                gate = torch.sigmoid(scal @ layer["gates"][str(l)])
                z = z * gate[:, :, None]
            new_h[l] = z
        h = new_h

    atom_e = (F.silu(h[0][:, :, 0] @ params["out_w1"]) @ params["out_w2"])[:, 0]
    if graph_ids is None:
        return atom_e.sum().reshape(1)
    return scatter_sum(atom_e, graph_ids, n_graphs)
