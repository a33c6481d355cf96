"""Minimal real-SO(3) representation machinery for NequIP (l <= 4); a
pinned numpy copy of ``repro.models.gnn.so3`` whose ``real_sh`` also takes
torch tensors.

No e3nn:

* complex Clebsch-Gordan coefficients via the Racah formula,
* the unitary complex->real spherical-harmonic basis change,
* real coupling coefficients C[l1, l2, l3][m1, m2, m3] used by the
  equivariant tensor product,
* real spherical harmonics Y_lm evaluated from Cartesian unit vectors
  (closed forms for l <= 2, the NequIP config's l_max).

The tables are float64 numpy; the model casts them to its feature dtype.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _fact(n: int) -> float:
    return math.factorial(n)


@lru_cache(maxsize=None)
def cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """Complex CG <l1 m1; l2 m2 | l3 m3> as [2l1+1, 2l2+1, 2l3+1] (m = -l..l)."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return out
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            # Racah formula
            pre = math.sqrt(
                (2 * l3 + 1)
                * _fact(l3 + l1 - l2)
                * _fact(l3 - l1 + l2)
                * _fact(l1 + l2 - l3)
                / _fact(l1 + l2 + l3 + 1)
            )
            pre *= math.sqrt(
                _fact(l3 + m3)
                * _fact(l3 - m3)
                * _fact(l1 - m1)
                * _fact(l1 + m1)
                * _fact(l2 - m2)
                * _fact(l2 + m2)
            )
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                denom_terms = [
                    k,
                    l1 + l2 - l3 - k,
                    l1 - m1 - k,
                    l2 + m2 - k,
                    l3 - l2 + m1 + k,
                    l3 - l1 - m2 + k,
                ]
                if any(t < 0 for t in denom_terms):
                    continue
                denom = 1.0
                for t in denom_terms:
                    denom *= _fact(t)
                s += (-1.0) ** k / denom
            out[m1 + l1, m2 + l2, m3 + l3] = pre * s
    return out


@lru_cache(maxsize=None)
def complex_to_real(l: int) -> np.ndarray:
    """Unitary U with Y_real = U @ Y_complex (Condon-Shortley phases)."""
    d = 2 * l + 1
    U = np.zeros((d, d), dtype=np.complex128)
    rt2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            U[i, m + l] = 1j * rt2
            U[i, -m + l] = -1j * rt2 * (-1.0) ** (-m)
        elif m == 0:
            U[i, l] = 1.0
        else:
            U[i, -m + l] = rt2
            U[i, m + l] = rt2 * (-1.0) ** m
    return U


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real coupling coefficients: contraction of real irreps l1 x l2 -> l3.

    Defined so that if a transforms as D_{l1}, b as D_{l2}, then
    t[m3] = sum_{m1,m2} C[m1,m2,m3] a[m1] b[m2] transforms as D_{l3}.
    """
    C = cg_complex(l1, l2, l3).astype(np.complex128)
    U1 = complex_to_real(l1)
    U2 = complex_to_real(l2)
    U3 = complex_to_real(l3)
    # C_real[a,b,c] = sum U1[a,m1] U2[b,m2] conj(U3[c,m3]) C[m1,m2,m3]
    Cr = np.einsum("am,bn,co,mno->abc", U1, U2, np.conj(U3), C)
    # real up to a global phase: rotate it away
    flat = Cr.reshape(-1)
    j = np.argmax(np.abs(flat))
    phase = flat[j] / abs(flat[j]) if abs(flat[j]) > 1e-12 else 1.0
    Cr = Cr / phase
    assert np.abs(Cr.imag).max() < 1e-9, f"CG({l1},{l2},{l3}) not real"
    return np.ascontiguousarray(Cr.real)


def sh_l0(vec: np.ndarray) -> np.ndarray:
    return np.full(vec.shape[:-1] + (1,), 1.0 / math.sqrt(4 * math.pi))


def real_sh(l: int, vec):
    """Real spherical harmonics of unit vectors [..., 3] (a numpy array or a
    torch tensor; the result is of the same kind) as [..., 2l+1].

    Basis order m = -l..l; normalization: orthonormal on the sphere.
    """
    if isinstance(vec, np.ndarray):
        def stack(xs):
            return np.stack(xs, axis=-1)

        ones_like = np.ones_like
    else:
        import torch

        def stack(xs):
            return torch.stack(xs, dim=-1)

        ones_like = torch.ones_like
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    pi = math.pi
    if l == 0:
        return (0.5 / math.sqrt(pi)) * ones_like(x)[..., None]
    if l == 1:
        c = math.sqrt(3.0 / (4 * pi))
        return stack([c * y, c * z, c * x])
    if l == 2:
        c0 = 0.5 * math.sqrt(15.0 / pi)
        c1 = 0.5 * math.sqrt(15.0 / pi)
        c2 = 0.25 * math.sqrt(5.0 / pi)
        return stack(
            [
                c0 * x * y,
                c1 * y * z,
                c2 * (3 * z * z - 1.0),
                c1 * x * z,
                0.5 * c0 * (x * x - y * y),
            ]
        )
    raise NotImplementedError(f"l={l}")


def tp_paths(l_max: int) -> list[tuple[int, int, int]]:
    """All (l_in, l_filter, l_out) paths with every l <= l_max."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                paths.append((l1, l2, l3))
    return paths
