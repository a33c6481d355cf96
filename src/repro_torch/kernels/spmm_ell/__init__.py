from repro_torch.kernels.spmm_ell.ops import spmm_csr, spmm_ell, spmm_ell_padded
from repro_torch.kernels.spmm_ell.ref import (
    spmm_csr_ref,
    spmm_ell_padded_ref,
    spmm_ell_ref,
)

__all__ = ["spmm_csr", "spmm_csr_ref", "spmm_ell", "spmm_ell_padded",
           "spmm_ell_padded_ref", "spmm_ell_ref"]
