from repro_torch.sparse.coo import COOTensor, from_dense, random_sparse
from repro_torch.sparse.csf import CSFTensor, build_csf, build_csf_batch

__all__ = ["COOTensor", "random_sparse", "from_dense", "CSFTensor",
           "build_csf", "build_csf_batch"]
