"""ProbeSim core in PyTorch.

    make_params         error-budget accounting (Thm 1 + 2)
    single_source       approximate single-source SimRank (Alg. 1 + §4)
    topk                approximate top-k SimRank (Def. 2)
    multi_source        fused multi-query serve path
    multi_source_topk   fused batched top-k (Def. 2)
    epoch_step          fused update->query epoch (apply, then serve)
    sample_walks        sqrt(c)-walk generation (Def. 3)
"""
from repro_torch.core.epoch import epoch_step
from repro_torch.core.multisource import (
    fused_serve,
    multi_source,
    multi_source_topk,
)
from repro_torch.core.params import (
    ProbeSimParams,
    abs_error_bound,
    make_params,
    sampling_error,
    walks_for_error,
)
from repro_torch.core.probe import (
    estimate_walk_reference,
    probe_prefix_reference,
    probe_tree_levels,
    probe_walks_telescoped,
    push_level,
    push_level_padded,
)
from repro_torch.core.probesim import single_source, topk
from repro_torch.core.walks import (
    derive_seed,
    make_generator,
    sample_walks,
    sample_walks_batch,
    walk_lengths,
    walk_uniforms,
    walks_from_uniforms,
)

__all__ = [
    "ProbeSimParams",
    "abs_error_bound",
    "derive_seed",
    "epoch_step",
    "estimate_walk_reference",
    "fused_serve",
    "make_generator",
    "make_params",
    "multi_source",
    "multi_source_topk",
    "probe_prefix_reference",
    "probe_tree_levels",
    "probe_walks_telescoped",
    "push_level",
    "push_level_padded",
    "sample_walks",
    "sample_walks_batch",
    "sampling_error",
    "single_source",
    "topk",
    "walk_lengths",
    "walk_uniforms",
    "walks_for_error",
    "walks_from_uniforms",
]
