"""ProbeSim core in PyTorch.

    make_params         error-budget accounting (Thm 1 + 2)
    single_source       approximate single-source SimRank (Alg. 1 + §4)
    single_source_simple  deprecated wrapper (a handle, or a bare ELL graph)
    topk                approximate top-k SimRank (Def. 2)
    multi_source        fused multi-query serve path
    multi_source_topk   fused batched top-k (Def. 2)
    epoch_step          fused update->query epoch (apply, then serve)
    sample_walks        sqrt(c)-walk generation (Def. 3)
    simrank_power       exact Power-Method oracle (sparse P on the device)
    mc_single_source    Monte Carlo baseline
    tsf_single_source   TSF baseline
    evaluate_with_pool  pooling evaluation (§6.2)
    AccuracyController  adaptive per-query walk escalation (core/accuracy.py)
    walks_for_error     Thm-1/2 inversion: walks needed for a requested eps
"""
from repro_torch.core.accuracy import (
    AccuracyController,
    Certificate,
    ProbeCache,
    empirical_error_bound,
    escalation_schedule,
    normal_quantile,
)
from repro_torch.core.epoch import (
    ShardEpochGraph,
    build_shard_epoch_graph,
    epoch_step,
    make_sharded_epoch_step,
)
from repro_torch.core.montecarlo import (
    mc_pool_scores,
    mc_single_pair,
    mc_single_source,
)
from repro_torch.core.multisource import (
    fused_serve,
    multi_source,
    multi_source_topk,
)
from repro_torch.core.params import (
    ProbeSimParams,
    abs_error_bound,
    bound_from_sampling_error,
    make_params,
    sampling_error,
    walks_for_error,
)
from repro_torch.core.pooling import (
    build_pool,
    evaluate_with_pool,
    pooled_ground_truth,
)
from repro_torch.core.power import (
    simrank_power,
    simrank_power_host,
    simrank_truncated_single_source,
)
from repro_torch.core.probe import (
    estimate_walk_reference,
    probe_prefix_reference,
    probe_tree_levels,
    probe_walks_telescoped,
    push_level,
    push_level_padded,
)
from repro_torch.core.probesim import single_source, single_source_simple, topk
from repro_torch.core.tree import build_prefix_tree, tree_stats
from repro_torch.core.tsf import build_oneway_index, tsf_single_source
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
    "AccuracyController",
    "Certificate",
    "ProbeCache",
    "ProbeSimParams",
    "ShardEpochGraph",
    "abs_error_bound",
    "bound_from_sampling_error",
    "build_oneway_index",
    "build_pool",
    "build_prefix_tree",
    "build_shard_epoch_graph",
    "derive_seed",
    "empirical_error_bound",
    "epoch_step",
    "escalation_schedule",
    "estimate_walk_reference",
    "evaluate_with_pool",
    "fused_serve",
    "make_generator",
    "make_params",
    "make_sharded_epoch_step",
    "mc_pool_scores",
    "mc_single_pair",
    "mc_single_source",
    "multi_source",
    "multi_source_topk",
    "normal_quantile",
    "pooled_ground_truth",
    "probe_prefix_reference",
    "probe_tree_levels",
    "probe_walks_telescoped",
    "push_level",
    "push_level_padded",
    "sample_walks",
    "sample_walks_batch",
    "sampling_error",
    "simrank_power",
    "simrank_power_host",
    "simrank_truncated_single_source",
    "single_source",
    "single_source_simple",
    "topk",
    "tree_stats",
    "tsf_single_source",
    "walk_lengths",
    "walk_uniforms",
    "walks_for_error",
    "walks_from_uniforms",
]
