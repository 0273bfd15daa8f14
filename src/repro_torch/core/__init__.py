# The paper's primary contribution — the host-faithful implementation of the
# RIG-based graph pattern matching system (GM): data graph + reachability
# substrate, transitive reduction, double simulation, RIG construction,
# search ordering and the MJoin worst-case-optimal enumerator.  The device
# executors for MJoin (CUDA kernels, resident RIG) live in
# ``repro_torch.torchgm``.
from .graph import DataGraph, graph_from_edge_list, paper_example_graph
from .matcher import GM, GMOptions, MatchResult, MatchStream, match
from .mjoin import (ENUM_METHODS, MJoinResult, MJoinStats, MJoinStream,
                    iter_tuples, mjoin, mjoin_batched)
from .ordering import get_order
from .query import CHILD, DESC, PatternQuery, QueryEdge, paper_example_query, query
from .rig import RIG, build_rig, prefilter
from .simulation import EdgeOracle, fb_sim, fb_sim_bas, fb_sim_dag, match_sets

__all__ = [
    "DataGraph", "graph_from_edge_list", "paper_example_graph",
    "PatternQuery", "QueryEdge", "CHILD", "DESC", "query", "paper_example_query",
    "EdgeOracle", "fb_sim", "fb_sim_bas", "fb_sim_dag", "match_sets",
    "RIG", "build_rig", "prefilter", "get_order", "mjoin",
    "MJoinResult", "MJoinStats", "MJoinStream", "ENUM_METHODS",
    "iter_tuples", "mjoin_batched",
    "GM", "GMOptions", "MatchResult", "MatchStream", "match",
]
