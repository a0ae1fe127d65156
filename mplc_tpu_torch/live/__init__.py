"""The live contributivity tier: resident incremental games, Shapley
queries from recorded-round reconstruction, DPVS-style coalition pruning,
WAL-backed bounded residency (live/residency.py) and hierarchical Shapley
past the 16-partner exact wall (live/hierarchy.py). See live/game.py for
the contract."""

from . import residency
from .dpvs import PrunedReconstruction, info_scores, low_information
from .game import (LIVE_METHODS, LiveGame, LiveGameFull, LiveQueryResult,
                   LiveResidencyFull, MAX_EXACT_PARTNERS)
from .hierarchy import (MAX_CLUSTERS, cluster_partners, default_clusters,
                        hierarchical_shapley)

__all__ = ["LIVE_METHODS", "LiveGame", "LiveGameFull", "LiveQueryResult",
           "LiveResidencyFull", "MAX_CLUSTERS", "MAX_EXACT_PARTNERS",
           "PrunedReconstruction", "cluster_partners", "default_clusters",
           "hierarchical_shapley", "info_scores", "low_information",
           "residency"]
