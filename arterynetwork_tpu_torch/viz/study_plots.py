# Copy of arterynetwork_tpu/viz/study_plots.py: the statistics only (PARTITION_NAMES and statistics_per_partition(2)); the figures wait for the port of viz.
"""Per-partition morphology statistics (reference C23 tail):
``statistics_per_partition`` / ``statistics_per_partition2`` —
graphRelated.py:662-722 (morphology summaries per compartment and for
the merged MCA/PCA/ACA groups).  numpy over ``calculate_property`` and
``summarize``; no figure is drawn and matplotlib is not imported.
"""

from __future__ import annotations

from typing import Dict, List

from ..morpho.metrics import calculate_property, summarize

PARTITION_NAMES = ["LMCA", "RMCA", "ACA", "LPCA", "RPCA"]


# ----------------------------------------------------------------------
# statistics per partition (graphRelated.py:662-722)
# ----------------------------------------------------------------------
def statistics_per_partition(G, segment_list, partition_info,
                             spacing: float = 0.0004) -> Dict[str, dict]:
    """Morphology summary per compartment plus 'Overall'
    (statisticsPerPartition, graphRelated.py:662-689)."""
    out = {}
    overall = []
    for name, info in partition_info.items():
        overall += [segment_list[i] for i in info["segment_index_list"]]
    node_info, seg_info = calculate_property(
        G, overall, spacing=spacing, skip_uncategorized=True, min_nodes=0)
    out["Overall"] = summarize(node_info, seg_info, spacing=spacing)
    for name, info in partition_info.items():
        segs = [segment_list[i] for i in info["segment_index_list"]]
        node_info, seg_info = calculate_property(
            G, segs, spacing=spacing, skip_uncategorized=True, min_nodes=0)
        out[name] = summarize(node_info, seg_info, spacing=spacing)
    return out


def statistics_per_partition2(G, segment_list, partition_info,
                              spacing: float = 0.0004) -> Dict[str, dict]:
    """Merged-group summaries: PCA = LPCA+RPCA, MCA = LMCA+RMCA, ACA
    (statisticsPerPartition2, graphRelated.py:691-722)."""
    groups = {"PCA": ["LPCA", "RPCA"], "MCA": ["LMCA", "RMCA"],
              "ACA": ["ACA"]}
    out = {}
    for gname, members in groups.items():
        ids: List[int] = []
        for m in members:
            if m in partition_info:
                ids += list(partition_info[m]["segment_index_list"])
        segs = [segment_list[i] for i in ids]
        node_info, seg_info = calculate_property(
            G, segs, spacing=spacing, skip_uncategorized=True, min_nodes=0)
        out[gname] = summarize(node_info, seg_info, spacing=spacing)
    return out
