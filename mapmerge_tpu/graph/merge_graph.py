"""Global-consistency merge graph solve (host side).

Equivalent of the reference's graph machinery (map_merge_3d/src/graph.cpp,
graph.h — itself adapted from OpenCV stitching): union-find connected
components with a confidence threshold, maximum spanning tree by Kruskal on
descending confidence, tree centers by leaf-BFS eccentricity, and global
transform chaining over the tree. The problem is O(N^2) scalars for N maps —
it stays exact and simple on the host in numpy while the heavy pairwise
estimation runs on the device mesh (SURVEY.md §7 sharding plan).

Semantics faithfully mirror the reference:
- edges below `confidence_threshold` do not join components
  (graph.cpp:77-80), but any estimate whose source lands in the largest
  component is kept for the spanning-tree solve (graph.cpp:92-99);
- global transforms are sized by the highest node index seen in the
  estimates (map_merging.cpp:167), zero matrix = unregistered
  (map_merging.h:81-84);
- for an edge stored as (source i, target j, T: i->j frame),
  global[j] = global[i] @ T^-1 when walking i->j (map_merging.cpp:137-151).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TransformEstimate:
    """Pairwise estimate (reference graph.h:24-36).

    `ambiguous` (no reference analog) marks registrations flagged at
    registration time as structurally weak evidence — low source->target
    coverage or a RANSAC consensus that admits materially different poses
    (pipeline/registration.PairEstimate.ambiguous). The MST solve ignores
    it (reference semantics); the pose-graph refiner down-weights such
    edges (graph/pose_graph.py)."""

    source_idx: int
    target_idx: int
    transform: np.ndarray  # (4, 4) float32; zeros when estimation failed
    confidence: float
    ambiguous: bool = False


class DisjointSets:
    """Union-find with union-by-rank + path compression (graph.cpp:17-57).

    Mirrors the reference's size bookkeeping: `size` entries are only
    authoritative at root indices.
    """

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n
        self.size = [1] * n

    def find(self, elem: int) -> int:
        root = elem
        while root != self.parent[root]:
            root = self.parent[root]
        while elem != self.parent[elem]:
            elem, self.parent[elem] = self.parent[elem], root
        return root

    def merge(self, a: int, b: int) -> int:
        if self.rank[a] < self.rank[b]:
            self.parent[a] = b
            self.size[b] += self.size[a]
            return b
        if self.rank[b] < self.rank[a]:
            self.parent[b] = a
            self.size[a] += self.size[b]
            return a
        self.parent[a] = b
        self.rank[b] += 1
        self.size[b] += self.size[a]
        return b


def number_of_nodes(estimates: list[TransformEstimate]) -> int:
    n = 0
    for est in estimates:
        n = max(n, est.source_idx + 1, est.target_idx + 1)
    return n


def largest_connected_component(
    estimates: list[TransformEstimate], confidence_threshold: float
) -> list[TransformEstimate]:
    """Subset of estimates belonging to the largest component
    (graph.cpp:64-102)."""
    n = number_of_nodes(estimates)
    if n == 0:
        return []
    comps = DisjointSets(n)
    for est in estimates:
        if est.confidence < confidence_threshold:
            continue
        a = comps.find(est.source_idx)
        b = comps.find(est.target_idx)
        if a != b:
            comps.merge(a, b)
    # reference: argmax over the raw size array; restrict to roots so the
    # winner is a valid component representative even on stale-size ties
    roots = [comps.find(i) for i in range(n)]
    sizes = [comps.size[i] if roots[i] == i else 0 for i in range(n)]
    max_comp = int(np.argmax(sizes))
    return [e for e in estimates if comps.find(e.source_idx) == max_comp]


def find_max_spanning_tree(
    estimates: list[TransformEstimate],
) -> tuple[dict[int, list[tuple[int, float]]], list[int]]:
    """Kruskal max spanning tree + tree centers (graph.cpp:104-175).

    Returns (adjacency {node: [(neighbor, weight)]}, centers).
    """
    n = number_of_nodes(estimates)
    if n == 0:
        return {}, []
    edges = sorted(
        ((e.source_idx, e.target_idx, e.confidence) for e in estimates),
        key=lambda t: t[2],
        reverse=True,
    )
    comps = DisjointSets(n)
    adj: dict[int, list[tuple[int, float]]] = {i: [] for i in range(n)}
    powers = [0] * n
    for a, b, w in edges:
        ra, rb = comps.find(a), comps.find(b)
        if ra != rb:
            comps.merge(ra, rb)
            adj[a].append((b, w))
            adj[b].append((a, w))
            powers[a] += 1
            powers[b] += 1

    leafs = [i for i in range(n) if powers[i] == 1]
    max_dists = [0] * n
    for leaf in leafs:
        cur = _bfs_distances(adj, leaf, n)
        for i in range(n):
            max_dists[i] = max(max_dists[i], cur[i])
    min_max = min(max_dists) if n else 0
    centers = [i for i in range(n) if max_dists[i] == min_max]
    return adj, centers


def _bfs_distances(adj, start: int, n: int) -> list[int]:
    dist = [0] * n
    seen = [False] * n
    seen[start] = True
    queue = [start]
    while queue:
        u = queue.pop(0)
        for v, _ in adj[u]:
            if not seen[v]:
                seen[v] = True
                dist[v] = dist[u] + 1
                queue.append(v)
    return dist


def _get_transform(
    estimates: list[TransformEstimate], from_idx: int, to_idx: int
) -> np.ndarray:
    """Transform for walking from->to (map_merging.cpp:137-151)."""
    for est in estimates:
        if est.source_idx == from_idx and est.target_idx == to_idx:
            return np.linalg.inv(est.transform)
        if est.source_idx == to_idx and est.target_idx == from_idx:
            return est.transform
    return np.zeros((4, 4), np.float32)


def compute_global_transforms(
    estimates: list[TransformEstimate], confidence_threshold: float
) -> list[np.ndarray]:
    """Per-node map->reference transforms (map_merging.cpp:153-186).

    Zero matrices mark nodes outside the largest component or unreachable.
    Uses the native C++ solver (mapmerge_tpu/native) when available; this
    pure-Python implementation is the behavioral contract and fallback.
    """
    nodes_count = number_of_nodes(estimates)
    if nodes_count == 0:
        return []

    from mapmerge_tpu import native

    if estimates:
        solved = native.merge_graph_solve(
            np.asarray([e.source_idx for e in estimates], np.int32),
            np.asarray([e.target_idx for e in estimates], np.int32),
            np.asarray([e.confidence for e in estimates], np.float32),
            np.stack([np.asarray(e.transform, np.float32) for e in estimates]),
            confidence_threshold,
        )
        if solved is not None:
            return list(solved)
    component = largest_connected_component(estimates, confidence_threshold)
    adj, centers = find_max_spanning_tree(component)

    global_t = [np.zeros((4, 4), np.float32) for _ in range(nodes_count)]
    if not centers:
        return global_t
    reference = centers[0]
    global_t[reference] = np.eye(4, dtype=np.float32)

    # BFS walk chaining transforms
    seen = {reference}
    queue = [reference]
    while queue:
        u = queue.pop(0)
        for v, _ in adj.get(u, []):
            if v not in seen:
                seen.add(v)
                global_t[v] = (
                    global_t[u] @ _get_transform(component, u, v)
                ).astype(np.float32)
                queue.append(v)
    return global_t
