"""BIRCH clustering in numpy and scipy: the counterpart of
``sklearn.cluster.Birch(threshold, n_clusters=k)`` as
pram_tpu/mapping/clustering.py:95-97 calls it (scikit-learn is not a
dependency of the port).

The algorithm is scikit-learn's, step for step, so the partition and its
label numbering come out the same:

- a CF-tree (branching factor 50) takes the samples one at a time; a
  sample joins its closest leaf subcluster when the merged radius stays
  within ``threshold``, else it starts a subcluster of its own;
- a node past the branching factor splits around its farthest pair of
  subclusters, each going to the nearer of the two;
- the leaves' subcluster centroids, in leaf order, are clustered into
  ``n_clusters`` by Ward's agglomerative clustering
  (``scipy.cluster.hierarchy.ward``, the tree scikit-learn builds without
  a connectivity graph) and the tree is cut as scikit-learn's ``_hc_cut``
  cuts it;
- each sample takes the label of its nearest subcluster centroid.

Every floating-point step (the centroid updates, the squared norms, the
distance forms) is the one scikit-learn performs, so the tree's decisions
are the same.
"""

from __future__ import annotations

from heapq import heappush, heappushpop
from typing import List, Optional

import numpy as np


class _CFSubcluster:
    """A clustering feature: sample count, linear sum, squared sum; a child
    node when the subcluster sits in an inner node."""

    def __init__(self, linear_sum: Optional[np.ndarray] = None):
        if linear_sum is None:
            self.n_samples = 0
            self.squared_sum = 0.0
            self.centroid = self.linear_sum = 0
        else:
            self.n_samples = 1
            self.centroid = self.linear_sum = linear_sum
            self.squared_sum = self.sq_norm = np.dot(linear_sum, linear_sum)
        self.child: Optional[_CFNode] = None

    def update(self, other: "_CFSubcluster") -> None:
        self.n_samples += other.n_samples
        self.linear_sum += other.linear_sum
        self.squared_sum += other.squared_sum
        self.centroid = self.linear_sum / self.n_samples
        self.sq_norm = np.dot(self.centroid, self.centroid)

    def merge(self, nominee: "_CFSubcluster", threshold: float) -> bool:
        """Absorb ``nominee`` if the merged radius is within ``threshold``."""
        new_ss = self.squared_sum + nominee.squared_sum
        new_ls = self.linear_sum + nominee.linear_sum
        new_n = self.n_samples + nominee.n_samples
        new_centroid = (1 / new_n) * new_ls
        new_sq_norm = np.dot(new_centroid, new_centroid)
        if new_ss / new_n - new_sq_norm <= threshold**2:
            self.n_samples, self.linear_sum, self.squared_sum = new_n, new_ls, new_ss
            self.centroid, self.sq_norm = new_centroid, new_sq_norm
            return True
        return False


class _CFNode:
    """A CF-tree node: up to ``branching_factor`` subclusters, their
    centroids and squared norms in preallocated rows; leaves are chained."""

    def __init__(self, threshold: float, branching_factor: int, is_leaf: bool, n_features: int, dtype):
        self.threshold = threshold
        self.branching_factor = branching_factor
        self.is_leaf = is_leaf
        self.subclusters: List[_CFSubcluster] = []
        self.init_centroids = np.zeros((branching_factor + 1, n_features), dtype)
        self.init_sq_norm = np.zeros((branching_factor + 1,), dtype)
        self.centroids = self.init_centroids[:0]
        self.sq_norms = self.init_sq_norm[:0]
        self.prev_leaf: Optional[_CFNode] = None
        self.next_leaf: Optional[_CFNode] = None

    def like(self) -> "_CFNode":
        return _CFNode(self.threshold, self.branching_factor, self.is_leaf, self.init_centroids.shape[1],
                       self.init_centroids.dtype)

    def append(self, sub: _CFSubcluster) -> None:
        n = len(self.subclusters)
        self.subclusters.append(sub)
        self.init_centroids[n] = sub.centroid
        self.init_sq_norm[n] = sub.sq_norm
        self.centroids = self.init_centroids[: n + 1]
        self.sq_norms = self.init_sq_norm[: n + 1]

    def replace_split(self, sub: _CFSubcluster, new1: _CFSubcluster, new2: _CFSubcluster) -> None:
        ind = self.subclusters.index(sub)
        self.subclusters[ind] = new1
        self.init_centroids[ind] = new1.centroid
        self.init_sq_norm[ind] = new1.sq_norm
        self.append(new2)

    def insert(self, sub: _CFSubcluster) -> bool:
        """Insert a one-sample subcluster below this node; True when this
        node now holds more than ``branching_factor`` subclusters."""
        if not self.subclusters:
            self.append(sub)
            return False
        dist = np.dot(self.centroids, sub.centroid)
        dist *= -2.0
        dist += self.sq_norms
        closest_index = np.argmin(dist)
        closest = self.subclusters[closest_index]
        if closest.child is not None:
            if not closest.child.insert(sub):
                closest.update(sub)
                self.init_centroids[closest_index] = closest.centroid
                self.init_sq_norm[closest_index] = closest.sq_norm
                return False
            new1, new2 = _split_node(closest.child)
            self.replace_split(closest, new1, new2)
            return len(self.subclusters) > self.branching_factor
        if closest.merge(sub, self.threshold):
            self.init_centroids[closest_index] = closest.centroid
            self.init_sq_norm[closest_index] = closest.sq_norm
            return False
        self.append(sub)
        return len(self.subclusters) > self.branching_factor


def _squared_distances(x: np.ndarray) -> np.ndarray:
    """``sklearn.metrics.pairwise.euclidean_distances(x, squared=True)`` for
    float64 rows: -2 x x^T + |x|^2 + |x|^2^T, clipped at 0, zero diagonal."""
    xx = np.einsum("ij,ij->i", x, x)[:, None]
    d = -2 * np.dot(x, x.T)
    d += xx
    d += xx.T
    np.maximum(d, 0, out=d)
    np.fill_diagonal(d, 0)
    return d


def _split_node(node: _CFNode):
    """Split ``node`` around its farthest pair of subclusters into two
    nodes, each the child of a new subcluster; the leaf chain is kept."""
    new_sub1, new_sub2 = _CFSubcluster(), _CFSubcluster()
    new_node1, new_node2 = node.like(), node.like()
    new_sub1.child, new_sub2.child = new_node1, new_node2
    if node.is_leaf:
        if node.prev_leaf is not None:
            node.prev_leaf.next_leaf = new_node1
        new_node1.prev_leaf = node.prev_leaf
        new_node1.next_leaf = new_node2
        new_node2.prev_leaf = new_node1
        new_node2.next_leaf = node.next_leaf
        if node.next_leaf is not None:
            node.next_leaf.prev_leaf = new_node2
    dist = _squared_distances(node.centroids)
    n = dist.shape[0]
    farthest = np.unravel_index(dist.argmax(), (n, n))
    node1_dist, node2_dist = dist[(farthest,)]
    node1_closer = node1_dist < node2_dist
    node1_closer[farthest[0]] = True
    for idx, sub in enumerate(node.subclusters):
        if node1_closer[idx]:
            new_node1.append(sub)
            new_sub1.update(sub)
        else:
            new_node2.append(sub)
            new_sub2.update(sub)
    return new_sub1, new_sub2


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """Cut a merge tree into ``n_clusters`` as scikit-learn's ``_hc_cut``:
    split the most recent merge first, label the final nodes in heap order."""
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heappush(nodes, -these[0])
        heappushpop(nodes, -these[1])
    label = np.zeros(n_leaves, np.intp)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            j = stack.pop()
            if j < n_leaves:
                leaves.append(j)
            else:
                stack.extend(children[j - n_leaves])
        label[leaves] = i
    return label


def ward_labels(x: np.ndarray, n_clusters: int) -> np.ndarray:
    """``sklearn.cluster.AgglomerativeClustering(n_clusters).fit_predict(x)``
    (ward linkage, no connectivity)."""
    from scipy.cluster import hierarchy

    if x.shape[0] < 2:
        raise ValueError(f"ward clustering needs at least 2 samples, got {x.shape[0]}")
    children = hierarchy.ward(np.require(x, requirements="W"))[:, :2].astype(np.intp)
    return _hc_cut(n_clusters, children, x.shape[0])


BRANCHING_FACTOR = 50  # scikit-learn's default, which clustering.py:95-97 keeps


class Birch:
    """BIRCH with a Ward global step into ``n_clusters``; ``fit`` sets
    ``subcluster_centers_``, ``subcluster_labels_`` and ``labels_`` as
    scikit-learn's estimator does."""

    def __init__(self, threshold: float, n_clusters: int):
        self.threshold = threshold
        self.n_clusters = n_clusters

    def fit(self, X) -> "Birch":
        X = np.asarray(X, np.float64)
        n_features = X.shape[1]
        new_node = lambda is_leaf: _CFNode(self.threshold, BRANCHING_FACTOR, is_leaf, n_features, X.dtype)
        root = new_node(True)
        dummy_leaf = new_node(True)
        dummy_leaf.next_leaf = root
        root.prev_leaf = dummy_leaf
        for sample in X:
            if root.insert(_CFSubcluster(linear_sum=sample)):
                new1, new2 = _split_node(root)
                root = new_node(False)
                root.append(new1)
                root.append(new2)
        leaves, leaf = [], dummy_leaf.next_leaf
        while leaf is not None:
            leaves.append(leaf)
            leaf = leaf.next_leaf
        centers = np.concatenate([lf.centroids for lf in leaves])
        self.subcluster_centers_ = centers
        if len(centers) < self.n_clusters:  # too few subclusters: each its own label
            self.subcluster_labels_ = np.arange(len(centers))
        else:
            self.subcluster_labels_ = ward_labels(centers, self.n_clusters)
        self.labels_ = self.predict(X)
        return self

    def predict(self, X) -> np.ndarray:
        """Each sample's label: that of its nearest subcluster centroid."""
        X = np.asarray(X)
        c = self.subcluster_centers_
        d = -2.0 * (X @ c.T)
        d += np.einsum("ij,ij->i", c, c)[None]
        return self.subcluster_labels_[np.argmin(d, axis=1)]
