"""Tree templates and FASCIA-style partitioning (paper §2.1 phase 2).

A template T (tree on k vertices) rooted at ``root`` is recursively cut at an
edge adjacent to the current root: the *active* child keeps the root; the
*passive* child is the subtree hanging off the cut edge. Leaves are single
vertices. The resulting binary partition tree is evaluated bottom-up
(post-order) by the dynamic program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from functools import cached_property

__all__ = ["TreeTemplate", "PlanNode", "ExecutionPlan", "TemplateSpec",
           "FusedPlan", "compile_fused_plan", "as_template",
           "STANDARD_TEMPLATES", "get_template"]


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One sub-template in the DP, identified by its vertex set.

    ``active``/``passive`` are indices into ExecutionPlan.nodes (None = leaf).
    ``size`` = number of template vertices in this sub-template.
    """

    vertices: tuple[int, ...]
    root: int
    active: int | None
    passive: int | None

    @property
    def size(self) -> int:
        return len(self.vertices)

    @property
    def is_leaf(self) -> bool:
        return self.active is None


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Post-order list of sub-templates; the full template is ``nodes[-1]``."""

    nodes: tuple[PlanNode, ...]
    k: int

    def __post_init__(self):
        for i, nd in enumerate(self.nodes):
            if not nd.is_leaf:
                assert nd.active < i and nd.passive < i, "plan must be post-order"

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def table_widths(self, k: int | None = None):
        from math import comb
        k = k or self.k
        return [comb(k, nd.size) for nd in self.nodes]


class TreeTemplate:
    """An unrooted tree on vertices 0..k-1 given by its edge list."""

    def __init__(self, edges, root: int = 0, name: str = "t"):
        raw = [tuple(e) for e in edges]
        for e in raw:
            if len(e) != 2:
                raise ValueError(f"edge {e!r} is not a vertex pair")
            u, v = e
            if u == v:
                raise ValueError(f"self-loop ({u}, {v}): tree templates have "
                                 "no self-loops")
            if u < 0 or v < 0:
                raise ValueError(f"edge ({u}, {v}) has a negative vertex id; "
                                 "template vertices are 0..k-1")
        self.edges = tuple(tuple(sorted(e)) for e in raw)
        if len(set(self.edges)) != len(self.edges):
            dup = next(e for e in self.edges if self.edges.count(e) > 1)
            raise ValueError(f"duplicate edge {dup} forms a cycle; "
                             "a tree has k-1 distinct edges")
        self.name = name
        self.root = root
        ks = {v for e in self.edges for v in e}
        self.k = (max(ks) + 1) if ks else 1
        if not 0 <= root < self.k:
            raise ValueError(f"root {root} is out of range: template "
                             f"vertices are 0..{self.k - 1}")
        if ks and ks != set(range(self.k)):
            missing = sorted(set(range(self.k)) - ks)
            raise ValueError(f"edge list skips vertices {missing}; template "
                             f"vertices must be exactly 0..{self.k - 1}")
        if len(self.edges) >= self.k:
            raise ValueError(f"not a tree: {self.k} vertices with "
                             f"{len(self.edges)} edges contain a cycle")
        if len(self.edges) < self.k - 1:
            raise ValueError(f"not a tree: {self.k} vertices, "
                             f"{len(self.edges)} edges (disconnected)")
        self._adj: dict[int, list[int]] = {v: [] for v in range(self.k)}
        for u, v in self.edges:
            self._adj[u].append(v)
            self._adj[v].append(u)
        # connectivity check (k-1 edges + a disconnection implies a cycle too)
        seen = {0}
        stack = [0]
        while stack:
            v = stack.pop()
            for u in self._adj[v]:
                if u not in seen:
                    seen.add(u)
                    stack.append(u)
        if len(seen) != self.k:
            unreached = sorted(set(range(self.k)) - seen)
            raise ValueError(f"template is not connected: vertices "
                             f"{unreached} are unreachable from vertex 0 "
                             "(so another component carries a cycle)")

    def adjacency(self, v: int) -> list[int]:
        return self._adj[v]

    def subtree_vertices(self, root: int, banned: int) -> tuple[int, ...]:
        """Vertices reachable from ``root`` without passing through ``banned``."""
        seen = {root}
        stack = [root]
        while stack:
            v = stack.pop()
            for u in self._adj[v]:
                if u != banned and u not in seen:
                    seen.add(u)
                    stack.append(u)
        return tuple(sorted(seen))

    @cached_property
    def plan(self) -> ExecutionPlan:
        """FASCIA partitioning: cut the first adjacent edge of the root."""
        return self._build_plan(dedup=False)

    @cached_property
    def plan_dedup(self) -> ExecutionPlan:
        """Plan with isomorphic sub-templates shared (beyond-paper optimization).

        Two sub-templates with the same *rooted canonical form* provably have
        identical count tables (the DP result is independent of the partition
        choice), so their tables — and the SpMM over their passive children —
        can be computed once.
        """
        return self._build_plan(dedup=True)

    @cached_property
    def plan_optimized(self) -> ExecutionPlan:
        """Work-optimal partitioning (beyond-paper): instead of FASCIA's
        first-adjacent-edge cut, cut the edge whose passive subtree is
        smallest. The SpMM term of a sub-template costs E * C(k, t_p), so
        keeping t_p small (and the active chain long) minimizes traversal
        work; combined with canonical-form dedup. See EXPERIMENTS.md §Perf.
        """
        return self._build_plan(dedup=True, optimize=True)

    def _rooted_canon(self, vertices: tuple[int, ...], root: int) -> str:
        vset = set(vertices)

        def rec(v: int, parent: int) -> str:
            subs = sorted(
                rec(u, v) for u in self._adj[v] if u != parent and u in vset
            )
            return "(" + "".join(subs) + ")"

        return rec(root, -1)

    def _build_plan(self, dedup: bool, optimize: bool = False) -> ExecutionPlan:
        nodes: list[PlanNode] = []
        self.grow_plan(nodes, {}, dedup=dedup, optimize=optimize)
        return ExecutionPlan(tuple(nodes), self.k)

    def grow_plan(self, nodes: list[PlanNode], cache: dict, *,
                  dedup: bool = True, optimize: bool = False) -> int:
        """Append this template's plan nodes to ``nodes`` (post-order) and
        return the index of this template's root node.

        With ``dedup`` the cache is keyed by the *rooted canonical form* of
        each sub-template — a structure-only key — so passing ONE shared
        ``(nodes, cache)`` pair across several same-k templates builds a
        fused plan in which canonically identical rooted sub-templates are
        computed once for all of them (the cross-template generalization of
        :attr:`plan_dedup`; see :func:`compile_fused_plan`). Without
        ``dedup`` keys carry the template identity, so nothing is shared.
        """

        def pick_cut(vset: set, root: int) -> int:
            cands = [u for u in self._adj[root] if u in vset]
            if not optimize:
                return cands[0]
            # smallest passive subtree minimizes E * C(k, t_p)
            def psize(u):
                return len([v for v in self.subtree_vertices(u, root)
                            if v in vset])
            return min(cands, key=psize)

        def build(vertices: tuple[int, ...], root: int) -> int:
            key = self._rooted_canon(vertices, root) if dedup \
                else (id(self), vertices, root)
            if key in cache:
                return cache[key]
            if len(vertices) == 1:
                nodes.append(PlanNode(vertices, root, None, None))
            else:
                vset = set(vertices)
                tau = pick_cut(vset, root)
                passive_vs = tuple(
                    v for v in self.subtree_vertices(tau, root) if v in vset
                )
                active_vs = tuple(v for v in vertices if v not in passive_vs)
                ai = build(active_vs, root)
                pi = build(passive_vs, tau)
                nodes.append(PlanNode(vertices, root, ai, pi))
            cache[key] = len(nodes) - 1
            return cache[key]

        return build(tuple(range(self.k)), self.root)

    @cached_property
    def automorphisms(self) -> int:
        from repro_torch.core.automorphism import tree_automorphisms
        return tree_automorphisms(self.edges, self.k)

    @cached_property
    def rooted_canonical(self) -> str:
        """AHU canonical string of the full rooted template (structure only:
        vertex labels and the template name do not enter)."""
        return self._rooted_canon(tuple(range(self.k)), self.root)

    @cached_property
    def canonical_hash(self) -> str:
        """Content hash of :attr:`rooted_canonical`. Two templates with the
        same hash are the same rooted tree up to relabeling, so their plans,
        count tables, and estimates coincide."""
        return hashlib.sha256(self.rooted_canonical.encode()).hexdigest()[:16]

    def __repr__(self):
        return f"TreeTemplate({self.name}, k={self.k})"


@dataclasses.dataclass(frozen=True)
class TemplateSpec:
    """Serializable, first-class template description (the query-API unit).

    A spec is *data*: an arbitrary tree edge list, a root choice, and an
    optional display name. It coerces from every template-ish thing the
    stack accepts (:meth:`of`: registry names, ``TreeTemplate`` objects,
    other specs, raw edge lists) and exposes the template's
    :attr:`canonical_hash`, its identity up to relabeling, and serializes
    to the JAX package's JSON form (:meth:`to_dict` / :meth:`from_dict`,
    the CLI's ``"u-v,u-v,...[@root]"`` through :meth:`from_edge_string`).
    """

    edges: tuple[tuple[int, int], ...]
    root: int = 0
    name: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "edges", tuple(
            tuple(int(v) for v in e) for e in self.edges))
        object.__setattr__(self, "root", int(self.root))

    # ------------------------------------------------------------- coercion
    @classmethod
    def of(cls, obj) -> "TemplateSpec":
        """Coerce a name / TreeTemplate / spec / edge list into a spec."""
        if isinstance(obj, TemplateSpec):
            return obj
        if isinstance(obj, TreeTemplate):
            spec = cls(edges=obj.edges, root=obj.root, name=obj.name)
            spec.__dict__["tree"] = obj     # reuse warm plan/automorphism caches
            return spec
        if isinstance(obj, str):
            return cls.of(get_template(obj))
        spec = cls(edges=tuple(tuple(e) for e in obj))
        spec.tree                           # validate eagerly: clear errors now
        return spec

    @classmethod
    def from_edge_string(cls, s: str, name: str | None = None
                         ) -> "TemplateSpec":
        """Parse the CLI form ``"0-1,1-2,1-3[@root]"``."""
        s = s.strip()
        root = 0
        if "@" in s:
            s, _, r = s.rpartition("@")
            root = int(r)
        edges = []
        for part in s.split(","):
            u, sep, v = part.strip().partition("-")
            if not sep:
                raise ValueError(f"bad edge {part!r}; expected 'u-v'")
            edges.append((int(u), int(v)))
        spec = cls(edges=tuple(edges), root=root, name=name)
        spec.tree
        return spec

    # ----------------------------------------------------------- derivation
    @cached_property
    def tree(self) -> TreeTemplate:
        return TreeTemplate(self.edges, root=self.root,
                            name=self.name or "spec")

    @property
    def k(self) -> int:
        return self.tree.k

    @property
    def canonical_hash(self) -> str:
        return self.tree.canonical_hash

    @property
    def automorphisms(self) -> int:
        return self.tree.automorphisms

    @property
    def display_name(self) -> str:
        return self.name or f"tpl:{self.canonical_hash[:8]}"

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = {"edges": [list(e) for e in self.edges], "root": self.root}
        if self.name is not None:
            d["name"] = self.name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TemplateSpec":
        spec = cls(edges=tuple(tuple(e) for e in d["edges"]),
                   root=d.get("root", 0), name=d.get("name"))
        spec.tree
        return spec

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


def as_template(obj) -> TreeTemplate:
    """Coerce a name / spec / edge list into a TreeTemplate (identity on
    TreeTemplate inputs, so warm plan caches are preserved)."""
    if isinstance(obj, TreeTemplate):
        return obj
    if isinstance(obj, str):
        return get_template(obj)
    return TemplateSpec.of(obj).tree


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One :class:`ExecutionPlan` serving several same-k templates.

    ``roots[i]`` is the plan-node index holding template *i*'s full-template
    count table; interior nodes whose rooted canonical forms coincide across
    templates appear ONCE, so their tables — and the SpMM over their passive
    children — are computed once per coloring for the whole bundle.
    """

    plan: ExecutionPlan
    roots: tuple[int, ...]

    @property
    def k(self) -> int:
        return self.plan.k


def compile_fused_plan(templates, optimize: bool = True) -> FusedPlan:
    """Merge the ExecutionPlans of same-k templates into one fused plan by
    deduplicating canonical rooted sub-templates *across* templates.

    Two sub-templates with the same rooted canonical form have identical
    count tables for any coloring, so a motif-vector workload of N
    templates pays for the UNION of their sub-template sets, not the sum.
    ``optimize`` selects the work-optimal (smallest-passive) cut, as
    :attr:`TreeTemplate.plan_optimized` does.
    """
    trees = [as_template(t) for t in templates]
    if not trees:
        raise ValueError("compile_fused_plan needs at least one template")
    ks = sorted({t.k for t in trees})
    if len(ks) != 1:
        raise ValueError(f"a fused plan shares one coloring, so all "
                         f"templates must have equal k; got k={ks} "
                         "(group by k first — repro_torch.api.count_many "
                         "does)")
    nodes: list[PlanNode] = []
    cache: dict = {}
    roots = tuple(t.grow_plan(nodes, cache, dedup=True, optimize=optimize)
                  for t in trees)
    return FusedPlan(ExecutionPlan(tuple(nodes), ks[0]), roots)


def _path(k: int, name: str) -> TreeTemplate:
    return TreeTemplate([(i, i + 1) for i in range(k - 1)], name=name)


def _star(k: int, name: str) -> TreeTemplate:
    return TreeTemplate([(0, i) for i in range(1, k)], name=name)


def _caterpillar(spine: int, legs_at, k: int, name: str) -> TreeTemplate:
    """Path of ``spine`` vertices with extra leaves attached at given spine ids."""
    edges = [(i, i + 1) for i in range(spine - 1)]
    nxt = spine
    for s in legs_at:
        edges.append((s, nxt))
        nxt += 1
    assert nxt == k, (nxt, k)
    return TreeTemplate(edges, name=name)


def _binary(k: int, name: str) -> TreeTemplate:
    """Complete-ish binary tree on k vertices (heap numbering)."""
    edges = [((i - 1) // 2, i) for i in range(1, k)]
    return TreeTemplate(edges, name=name)


# Templates follow the paper's u10..u17 naming (FASCIA's test templates are
# paths/caterpillars/near-binary trees; exact shapes were "from the tests in
# [32] or created by us", so we create representative ones of each size).
STANDARD_TEMPLATES: dict[str, TreeTemplate] = {
    "u3": _path(3, "u3"),
    "u5": _caterpillar(3, [1, 1], 5, "u5"),
    "u7": _binary(7, "u7"),
    "u10": _caterpillar(6, [1, 2, 3, 4], 10, "u10"),
    "u12": _caterpillar(7, [1, 2, 3, 4, 5], 12, "u12"),
    "u13": _binary(13, "u13"),
    "u14": _caterpillar(8, [1, 2, 3, 4, 5, 6], 14, "u14"),
    "u15-1": _caterpillar(9, [1, 2, 3, 4, 5, 6], 15, "u15-1"),
    "u15-2": _binary(15, "u15-2"),
    "u16": _caterpillar(10, [1, 2, 3, 4, 5, 6], 16, "u16"),
    "u17": _caterpillar(11, [1, 2, 3, 4, 5, 6], 17, "u17"),
    "path5": _path(5, "path5"),
    "star5": _star(5, "star5"),
    "path4": _path(4, "path4"),
    "star4": _star(4, "star4"),
}


_DYNAMIC_PATTERN = re.compile(r"^(path|star)([0-9]+)$")
_DYNAMIC_CACHE: dict[str, TreeTemplate] = {}


def get_template(name: str) -> TreeTemplate:
    """Registry lookup, plus dynamic ``path{k}`` / ``star{k}`` for any
    k >= 2 (``path9``, ``star23``, ...); dynamic results are memoized so
    repeated lookups share one object (and its warm plan caches)."""
    if name in STANDARD_TEMPLATES:
        return STANDARD_TEMPLATES[name]
    m = _DYNAMIC_PATTERN.match(name)
    if m and int(m.group(2)) >= 2:
        if name not in _DYNAMIC_CACHE:
            kind, k = m.group(1), int(m.group(2))
            _DYNAMIC_CACHE[name] = (_path if kind == "path" else _star)(k, name)
        return _DYNAMIC_CACHE[name]
    raise KeyError(
        f"unknown template {name!r}; have {sorted(STANDARD_TEMPLATES)} plus "
        "dynamic 'path{k}' / 'star{k}' for any k >= 2 (e.g. 'path6', "
        "'star9'), or submit an arbitrary tree via TemplateSpec")
