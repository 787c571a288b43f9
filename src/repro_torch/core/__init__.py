"""PGBSC core: templates, color sets, the plan executor, the three
counting engines, the estimator runner and the brute-force oracle."""

from repro_torch.core.automorphism import tree_automorphisms
from repro_torch.core.colorsets import (all_colorsets, colorful_probability,
                                        rank_colorset, split_tables,
                                        unrank_colorset)
from repro_torch.core.engines import ENGINES, CountingEngine, build_engine
from repro_torch.core.executor import (PlanExecutor, Schedule,
                                       compute_schedule,
                                       keep_everything_bytes,
                                       peak_table_bytes, pick_execution)
from repro_torch.core.oracle import (count_colorful_embeddings,
                                     count_embeddings, count_subgraphs_exact)
from repro_torch.core.templates import (STANDARD_TEMPLATES, ExecutionPlan,
                                        FusedPlan, PlanNode, TemplateSpec,
                                        TreeTemplate, as_template,
                                        compile_fused_plan, get_template)

__all__ = [
    "tree_automorphisms",
    "all_colorsets", "colorful_probability", "rank_colorset",
    "split_tables", "unrank_colorset",
    "ENGINES", "CountingEngine", "build_engine",
    "PlanExecutor", "Schedule", "compute_schedule",
    "keep_everything_bytes", "peak_table_bytes", "pick_execution",
    "count_colorful_embeddings", "count_embeddings", "count_subgraphs_exact",
    "STANDARD_TEMPLATES", "ExecutionPlan", "PlanNode", "TreeTemplate",
    "TemplateSpec", "FusedPlan", "as_template", "compile_fused_plan",
    "get_template",
]
