"""PGBSC core: templates, color sets, the plan executor and the counting
engine."""
