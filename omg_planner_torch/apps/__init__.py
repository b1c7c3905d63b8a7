"""Subpackage of omg_planner_torch; see the package docstring."""
