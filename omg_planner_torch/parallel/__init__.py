"""Scale-out helpers (counterpart of ``omg_planner_tpu/parallel``)."""
